from .rules import MeshRules, batch_axes, serve_rules, train_rules  # noqa: F401
