from .rules import MeshRules, Sharding, batch_axes, serve_rules, sweep_rules, train_rules  # noqa: F401
