"""The port's AdamW against the reference's on the same parameters and
gradients.  Tolerance rtol 1e-5 / atol 1e-7: the reference computes the
learning-rate schedule and bias corrections in f32 under jit, the port in
Python float64, so the step can differ in the last f32 bits."""
from __future__ import annotations

import test_torch_ref  # noqa: F401  (installs the jax 0.9 shims first)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.train import optim as joptim
from repro_torch.train import optim


@pytest.mark.parametrize("grad_clip", [1.0, 0.0])
def test_adamw_steps_match_reference(grad_clip):
    cfg = dict(lr=3e-3, warmup_steps=3, total_steps=8, weight_decay=0.1, grad_clip=grad_clip)
    rng = np.random.default_rng(0)
    params = {"a": {"w": rng.standard_normal((4, 3)).astype(np.float32)},
              "b": rng.standard_normal((5,)).astype(np.float32)}
    grads = [jax.tree.map(lambda p: (rng.standard_normal(p.shape) * 2).astype(np.float32), params)
             for _ in range(6)]
    jp = jax.tree.map(jnp.asarray, params)
    jopt = joptim.init_opt_state(jp)
    jstep = jax.jit(lambda p, g, o: joptim.adamw_update(joptim.AdamWConfig(**cfg), p, g, o))
    tp = {"a": {"w": torch.tensor(params["a"]["w"])}, "b": torch.tensor(params["b"])}
    topt = optim.init_opt_state(tp)
    for g in grads:
        jp, jopt, jm = jstep(jp, jax.tree.map(jnp.asarray, g), jopt)
        tm = optim.adamw_update(optim.AdamWConfig(**cfg), tp, {"a": {"w": torch.tensor(g["a"]["w"])},
                                                              "b": torch.tensor(g["b"])}, topt)
        np.testing.assert_allclose(tp["a"]["w"].numpy(), np.asarray(jp["a"]["w"]), rtol=1e-5, atol=1e-7)
        np.testing.assert_allclose(tp["b"].numpy(), np.asarray(jp["b"]), rtol=1e-5, atol=1e-7)
        np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]), rtol=1e-6)
        np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-6)
    assert topt["step"] == int(jopt["step"]) == len(grads)
