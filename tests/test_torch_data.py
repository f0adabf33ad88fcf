"""The port's data pipeline (``data/pipeline``) against the reference's, on
the CPU.

Tolerances: none.  ``SyntheticStream.batch_at`` makes the reference's numpy
calls in the reference's order, so every batch is bitwise equal (values,
dtypes, shapes, keys); the prefetching iterator yields exactly
``batch_at(start_step + i)``.
"""
from __future__ import annotations

import dataclasses
import threading
import time

import test_torch_ref  # noqa: F401  (installs the jax 0.9 shims first)

import numpy as np
import pytest

from repro import configs as jconfigs
from repro.arch import ShapeSpec as JShapeSpec
from repro.data import DataSpec as JDataSpec
from repro.data import SyntheticStream as JSyntheticStream
from repro_torch import arch as A
from repro_torch import configs
from repro_torch.data import DataSpec, SyntheticStream, make_batch_iterator

CASES = [  # (arch, kind, batch, seq, img): every family, training and serving kinds
    ("qwen3-0.6b", "train", 2, 16, 0),
    ("deepseek-moe-16b", "prefill", 2, 16, 0),
    ("command-r-35b", "decode", 3, 16, 0),
    ("dit-xl2", "denoise_train", 2, 0, 64),
    ("dit-xl2", "denoise_step", 2, 0, 64),
    ("flux-dev", "denoise_train", 2, 0, 64),
    ("flux-dev", "denoise_step", 2, 0, 64),
    ("resnet-50", "classify_train", 3, 0, 32),
    ("squeezenet", "classify_train", 3, 0, 32),
    ("vit-s16", "classify_train", 2, 0, 32),
    ("efficientnet-b7", "classify_serve", 2, 0, 32),
    ("swin-b", "classify_train", 2, 0, 32),
]


def _streams(name, kind, batch, seq, img, seed):
    def one(mod, shape_cls, spec_cls, stream_cls):
        arch = mod.get(name, smoke=True)
        arch = dataclasses.replace(arch, shapes=(shape_cls("t", kind, batch, seq=seq, img=img),))
        return stream_cls(spec_cls(arch, arch.shape("t"), seed=seed))

    return (one(configs, A.ShapeSpec, DataSpec, SyntheticStream),
            one(jconfigs, JShapeSpec, JDataSpec, JSyntheticStream))


@pytest.mark.parametrize("case", CASES, ids=[f"{c[0]}-{c[1]}" for c in CASES])
def test_batch_at_is_bitwise_the_reference(case):
    port, ref = _streams(*case, seed=5)
    for step in (0, 1, 17, 123456):
        got, want = port.batch_at(step), ref.batch_at(step)
        assert list(got) == list(want)
        for k in want:
            assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
            np.testing.assert_array_equal(got[k], want[k])


def _lm_stream(seed=5):
    return _streams("qwen3-0.6b", "train", 2, 16, 0, seed)[0]


def test_counter_mode_determinism():
    s1, s2 = _lm_stream(), _lm_stream()
    b1, b2 = s1.batch_at(42), s2.batch_at(42)
    for k in b1:
        np.testing.assert_array_equal(b1[k], b2[k])
    assert not np.array_equal(s1.batch_at(42)["tokens"], s1.batch_at(43)["tokens"])
    assert not np.array_equal(s1.batch_at(42)["tokens"], _lm_stream(6).batch_at(42)["tokens"])


def test_iterator_skip_ahead():
    stream = _lm_stream()
    it = make_batch_iterator(stream, start_step=10, prefetch=1)
    for step in (10, 11, 12):
        got = next(it)
        for k, v in stream.batch_at(step).items():
            np.testing.assert_array_equal(got[k], v)
    it.close()


def _prefetchers() -> list[threading.Thread]:
    return [t for t in threading.enumerate() if t.name == "batch-prefetch" and t.is_alive()]


def test_iterator_thread_stops_when_closed():
    before = len(_prefetchers())
    it = make_batch_iterator(_lm_stream(), prefetch=2)
    next(it)
    deadline = time.monotonic() + 5
    while not it.gi_frame.f_locals["q"].full() and time.monotonic() < deadline:
        time.sleep(0.01)  # let the worker fill the queue and block on put
    assert len(_prefetchers()) == before + 1
    it.close()
    assert len(_prefetchers()) == before
