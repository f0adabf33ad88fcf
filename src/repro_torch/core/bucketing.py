"""The shape-bucketing policy of the batched sweep engine.

The sweep engine (:mod:`repro_torch.core.sim_batch`) runs scenarios in
*shape buckets*, not one by one: every padded dimension — the planning
window ``W``, the DP bin count ``NBINS``, trace-segment and frame-horizon
pads — is first rounded UP through the quantizers below, and scenarios are
padded to the bucket size.  Padding is inert (padded windows are gated
off, padded bins are unreachable, padded segments carry ``+inf``
sentinels), so bucketing can only change wall-clock, never results.  The
contract every quantizer obeys:

* **never shrinks**: ``quant(n) >= n`` for all ``n >= 1``,
* **monotone**: ``m <= n`` implies ``quant(m) <= quant(n)``, so a bigger
  scenario can never land in a smaller bucket, and
* **idempotent on its own outputs**: ``quant(quant(n)) == quant(n)``.

The ladders are the reference's, value for value, so a grid partitions
into the same groups and pads to the same widths in either package:

* ``quant_w`` — planning windows concentrate in 1..128 (fps x deadline);
  a dense-then-sparse ladder caps in-group padding waste at ~2x.
* ``quant_bins`` — DP bin grids are large (10^2..10^4) and cheap per bin;
  a coarse linear quantum bounds waste at one quantum.
* ``quant_pow2`` — trace-segment counts and frame horizons are tiny;
  powers of two give log-many buckets.
"""
from __future__ import annotations

import numpy as np

# Dense below 8, then spreading steps: the window ladder shared by every
# planner's padded W dimension.
W_LADDER = (1, 2, 3, 4, 5, 6, 7, 8, 10, 12, 14, 16, 20, 24, 28, 32, 40, 48, 64, 96, 128)


def quant_w(n: int) -> int:
    """Bucket a planning-window length onto the ladder (pow2 past 128)."""
    for w in W_LADDER:
        if n <= w:
            return w
    return int(2 ** np.ceil(np.log2(n)))


def quant_bins(n: int, q: int = 128) -> int:
    """Round a DP bin count up to a multiple of the quantum ``q``."""
    return int(q * np.ceil(max(n, 1) / q))


def quant_pow2(n: int) -> int:
    """Round up to the next power of two (minimum 1)."""
    return 1 << max(int(np.ceil(np.log2(max(n, 1)))), 0)
