"""The yardstick behind every flash-attention bound: ``flash_work`` counts
the live (query, key) pairs, rows and keys of the causal-and-window mask,
and from them the forward's and the backward's operations and bytes.
Held here against a brute-force count of the mask itself on small shapes.
"""

import numpy as np
import pytest
import torch

from mlcomp_tpu_torch.ops.cuda.flash_attention import flash_work


def _brute(b, s_q, s_k, causal, lo, hi):
    """The (b, s_q, s_k) live mask, element by element."""
    mask = np.zeros((b, s_q, s_k), dtype=bool)
    for bb in range(b):
        for i in range(s_q):
            for j in range(s_k):
                mask[bb, i, j] = lo[bb] <= j < hi[bb] and (not causal or i >= j)
    return mask


CASES = {
    # name: (b, s, h, h_kv, d, causal, kv_start, kv_stop)
    "causal": (2, 37, 4, 4, 16, True, None, None),
    "windows": (3, 40, 4, 2, 8, False, [0, 5, 12], [40, 30, 13]),
    "causal_windows": (3, 33, 2, 1, 16, True, [0, 7, 20], [33, 25, 21]),
    "ragged_gqa": (3, 29, 8, 4, 8, True, [0, 3, 11], None),
    "empty_row": (3, 24, 2, 2, 8, True, [0, 24, 5], [24, 24, 3]),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_flash_work_matches_brute_force_mask(name):
    b, s, h, h_kv, d, causal, start, stop = CASES[name]
    lo = start if start is not None else [0] * b
    hi = stop if stop is not None else [s] * b
    mask = _brute(b, s, s, causal, lo, hi)
    ks = None if start is None else torch.tensor(start, dtype=torch.int32)
    ke = None if stop is None else torch.tensor(stop, dtype=torch.int32)
    w = flash_work(b, s, s, h, h_kv, d, causal, ks, ke)

    pairs = int(mask.sum())
    rows = int(mask.any(-1).sum())
    keys = int(mask.any(1).sum())
    assert (w["live_pairs"], w["live_rows"], w["live_keys"]) == (pairs, rows, keys)
    win = 4 * b * ((start is not None) + (stop is not None))
    assert w["fwd_ops"] == 4 * pairs * h * d
    assert w["bwd_ops"] == 10 * pairs * h * d
    assert w["fwd_bytes"] == ((rows * h + 2 * keys * h_kv) * d * 2 + b * s * h * d * 2
                              + b * h * s * 4 + win)
    assert w["bwd_bytes"] == ((3 * rows * h + 2 * keys * h_kv) * d * 2
                              + (b * s * h + 2 * b * s * h_kv) * d * 2 + b * h * s * 4 + win)
    if name == "empty_row":
        # row 1's window [24, 24) and row 2's [5, 3) hold no key
        assert not mask[1:].any() and w["live_pairs"] == int(mask[0].sum())
