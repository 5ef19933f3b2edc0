"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Skipped where torch sees no card; run them there with

    python -m pytest tests/test_torch_cuda.py -m cuda

The cases are chip_smoke.py's phase 3 at test size: counts, mins and maxs
bit-equal, sums within SUM_RTOL of the segment's sum of |x|.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import chip_smoke

pytestmark = pytest.mark.cuda


@pytest.fixture()
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: torch.cuda.is_available() is False")
    return torch.device("cuda")


@pytest.mark.parametrize("arm,G,B", [("single", 1, 1), ("shared", 16, 8), ("scatter", 512, 64)])
@pytest.mark.parametrize("need_minmax", [True, False])
@pytest.mark.parametrize("op", chip_smoke.OPS)
def test_direct_kernel_matches_plain(card, arm, G, B, need_minmax, op):
    rng = np.random.default_rng(len(op) + G)
    chip_smoke._direct_case(torch, rng, 30_011, G, B, 3, op, need_minmax, arm)


@pytest.mark.parametrize("arm,G,B", [("single", 1, 1), ("shared", 16, 8), ("scatter", 512, 64)])
@pytest.mark.parametrize("case", chip_smoke.LAYOUT_CASES, ids=lambda c: "-".join([c[0], c[1], *c[2]]))
@pytest.mark.parametrize("selective", [False, True])
def test_cached_kernel_matches_plain(card, arm, G, B, case, selective):
    rng = np.random.default_rng(G + selective)
    chip_smoke._cached_case(torch, rng, case, arm, selective, True, ">", G, B, n_series=20, per=1001)
