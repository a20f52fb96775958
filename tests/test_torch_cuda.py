"""The CUDA pair kernel against its plain version, on the card.

Marked `cuda`: it skips on a host without a card.  Whether a card is
present is decided inside the test, never at import (pytest-xdist
workers must all collect the same tests).  On the card:
    python -m pytest -q -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch


def _inputs(nb, blk, S, seed, device):
    rng = np.random.RandomState(seed)
    tgt = rng.randint(0, 2 ** 32, (nb, blk, 3), dtype=np.uint64
                      ).astype(np.uint32)
    src = rng.randint(0, 2 ** 32, (nb, S, 3), dtype=np.uint64
                      ).astype(np.uint32)
    src[:, : 2 * blk] = (np.resize(tgt, (nb, 2 * blk, 3)).astype(np.int64)
                         + rng.randint(-2 ** 22, 2 ** 22, (nb, 2 * blk, 3))
                         ).astype(np.uint32)
    sm = rng.uniform(0.5, 2.0, (nb, S)).astype(np.float32)
    sm[:, ::7] = 0.0

    def t(a):
        if a.dtype == np.uint32:
            a = a.view(np.int32)
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    return t(tgt), t(src), t(sm)


@pytest.mark.cuda
@pytest.mark.parametrize("blk", [1, 32, 128])
@pytest.mark.parametrize("want_pot", [False, True])
def test_p2p_kernel_matches_plain_version(blk, want_pot):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    from shenqi_tpu_torch.gravity.window import window_polynomials
    from shenqi_tpu_torch.ops.p2p import p2p_blocked, p2p_blocked_reference
    dev = torch.device("cuda")
    w = window_polynomials(1.5, device=dev)
    tgt, src, sm = _inputs(64, blk, 1024, blk, dev)
    args = (tgt, src, sm, 50000.0, 120.0, 50000.0 / 64, w, 43007.1)
    before = p2p_blocked.launches
    acc, pot = p2p_blocked(*args, want_pot=want_pot, blk=blk)
    torch.cuda.synchronize()
    assert p2p_blocked.launches == before + 1
    ref_acc, ref_pot = p2p_blocked_reference(*args, want_pot=want_pot,
                                             blk=blk)
    scale = ref_acc.abs().max()
    assert (acc - ref_acc).abs().max() < 2e-4 * scale
    if want_pot:
        assert (pot - ref_pot).abs().max() < 2e-4 * ref_pot.abs().max()
