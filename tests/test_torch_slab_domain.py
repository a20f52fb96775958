"""The port's slab domain layer (shenqi_tpu_torch/parallel/domain.py)
on 2 and 4 gloo ranks, against numpy owner sets and the JAX package.

  * slab_index, balance_cuts and cuts_fp_from_planes against the JAX
    functions, bit-exact, on x at and above 2^31 (an arithmetic shift
    would put them on the wrong rank);
  * exchange: each rank's rows are exactly the IDs numpy assigns it, in
    the JAX order (its kept rows, then arrivals by source rank and
    source row); halo_exchange: the ghost IDs are exactly the alive rows
    of other slabs within the width, none twice (D = 2 takes _halo_a2a,
    D = 4 the two-hop ring, cost-balanced cuts _halo_a2a, and the ring
    agrees with _halo_a2a); route_rows / route_back return each shipped
    row's result to its sender.

The ranks are spawned once per module (`spawn_ranks`, which the other
multi-rank files import): rank bodies live at module level, import
nothing of JAX, and hand their arrays back through .npz files.
"""

import numpy as np
import pytest
import torch

N = 3000
WIDTH = 0.28            # halo width as a share of the box


class SpawnCache(dict):
    """Module-fixture results computed on first use, so a worker that
    gets one parametrized case spawns only for that case."""

    def __init__(self, tmp, make):
        super().__init__()
        self.tmp, self.make = tmp, make

    def __missing__(self, key):
        args = key if isinstance(key, tuple) else (key,)
        self[key] = self.make(self.tmp / "_".join(map(str, args)), *args)
        return self[key]


def spawn_ranks(body, ndev, tmp, *args):
    """Run body(rank, device, out_dir, *args) on `ndev` gloo ranks (each
    collective bounded at 60 s, the whole spawn at 300 s); returns each
    rank's rank<r>.npz as a dict."""
    from shenqi_tpu_torch.parallel.launch import run_ranks
    tmp.mkdir(parents=True, exist_ok=True)
    run_ranks(body, ndev, (str(tmp),) + args, "cpu", str(tmp / "store"),
              60.0, 300.0)
    return [dict(np.load(tmp / f"rank{r}.npz")) for r in range(ndev)]


def _state():
    rng = np.random.RandomState(7)
    ipos = rng.randint(0, 2 ** 32, (N, 3), dtype=np.uint64).astype(np.uint32)
    ipos[:300, 0] = (2 ** 31 + rng.randint(0, 2 ** 31, 300)).astype(np.uint32)
    ipos[300:310, 0] = 2 ** 31
    ipos[310:320, 0] = 2 ** 32 - 1
    mass = rng.uniform(0.5, 2.0, N).astype(np.float32)
    mass[::13] = 0.0
    return ipos, mass, np.arange(N, dtype=np.int64)


def _cuts(ipos, ndev):
    from shenqi_tpu_torch.parallel.domain import (balance_cuts,
                                                  cuts_fp_from_planes)
    cols = (ipos[:, 0].astype(np.uint64) * np.uint64(4096)
            >> np.uint64(32)).astype(np.int64)
    return cuts_fp_from_planes(
        balance_cuts(np.bincount(cols, minlength=4096), ndev), 4096)


def _domain_body(rank, dev, out, ndev):
    """Uniform slabs (keys u_*), and with D = 4 cost-balanced ones too
    (b_*), in one spawn."""
    from shenqi_tpu_torch.parallel.domain import (
        _halo_a2a, exchange, halo_exchange, route_back, route_rows)
    ipos, mass, pid = _state()
    res = {}
    for tag in ("u", "b") if ndev == 4 else ("u",):
        cuts = _cuts(ipos, ndev) if tag == "b" else None
        loc = {"ipos": torch.from_numpy(ipos[rank::ndev].view(np.int32)),
               "mass": torch.from_numpy(mass[rank::ndev]),
               "pid": torch.from_numpy(pid[rank::ndev])}
        new, info = exchange(loc, ndev, cuts)
        width = int(WIDTH * 2 ** 32)
        dest = new["pid"] % ndev
        recv, state = route_rows({"pid": new["pid"]}, dest,
                                 torch.ones_like(dest, dtype=torch.bool),
                                 ndev)
        for k, v in (("pid", new["pid"]), ("ipos", new["ipos"]),
                     ("ghosts", halo_exchange(new, width, ndev,
                                              cuts)["pid"]),
                     ("a2a", _halo_a2a(new, width, ndev, cuts)["pid"]),
                     ("back", route_back(recv["pid"] * 2, state))):
            res[f"{tag}_{k}"] = v.numpy()
        res[f"{tag}_n_total"] = info["n_total"]
    np.savez(f"{out}/rank{rank}.npz", **res)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return SpawnCache(tmp_path_factory.mktemp("domain"),
                      lambda tmp, d: spawn_ranks(_domain_body, d, tmp, d))


def _owner(x, ndev, cuts):
    if cuts is not None:
        return np.searchsorted(cuts, x, side="right")
    return (x.astype(np.int64) >> (32 - int(np.log2(ndev)))) \
        if ndev > 1 else np.zeros(len(x), np.int64)


def test_slab_index_and_cuts_match_jax():
    """The owner of every x, the balanced cuts and their fixed-point
    boundaries equal the JAX package's bit for bit, x >= 2^31 included."""
    import jax.numpy as jnp
    from shenqi_tpu.parallel import domain as jd
    from shenqi_tpu_torch.parallel import domain as td
    ipos, _, _ = _state()
    x = ipos[:, 0]
    assert (x >= 2 ** 31).sum() > 300
    tx = torch.from_numpy(x.view(np.int32))
    for ndev in (1, 2, 4, 8):
        want = np.asarray(jd.slab_index(jnp.asarray(x), ndev))
        np.testing.assert_array_equal(td.slab_index(tx, ndev).numpy(), want)
        np.testing.assert_array_equal(want, _owner(x, ndev, None))
        cols = (x.astype(np.uint64) * np.uint64(4096)
                >> np.uint64(32)).astype(np.int64)
        hist = np.bincount(cols, minlength=4096)
        cp = td.balance_cuts(hist, ndev)
        np.testing.assert_array_equal(cp, jd.balance_cuts(hist, ndev))
        cf = td.cuts_fp_from_planes(cp, 4096)
        np.testing.assert_array_equal(cf, jd.cuts_fp_from_planes(cp, 4096))
        assert cf.dtype == np.uint32
        np.testing.assert_array_equal(
            td.slab_index(tx, ndev, cf).numpy(),
            np.asarray(jd.slab_index(jnp.asarray(x), ndev,
                                     jnp.asarray(cf))))
        for me in range(ndev):
            assert td.slab_lo(me, ndev) == int(
                jd.slab_lo(jnp.int32(me), ndev))


@pytest.mark.parametrize("ndev,balanced", [(2, False), (4, False),
                                           (4, True)])
def test_exchange_halo_route(ranks, ndev, balanced):
    """Rows, ghosts and routed results of every rank against the numpy
    owner sets, bit-exact by ID."""
    ipos, mass, pid = _state()
    cuts = _cuts(ipos, ndev) if balanced else None
    own = _owner(ipos[:, 0], ndev, cuts)
    width = int(WIDTH * 2 ** 32)
    tag = "b" if balanced else "u"
    for r, full in enumerate(ranks[ndev]):
        res = {k[2:]: v for k, v in full.items()
               if k.startswith(tag + "_")}
        # the JAX order: kept rows, then arrivals by (source, source row)
        want = np.concatenate([pid[s::ndev][own[s::ndev] == r]
                               for s in [r] + [s for s in range(ndev)
                                               if s != r]])
        np.testing.assert_array_equal(res["pid"], want)
        np.testing.assert_array_equal(res["ipos"].view(np.uint32),
                                      ipos[want])
        assert int(res["n_total"]) == N
        # ghosts: the alive rows of other slabs within the width of
        # this slab's interval, each once
        if cuts is None:
            lo = r << (32 - int(np.log2(ndev)))
            size = 2 ** 32 // ndev
        else:
            b = [0] + [int(c) for c in cuts] + [2 ** 32]
            lo, size = b[r], b[r + 1] - b[r]
        off = (ipos[:, 0].astype(np.int64) - lo) % 2 ** 32
        dist = np.where(off < size, 0,
                        np.minimum(2 ** 32 - off, off - (size - 1)))
        near = pid[(mass > 0) & (own != r) & (dist < width)]
        for got in (res["ghosts"], res["a2a"]):
            assert len(got) == len(set(got.tolist()))
            np.testing.assert_array_equal(np.sort(got), near)
        # route_back: twice the pid of each row shipped to pid % D
        shipped = (res["pid"] % ndev) != r
        np.testing.assert_array_equal(
            res["back"], np.where(shipped, 2 * res["pid"], 0))
    # the uniform D = 2 halo is wider than half a slab: _halo_a2a; D = 4
    # takes the ring with two hops
    from shenqi_tpu_torch.parallel.domain import _TWO32
    slab = _TWO32 // ndev
    ring = cuts is None and not 2 * width > (ndev - 1) * slab
    assert ring == (ndev == 4 and not balanced)
    if ring:
        assert int(np.ceil(width / slab)) == 2
