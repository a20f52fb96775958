"""The JAX package's shard_map collectives as torch.distributed calls.

The JAX slab layer (shenqi_tpu/parallel/) runs one program over a
1-D device mesh axis 'dp'; here each rank is a process of its own, one
per card (NCCL) or per CPU worker (gloo), and this module is the one
place the mapping lives:

  jax.lax.all_to_all of [D, K] buckets -> all_to_all_single with the
      per-rank row counts exchanged first and exact split sizes, so no
      bucket capacity (kcap, gcap) exists and nothing can overflow
  ppermute ring                        -> batch_isend_irecv (ring_shift)
  psum / pmin / pmax                   -> all_reduce (all_sum, all_min,
                                          all_max)
  all_gather                           -> all_gather (all_gather_rows)

Rows of several fields travel together as one int32 matrix
(pack_rows / unpack_rows), so an exchange is one collective whatever
the number of fields.  Complex tensors go as view_as_real views.

With no process group every call is the identity, so the slab code
runs unchanged in one process.  In a group of one the reductions and
gathers still go through the backend (a --mesh 1 run exercises NCCL),
while the all_to_all exchanges and the ring have nothing to move: a rank
never sends to itself.  `COUNTS` tallies collectives and the rows each call site
shipped to other ranks, for the per-step records of the slab run.
"""

from __future__ import annotations

import collections
import datetime
import math

import torch
import torch.distributed as dist

# per-call-site tallies: "<tag>_rows" (rows shipped to other ranks),
# "<tag>_calls", "all_reduce"
COUNTS: collections.Counter = collections.Counter()


def init(store_path: str, rank: int, world: int, device: torch.device,
         timeout_s: float):
    """Join the process group of `world` ranks through a FileStore at
    `store_path`: NCCL on a card (rank r on cuda:r), gloo on the CPU.  A
    collective that some rank never joins raises after `timeout_s`."""
    backend = "nccl" if device.type == "cuda" else "gloo"
    if device.type == "cuda":
        torch.cuda.set_device(device)
    store = dist.FileStore(store_path, world)
    dist.init_process_group(
        backend, store=store, rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=timeout_s))
    return backend


def finalize():
    if dist.is_initialized():
        dist.destroy_process_group()


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def backend() -> str:
    return dist.get_backend() if dist.is_initialized() else "none"


def barrier():
    if dist.is_initialized():
        dist.barrier()


# ---------------------------------------------------------- reductions

def _reduce(t: torch.Tensor, op) -> torch.Tensor:
    if not dist.is_initialized():
        return t
    out = t.clone()
    dist.all_reduce(out, op=op)
    COUNTS["all_reduce"] += 1
    return out


def all_sum(t: torch.Tensor) -> torch.Tensor:
    """psum: the elementwise sum over ranks (a new tensor)."""
    return _reduce(t, dist.ReduceOp.SUM)


def all_min(t: torch.Tensor) -> torch.Tensor:
    """pmin."""
    return _reduce(t, dist.ReduceOp.MIN)


def all_max(t: torch.Tensor) -> torch.Tensor:
    """pmax."""
    return _reduce(t, dist.ReduceOp.MAX)


def sum_int(v: int, device) -> int:
    """A host integer summed over ranks (every rank gets the same)."""
    if not dist.is_initialized():
        return int(v)
    return int(all_sum(torch.tensor([int(v)], dtype=torch.int64,
                                    device=device)).item())


def broadcast_int(v: int, device, src: int = 0) -> int:
    """Rank `src`'s host integer on every rank."""
    if not dist.is_initialized():
        return int(v)
    t = torch.tensor([int(v)], dtype=torch.int64, device=device)
    dist.broadcast(t, src)
    return int(t.item())


# ------------------------------------------------------------ row packs

def pack_rows(fields: dict):
    """dict of [n, ...] tensors -> ([n, W] int32 matrix, spec).  4-byte
    dtypes are bit views; 8-byte ones two columns; smaller ones widen."""
    cols, spec = [], []
    for name, t in fields.items():
        # the row width spelt out: a pack of no rows has no -1 to infer
        flat = t.reshape(t.shape[0], math.prod(t.shape[1:])).contiguous()
        size = flat.element_size()
        if size == 4:
            c = flat.view(torch.int32)
        elif size == 8:
            # fresh strides: a one-row slice counts as contiguous with any
            c = flat.clone(memory_format=torch.contiguous_format).view(
                torch.int32)                    # [n, 2w]
        else:
            c = flat.to(torch.int32)
        spec.append((name, t.dtype, tuple(t.shape[1:]), c.shape[1]))
        cols.append(c)
    return torch.cat(cols, dim=1) if cols else None, spec


def unpack_rows(mat: torch.Tensor, spec) -> dict:
    out = {}
    c0 = 0
    for name, dtype, tail, w in spec:
        c = mat[:, c0:c0 + w].clone(memory_format=torch.contiguous_format)
        c0 += w
        size = torch.empty((), dtype=dtype).element_size()
        if size in (4, 8):
            t = c.view(dtype)
        else:
            t = c.to(dtype)
        out[name] = t.reshape((mat.shape[0],) + tail)
    return out


# -------------------------------------------------------------- all_to_all

def all_to_all_rows(x: torch.Tensor, send_counts, tag: str = "a2a"):
    """Rows of x, grouped by destination rank in rank order with
    send_counts[d] rows for rank d, -> (received rows grouped by source
    rank, recv_counts).  The counts go first (all_to_all_single of one
    int64 per rank), then the rows with exact split sizes.  Complex x
    travels as its view_as_real."""
    D = world_size()
    send_counts = [int(c) for c in send_counts]
    if D == 1:
        return x, send_counts
    me = rank()
    sc = torch.tensor(send_counts, dtype=torch.int64, device=x.device)
    rc = torch.empty_like(sc)
    dist.all_to_all_single(rc, sc)
    recv_counts = rc.tolist()
    cplx = x.is_complex()
    xs = torch.view_as_real(x) if cplx else x
    out = torch.empty((sum(recv_counts),) + tuple(xs.shape[1:]),
                      dtype=xs.dtype, device=x.device)
    dist.all_to_all_single(out, xs.contiguous(),
                           output_split_sizes=recv_counts,
                           input_split_sizes=send_counts)
    COUNTS[tag + "_calls"] += 1
    COUNTS[tag + "_rows"] += sum(send_counts) - send_counts[me]
    return (torch.view_as_complex(out) if cplx else out), recv_counts


def all_to_all_equal(x: torch.Tensor, tag: str = "pfft"):
    """jax.lax.all_to_all of a [D, ...] tensor: block d goes to rank d,
    the result's block s came from rank s (the pencil-FFT transpose)."""
    D = world_size()
    if D == 1:
        return x
    cplx = x.is_complex()
    xs = (torch.view_as_real(x) if cplx else x).contiguous()
    out = torch.empty_like(xs)
    dist.all_to_all_single(out, xs)
    COUNTS[tag + "_calls"] += 1
    return torch.view_as_complex(out) if cplx else out


# ------------------------------------------------------------------ ring

def ring_shift(x: torch.Tensor, shift: int, same_shape: bool = False,
               tag: str = "ring"):
    """ppermute (i -> i + shift): send x to rank (me + shift) % D and
    return what rank (me - shift) % D sent.  Row counts may differ per
    rank unless same_shape; then they go first.  At D = 2 both
    neighbours are one rank, which the batched pair handles; with one
    rank there is no ring (the callers never ask for it)."""
    D = world_size()
    if D == 1:
        raise ValueError("ring_shift needs more than one rank: a rank "
                         "never sends to itself")
    me = rank()
    dst, src = (me + shift) % D, (me - shift) % D
    cplx = x.is_complex()
    xs = (torch.view_as_real(x) if cplx else x).contiguous()
    if same_shape:
        rows = xs.shape[0]
    else:
        n_out = torch.tensor([xs.shape[0]], dtype=torch.int64,
                             device=x.device)
        n_in = torch.empty_like(n_out)
        for w in dist.batch_isend_irecv([
                dist.P2POp(dist.isend, n_out, dst),
                dist.P2POp(dist.irecv, n_in, src)]):
            w.wait()
        rows = int(n_in.item())
    out = torch.empty((rows,) + tuple(xs.shape[1:]), dtype=xs.dtype,
                      device=x.device)
    ops = []
    if xs.numel():
        ops.append(dist.P2POp(dist.isend, xs, dst))
    if out.numel():
        ops.append(dist.P2POp(dist.irecv, out, src))
    if ops:
        for w in dist.batch_isend_irecv(ops):
            w.wait()
    COUNTS[tag + "_calls"] += 1
    COUNTS[tag + "_rows"] += xs.shape[0]
    return torch.view_as_complex(out) if cplx else out


# ---------------------------------------------------------------- gather

def all_gather_rows(x: torch.Tensor):
    """all_gather of a [n_r, ...] tensor whose n_r differ per rank:
    every rank gets the rows of all ranks, in rank order, and the
    counts."""
    if not dist.is_initialized():
        return x, [x.shape[0]]
    D = world_size()
    n = torch.tensor([x.shape[0]], dtype=torch.int64, device=x.device)
    ns = [torch.empty_like(n) for _ in range(D)]
    dist.all_gather(ns, n)
    counts = [int(c.item()) for c in ns]
    m = max(counts)
    pad = torch.zeros((m,) + tuple(x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    pad[:x.shape[0]] = x
    outs = [torch.empty_like(pad) for _ in range(D)]
    dist.all_gather(outs, pad)
    COUNTS["all_gather_calls"] += 1
    return torch.cat([o[:c] for o, c in zip(outs, counts)]), counts


def all_gather_object(obj):
    """Every rank's picklable object, in rank order."""
    if not dist.is_initialized():
        return [obj]
    out = [None] * world_size()
    dist.all_gather_object(out, obj)
    return out

