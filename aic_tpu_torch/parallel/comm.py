"""Collectives between the ranks of a mesh (`parallel/mesh.py`).

What XLA gave `aic_tpu/parallel` implicitly (`lax.ppermute`, `psum`, the
gather of a sharded array on fetch), made explicit over
`torch.distributed`, always called outside the kernels:

- `halo_exchange`: `aic_tpu/parallel/slab.py:151 _halo_ext`, the
  multi-hop exchange of X planes with the slab neighbours;
- `all_reduce`: `psum` (and a max, for the stop test of a sharded pass);
- `all_gather`: every rank's tensor, stacked along a new leading axis.

A mesh names its transport, and nothing here picks another:

- `"nccl"`: one rank per card, the tensors stay on the card;
- `"gloo"`: CPU tensors. A CUDA tensor is staged through host memory,
  explicitly: gloo has no send/recv and no all-gather for CUDA tensors.
- a mesh of one process and no group (`make_mesh()` outside `spawn`):
  every collective is the identity, the halo past both ends zeros.

Every call appends {"op", "bytes", "ms"} to `EXCHANGES`: the bytes this
rank hands to the transport (a halo's planes sent, a reduced or gathered
tensor), and the host-clock milliseconds of the call, staging included,
with the card synchronized before the clock starts and before it stops.
"""

from __future__ import annotations

import math
import time

import torch
import torch.distributed as dist

#: The exchanges of this process since the last `reset_exchanges`.
EXCHANGES: list[dict] = []


def reset_exchanges() -> None:
    EXCHANGES.clear()


def _sync(t: torch.Tensor) -> None:
    if t.device.type == "cuda":
        torch.cuda.synchronize(t.device)


def _record(op: str, nbytes: int, t0: float, t: torch.Tensor) -> None:
    _sync(t)
    EXCHANGES.append({"op": op, "bytes": int(nbytes), "ms": (time.perf_counter() - t0) * 1e3})


def _staged(mesh) -> bool:
    """Whether this mesh's tensors on its device go through host memory."""
    return mesh.transport == "gloo" and mesh.device.type != "cpu"


def halo_exchange(local: torch.Tensor, halo: int, mesh) -> torch.Tensor:
    """`local` [S, ...] (this rank's slab of S planes along X) extended by
    `halo` planes from each X neighbour: [S + 2·halo, ...]. A halo deeper
    than a slab takes ceil(halo / S) hops, each passing on what the last
    one brought, and the last hop carries only the planes still needed;
    past the chain's ends the planes are zeros. The result is the slice
    [hops·S − halo, hops·S + S + halo) of `aic_tpu`'s `_halo_ext`. Each
    hop is one `batch_isend_irecv` of both directions, so no pair of
    ranks waits on the other."""
    slab = local.shape[0]
    if halo <= 0:
        return local
    t0 = time.perf_counter()
    _sync(local)
    hops = max(1, math.ceil(halo / slab))
    tail = halo - (hops - 1) * slab  # planes taken from the farthest slab
    rank, world = mesh.rank, mesh.world
    stage = _staged(mesh)
    left, right = [], []
    cur_f = cur_b = local
    sent = 0
    for h in range(hops):
        last = h == hops - 1
        send_f = cur_f[slab - tail:] if last else cur_f  # travels to rank + 1
        send_b = cur_b[:tail] if last else cur_b  # travels to rank - 1
        if stage:
            send_f, send_b = send_f.cpu(), send_b.cpu()
        send_f, send_b = send_f.contiguous(), send_b.contiguous()
        recv_f, recv_b = torch.zeros_like(send_f), torch.zeros_like(send_b)
        ops = []
        if rank + 1 < world:
            ops += [dist.P2POp(dist.isend, send_f, rank + 1), dist.P2POp(dist.irecv, recv_b, rank + 1)]
            sent += send_f.numel() * send_f.element_size()
        if rank > 0:
            ops += [dist.P2POp(dist.isend, send_b, rank - 1), dist.P2POp(dist.irecv, recv_f, rank - 1)]
            sent += send_b.numel() * send_b.element_size()
        if ops:
            for work in dist.batch_isend_irecv(ops):
                work.wait()
        cur_f, cur_b = recv_f, recv_b
        left.insert(0, recv_f)
        right.append(recv_b)
    out = torch.cat(left + [local.cpu() if stage else local] + right, dim=0)
    out = out.to(local.device)
    _record("halo", sent, t0, out)
    return out


_REDUCE_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}


def all_reduce(t: torch.Tensor, mesh, op: str = "sum") -> torch.Tensor:
    """The elementwise sum (or max) of every rank's `t`, on every rank, as
    a new tensor on `t`'s device. The order of a float sum is the
    backend's."""
    if mesh.world == 1:
        return t
    t0 = time.perf_counter()
    _sync(t)
    buf = t.cpu() if _staged(mesh) else t.clone()
    dist.all_reduce(buf, op=_REDUCE_OPS[op])
    out = buf.to(t.device)
    _record(f"all_reduce {op}", t.numel() * t.element_size(), t0, out)
    return out


def all_gather(t: torch.Tensor, mesh) -> torch.Tensor:
    """Every rank's `t` (one shape on every rank), stacked in rank order
    along a new leading axis, on every rank, on `t`'s device."""
    if mesh.world == 1:
        return t[None]
    t0 = time.perf_counter()
    _sync(t)
    if _staged(mesh) or t.device.type == "cpu":
        host = t.cpu().contiguous()
        parts = [torch.empty_like(host) for _ in range(mesh.world)]
        dist.all_gather(parts, host)
        out = torch.stack(parts).to(t.device)
    else:
        out = torch.empty((mesh.world,) + tuple(t.shape), dtype=t.dtype, device=t.device)
        dist.all_gather_into_tensor(out, t.contiguous())
    _record("all_gather", t.numel() * t.element_size(), t0, out)
    return out
