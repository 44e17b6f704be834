"""Overlapped all-gather matmul ("collective matmul", Wang et al. 2023), the
port's copy of the reference's `distributed/collective_matmul.py`, over a
torch `DeviceMesh` with point-to-point sends in place of `ppermute`.

The plain lowering of y = x @ W with W column-sharded and x row-sharded
all-gathers x, then multiplies. The ring form pipelines: each of the n
steps multiplies the x block a rank holds by its W block while the block
moves on to the next rank, so the transfer hides behind the product when
a step's product takes at least as long as a step's transfer. On the card
the transfer is issued on a side stream.
"""
from __future__ import annotations

import torch
import torch.distributed as dist


def ag_matmul(x, w, mesh, axis="model"):
    """y = x @ w with x row-sharded on mesh axis `axis` and w
    column-sharded on it.

    x: DTensor (M, K), `Shard(0)` on `axis`; w: DTensor (K, N), `Shard(1)`
    on `axis` (both replicated over any other mesh axis). Returns y: DTensor
    (M, N), `Shard(1)` on `axis`."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    dim = list(mesh.mesh_dim_names).index(axis)
    n = mesh.size(dim)
    idx = mesh.get_local_rank(axis)
    x_blk = x.to_local().contiguous()          # (M/n, K)
    w_blk = w.to_local()                       # (K, N/n)
    m_blk = x_blk.shape[0]
    out = torch.empty((m_blk * n, w_blk.shape[1]), dtype=x_blk.dtype,
                      device=x_blk.device)
    group = mesh.get_group(axis)
    ranks = dist.get_process_group_ranks(group)
    send_to, recv_from = ranks[(idx + 1) % n], ranks[(idx - 1) % n]
    on_card = x_blk.device.type == "cuda"
    side = torch.cuda.Stream(x_blk.device) if on_card and n > 1 else None
    cur = x_blk
    for i in range(n):
        reqs, nxt = [], None
        if i < n - 1:
            nxt = torch.empty_like(cur)
            ops = [dist.P2POp(dist.isend, cur, send_to, group),
                   dist.P2POp(dist.irecv, nxt, recv_from, group)]
            if side is not None:
                side.wait_stream(torch.cuda.current_stream(x_blk.device))
                with torch.cuda.stream(side):
                    reqs = dist.batch_isend_irecv(ops)
            else:
                reqs = dist.batch_isend_irecv(ops)
        src = (idx - i) % n                    # whose block this rank holds
        out[src * m_blk:(src + 1) * m_blk] = cur @ w_blk
        if nxt is not None:
            for r in reqs:
                r.wait()
            if side is not None:
                torch.cuda.current_stream(x_blk.device).wait_stream(side)
                cur.record_stream(side)
            cur = nxt
    placements = [Replicate()] * mesh.ndim
    placements[dim] = Shard(1)
    return DTensor.from_local(out, mesh, placements)
