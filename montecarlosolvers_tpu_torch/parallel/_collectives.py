"""The collectives of the sharded engines, on one mesh axis's process group.

  ring_halo  — the Trotter ring's halo (JAX `lax.ppermute` of a boundary
               row, parallel/trotter.py:90, :317, :327): both directions
               in one `batch_isend_irecv` to the ring neighbours;
  axis_sum   — the sum over an axis (JAX `lax.psum`): `all_reduce`;
  gather     — the blocks of an axis put back together (JAX
               `lax.all_gather(tiled=True)`): `all_gather`; `gather_spins`
               sends +/-1 values as int8;
  any_flag   — whether any rank raised a flag (JAX `lax.psum` of a bit,
               parallel/trotter.py:613, :782): `all_reduce` MAX of one
               int, read on the host, so that every rank runs the same
               number of rounds, and so of collectives;
  broadcast  — one rank's value on every rank (JAX `lax.psum` of a masked
               value, trotter.py:554-556): `broadcast`.

Under gloo a tensor on the card is staged through a pinned host buffer,
because gloo's send and receive take CPU tensors; under NCCL it goes from
device to device. The staging is chosen by the group's backend, never on a
failure. A group of one rank needs no message and no copy: the ring is
the rank itself, and the sum is the tensor.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def _staged(group, t):
    """True when `t` must go through host memory on `group` (gloo and a
    tensor on the card)."""
    return t.is_cuda and dist.get_backend(group) == "gloo"


def _host(t):
    """A pinned host copy of `t` (a card tensor under gloo)."""
    buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    buf.copy_(t)
    return buf


def ring_halo(last, first, group):
    """The Trotter ring's halo on `group`, whose ranks in group order form
    the ring: this rank sends `last` (its last row) to the next rank and
    `first` (its first row) to the previous one, in one batch_isend_irecv.
    Returns (from_prev, from_next): the previous rank's last row and the
    next rank's first row, on the device of `last`. On a group of one rank
    they are `last` and `first` themselves: the engines read the halo rows
    before anything writes the rows they were cut from."""
    n = dist.get_world_size(group)
    if n == 1:
        return last, first
    ranks = dist.get_process_group_ranks(group)
    me = dist.get_rank(group)
    prev, nxt = ranks[(me - 1) % n], ranks[(me + 1) % n]
    staged = _staged(group, last)
    if staged:
        torch.cuda.current_stream(last.device).synchronize()
    send_up = _host(last) if staged else last.contiguous()
    send_dn = _host(first) if staged else first.contiguous()
    from_prev = torch.empty_like(send_up)
    from_next = torch.empty_like(send_dn)
    # with two ranks prev == next: the pair's two messages match in the
    # order they are posted, and the tags keep the directions apart
    ops = [dist.P2POp(dist.isend, send_up, nxt, group, tag=0),
           dist.P2POp(dist.isend, send_dn, prev, group, tag=1),
           dist.P2POp(dist.irecv, from_prev, prev, group, tag=0),
           dist.P2POp(dist.irecv, from_next, nxt, group, tag=1)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    if staged:
        return (from_prev.to(last.device, non_blocking=True),
                from_next.to(last.device, non_blocking=True))
    return from_prev, from_next


def axis_sum(t, group):
    """The sum of `t` over the ranks of `group` (all_reduce), on the device
    of `t`: a new tensor, or on a group of one rank `t` itself."""
    if dist.get_world_size(group) == 1:
        return t
    if _staged(group, t):
        torch.cuda.current_stream(t.device).synchronize()
        buf = _host(t)
        dist.all_reduce(buf, group=group)
        return buf.to(t.device, non_blocking=True)
    out = t.clone()
    dist.all_reduce(out, group=group)
    return out


def gather(t, group, dim):
    """The blocks `t` of the ranks of `group`, in group order, concatenated
    along `dim` (all_gather), on the device of `t`."""
    n = dist.get_world_size(group)
    if n == 1:
        return t.clone()
    staged = _staged(group, t)
    if staged:
        torch.cuda.current_stream(t.device).synchronize()
    src = _host(t) if staged else t.contiguous()
    parts = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(parts, src, group=group)
    return torch.cat(parts, dim=dim).to(t.device)


def gather_spins(t, group, dim):
    """`gather` of +/-1 values (spins, or a state's +/-1 floats) sent as
    int8 and given back in t's dtype: the same values, a quarter of the
    bytes of float32 (and of what gloo stages through host memory)."""
    return gather(t.to(torch.int8), group, dim).to(t.dtype)


def any_flag(flag, group):
    """True when the one-element int tensor `flag` is nonzero on any rank
    of `group` (all_reduce MAX, read on the host: a sync with the device).
    Every rank must call it as often as every other, so a loop that ends
    on it makes the same calls on every rank."""
    if dist.get_world_size(group) == 1:
        return bool(flag.item())
    buf = flag.reshape(1).to(torch.int32)
    if _staged(group, buf):
        torch.cuda.current_stream(buf.device).synchronize()
        buf = _host(buf)
    elif buf is flag:
        buf = buf.clone()
    dist.all_reduce(buf, op=dist.ReduceOp.MAX, group=group)
    return bool(buf.item())


def broadcast(t, src, group):
    """The tensor `t` of group rank `src` on every rank of `group`, on the
    device of `t` (a new tensor; on a group of one rank `t` itself)."""
    if dist.get_world_size(group) == 1:
        return t
    staged = _staged(group, t)
    if staged:
        torch.cuda.current_stream(t.device).synchronize()
    buf = _host(t) if staged else t.clone()
    dist.broadcast(buf, src=dist.get_process_group_ranks(group)[src],
                   group=group)
    return buf.to(t.device, non_blocking=True) if staged else buf
