"""The EP communicator (counterpart of the JAX package's parallel/comm.py).

The JAX package's strategies run inside a shard_map and reach their peers
through a mesh axis. Here the communicator is an explicit object, `EPGroup`:

  num_ranks, rank
  all_to_all(t)        tiled over dim 0: block i of the result is block
                       `rank` of rank i's t (jax.lax.all_to_all, tiled=True)
  ragged_all_to_all(operand, output, input_offsets, send_sizes,
                    output_offsets, recv_sizes)
                       the semantics of jax.lax.ragged_all_to_all: with S
                       slices per peer, slice j*S+s of my operand
                       (input_offsets / send_sizes) lands in peer j's output
                       at my output_offsets[j*S+s]; recv_sizes[i*S+s] is the
                       size of slice s arriving from rank i
  all_gather(t)        [R, *t.shape]: row i is rank i's t (jax.lax.all_gather)
  all_reduce_sum(t)    the sum of every rank's t (jax.lax.psum)

`EPGroup(None)` is one rank: a loopback of indexed copies on the tensors'
own device, with no host sync. Over a torch.distributed process group the
exchanges are `all_to_all_single` with split sizes, read on the host (the
port runs that form on the CPU with gloo; the card runs one rank).
"""

from __future__ import annotations

import math

import torch


def _rows_as_bytes(t):
    """[n, ...] -> a contiguous uint8 view [n, row bytes]: the exchanges move
    bytes, whatever the dtype."""
    row = math.prod(t.shape[1:]) * t.element_size()
    return t.contiguous().reshape(-1).view(torch.uint8).reshape(t.shape[0], row)


class EPGroup:
    """One rank's view of the expert-parallel group (module docstring)."""

    def __init__(self, process_group=None):
        self.process_group = process_group
        if process_group is None:
            self.num_ranks, self.rank = 1, 0
        else:
            import torch.distributed as dist
            self.num_ranks = dist.get_world_size(process_group)
            self.rank = dist.get_rank(process_group)

    def _exchange(self, send, send_splits, recv_splits):
        import torch.distributed as dist
        sb = _rows_as_bytes(send)
        recv = torch.empty((sum(recv_splits), sb.shape[1]), dtype=torch.uint8,
                           device=send.device)
        dist.all_to_all_single(recv, sb, recv_splits, send_splits,
                               group=self.process_group)
        return recv.view(send.dtype).reshape(-1, *send.shape[1:])

    def all_to_all(self, t):
        """Tiled all_to_all over dim 0 (t.shape[0] % num_ranks == 0)."""
        if self.num_ranks == 1:
            return t
        n = t.shape[0] // self.num_ranks
        return self._exchange(t, [n] * self.num_ranks, [n] * self.num_ranks)

    def all_gather(self, t):
        """[R, *t.shape]: row i is rank i's t. One rank: t[None], no copy
        and no host sync."""
        if self.num_ranks == 1:
            return t[None]
        import torch.distributed as dist
        parts = [torch.empty_like(t) for _ in range(self.num_ranks)]
        dist.all_gather(parts, t.contiguous(), group=self.process_group)
        return torch.stack(parts)

    def all_reduce_sum(self, t):
        """The sum over the ranks of t, a new tensor (one rank: t itself)."""
        if self.num_ranks == 1:
            return t
        import torch.distributed as dist
        out = t.clone()
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=self.process_group)
        return out

    def ragged_all_to_all(self, operand, output, input_offsets, send_sizes,
                          output_offsets, recv_sizes):
        """Module docstring. Returns a new tensor: `output` with the
        received slices written into it."""
        if self.num_ranks == 1:
            return _ragged_loopback(operand, output, input_offsets, send_sizes,
                                    output_offsets)
        r = self.num_ranks
        s = input_offsets.numel() // r
        in_off, sz = input_offsets.tolist(), send_sizes.tolist()
        rsz = recv_sizes.tolist()
        # where each peer puts its slices in my output
        their_out = self.all_to_all(output_offsets.reshape(r, s)).tolist()
        parts = [operand[in_off[i]:in_off[i] + sz[i]] for i in range(r * s)]
        send = torch.cat(parts) if parts else operand[:0]
        recv = self._exchange(send, [sum(sz[j * s:(j + 1) * s]) for j in range(r)],
                              [sum(rsz[i * s:(i + 1) * s]) for i in range(r)])
        out = output.clone()
        pos = 0
        for i in range(r):
            for sl in range(s):
                n, o = rsz[i * s + sl], their_out[i][sl]
                out[o:o + n] = recv[pos:pos + n]
                pos += n
        return out


def loopback_targets(rows: int, input_offsets, send_sizes, output_offsets, out_rows: int):
    """The output row of each of `rows` operand rows in a one-rank ragged
    all_to_all: output_offsets[s] + its place in slice s; out_rows for a
    row in no slice or aimed past the end (dropped). Slices must not
    overlap."""
    r = torch.arange(rows, device=input_offsets.device)
    rel = r[None, :] - input_offsets.long()[:, None]                     # [S, rows]
    inside = (rel >= 0) & (rel < send_sizes.long()[:, None])
    tgt = torch.where(inside, output_offsets.long()[:, None] + rel, out_rows)
    return tgt.amin(dim=0).clamp(max=out_rows)


def _ragged_loopback(operand, output, input_offsets, send_sizes, output_offsets):
    """ragged_all_to_all on one rank: indexed copies into `output` (plus a
    row for the dropped ones, cut off)."""
    out_rows = output.shape[0]
    tgt = loopback_targets(operand.shape[0], input_offsets, send_sizes, output_offsets,
                           out_rows)
    out = torch.cat([output, output.new_zeros((1, *output.shape[1:]))])
    out[tgt] = operand.to(out.dtype)
    return out[:out_rows]
