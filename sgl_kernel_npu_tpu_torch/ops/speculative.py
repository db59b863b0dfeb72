"""EAGLE speculative-decoding tree ops: build_tree_efficient, the tree mask's
bit packing and verify_tree_greedy (counterpart of the JAX package's
ops/speculative.py). Plain PyTorch, as the JAX functions are plain jnp: no
kernel.

Node convention: node 0 is the verified root; node i (1 .. dt - 1) is
selected_index[:, i - 1]. Its parent: ptb = selected_index[i - 1] // topk;
ptb == 0 is the root, else the node whose selected_index equals
parent_list[ptb], plus one. Every step is a [bs, dt] vector operation inside
small static loops (dt is a draft's token count), as in the JAX package.
"""

from __future__ import annotations

from enum import IntEnum

import torch


class TreeMaskMode(IntEnum):
    FULL_MASK = 0
    QLEN_ONLY = 1
    QLEN_ONLY_BITPACKING = 2


def _parents(parent_list, selected_index, topk: int, dt: int):
    """Parent node of nodes 1 .. dt - 1 ([bs, dt - 1]); dt marks none."""
    ptb = torch.div(selected_index, topk, rounding_mode="floor")
    parent_tok = torch.gather(parent_list, 1, ptb.clamp(0, parent_list.shape[1] - 1))
    eq = selected_index[:, None, :] == parent_tok[:, :, None]        # [bs, dt-1, dt-1]
    found = eq.any(dim=-1)
    pos = torch.argmax(eq.to(torch.int32), dim=-1) + 1                # the first match
    return torch.where(ptb == 0, 0, torch.where(found, pos, dt))


def build_tree_efficient(parent_list, selected_index, verified_seq_len, topk: int,
                         draft_token_num: int, tree_mask_mode: int = TreeMaskMode.QLEN_ONLY):
    """Returns (positions [bs * dt], retrive_index [bs, dt],
    retrive_next_token [bs, dt], retrive_next_sibling [bs, dt], tree_mask
    [bs, dt, dt] bool: the draft-vs-draft ancestor mask, or with
    QLEN_ONLY_BITPACKING its rows packed into int32 words), int32 ids."""
    dt = draft_token_num
    bs = selected_index.shape[0]
    dev = selected_index.device
    parent = _parents(parent_list.long(), selected_index.long(), topk, dt)
    par = torch.cat([torch.zeros((bs, 1), dtype=torch.long, device=dev), parent], dim=1)
    par_safe = par.clamp(0, dt - 1)
    node = torch.arange(dt, device=dev)

    # depth and the ancestor closure by pointer jumping (dt - 1 rounds)
    depth = torch.zeros((bs, dt), dtype=torch.long, device=dev)
    anc = torch.eye(dt, dtype=torch.bool, device=dev).expand(bs, dt, dt)
    valid_node = torch.cat([torch.ones((bs, 1), dtype=torch.bool, device=dev), parent < dt],
                           dim=1)
    for _ in range(dt - 1):
        parent_depth = torch.gather(depth, 1, par_safe)
        depth = torch.where((par > 0) | (node[None] > 0),
                            torch.clamp(parent_depth + 1, max=dt), depth)
        depth[:, 0] = 0
        parent_anc = torch.gather(anc, 1, par_safe[:, :, None].expand(bs, dt, dt))
        anc = anc | ((node[None, :, None] > 0) & parent_anc)

    positions = (verified_seq_len.long()[:, None] + depth).reshape(-1).to(torch.int32)
    retrive_index = (torch.arange(bs, device=dev)[:, None] * dt + node[None]).to(torch.int32)

    # children lists: walk the nodes downwards, each prepended to its parent's
    next_token = torch.full((bs, dt), -1, dtype=torch.long, device=dev)
    next_sibling = torch.full((bs, dt), -1, dtype=torch.long, device=dev)
    rows = torch.arange(bs, device=dev)
    for i in range(dt - 1, 0, -1):
        p = par[:, i]
        ok = (p < dt) & valid_node[:, i]
        p_safe = p.clamp(0, dt - 1)
        old_head = next_token[rows, p_safe]
        next_sibling[:, i] = torch.where(ok, old_head, next_sibling[:, i])
        next_token[rows, p_safe] = torch.where(ok, i, old_head)

    tree_mask = anc & valid_node[:, :, None] & valid_node[:, None, :]
    if tree_mask_mode == TreeMaskMode.QLEN_ONLY_BITPACKING:
        tree_mask = pack_tree_mask(tree_mask)
    return (positions, retrive_index, next_token.to(torch.int32),
            next_sibling.to(torch.int32), tree_mask)


def pack_tree_mask(tree_mask):
    """[..., dt] bool -> [..., ceil(dt / 32)] int32: bit j of word w is
    mask[..., w * 32 + j] (LSB first, the grammar bitmask's convention)."""
    dt = tree_mask.shape[-1]
    words = -(-dt // 32)
    m = torch.nn.functional.pad(tree_mask.long(), (0, words * 32 - dt))
    m = m.reshape(tree_mask.shape[:-1] + (words, 32))
    shifts = torch.arange(32, device=tree_mask.device)
    packed = (m << shifts).sum(dim=-1)                  # the uint32 value
    return torch.where(packed >= 2 ** 31, packed - 2 ** 32, packed).to(torch.int32)


def unpack_tree_mask(packed, dt: int):
    """Inverse of pack_tree_mask: [..., words] int32 -> [..., dt] bool."""
    words = packed.shape[-1]
    shifts = torch.arange(32, device=packed.device)
    bits = ((packed.long() & 0xFFFFFFFF)[..., :, None] >> shifts) & 1
    return bits.reshape(packed.shape[:-1] + (words * 32,))[..., :dt].bool()


def verify_tree_greedy(candidates, retrive_index, retrive_next_token, retrive_next_sibling,
                       target_predict):
    """Greedy tree verification. candidates [bs, dt] draft tokens; retrive_*
    [bs, dt]; target_predict [bs, dt], the target's argmax at each draft
    position. Returns (predicts [bs * dt], -1 where unset; accept_index
    [bs, dt], -1 padded; accept_token_num [bs]), int32."""
    bs, dt = candidates.shape
    dev = candidates.device
    cand, ridx = candidates.long(), retrive_index.long()
    ntok, nsib = retrive_next_token.long(), retrive_next_sibling.long()
    target = target_predict.long()
    rows = torch.arange(bs, device=dev)

    def at(a, i):
        return a[rows, i.clamp(0, dt - 1)]

    predicts = torch.full((bs, dt), -1, dtype=torch.long, device=dev)
    accept_index = torch.full((bs, dt), -1, dtype=torch.long, device=dev)
    accept_index[:, 0] = ridx[:, 0]
    last_local = torch.zeros(bs, dtype=torch.long, device=dev)   # node of the last accept
    num_accepted = torch.zeros(bs, dtype=torch.long, device=dev)
    cur = torch.zeros(bs, dtype=torch.long, device=dev)
    alive = torch.ones(bs, dtype=torch.bool, device=dev)
    for _ in range(1, dt):
        cur = torch.where(alive, at(ntok, cur), -1)
        found = torch.zeros(bs, dtype=torch.bool, device=dev)
        match_node = torch.full((bs,), -1, dtype=torch.long, device=dev)
        for _ in range(dt):                              # the sibling walk
            ok = alive & (cur != -1) & ~found
            hit = ok & (at(cand, cur) == at(target, last_local))
            match_node = torch.where(hit, cur, match_node)
            found = found | hit
            cur = torch.where(ok & ~hit, at(nsib, cur), cur)
        acc = alive & found
        mn = match_node.clamp(0, dt - 1)
        ll = last_local.clamp(0, dt - 1)
        predicts[rows, ll] = torch.where(acc, target[rows, ll], predicts[rows, ll])
        num_accepted = num_accepted + acc.long()
        accept_index[rows, num_accepted] = torch.where(acc, ridx[rows, mn],
                                                       accept_index[rows, num_accepted])
        last_local = torch.where(acc, mn, last_local)
        cur = torch.where(acc, mn, cur)
        alive = acc
    ll = last_local.clamp(0, dt - 1)
    predicts[rows, ll] = target[rows, ll]
    return (predicts.reshape(-1).to(torch.int32), accept_index.to(torch.int32),
            num_accepted.to(torch.int32))
