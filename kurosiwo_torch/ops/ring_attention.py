"""Ring attention: context-parallel attention over the ranks of a process
group; counterpart of ``kurosiwo_tpu/ops/ring_attention.py``.

Each rank holds its (B, H, n, D) query shard and a rotating key/value block.
P steps of block attention merge their partial results exactly with a
running online-softmax carry; between steps the k/v block moves to the next
rank (``torch.distributed.batch_isend_irecv``, the ``jax.lax.ppermute`` of
the JAX ring), so after P steps every block is home again:

  * the flash branch, when the local shards take the flash route (at least
    1,024 tokens and a 128-multiple block, ``ops/attention._flash_route``;
    JAX's ``_flash_blocks`` without its TPU-backend test): each step runs
    B5's forward (``ops/flash_attention.flash_attention_fwd``, ``hw::flash_fwd``
    on the card) and the normalized blocks merge by logaddexp on their lse;
  * the dense branch otherwise: a block of f32 scores in plain torch, merged
    with the running max and sum. On a CUDA tensor there is no dense branch:
    every block launches B5 or the ring raises.

The backward is a second ring pass with JAX's residuals (q, k, v, out, lse).
The flash branch computes delta once from the global out and hands each
step B5's backward (``flash_attention_bwd`` -> ``hw::flash_dq``,
``hw::flash_dkv``) the global lse and delta; dk and dv rotate with their
block and arrive home after P steps. Residual memory is O(n) a rank:
autograd through the forward loop would keep every rotated block.

The per-step merge and gradient are functions shared by the distributed
loop (``ring_attention_p``, ``ring_attention``) and by
``ring_attention_shards``, which runs the same steps over P shards held by
one process, the rotation a list rotation, in the same order of sums: it is
bitwise the distributed ring. It is what JAX's ``scripts/hw_ring_flash.py``
mirrors, and what ``chip_smoke.py`` drives on one card; no user path calls
it. Its ``plain`` form runs the plain versions of B5's kernels on any
device, the ring's oracle on the card.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch
import torch.distributed as dist

from .attention import _flash_route
from .flash_attention import (flash_attention_bwd, flash_attention_bwd_plain, flash_attention_fwd,
                              flash_attention_fwd_plain, flash_delta)


class Blocks(NamedTuple):
    """How a ring step attends to one k/v block: ``fwd(q, k, v, scale) ->
    (out, lse)`` and ``bwd(q, k, v, do, lse, delta, scale) -> (dq, dk, dv)``
    (B5's wrappers, or their plain versions), or None for the dense block."""

    fwd: Callable | None
    bwd: Callable | None


FLASH = Blocks(flash_attention_fwd, flash_attention_bwd)
FLASH_PLAIN = Blocks(flash_attention_fwd_plain, flash_attention_bwd_plain)
DENSE = Blocks(None, None)


def ring_blocks(q: torch.Tensor, k: torch.Tensor, plain: bool = False) -> Blocks:
    """The branch of a ring over shards of these shapes: flash where the
    shards take the flash route, else dense; a CUDA tensor that does not
    take the route raises (the card's ring runs B5 only)."""
    if _flash_route(q.shape[-2], k.shape[-2]):
        return FLASH_PLAIN if plain else FLASH
    if q.device.type == "cuda" and not plain:
        raise ValueError(
            f"ring attention on the card runs B5's flash kernels, which take shards of at least "
            f"1,024 tokens with a 128-multiple block; got shards of {q.shape[-2]} queries and "
            f"{k.shape[-2]} keys")
    return DENSE


# -- one step, forward ---------------------------------------------------------

def forward_init(q: torch.Tensor, blocks: Blocks) -> tuple:
    """The online-softmax carry before the first block."""
    shape = q.shape[:-1] + (1,)
    acc = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    if blocks.fwd is not None:
        return acc, torch.full(shape, -1e30, dtype=torch.float32, device=q.device)
    return (acc, torch.full(shape, -1e30, dtype=torch.float32, device=q.device),
            torch.zeros(shape, dtype=torch.float32, device=q.device))


def forward_step(q, kb, vb, scale: float, carry: tuple, blocks: Blocks) -> tuple:
    """Merge the attention of ``q`` to one k/v block into ``carry``
    (JAX ``_ring_impl``'s step)."""
    if blocks.fwd is not None:
        acc, lse_run = carry
        o_blk, lse_blk = blocks.fwd(q, kb, vb, scale)
        lse_blk = lse_blk[..., None]
        lse_new = torch.logaddexp(lse_run, lse_blk)
        acc = acc * torch.exp(lse_run - lse_new) + o_blk.float() * torch.exp(lse_blk - lse_new)
        return acc, lse_new
    acc, m_run, l_run = carry
    s = torch.einsum("bhnd,bhmd->bhnm", q.float() * scale, kb.float())
    m_blk = s.amax(-1, keepdim=True)
    e = torch.exp(s - m_blk)
    l_blk = e.sum(-1, keepdim=True)
    o_blk = torch.einsum("bhnm,bhmd->bhnd", e, vb.float())
    m_new = torch.maximum(m_run, m_blk)
    a, b = torch.exp(m_run - m_new), torch.exp(m_blk - m_new)
    return acc * a + o_blk * b, m_new, l_run * a + l_blk * b


def forward_finish(q: torch.Tensor, carry: tuple, blocks: Blocks):
    """(out in q's dtype, lse (B, H, n, 1) f32) from the last carry."""
    if blocks.fwd is not None:
        acc, lse = carry
        return acc.to(q.dtype), lse
    acc, m_run, l_run = carry
    l_safe = torch.clamp_min(l_run, 1e-30)
    return (acc / l_safe).to(q.dtype), m_run + torch.log(l_safe)


# -- one step, backward --------------------------------------------------------

def backward_init(q, out, do, lse, blocks: Blocks) -> tuple:
    """(delta, lse) as the steps take them: (B, H, n) f32 for B5, with a
    trailing axis of 1 for the dense block."""
    if blocks.bwd is not None:
        return flash_delta(do, out), lse[..., 0].contiguous()
    return (do.float() * out.float()).sum(-1, keepdim=True), lse


def backward_step(q, kb, vb, do, lse, delta, scale: float, blocks: Blocks):
    """(dq, dk, dv) in f32 of ``q``'s attention to one k/v block, from the
    global lse and delta (JAX ``_ring_bwd_flash`` / ``_ring_bwd_dense``)."""
    if blocks.bwd is not None:
        dq, dk, dv = blocks.bwd(q, kb, vb, do, lse, delta, scale)
        return dq.float(), dk.float(), dv.float()
    qf = q.float() * scale
    kf, vf, dof = kb.float(), vb.float(), do.float()
    p = torch.exp(torch.einsum("bhnd,bhmd->bhnm", qf, kf) - lse)
    dv = torch.einsum("bhnm,bhnd->bhmd", p, dof)
    ds = p * (torch.einsum("bhnd,bhmd->bhnm", dof, vf) - delta)
    return (torch.einsum("bhnm,bhmd->bhnd", ds, kf) * scale,
            torch.einsum("bhnm,bhnd->bhmd", ds, qf), dv)


# -- the distributed ring --------------------------------------------------------

def _rotate(tensors: list[torch.Tensor], group) -> list[torch.Tensor]:
    """Each tensor sent to the next rank of ``group``, the previous rank's
    received in its place. Gloo's send and receive take CPU tensors only, so
    a CUDA tensor goes through the host there."""
    p, r = dist.get_world_size(group), dist.get_rank(group)
    nxt, prv = dist.get_global_rank(group, (r + 1) % p), dist.get_global_rank(group, (r - 1) % p)
    host = dist.get_backend(group) == "gloo"
    sends = [t.contiguous().cpu() if host else t.contiguous() for t in tensors]
    recvs = [torch.empty_like(t) for t in sends]
    ops = [dist.P2POp(dist.isend, t, nxt, group) for t in sends] + \
          [dist.P2POp(dist.irecv, t, prv, group) for t in recvs]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return [t.to(s.device) for t, s in zip(recvs, tensors)]


# the ring of this process alone: a ``group`` for a run with no process group
SOLO = "solo"


def _ring_size(group) -> int:
    return 1 if group is SOLO else dist.get_world_size(group)


class _RingP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, group, scale, blocks):
        p = _ring_size(group)
        carry = forward_init(q, blocks)
        kb, vb = k, v
        for i in range(p):
            carry = forward_step(q, kb, vb, scale, carry, blocks)
            if i < p - 1:
                kb, vb = _rotate([kb, vb], group)
        out, lse = forward_finish(q, carry, blocks)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.group, ctx.scale, ctx.blocks = group, scale, blocks
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        group, scale, blocks = ctx.group, ctx.scale, ctx.blocks
        p = _ring_size(group)
        do = do.contiguous()
        delta, lse_b = backward_init(q, out, do, lse, blocks)
        dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        dk = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
        dv = torch.zeros(v.shape, dtype=torch.float32, device=v.device)
        kb, vb = k, v
        for i in range(p):
            dq_i, dk_i, dv_i = backward_step(q, kb, vb, do, lse_b, delta, scale, blocks)
            dq, dk, dv = dq + dq_i, dk + dk_i, dv + dv_i
            if p > 1:
                # dk and dv travel with their block: after p moves they are home
                moved = [dk, dv] if i == p - 1 else [dk, dv, kb, vb]
                moved = _rotate(moved, group)
                dk, dv = moved[:2]
                if i < p - 1:
                    kb, vb = moved[2:]
        return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None, None


def ring_attention_p(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, group,
                     scale: float | None = None) -> torch.Tensor:
    """One rank's part of ring attention over ``group`` (``SOLO``: a ring of
    this process alone): q, k, v are its LOCAL (B, H, n, D) sequence shards, the
    shards of the ranks in group order making the sequence. Returns its
    (B, H, n, D) output shard; differentiable with O(n) residuals."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    return _RingP.apply(q, k, v, group, scale, ring_blocks(q, k))


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, plan,
                   axis: str = "model", scale: float | None = None) -> torch.Tensor:
    """Context-parallel attention: this rank's (B, H, N/P, D) shard of the
    sequence along ``plan``'s ``axis`` (its group's size P) -> its output
    shard; the counterpart of JAX's shard_map-wrapped ``ring_attention``,
    where each rank holds its shard rather than a sharded array."""
    group = plan.model_group if axis == plan.model_axis else plan.data_group
    return ring_attention_p(q, k, v, SOLO if group is None else group, scale)


# -- one process, P shards ------------------------------------------------------

class _RingShards(torch.autograd.Function):
    """The distributed ring's steps over P shards in one process: shard j
    plays rank j, and at step i it holds the k/v block of shard (j - i) mod
    P, as rank j does; each block's dk and dv sum its steps in the order the
    travelling accumulator on the ring sums them."""

    @staticmethod
    def forward(ctx, scale, blocks, p, *shards):
        qs, ks, vs = shards[:p], shards[p:2 * p], shards[2 * p:]
        outs, lses = [], []
        for j in range(p):
            carry = forward_init(qs[j], blocks)
            for i in range(p):
                src = (j - i) % p
                carry = forward_step(qs[j], ks[src], vs[src], scale, carry, blocks)
            out, lse = forward_finish(qs[j], carry, blocks)
            outs.append(out)
            lses.append(lse)
        ctx.save_for_backward(*qs, *ks, *vs, *outs, *lses)
        ctx.scale, ctx.blocks, ctx.p = scale, blocks, p
        return tuple(outs)

    @staticmethod
    def backward(ctx, *dos):
        p, scale, blocks = ctx.p, ctx.scale, ctx.blocks
        saved = ctx.saved_tensors
        qs, ks, vs, outs, lses = (saved[i * p:(i + 1) * p] for i in range(5))
        dos = [d.contiguous() for d in dos]
        stats = [backward_init(qs[j], outs[j], dos[j], lses[j], blocks) for j in range(p)]
        dq = [torch.zeros(q.shape, dtype=torch.float32, device=q.device) for q in qs]
        dk = [torch.zeros(k.shape, dtype=torch.float32, device=k.device) for k in ks]
        dv = [torch.zeros(v.shape, dtype=torch.float32, device=v.device) for v in vs]
        # step i: the block of shard s is at shard (s + i) mod p
        for i in range(p):
            for j in range(p):
                src = (j - i) % p
                delta, lse = stats[j]
                dq_i, dk_i, dv_i = backward_step(qs[j], ks[src], vs[src], dos[j], lse, delta,
                                                 scale, blocks)
                dq[j] = dq[j] + dq_i
                dk[src] = dk[src] + dk_i
                dv[src] = dv[src] + dv_i
        grads = ([g.to(q.dtype) for g, q in zip(dq, qs)] + [g.to(k.dtype) for g, k in zip(dk, ks)]
                 + [g.to(v.dtype) for g, v in zip(dv, vs)])
        return (None, None, None, *grads)


def ring_attention_shards(q_shards: list, k_shards: list, v_shards: list,
                          scale: float | None = None, plain: bool = False) -> list:
    """Ring attention over P (B, H, n, D) shards held by one process: the
    distributed ring's steps, in its order (see ``_RingShards``); returns
    the P output shards, differentiable. ``plain`` runs the plain versions
    of B5's kernels on any device (the card's oracle)."""
    p = len(q_shards)
    if not (p == len(k_shards) == len(v_shards)) or p == 0:
        raise ValueError("ring_attention_shards takes as many q, k and v shards, at least one")
    if scale is None:
        scale = q_shards[0].shape[-1] ** -0.5
    blocks = ring_blocks(q_shards[0], k_shards[0], plain=plain)
    return list(_RingShards.apply(scale, blocks, p, *q_shards, *k_shards, *v_shards))
