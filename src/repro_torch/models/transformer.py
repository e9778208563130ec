"""Decoder-only LM covering the five transformer architectures (port of
``repro/models/transformer.py``).

Features: GQA (grouped KV heads), RoPE, RMSNorm, SwiGLU FFN or MoE
(top-1 / top-2), sliding-window attention, Gemma-style local:global
layer interleave, Qwen-style qk-norm, stacked (L, ...) parameters with
per-layer remat, chunked (online-softmax) flash attention for long
sequences, and chunked cross-entropy so that the (B, S, V) logits never
exist at once.

Entry points:
  init_params / ``lm_loss``                       (train_4k)
  prefill     -> (last-token logits, KV cache)    (prefill_32k)
  decode_step -> one token against a KV cache     (decode_32k, long_500k)

Parameters live in an :class:`LMParams` module under the reference's
names (``embed``, ``blocks.wq``, ``blocks.moe_w_gate``, ``ln_f``, ...;
``optim.adamw.named_leaves`` gives "blocks/wq"), float32, without
``requires_grad``: the training entry points turn it on. They are cast
to ``cfg.dtype`` at every use, as the reference casts them. The
reference's ``logical(...)`` sharding hints are left out: the port's
sharding is single-controller and ``launch.sharding.logical`` changes
no value. Under ``launch.sharding.use_mesh_rules`` the MoE layers take
``moe_ffn``'s mesh branch.

Remat: ``forward`` checkpoints each block and ``lm_loss`` each (B, C,
V) logits chunk with ``torch.utils.checkpoint`` (non-reentrant), saving
only their inputs, as the reference's ``jax.checkpoint`` with
``nothing_saveable`` does.

The decode cache is {"k", "v": (L, B, S_max, K, dh) in cfg.dtype,
"len": the filled length, a Python int}. ``decode_step`` writes the new
token's keys and values into the given tensors in place (the reference
updates them functionally, and jit's donation makes that in place) and
returns a new dict over the same tensors. At a full cache the reference
clamps its write to slot S - 1 and keeps every key valid; the port
raises ``ValueError``. ``prefill`` returns a cache exactly S long:
callers pad it.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.device import resolve_device
from repro_torch.kernels.cost import host_read, is_fake, worst_case
from repro_torch.models import moe as moe_lib
from repro_torch.models.flash_attention import flash_attention
from repro_torch.models.layers import dense_init, rms_norm, rope, silu

NEG = -1e30


@dataclasses.dataclass(frozen=True)
class LMConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_head: int
    d_ff: int
    vocab: int
    moe_experts: int = 0
    moe_top_k: int = 0
    capacity_factor: float = 1.25
    window: int = 0            # sliding-window size for local layers
    global_every: int = 0      # >0: layer l is global iff (l+1) % global_every == 0
    qk_norm: bool = False
    rope_theta: float = 1e4
    dtype: Any = torch.bfloat16
    remat: bool = True
    attn_chunk: int = 0        # 0 = dense attention
    loss_chunk: int = 0        # 0 = unchunked CE

    @property
    def is_moe(self) -> bool:
        return self.moe_experts > 0

    def layer_is_global(self) -> np.ndarray:
        if self.window == 0:
            return np.ones(self.n_layers, dtype=bool)
        if self.global_every == 0:
            return np.zeros(self.n_layers, dtype=bool)  # all windowed (SWA)
        return np.array([(l + 1) % self.global_every == 0
                         for l in range(self.n_layers)])

    def param_count(self) -> int:
        d, f, V = self.d_model, self.d_ff, self.vocab
        attn = d * (self.n_heads + 2 * self.n_kv_heads) * self.d_head \
            + self.n_heads * self.d_head * d
        if self.is_moe:
            ffn = 3 * d * f * self.moe_experts + d * self.moe_experts
        else:
            ffn = 3 * d * f
        per_layer = attn + ffn + 2 * d
        return V * d + self.n_layers * per_layer + d

    def active_param_count(self) -> int:
        if not self.is_moe:
            return self.param_count()
        d, f = self.d_model, self.d_ff
        dense = self.param_count() - 3 * d * f * self.moe_experts * self.n_layers
        return dense + 3 * d * f * max(self.moe_top_k, 1) * self.n_layers


# ----------------------------------------------------------------------
# params
# ----------------------------------------------------------------------
def _param(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


class LMParams(nn.Module):
    """The parameters of ``init_params``: ``embed`` (V, d), the stacked
    ``blocks.*`` (L, ...) and ``ln_f`` (d,), float32, drawn from
    ``generator`` (a new one seeded with 0 on ``device`` when None;
    ``device`` is ``cuda`` unless the caller passes ``device="cpu"``).
    The norms' scales start at zero (RMSNorm scales by 1 + scale)."""

    def __init__(self, cfg: LMConfig,
                 generator: torch.Generator | None = None, device=None):
        super().__init__()
        if generator is None:
            generator = torch.Generator(
                device=resolve_device(device)).manual_seed(0)
        gen = generator
        L, d, H, K, dh, f, V = (cfg.n_layers, cfg.d_model, cfg.n_heads,
                                cfg.n_kv_heads, cfg.d_head, cfg.d_ff,
                                cfg.vocab)

        def zeros(*shape):
            return _param(torch.zeros(shape, device=gen.device))

        def w(shape, scale=None):
            return _param(dense_init(gen, shape, scale))

        b = nn.Module()
        b.ln1, b.ln2 = zeros(L, d), zeros(L, d)
        b.wq = w((L, d, H, dh))
        b.wk = w((L, d, K, dh))
        b.wv = w((L, d, K, dh))
        b.wo = w((L, H, dh, d), scale=1.0 / math.sqrt(H * dh))
        if cfg.qk_norm:
            b.qnorm, b.knorm = zeros(L, dh), zeros(L, dh)
        if cfg.is_moe:
            E = cfg.moe_experts
            b.router = w((L, d, E))
            b.moe_w_gate = w((L, E, d, f))
            b.moe_w_up = w((L, E, d, f))
            b.moe_w_down = w((L, E, f, d), scale=1.0 / math.sqrt(f))
        else:
            b.w_gate = w((L, d, f))
            b.w_up = w((L, d, f))
            b.w_down = w((L, f, d), scale=1.0 / math.sqrt(f))
        self.embed = w((V, d), scale=0.02)
        self.blocks = b
        self.ln_f = zeros(d)


def init_params(cfg: LMConfig, generator: torch.Generator) -> LMParams:
    """The parameters on ``generator``'s device, drawn from it."""
    return LMParams(cfg, generator=generator)


def _layers(params: LMParams) -> list[dict]:
    """One {name: (...) view} dict a layer, from the stacked leaves
    (``unbind``: the backward stacks the layers' gradients once)."""
    stacks = {n: p.unbind(0) for n, p in params.blocks.named_parameters()}
    return [{n: s[l] for n, s in stacks.items()}
            for l in range(params.blocks.ln1.shape[0])]


# ----------------------------------------------------------------------
# attention
# ----------------------------------------------------------------------
def _project_qkv(cfg: LMConfig, lp: dict, h, positions):
    dt = cfg.dtype
    B, S, d = h.shape
    q = (h @ lp["wq"].to(dt).reshape(d, -1)).view(B, S, cfg.n_heads, -1)
    k = (h @ lp["wk"].to(dt).reshape(d, -1)).view(B, S, cfg.n_kv_heads, -1)
    v = (h @ lp["wv"].to(dt).reshape(d, -1)).view(B, S, cfg.n_kv_heads, -1)
    if cfg.qk_norm:
        q = rms_norm(q, lp["qnorm"])
        k = rms_norm(k, lp["knorm"])
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    return q, k, v


def _expand_kv(cfg: LMConfig, k):
    """(B, S, K, dh) -> (B, S, H, dh) by repeating each KV head."""
    return torch.repeat_interleave(k, cfg.n_heads // cfg.n_kv_heads, dim=2)


def _attn_mask(q_pos, k_pos, is_global: bool, window: int):
    causal = k_pos[None, :] <= q_pos[:, None]
    if window <= 0 or is_global:
        return causal
    return causal & (k_pos[None, :] > (q_pos[:, None] - window))


def dense_attention(cfg: LMConfig, q, k, v, q_pos, k_pos, is_global):
    k = _expand_kv(cfg, k)
    v = _expand_kv(cfg, v)
    scores = torch.einsum("bshk,bthk->bhst", q, k).to(torch.float32)
    scores = scores / math.sqrt(cfg.d_head)
    mask = _attn_mask(q_pos, k_pos, bool(is_global), cfg.window)
    scores = torch.where(mask[None, None], scores, NEG)
    w = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhst,bthk->bshk", w, v)


def chunked_attention(cfg: LMConfig, q, k, v, q_pos, k_pos, is_global):
    """Online-softmax attention over KV chunks of ``cfg.attn_chunk``
    (flash-style, no (S, S) scores), differentiated by autograd."""
    B, S, H, dh = q.shape
    C = cfg.attn_chunk
    if S % C:
        raise ValueError(f"sequence {S} is not a multiple of attn_chunk {C}")
    k = _expand_kv(cfg, k)
    v = _expand_kv(cfg, v)
    acc = torch.zeros((B, H, S, dh), dtype=torch.float32, device=q.device)
    m = torch.full((B, H, S), NEG, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, H, S), dtype=torch.float32, device=q.device)
    qT = q.transpose(1, 2).to(torch.float32)                 # (B, H, S, dh)
    for c in range(S // C):
        sl = slice(c * C, (c + 1) * C)
        kci = k[:, sl].to(torch.float32)                     # (B, C, H, dh)
        vci = v[:, sl].to(torch.float32)
        s = torch.einsum("bhsk,bthk->bhst", qT, kci) / math.sqrt(cfg.d_head)
        mask = _attn_mask(q_pos, k_pos[sl], bool(is_global), cfg.window)
        s = torch.where(mask[None, None], s, NEG)
        m_new = torch.maximum(m, s.amax(-1))
        corr = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + torch.einsum("bhst,bthk->bhsk", p, vci)
        m = m_new
    out = acc / torch.clamp(l[..., None], min=1e-30)
    return out.transpose(1, 2).to(q.dtype)


def _use_flash(cfg: LMConfig, S: int) -> bool:
    return cfg.attn_chunk > 0 and S > cfg.attn_chunk \
        and S % cfg.attn_chunk == 0


def _attend(cfg: LMConfig, q, k, v, positions, is_global):
    """Flash attention over the sequence when it is chunked, else dense
    (as the reference's ``attention`` and ``prefill`` choose)."""
    if _use_flash(cfg, q.shape[1]):
        return flash_attention(q, _expand_kv(cfg, k), _expand_kv(cfg, v),
                               float(is_global), cfg.window, cfg.attn_chunk)
    pos1d = positions[0]
    return dense_attention(cfg, q, k, v, pos1d, pos1d, is_global)


def _out_proj(cfg: LMConfig, lp: dict, o):
    B, S = o.shape[:2]
    return o.reshape(B, S, -1) @ lp["wo"].to(cfg.dtype).reshape(-1,
                                                                cfg.d_model)


def attention(cfg: LMConfig, lp: dict, h, positions, is_global):
    q, k, v = _project_qkv(cfg, lp, h, positions)
    return _out_proj(cfg, lp, _attend(cfg, q, k, v, positions, is_global))


# ----------------------------------------------------------------------
# blocks / forward
# ----------------------------------------------------------------------
def _ffn(cfg: LMConfig, lp: dict, h):
    B, S, d = h.shape
    if cfg.is_moe:
        y, aux = moe_lib.moe_ffn(
            h.reshape(B * S, d), lp["router"], lp["moe_w_gate"],
            lp["moe_w_up"], lp["moe_w_down"], cfg.moe_top_k,
            cfg.capacity_factor)
        return y.view(B, S, d), aux
    dt = cfg.dtype
    g = silu(h @ lp["w_gate"].to(dt))
    u = h @ lp["w_up"].to(dt)
    return (g * u) @ lp["w_down"].to(dt), 0.0


def _block(cfg: LMConfig, x, lp, is_global_l, positions):
    h = rms_norm(x, lp["ln1"])
    x = x + attention(cfg, lp, h, positions, is_global_l)
    h2 = rms_norm(x, lp["ln2"])
    y, aux = _ffn(cfg, lp, h2)
    return x + y, aux


def _block_flat(cfg, names, is_global_l, positions, x, *leaves):
    return _block(cfg, x, dict(zip(names, leaves)), is_global_l, positions)


def forward(cfg: LMConfig, params: LMParams, tokens):
    """tokens (B, S) -> (final hidden states (B, S, d), the summed aux
    load-balance loss: 0.0 for a dense model)."""
    dev = params.embed.device
    tokens = torch.as_tensor(tokens, device=dev)
    B, S = tokens.shape
    x = params.embed.to(cfg.dtype).index_select(
        0, tokens.reshape(-1)).view(B, S, cfg.d_model)
    positions = torch.arange(S, dtype=torch.int32, device=dev)[None].expand(
        B, S)
    is_global = cfg.layer_is_global()
    remat = cfg.remat and torch.is_grad_enabled()
    aux = 0.0
    for l, lp in enumerate(_layers(params)):
        names = list(lp)
        fn = functools.partial(_block_flat, cfg, names, bool(is_global[l]),
                               positions)
        if remat:
            x, a = checkpoint(fn, x, *lp.values(), use_reentrant=False,
                              preserve_rng_state=False)
        else:
            x, a = fn(x, *lp.values())
        aux = aux + a
    return rms_norm(x, params.ln_f), aux


def loss_chunk_of(cfg: LMConfig, S: int) -> int:
    """The cross-entropy chunk for a sequence of S; raises ValueError
    naming ``loss_chunk`` when it does not divide S (the reference
    asserts it, after its forward pass)."""
    C = cfg.loss_chunk if cfg.loss_chunk > 0 else S
    if S % C:
        raise ValueError(f"{cfg.name}: sequence length {S} is not a "
                         f"multiple of loss_chunk {C}")
    return C


def _chunk_nll(xi, ti, emb):
    """Summed negative log-likelihood of one (B, C) chunk over the tied
    embeddings: the (B, C, V) logits exist only here."""
    logits = (xi @ emb.T).to(torch.float32)
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, ti.long()[..., None])[..., 0]
    return (logz - gold).sum()


def lm_loss(cfg: LMConfig, params: LMParams, tokens, targets):
    """Chunked cross-entropy over tied embeddings, plus 0.01 x the aux
    loss; each chunk's logits are recomputed in the backward."""
    dev = params.embed.device
    tokens = torch.as_tensor(tokens, device=dev)
    targets = torch.as_tensor(targets, device=dev)
    B, S = tokens.shape
    C = loss_chunk_of(cfg, S)
    x, aux = forward(cfg, params, tokens)
    emb = params.embed.to(cfg.dtype)
    tot = torch.zeros((), dtype=torch.float32, device=dev)
    for c in range(S // C):
        xi, ti = x[:, c * C:(c + 1) * C], targets[:, c * C:(c + 1) * C]
        if torch.is_grad_enabled():
            part = checkpoint(_chunk_nll, xi, ti, emb, use_reentrant=False,
                              preserve_rng_state=False)
        else:
            part = _chunk_nll(xi, ti, emb)
        tot = tot + part
    return tot / (B * S) + 0.01 * aux


# ----------------------------------------------------------------------
# serving: prefill + decode
# ----------------------------------------------------------------------
def init_cache(cfg: LMConfig, batch: int, max_seq: int, device=None) -> dict:
    """An empty cache of ``max_seq`` slots on ``device`` (``cuda`` unless
    ``device="cpu"``)."""
    dev = resolve_device(device)
    shape = (cfg.n_layers, batch, max_seq, cfg.n_kv_heads, cfg.d_head)
    return {"k": torch.zeros(shape, dtype=cfg.dtype, device=dev),
            "v": torch.zeros(shape, dtype=cfg.dtype, device=dev),
            "len": 0}


def pad_cache(cache: dict, max_seq: int) -> dict:
    """``cache`` with its k and v zero-padded along the sequence to
    ``max_seq`` slots (new tensors), its len kept."""
    k = cache["k"]
    if max_seq < k.shape[2]:
        raise ValueError(f"max_seq {max_seq} is below the cache's "
                         f"{k.shape[2]} slots")
    out = {"len": cache["len"]}
    for name in ("k", "v"):
        t = cache[name]
        shape = t.shape[:2] + (max_seq,) + t.shape[3:]
        out[name] = torch.zeros(shape, dtype=t.dtype, device=t.device)
        out[name][:, :, :t.shape[2]] = t
    return out


def _embed_rows(cfg: LMConfig, params: LMParams, ids):
    """``embed.to(dtype)[ids]``, gathered before the cast (equal values,
    without casting the whole table)."""
    return params.embed.index_select(0, ids.reshape(-1)).to(
        cfg.dtype).view(*ids.shape, cfg.d_model)


@torch.no_grad()
def prefill(cfg: LMConfig, params: LMParams, tokens):
    """tokens (B, S) -> (last-token logits (B, V) float32, a cache of
    exactly S slots with len S)."""
    dev = params.embed.device
    tokens = torch.as_tensor(tokens, device=dev)
    B, S = tokens.shape
    x = _embed_rows(cfg, params, tokens)
    positions = torch.arange(S, dtype=torch.int32, device=dev)[None].expand(
        B, S)
    is_global = cfg.layer_is_global()
    shape = (cfg.n_layers, B, S, cfg.n_kv_heads, cfg.d_head)
    ks = torch.empty(shape, dtype=cfg.dtype, device=dev)
    vs = torch.empty(shape, dtype=cfg.dtype, device=dev)
    for l, lp in enumerate(_layers(params)):
        h = rms_norm(x, lp["ln1"])
        q, k, v = _project_qkv(cfg, lp, h, positions)
        ks[l], vs[l] = k, v
        o = _attend(cfg, q, k, v, positions, bool(is_global[l]))
        x = x + _out_proj(cfg, lp, o)
        del q, k, v, o
        y, _ = _ffn(cfg, lp, rms_norm(x, lp["ln2"]))
        x = x + y
    x = rms_norm(x, params.ln_f)
    logits = x[:, -1] @ params.embed.to(cfg.dtype).T
    return logits.to(torch.float32), {"k": ks, "v": vs, "len": S}


def _decode_attention(cfg: LMConfig, q, ck, cv, valid):
    """q (B, 1, H, dh) against the whole cache ck / cv (B, S, K, dh),
    a KV head at a time: each head's (B, S, dh) view of the cache is a
    strided batch of matrices, so no expanded copy of the cache is
    made. The scores are formed in cfg.dtype, then float32."""
    B, _, H, dh = q.shape
    K = cfg.n_kv_heads
    reps = H // K
    qh = q[:, 0]                                             # (B, H, dh)
    scores = torch.cat([torch.bmm(qh[:, j * reps:(j + 1) * reps],
                                  ck[:, :, j].transpose(1, 2))
                        for j in range(K)], dim=1).to(torch.float32)
    scores = scores / math.sqrt(cfg.d_head)
    scores = torch.where(valid[None, None], scores, NEG)     # (B, H, S)
    w = torch.softmax(scores, dim=-1).to(q.dtype)
    o = torch.cat([torch.bmm(w[:, j * reps:(j + 1) * reps], cv[:, :, j])
                   for j in range(K)], dim=1)                # (B, H, dh)
    return o[:, None]


@torch.no_grad()
def decode_step(cfg: LMConfig, params: LMParams, cache: dict, token):
    """One decode step. token (B,) ids -> (logits (B, V) float32, the
    cache with len + 1). The token's keys and values are written into
    ``cache``'s tensors in place; a full cache raises ValueError."""
    dev = params.embed.device
    token = torch.as_tensor(token, device=dev)
    B = token.shape[0]
    ck_all, cv_all = cache["k"], cache["v"]
    S = ck_all.shape[2]
    if is_fake(cache["len"]):
        # a fake cache (the dry run's) holds no length: the last slot,
        # every position attended
        worst_case("decode_step: the cache's len taken as S - 1")
        host_read("_local_scalar_dense")
        pos = S - 1
    else:
        pos = int(cache["len"])
    if pos >= S:
        raise ValueError(
            f"the cache is full: len {pos} of {S} slots; pad it before "
            f"decoding (the reference clamps its write to slot {S - 1})")
    x = _embed_rows(cfg, params, token[:, None])             # (B, 1, d)
    positions = torch.full((B, 1), pos, dtype=torch.int32, device=dev)
    k_pos = torch.arange(S, device=dev)
    causal = k_pos <= pos
    local = k_pos > pos - cfg.window
    is_global = cfg.layer_is_global()
    for l, lp in enumerate(_layers(params)):
        h = rms_norm(x, lp["ln1"])
        q, k_new, v_new = _project_qkv(cfg, lp, h, positions)
        ck, cv = ck_all[l], cv_all[l]
        ck[:, pos] = k_new[:, 0]
        cv[:, pos] = v_new[:, 0]
        valid = causal if cfg.window <= 0 or is_global[l] \
            else causal & local
        o = _decode_attention(cfg, q, ck, cv, valid)
        x = x + _out_proj(cfg, lp, o)
        y, _ = _ffn(cfg, lp, rms_norm(x, lp["ln2"]))
        x = x + y
    x = rms_norm(x, params.ln_f)
    logits = x[:, 0] @ params.embed.to(cfg.dtype).T
    return logits.to(torch.float32), {"k": ck_all, "v": cv_all,
                                      "len": pos + 1}
