"""Model assembly (port of ``repro.models.model``): embedding, a stack of
pre-norm blocks, tied or untied unembedding, with the training loss and
dense-cache and paged-pool serve entry points, for all eleven reference
architectures.
Block kinds:

  attn   GQA self-attention, global or over a local window (+ MLP)
  cross  cross-attention to context embeddings (+ MLP)
  rglru  the RG-LRU recurrent block (+ MLP)
  mlstm / slstm  the xLSTM blocks (self-contained, no MLP)

The MLP is SwiGLU, GELU for the ``audio`` family (whisper), or, after an
``attn`` block of a ``moe`` family config, the top-k MoE block; where
``mlp_after`` is set, only the blocks it names have one. An
encoder-decoder config (whisper) runs a separate non-causal stack of
``("attn",)`` super-blocks over its frames (``params["encoder"]``) whose
normed output is the cross blocks' context; other cross configs
(llama-3.2-vision) take the context embeddings as given.

A config's ``block_pattern`` defines one super-block, repeated
``n_repeats`` times, and ``block_tail`` the blocks after them.
Parameters keep the reference's layout: every leaf under
``params["blocks"]`` (and ``params["encoder"]``) has a leading repeat
axis, ``params["tail"]`` none (that is what ``repro_torch.convert``
carries over), and the forward pass is a Python loop over that axis
where the reference scans. Caches and page pools are laid out the same
way and updated in place.

The paged serve path covers attention-only configs with global attention
and no context (:meth:`Model.supports_paged`), the MoE ones among them;
the others (recurrent, xLSTM, cross-attention and encoder-decoder
configs) serve through the dense caches of ``prefill`` /
``decode_step``, as in the reference.
"""
from __future__ import annotations

from typing import Any

import torch
import torch.utils.checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.core.engine import DevicePlan, ForestPlan, SparseForestPlan
from repro_torch.device import resolve_device
from repro_torch.models import attention as A
from repro_torch.models import blocks as B

Params = dict[str, Any]


def _index(tree, i):
    """Stacked entry ``i`` of every leaf (views; device plans sliced)."""
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    if isinstance(tree, (DevicePlan, ForestPlan, SparseForestPlan)):
        return tree.index(i)
    return tree[i]


def _repeats(tree, n: int) -> list:
    """The ``n`` entries of every stacked leaf, as ``n`` trees of views
    (one ``unbind`` a leaf, whose backward stacks the n gradients once;
    device plans sliced)."""
    if isinstance(tree, dict):
        per_key = {k: _repeats(v, n) for k, v in tree.items()}
        return [{k: v[i] for k, v in per_key.items()} for i in range(n)]
    if isinstance(tree, (DevicePlan, ForestPlan, SparseForestPlan)):
        return [tree.index(i) for i in range(n)]
    return list(tree.unbind(0))


def _stacked(draw, n: int):
    """The ``n`` trees of tensors that ``draw()`` makes, in turn, stacked
    along a new leading axis: each leaf is allocated once, on the device
    of the first tree's, and filled entry by entry, so no more than one
    drawn tree is held beside the stack (``torch.stack`` of all n would
    hold the model twice); one tree is its own stack, a view."""
    def alloc(t):
        if isinstance(t, dict):
            return {k: alloc(v) for k, v in t.items()}
        return t.unsqueeze(0) if n == 1 else t.new_empty((n,) + t.shape)

    def fill(dst, src, i):
        if isinstance(src, dict):
            for k, v in src.items():
                fill(dst[k], v, i)
        else:
            dst[i].copy_(src)
    first = draw()
    out = alloc(first)
    if n > 1:
        fill(out, first, 0)
        del first
        for i in range(1, n):
            fill(out, draw(), i)
    return out


KINDS = ("attn", "cross", "rglru", "mlstm", "slstm")


class Model:
    """Functional decoder: init / loss / prefill / decode_step and the paged
    serve entry points. Runs on ``cuda`` unless ``device="cpu"`` is
    passed."""

    def __init__(self, cfg: ModelConfig, device=None):
        unknown = set(cfg.block_pattern + cfg.block_tail) - set(KINDS)
        if unknown:
            raise ValueError(f"{cfg.name}: unknown block kinds "
                             f"{sorted(unknown)}")
        self.cfg = cfg
        self.pattern = cfg.block_pattern
        self.device = resolve_device(device)

    def _moe(self, kind: str) -> bool:
        """Whether the MLP after a block of ``kind`` is the MoE block."""
        return self.cfg.family == "moe" and kind == "attn"

    # ---- init --------------------------------------------------------------
    def _init_superblock(self, gen, pattern, cfg=None) -> Params:
        cfg = cfg or self.cfg
        p = {}
        for i, kind in enumerate(pattern):
            if kind in ("attn", "cross"):
                p[f"b{i}"] = A.init_attn(gen, cfg)
            elif kind == "rglru":
                p[f"b{i}"] = B.init_rglru(gen, cfg)
            elif kind == "mlstm":
                p[f"b{i}"] = B.init_mlstm(gen, cfg)
            else:
                p[f"b{i}"] = B.init_slstm(gen, cfg)
            if (kind in ("attn", "cross", "rglru") and cfg.d_ff
                    and (cfg.mlp_after is None or i in cfg.mlp_after)):
                p[f"m{i}"] = (B.init_moe(gen, cfg) if self._moe(kind)
                              else B.init_mlp(gen, cfg,
                                              gelu=cfg.family == "audio"))
        return p

    def init(self, seed: int = 0, on_device: bool = False) -> Params:
        """Random params from a ``torch.Generator`` seeded with ``seed``:
        on the CPU (the same weights on every device), moved to the
        model's device; or, with ``on_device``, on the model's device
        itself (other numbers than the CPU's; no host copy and no f32
        weight kept: each linear is drawn and quantized in turn, which is
        how a full-width model is made on the card). The stacked blocks
        are filled repeat by repeat (:func:`_stacked`): the peak is the
        model plus one super-block and its largest f32 draw."""
        cfg = self.cfg
        where = self.device if on_device else torch.device("cpu")
        gen = torch.Generator(device=where).manual_seed(seed)
        embed = (torch.randn((cfg.vocab, cfg.d_model), generator=gen,
                             device=where) * 0.02).to(cfg.dtype)
        blocks = _stacked(lambda: self._init_superblock(gen, self.pattern),
                          cfg.n_repeats)
        params: Params = {
            "embed": embed, "blocks": blocks,
            "final_norm": torch.ones((cfg.d_model,), dtype=torch.float32,
                                     device=where)}
        if not cfg.tie_embeddings:
            params["unembed"] = (torch.randn(
                (cfg.vocab, cfg.d_model), generator=gen, device=where)
                * 0.02).to(cfg.dtype)
        if cfg.block_tail:
            params["tail"] = self._init_superblock(gen, cfg.block_tail)
        if cfg.is_encdec:
            ecfg = cfg.replace(mlp_after=None)
            params["encoder"] = _stacked(
                lambda: self._init_superblock(gen, ("attn",), ecfg),
                cfg.encoder_layers)
            params["enc_norm"] = torch.ones((cfg.d_model,),
                                            dtype=torch.float32,
                                            device=where)
        return _to(params, self.device)

    # ---- serve-path plan warmup -------------------------------------------
    def precompile_plans(self, params: Params) -> dict:
        """Build every PTQ linear's ExecutionPlan ahead of serving (the
        offline half), warming the process plan cache. No-op unless the
        configured backend plans."""
        q = self.cfg.quant
        from repro_torch.core.backend import get_backend
        if q.mode != "ptq" or not get_backend(q).needs_plan:
            return {"layers": 0, "plans": 0, "built": 0}
        from repro_torch.core import plancache
        return plancache.precompile(params, q)

    def attach_device_plans(self, params: Params) -> Params:
        """Embed compiled device plans (stacked like the weights, on the
        weights' device) next to every PTQ weight: DevicePlans for
        ``engine_torch``, compact ForestPlans for ``engine_cuda``
        (SparseForestPlans from T = 16; DevicePlans where one column of a
        tile's table does not fit shared memory). No-op
        unless the backend executes from device plans."""
        q = self.cfg.quant
        from repro_torch.core.backend import get_backend
        b = get_backend(q)
        if q.mode != "ptq" or not (b.needs_plan and b.device_resident):
            return params
        from repro_torch.core import plancache
        return plancache.attach_device_plans(params, q)

    # ---- shared ------------------------------------------------------------
    def _tokens(self, tokens) -> torch.Tensor:
        return torch.as_tensor(tokens, device=self.device).to(torch.int64)

    def _embed_tokens(self, params, tokens):
        return params["embed"][self._tokens(tokens)].to(self.cfg.dtype)

    def _logits(self, params, x):
        x = A.rms_norm(x, params["final_norm"], self.cfg.norm_eps)
        table = params.get("unembed", params["embed"])
        return torch.matmul(x, table.to(x.dtype).T).to(torch.float32)

    def _run(self, bp, st, pattern, x, layer_fn):
        """One super-block: each block of ``pattern`` (``layer_fn(kind,
        bp, x, c)`` with its slice ``c`` of the state, or None) and its
        MLP, residuals added."""
        for i, kind in enumerate(pattern):
            c = None if st is None else st[f"c{i}"]
            x = x + layer_fn(kind, bp[f"b{i}"], x, c)
            if f"m{i}" in bp:
                mlp = B.apply_moe if self._moe(kind) else B.apply_mlp
                x = x + mlp(bp[f"m{i}"], x, self.cfg)
        return x

    def _blocks(self, params, x, state, layer_fn, remat: bool = False):
        """Run the stacked super-blocks, then the tail. ``layer_fn(kind,
        bp, x, c)`` applies one block with its slice ``c`` of ``state``
        (the caches or the page pool, laid out like the params), or with
        ``c = None`` where ``state`` is None (the loss: nothing written).
        With ``remat`` each stacked super-block runs under
        ``torch.utils.checkpoint`` (recomputed in the backward, as the
        reference's ``jax.checkpoint`` of its scan body; the tail is not)."""
        n = self.cfg.n_repeats
        body = _repeats(params["blocks"], n)
        for r in range(n):
            st = None if state is None else _index(state["body"], r)
            if remat:
                x = torch.utils.checkpoint.checkpoint(
                    self._run, body[r], st, self.pattern, x, layer_fn,
                    use_reentrant=False)
            else:
                x = self._run(body[r], st, self.pattern, x, layer_fn)
        if self.cfg.block_tail:
            x = self._run(params["tail"],
                          None if state is None else state["tail"],
                          self.cfg.block_tail, x, layer_fn)
        return x

    def _encode(self, params, frames):
        """The encoder: ``encoder_layers`` non-causal ``("attn",)``
        super-blocks (each with its MLP) over the frame embeddings at
        positions 0..n-1 (RoPE included), then ``enc_norm``."""
        cfg = self.cfg.replace(mlp_after=None)
        x = frames.to(cfg.dtype)
        b, n = x.shape[:2]
        pos = torch.arange(n, device=self.device).expand(b, n)

        def layer(kind, bp, x, c):
            return A.apply_attn(bp, x, cfg, positions=pos, causal=False,
                                window=cfg.local_window)[0]
        for bp in _repeats(params["encoder"], cfg.encoder_layers):
            x = self._run(bp, None, ("attn",), x, layer)
        return A.rms_norm(x, params["enc_norm"], cfg.norm_eps)

    def _context(self, params, batch):
        """The cross blocks' context: the encoder's output over
        ``batch["context"]`` (frame embeddings) for an encoder-decoder
        config, else ``batch["context"]`` cast to the working dtype; None
        for a config without one."""
        cfg = self.cfg
        if not (cfg.n_context_tokens or cfg.is_encdec):
            return None
        if "context" not in batch:
            raise ValueError(f"{cfg.name} attends to context embeddings: "
                             f"the batch needs 'context' (B, n, d_model)")
        ctx = torch.as_tensor(batch["context"], device=self.device)
        if cfg.is_encdec:
            return self._encode(params, ctx)
        return ctx.to(cfg.dtype)

    # ---- train -------------------------------------------------------------
    def loss(self, params: Params, batch: dict) -> torch.Tensor:
        """Mean next-token cross-entropy (f32 scalar) of ``batch["tokens"]``
        (B, S) against ``batch["labels"]`` (B, S) over every position: the
        forward without caches (every block, the tail, and for a config
        with cross blocks the context of ``batch["context"]``), then
        ``logsumexp(logits) - logits[label]``. The label's logit is
        gathered, the one term the reference's one-hot product picks.
        ``cfg.remat == "block"`` recomputes each stacked super-block in the
        backward; loss and gradients are the same either way."""
        tokens = self._tokens(batch["tokens"])
        labels = self._tokens(batch["labels"])
        b, s = tokens.shape
        context = self._context(params, batch)
        pos = torch.arange(s, device=self.device).expand(b, s)
        x = self._blocks(params, self._embed_tokens(params, tokens), None,
                         self._layer(pos, context=context),
                         remat=self.cfg.remat == "block")
        logits = self._logits(params, x)
        lse = torch.logsumexp(logits, -1)
        ll = logits.gather(-1, labels[..., None])[..., 0]
        return (lse - ll).mean()

    # ---- dense cache serve -------------------------------------------------
    def _state(self, one):
        """Zeros on the model's device shaped like ``one(kind)``'s leaves
        (on the meta device) for every block: a leading layer axis under
        ``body``, none under ``tail``."""
        def zeros(tree, lead):
            return {k: torch.zeros(lead + v.shape, dtype=v.dtype,
                                   device=self.device)
                    for k, v in tree.items()}
        out = {"body": {f"c{i}": zeros(one(kind), (self.cfg.n_repeats,))
                        for i, kind in enumerate(self.pattern)}}
        if self.cfg.block_tail:
            out["tail"] = {f"c{i}": zeros(one(kind), ())
                           for i, kind in enumerate(self.cfg.block_tail)}
        return out

    def init_cache(self, batch: int, max_len: int):
        """Dense caches for ``batch`` rows of ``max_len`` positions (capped
        at ``max_target_positions`` where the config has one): K/V (rolling
        over a local window), the cross blocks' context K/V
        (``n_context_tokens`` positions, working dtype), the recurrent
        blocks' states."""
        cfg = self.cfg
        if cfg.max_target_positions:
            max_len = min(max_len, cfg.max_target_positions)

        def one(kind):
            if kind == "attn":
                return A.init_attn_cache(cfg, batch, max_len,
                                         cfg.local_window, device="meta")
            if kind == "cross":
                return A.init_attn_cache(cfg, batch,
                                         cfg.n_context_tokens or 1,
                                         cross=True, device="meta")
            if kind == "rglru":
                return B.cache_rglru(cfg, batch, device="meta")
            if kind == "mlstm":
                return B.cache_mlstm(cfg, batch, device="meta")
            return B.cache_slstm(cfg, batch, device="meta")
        return self._state(one)

    def _layer(self, positions, step=None, context=None):
        """The dense-cache layer function of :meth:`_blocks`: prefill
        (cross blocks attend to ``context``), or the decode step writing
        position ``step`` (cross blocks read their caches)."""
        cfg = self.cfg
        prefill = step is None

        def layer(kind, bp, x, c):
            if kind == "attn":
                return A.apply_attn(bp, x, cfg, positions=positions,
                                    cache=c, step=step, prefill=prefill,
                                    window=cfg.local_window)[0]
            if kind == "cross":
                return A.apply_cross(bp, x, cfg, cache=c,
                                     context=context)[0]
            if kind == "rglru":
                return B.apply_rglru(bp, x, cfg, cache=c, prefill=prefill)[0]
            if kind == "mlstm":
                return B.apply_mlstm(bp, x, cfg, cache=c, prefill=prefill)[0]
            return B.apply_slstm(bp, x, cfg, cache=c, prefill=prefill)[0]
        return layer

    def prefill(self, params: Params, batch: dict, max_len: int):
        """Process the prompt (and the context, for a config with cross
        blocks: ``batch["context"]``) and fill fresh caches; returns
        (last-position logits (B, 1, V), caches)."""
        tokens = self._tokens(batch["tokens"])
        b, s = tokens.shape
        context = self._context(params, batch)
        caches = self.init_cache(b, max_len)
        pos = torch.arange(s, device=self.device).expand(b, s)
        x = self._blocks(params, self._embed_tokens(params, tokens), caches,
                         self._layer(pos, context=context))
        return self._logits(params, x[:, -1:]), caches

    def decode_step(self, params: Params, caches, token, step: int):
        """One decode step. token (B, 1); step the position written."""
        token = self._tokens(token)
        b = token.shape[0]
        pos = torch.full((b, 1), int(step), device=self.device)
        x = self._blocks(params, self._embed_tokens(params, token), caches,
                         self._layer(pos, int(step)))
        return self._logits(params, x), caches

    # ---- paged serve (continuous batching, repro_torch.serve) --------------
    def supports_paged(self) -> str | None:
        """None when the paged serve path covers this config, else why not
        (the reference's reasons, word for word)."""
        cfg = self.cfg
        if any(k != "attn" for k in self.pattern):
            return f"block pattern {self.pattern} has non-attn blocks"
        if cfg.block_tail:
            return f"block_tail {cfg.block_tail} is not paged"
        if cfg.local_window:
            return "local-window (rolling) caches are not paged"
        if cfg.n_context_tokens or cfg.is_encdec:
            return "cross-attention context caches are not paged"
        return None

    def init_page_pool(self, n_pages: int, page_size: int):
        """Layer-stacked paged KV pool: leaves (n_repeats, n_pages,
        page_size, KV, D) (+ scale leaves under KV8)."""
        reason = self.supports_paged()
        if reason is not None:
            raise NotImplementedError(f"paged KV pool: {reason}")
        return self._state(lambda kind: A.init_attn_page_pool(
            self.cfg, n_pages, page_size, device="meta"))

    def _paged(self, params, tokens, pool, fn, **kw):
        cfg = self.cfg

        def layer(kind, bp, x, pl):
            return fn(bp, x, cfg, pool=pl, **kw)[0]
        return self._blocks(params, self._embed_tokens(params, tokens),
                            pool, layer)

    def prefill_paged(self, params: Params, tokens, pool, *,
                      prefix_page_ids, write_page_ids, write_offs,
                      write_from: int = 0):
        """Suffix prefill for one request through the page pool; returns
        (last-position logits, pool) — the pool is written in place."""
        x = self._paged(params, tokens, pool, A.apply_attn_paged_prefill,
                        prefix_page_ids=prefix_page_ids,
                        write_page_ids=write_page_ids,
                        write_offs=write_offs, write_from=write_from)
        return self._logits(params, x[:, -1:]), pool

    def prefill_paged_batched(self, params: Params, tokens, pool, *,
                              prefix_page_ids, prefix_lens, suffix_lens,
                              write_page_ids, write_offs, write_pos):
        """Bucket-padded batched prefill of several requests' suffixes;
        returns (per-row last-real-position logits (B, 1, V), pool)."""
        x = self._paged(params, tokens, pool,
                        A.apply_attn_paged_prefill_batched,
                        prefix_page_ids=prefix_page_ids,
                        prefix_lens=prefix_lens, suffix_lens=suffix_lens,
                        write_page_ids=write_page_ids,
                        write_offs=write_offs, write_pos=write_pos)
        idx = (suffix_lens.long() - 1)[:, None, None].expand(
            -1, 1, x.shape[-1])
        last = torch.take_along_dim(x, idx, dim=1)
        return self._logits(params, last), pool

    def decode_step_paged(self, params: Params, pool, tokens, page_indices,
                          steps, kernel: bool | None = None):
        """One packed decode step over every slot. tokens (B, 1);
        page_indices (B, P) int32; steps (B,) int32. Returns (logits
        (B, 1, V), pool). ``kernel`` selects the live-page CUDA attention
        kernel; None defers to ``cfg.paged_kernel``."""
        x = self._paged(params, tokens, pool, A.apply_attn_paged_decode,
                        page_indices=page_indices, steps=steps,
                        kernel=kernel)
        return self._logits(params, x), pool


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree.to(device)
