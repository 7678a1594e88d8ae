"""ColBERT MaxSim (late-interaction scoring): counterpart of
``matchmaker_tpu/ops/maxsim.py`` and of the TPU kernel K14,
``matchmaker_tpu/ops/pallas_kernels.py:maxsim_all_pairs_pallas_v2``
(``_maxsim_v2_kernel``).

Per (query, doc) pair: for each query token the max over the doc's tokens of
q·d, padded doc positions (mask 0) taking ``fill``; then the sum over query
tokens weighted by the query mask, a masked query token adding exactly 0.

- :func:`maxsim_pairwise`: (B,) scores of aligned pairs, plain torch (JAX
  computes it in jnp, outside any kernel);
- :func:`maxsim_all_pairs`: the (Bq, Bd) matrix;
- :func:`maxsim_gathered`: (B, C) scores of each query against its own C
  candidates, each a (first row, token count) span of one (N, D) token
  matrix, padded to ``pad_tokens`` slots, the spans given on the CPU and
  checked there: the batched exact rescore of retrieval/colbert_search.py,
  one launch a query batch.

CPU tensors run the plain versions (:func:`reference_maxsim_all_pairs`,
:func:`reference_maxsim_gathered`), differentiated by autograd; CUDA tensors
launch the hand-written kernel of ``csrc/maxsim_kernels.cu`` (K14), which
serves both forms (the all-pairs docs as dense Ld-row blocks of their flat
rows with the doc mask), or raise. The kernels take D up to 2048 and any
Lq and Ld (:func:`check_kernel_geometry`, which runs on any device);
their tiles are read 16 bytes at a time, so a D that is not a multiple of
8 runs at the next one, q and the doc tokens copied into zero-padded rows
(:func:`_pad_dim`): zero columns add nothing to a dot product, and the
backward's gradients are cut back to D.

Under autograd on the card, the all-pairs form runs as
:class:`MaxSimAllPairs`: the training form, which also saves each (query
token, doc)'s max doc token (int32 (Bq, Lq, Bd)), and a backward that
gathers dq from those tokens and scatters dd into them, both hand-written
for the in-batch shape in ``csrc/maxsim_train_kernels.cu`` (wgmma products,
persistent over the docs; :func:`train_plan` and :func:`bwd_plan` size their
launches), each output summed in a fixed order (no float atomics, reruns
bit-identical), at any Ld. A max that the fill wins (a masked or
padded doc slot) passes no gradient, nor do the masks. Exactly equal maxima
split their gradient evenly, as ``torch.amax`` and JAX's ``max`` do; the
kernel finds them as the doc's rows equal bit for bit to the first (a
repeated token; two different rows whose products round to the same f32
give it all to the first). The gathered form is a serving form and stays
forward-only: on the card, inputs that require grad are refused there.

The kernels' products run on the tensor cores in split TF32 (each f32
operand a TF32 hi + lo pair, three products; two for float16 tokens, exact
in TF32), which keeps the TPU kernel's default ``compute_dtype=float32``
within rtol = atol = 1e-4 of the plain f32 version; TF32 alone would not
(``tests/test_torch_maxsim_tf32_split.py`` emulates both). ``fill`` reaches
the kernel: −1000 (``NEG_FILL``, JAX's ``maxsim_all_pairs``) or −inf (the
exact rescore). Raw ColBERT dots reach |s| ≈ 7000, so a live max below −1000
is real and the two fills give different scores.
"""

from __future__ import annotations

import functools

import torch

from matchmaker_tpu_torch.ops import _build, matmul_f32
from matchmaker_tpu_torch.ops.fused_attention import card_width, pad_groups

NEG_FILL = -1000.0
# csrc/maxsim_kernels.cu: the widest D whose 16-row query tile fits shared
# memory
_KERNEL_MAX_DIM = 2048
# csrc/maxsim_train_kernels.cu: a training-form tile's query rows, its token
# chunks, the shared memory a block can use and the part of it that is
# neither the query tile nor the ring; the backward's dd rows a block
# (their sums in shared memory) and its entry list
_TRAIN_ROWS = 128
_TRAIN_CHUNKS = (64, 104, 128)
_TRAIN_MAX_SLOTS = 4
_SMEM_MAX = 232448
_TRAIN_SMEM_FIXED = 2048
_BWD_ROWS_MAX = 40
_BWD_LIST = 1024
_BWD_GROUPS = 4
# the backward's tie classes: a doc's arrays hold at least 1,024 rows, its
# hash table at least twice as many entries (a power of two)
_BWD_CLASS_ROWS = 1024
# the most doc rows whose class lead and size share one int32 (lead | size
# << 16, staged in dd's shared memory); past it two planes, read in place
_BWD_PACKED_LD = 32767


def train_plan(bq: int, lq: int, bd: int, ld: int, dim: int, sms: int = 132) -> dict:
    """The training form's launch on a card of ``sms`` SMs: ``chunk`` doc
    tokens a stage (the size of {64, 104, 128} that pads Ld the least, the
    larger on a tie), ``slabs`` of 32 floats of D, whether the 128-row query
    tile stays ``resident`` in shared memory (split into TF32 hi and lo once;
    when it leaves room for two ring slots) or streams beside every doc
    slab, the ring's ``slots`` (as many as fit, at most 4), the block's shared
    memory, the row ``tiles``, the (tile, doc) ``items`` and ``ctas``
    blocks, one an SM, that split them evenly."""
    chunk = min(_TRAIN_CHUNKS, key=lambda n: (-(-ld // n) * n, -n))
    slabs = -(-dim // 32)
    tile = 2 * _TRAIN_ROWS * 128  # a slab of the tile, hi and lo
    room = _SMEM_MAX - _TRAIN_SMEM_FIXED
    slot = 2 * chunk * 128 + 1024  # doc hi and lo, the chunk's token masks
    resident = room - slabs * tile >= 2 * slot
    if not resident:
        slot += tile  # the query slab streams beside the doc slab
    slots = min(_TRAIN_MAX_SLOTS, (room - (slabs * tile if resident else 0)) // slot)
    tiles = -(-(bq * lq) // _TRAIN_ROWS)
    items = tiles * bd
    return {"chunk": chunk, "slabs": slabs, "resident": resident, "slots": slots,
            "smem": _TRAIN_SMEM_FIXED + (slabs * tile if resident else 0) + slots * slot, "tiles": tiles,
            "items": items, "ctas": max(1, min(items, sms))}


def bwd_plan(bq: int, lq: int, bd: int, ld: int, dim: int, sms: int = 132) -> dict:
    """The backward's launches: the first takes ``bd`` class blocks and
    ``dq_blocks`` of eight query rows, a doc's tie-class arrays
    (``class_bytes``: hashes, leads, sizes, the hash table, live flags) in
    shared memory where they fit, else in a global workspace of
    ``class_ws`` bytes (Ld past 8,192), its classes into ``info_planes``
    int32 planes of (Bd, Ld) (a row's lead and class size packed in one,
    or past 32,767 rows apart); the second cuts each doc's dd into
    ``parts`` row ranges (at most 40 rows each, and enough blocks for about
    two an SM) by ``slabs`` of 128 columns, ``dd_blocks`` in all, each with
    ``dd_smem`` bytes of shared memory (four column groups' sums of its
    rows, the doc's packed classes, the entry list)."""
    slabs = -(-dim // 128)
    parts = min(ld, max(-(-ld // _BWD_ROWS_MAX), -(-2 * sms // max(1, bd * slabs))))
    rows = -(-ld // parts)
    cap, table = max(ld, _BWD_CLASS_ROWS), 2 * _BWD_CLASS_ROWS
    while table < 2 * ld:
        table *= 2
    class_bytes = (3 * cap + table) * 4 + -(-cap // 4) * 4
    packed = ld <= _BWD_PACKED_LD
    return {"parts": parts, "slabs": slabs, "rows": rows, "dq_blocks": -(-(bq * lq) // 8),
            "class_bytes": class_bytes, "class_ws": 0 if class_bytes <= _SMEM_MAX else bd * class_bytes,
            "info_planes": 1 if packed else 2, "dd_blocks": bd * parts * slabs,
            "dd_smem": _BWD_GROUPS * rows * 128 * 4 + (ld * 4 if packed else 0) + _BWD_LIST * 12 + _BWD_GROUPS * 4 * 4}


def maxsim_pairwise(q_vecs: torch.Tensor, d_vecs: torch.Tensor, q_mask: torch.Tensor,
                    d_mask: torch.Tensor) -> torch.Tensor:
    """Per-pair MaxSim score (B,): q_vecs (B, Lq, D), d_vecs (B, Ld, D),
    masks (B, Lq) / (B, Ld)."""
    per_term = matmul_f32(q_vecs, d_vecs.transpose(-1, -2))  # (B, Lq, Ld)
    per_term = torch.where(d_mask[:, None, :] > 0, per_term, NEG_FILL)
    best = per_term.amax(dim=-1)
    return (best * q_mask).sum(dim=-1)


def _terms(best: torch.Tensor, q_mask: torch.Tensor) -> torch.Tensor:
    """best · mask, a masked query token giving exactly 0 (never −inf·0)."""
    q_mask = q_mask.to(best.dtype)
    return torch.where(q_mask != 0, best * q_mask, torch.zeros((), dtype=best.dtype, device=best.device))


def reference_maxsim_all_pairs(q_vecs: torch.Tensor, d_vecs: torch.Tensor, q_mask: torch.Tensor,
                               d_mask: torch.Tensor, fill: float = NEG_FILL) -> torch.Tensor:
    """Plain version of K14: one flat f32 product (Bq·Lq, Bd·Ld), the masked
    max over doc tokens, the masked sum over query tokens."""
    bq, lq, dim = q_vecs.shape
    bd, ld, _ = d_vecs.shape
    flat = matmul_f32(q_vecs.reshape(bq * lq, dim), d_vecs.reshape(bd * ld, dim).T).reshape(bq, lq, bd, ld)
    flat = torch.where(d_mask[None, None, :, :] > 0, flat, fill)
    best = flat.amax(dim=-1)  # (Bq, Lq, Bd)
    return _terms(best, q_mask[:, :, None]).sum(dim=1)


def reference_maxsim_argmax(q_vecs: torch.Tensor, d_vecs: torch.Tensor, q_mask: torch.Tensor, d_mask: torch.Tensor,
                           fill: float = NEG_FILL, with_top2: bool = False):
    """Plain version of the training form: (out (Bq, Bd), argmax (Bq, Lq,
    Bd) int32), argmax the first doc token holding each max of the plain f32
    dots (-1 where a filled slot holds it); ``with_top2`` adds the largest
    and second-largest dot with the fill, (Bq, Lq, Bd) each, to tell a near
    tie."""
    bq, lq, dim = q_vecs.shape
    bd, ld, _ = d_vecs.shape
    flat = matmul_f32(q_vecs.reshape(bq * lq, dim), d_vecs.reshape(bd * ld, dim).T).reshape(bq, lq, bd, ld)
    live = d_mask[None, None, :, :] > 0
    flat = torch.where(live, flat, fill)
    best, idx = flat.max(dim=-1)
    idx = torch.where(torch.gather(live.expand_as(flat), -1, idx[..., None])[..., 0], idx, -1).to(torch.int32)
    out = _terms(best, q_mask[:, :, None]).sum(dim=1)
    if not with_top2:
        return out, idx
    top = flat.topk(min(2, ld), dim=-1).values
    return out, idx, top[..., 0], top[..., -1]


def reference_maxsim_bwd(q_vecs: torch.Tensor, d_vecs: torch.Tensor, q_mask: torch.Tensor, d_mask: torch.Tensor,
                        argmax: torch.Tensor, grad: torch.Tensor):
    """Plain version of the backward kernel: (dq, dd) of the all-pairs
    MaxSim from the upstream gradient ``grad`` (Bq, Bd) and the training
    form's saved doc tokens ``argmax`` (Bq, Lq, Bd): entry (b, l, k) with a
    live token a = argmax[b, l, k] adds grad[b, k] q_mask[b, l] d[k, a] to
    dq[b, l] and grad[b, k] q_mask[b, l] q[b, l] to dd[k, a], split evenly
    over the doc's live rows equal bit for bit to row a (the exact ties)."""
    bq, lq, dim = q_vecs.shape
    bd, ld, _ = d_vecs.shape
    q, d = q_vecs.float(), d_vecs.float()
    a = argmax.long()
    w = torch.where(a >= 0, grad.float()[:, None, :] * q_mask.float()[:, :, None], 0.0)  # (Bq, Lq, Bd)
    docs = torch.arange(bd, device=d.device)
    dq = (w[..., None] * d[docs[None, None, :], a.clamp(min=0)]).sum(dim=2)
    live = d_mask > 0
    same = (d[:, :, None, :] == d[:, None, :, :]).all(dim=-1) & live[:, :, None] & live[:, None, :]  # (Bd, Ld, Ld)
    share = same / same.sum(dim=-1, keepdim=True).clamp(min=1)
    spread = share[docs[None, None, :], a.clamp(min=0)]  # (Bq, Lq, Bd, Ld): entry's share of each row
    dd = torch.einsum("blkm,blk,bld->kmd", spread, w, q)
    return dq, dd


def reference_maxsim_gathered(q_vecs: torch.Tensor, q_mask: torch.Tensor, tokens: torch.Tensor,
                              first: torch.Tensor, count: torch.Tensor, pad_tokens: int,
                              fill: float = NEG_FILL) -> torch.Tensor:
    """Plain version of K14's gathered form: query b against candidate c is
    the all-pairs MaxSim of q_vecs[b] and the doc tokens[first[b, c] :
    first[b, c] + count[b, c]] padded to ``pad_tokens`` slots (the padding
    taking ``fill``), one query at a time."""
    slots = torch.arange(pad_tokens, device=tokens.device)
    first, count = first.to(tokens.device), count.to(tokens.device)
    rows = (first[..., None] + slots).clamp(max=max(tokens.shape[0] - 1, 0))  # (B, C, T)
    live = (slots < count[..., None]).float()
    return torch.cat([reference_maxsim_all_pairs(q_vecs[b:b + 1], tokens[rows[b]].float(), q_mask[b:b + 1],
                                                 live[b], fill) for b in range(first.shape[0])])


def check_kernel_geometry(q_vecs, d_vecs, q_mask, d_mask) -> None:
    """Raise ValueError unless K14 takes these shapes: q (Bq, Lq, D), d
    (Bd, Ld, D), masks (Bq, Lq) / (Bd, Ld), 1 <= D <= 2048 (run at the
    next multiple of 8) and Lq >= 1, any Ld. Reads shapes only, so it runs
    on tensors on any device."""
    bq, lq, dim = q_vecs.shape
    bd, ld, dim_d = d_vecs.shape
    if dim != dim_d or tuple(q_mask.shape) != (bq, lq) or tuple(d_mask.shape) != (bd, ld):
        raise ValueError(f"maxsim_all_pairs: shapes q {tuple(q_vecs.shape)}, d {tuple(d_vecs.shape)}, "
                         f"q_mask {tuple(q_mask.shape)}, d_mask {tuple(d_mask.shape)} do not fit")
    _check_widths(dim, lq)


def check_backward_geometry(q_vecs, d_vecs, q_mask, d_mask) -> None:
    """Raise ValueError unless the training form and its backward kernels
    take these shapes: :func:`check_kernel_geometry` and Ld >= 1 (a doc's
    tie classes in shared memory, or past 8,192 rows in a workspace)."""
    check_kernel_geometry(q_vecs, d_vecs, q_mask, d_mask)
    if d_vecs.shape[1] < 1:
        raise ValueError(f"maxsim: the backward kernel takes Ld >= 1, got Ld={d_vecs.shape[1]}")


def _check_widths(dim: int, lq: int) -> None:
    if not 1 <= dim <= _KERNEL_MAX_DIM or lq < 1:
        raise ValueError(f"maxsim: the CUDA kernel takes 1 <= D <= {_KERNEL_MAX_DIM} (run at the next multiple "
                         f"of 8) and Lq >= 1, got D={dim}, Lq={lq}")


def _pad_dim(t: torch.Tensor) -> torch.Tensor:
    """``t`` with its last axis (D) zero-padded to the next multiple of 8,
    the width the kernels read (``t`` itself where D is one)."""
    return pad_groups(t, 1, card_width(t.shape[-1]), -1)


def _f32(t: torch.Tensor) -> torch.Tensor:
    return t if t.dtype == torch.float32 and t.is_contiguous() else t.to(torch.float32).contiguous()


def _launch(q, q_mask, tokens, tok_mask, first, count, pad_tokens: int, n_cands: int, fill: float):
    """One K14 launch: q (B, Lq, D) and q_mask (B, Lq), made f32; tokens
    (N, D) rows (any contiguous shape over them), float16 or made f32;
    tok_mask (N) or None; first (B, C) int64 and count (B, C) int32 spans
    on the card, or both None for ``n_cands`` dense docs of ``pad_tokens``
    rows each → (B, C) f32."""
    if torch.is_grad_enabled() and (q.requires_grad or q_mask.requires_grad or tokens.requires_grad or (
            tok_mask is not None and tok_mask.requires_grad)):
        raise NotImplementedError("maxsim: the gathered form is a forward-only serving form; only "
                                  "maxsim_all_pairs has a backward")
    q, tokens = _pad_dim(q), _pad_dim(tokens)
    b, lq, dim = q.shape
    c = n_cands if first is None else first.shape[1]
    dev = q.device
    # held in names until the launch: the kernel reads them on the stream
    q, qm = _f32(q), _f32(q_mask)
    f16 = tokens.dtype == torch.float16
    tokens = tokens.contiguous() if f16 else _f32(tokens)
    tm = None if tok_mask is None else _f32(tok_mask)
    for name, t in (("q_vecs", q), ("q_mask", qm), ("tokens", tokens), ("tok_mask", tm), ("first", first),
                    ("count", count)):
        if t is not None:
            _build.check_cuda(t, f"maxsim.{name}", t.dtype)
    with torch.cuda.device(dev):
        out = torch.empty((b, c), dtype=torch.float32, device=dev)
        if b and c:
            _build.call("mm_maxsim", q.data_ptr(), qm.data_ptr(), tokens.data_ptr(),
                        None if tm is None else tm.data_ptr(), None if first is None else first.data_ptr(),
                        None if count is None else count.data_ptr(), out.data_ptr(), b, lq, c, dim, pad_tokens,
                        int(f16), float(fill), _build.stream(dev))
            _build.LAUNCHES["maxsim_all_pairs"] += 1
    return out


def _maxsim_cuda(q_vecs, d_vecs, q_mask, d_mask, fill):
    """K14 on the card, all pairs: doc j is the Ld rows from j * Ld of the
    docs (read flat where they lie), shared by every query, the doc mask the
    token mask."""
    check_kernel_geometry(q_vecs, d_vecs, q_mask, d_mask)
    return _launch(q_vecs, q_mask, d_vecs, d_mask, None, None, d_vecs.shape[1], d_vecs.shape[0], fill)


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _launch_argmax(q, q_mask, d, d_mask, fill):
    """The training form: f32 q (Bq, Lq, D), q_mask, d (Bd, Ld, D), d_mask
    on the card → (out (Bq, Bd) f32, argmax (Bq, Lq, Bd) int32, the doc
    token of each max, -1 where the fill is the max)."""
    for name, t in (("q_vecs", q), ("q_mask", q_mask), ("d_vecs", d), ("d_mask", d_mask)):
        _build.check_cuda(t, f"maxsim.{name}", torch.float32)
    q, d = _f32(_pad_dim(q)), _f32(_pad_dim(d))
    (bq, lq, dim), (bd, ld) = q.shape, d.shape[:2]
    dev = q.device
    with _build.on(dev):
        out = torch.empty((bq, bd), dtype=torch.float32, device=dev)
        argmax = torch.empty((bq, lq, bd), dtype=torch.int32, device=dev)
        if bq and bd:
            best = torch.empty((bq, lq, bd), dtype=torch.float32, device=dev)  # each row's max, summed after
            plan = train_plan(bq, lq, bd, ld, dim, _sm_count(q.get_device()))
            _build.call("mm_maxsim_train", q.data_ptr(), q_mask.data_ptr(), d.data_ptr(), d_mask.data_ptr(),
                        best.data_ptr(), out.data_ptr(), argmax.data_ptr(), bq, lq, bd, ld, dim, plan["chunk"],
                        int(plan["resident"]), plan["slots"], plan["ctas"], float(fill), _build.stream(dev))
            _build.LAUNCHES["maxsim_all_pairs_argmax"] += 1
    return out, argmax


def _launch_bwd(q, q_mask, d, d_mask, argmax, g):
    """The backward kernels: (dq (Bq, Lq, D), dd (Bd, Ld, D)) f32 from g
    (Bq, Bd) and the training form's argmax over the same inputs (run at D
    padded to a multiple of 8, the gradients cut back)."""
    g = _f32(g)
    for name, t, dtype in (("q_vecs", q, torch.float32), ("q_mask", q_mask, torch.float32),
                           ("d_vecs", d, torch.float32), ("d_mask", d_mask, torch.float32),
                           ("argmax", argmax, torch.int32), ("grad", g, torch.float32)):
        _build.check_cuda(t, f"maxsim_bwd.{name}", dtype)
    width = q.shape[-1]
    q, d = _f32(_pad_dim(q)), _f32(_pad_dim(d))
    (bq, lq, dim), (bd, ld) = q.shape, d.shape[:2]
    dev = q.device
    with _build.on(dev):
        dq = torch.empty_like(q)
        dd = torch.empty_like(d)
        if bq and bd:
            plan = bwd_plan(bq, lq, bd, ld, dim, _sm_count(q.get_device()))
            info = torch.empty((plan["info_planes"], bd, ld), dtype=torch.int32, device=dev)  # the tie classes
            ws = torch.empty(plan["class_ws"], dtype=torch.uint8, device=dev) if plan["class_ws"] else None
            _build.call("mm_maxsim_bwd", q.data_ptr(), q_mask.data_ptr(), d.data_ptr(), d_mask.data_ptr(),
                        argmax.data_ptr(), g.data_ptr(), info.data_ptr(), None if ws is None else ws.data_ptr(),
                        dq.data_ptr(), dd.data_ptr(), bq, lq, bd, ld, dim, plan["parts"], _build.stream(dev))
            _build.LAUNCHES["maxsim_all_pairs_bwd"] += 1
        else:
            dq.zero_()
            dd.zero_()
    return dq[..., :width], dd[..., :width]


def maxsim_all_pairs_argmax(q_vecs: torch.Tensor, d_vecs: torch.Tensor, q_mask: torch.Tensor,
                            d_mask: torch.Tensor, fill: float = NEG_FILL):
    """The training form: (out (Bq, Bd) f32, argmax (Bq, Lq, Bd) int32, each
    max's doc token, -1 where the fill is the max). CUDA tensors launch the
    training form's kernel (shapes of :func:`check_kernel_geometry`), CPU
    ones run :func:`reference_maxsim_argmax`."""
    if not q_vecs.is_cuda:
        return reference_maxsim_argmax(q_vecs, d_vecs, q_mask, d_mask, fill)
    check_backward_geometry(q_vecs, d_vecs, q_mask, d_mask)
    return _launch_argmax(*(_f32(t.detach()) for t in (q_vecs, q_mask, d_vecs, d_mask)), fill)


def maxsim_all_pairs_bwd(q_vecs: torch.Tensor, d_vecs: torch.Tensor, q_mask: torch.Tensor, d_mask: torch.Tensor,
                         argmax: torch.Tensor, grad: torch.Tensor):
    """(dq, dd) f32 from the upstream gradient (Bq, Bd) and the training
    form's argmax. CUDA tensors launch the backward kernels, CPU ones run
    :func:`reference_maxsim_bwd`."""
    if not q_vecs.is_cuda:
        return reference_maxsim_bwd(q_vecs, d_vecs, q_mask, d_mask, argmax, grad)
    check_backward_geometry(q_vecs, d_vecs, q_mask, d_mask)
    return _launch_bwd(*(_f32(t.detach()) for t in (q_vecs, q_mask, d_vecs, d_mask)), argmax, grad)


class MaxSimAllPairs(torch.autograd.Function):
    """The all-pairs MaxSim on the card under autograd: the training form
    forward (saving each max's doc token), the backward kernels backward.
    The masks get no gradient."""

    @staticmethod
    def forward(ctx, q_vecs, d_vecs, q_mask, d_mask, fill):
        q, qm, d, dm = (_f32(t.detach()) for t in (q_vecs, q_mask, d_vecs, d_mask))
        out, argmax = _launch_argmax(q, qm, d, dm, fill)
        ctx.save_for_backward(q, qm, d, dm, argmax)
        ctx.dtypes = (q_vecs.dtype, d_vecs.dtype)
        ctx.mark_non_differentiable(argmax)
        return out

    @staticmethod
    def backward(ctx, grad):
        q, qm, d, dm, argmax = ctx.saved_tensors
        dq, dd = _launch_bwd(q, qm, d, dm, argmax, grad)
        return (dq.to(ctx.dtypes[0]) if ctx.needs_input_grad[0] else None,
                dd.to(ctx.dtypes[1]) if ctx.needs_input_grad[1] else None, None, None, None)


def maxsim_all_pairs(q_vecs: torch.Tensor, d_vecs: torch.Tensor, q_mask: torch.Tensor, d_mask: torch.Tensor,
                     *, fill: float = NEG_FILL) -> torch.Tensor:
    """All-pairs MaxSim matrix (Bq, Bd) f32: q_vecs (Bq, Lq, D), d_vecs
    (Bd, Ld, D), q_mask (Bq, Lq), d_mask (Bd, Ld). Padded doc tokens
    (mask <= 0) take ``fill``. CUDA tensors: D up to 2048, any Lq and Ld;
    under autograd the training form and its backward
    (:class:`MaxSimAllPairs`)."""
    if not q_vecs.is_cuda:
        return reference_maxsim_all_pairs(q_vecs, d_vecs, q_mask, d_mask, fill)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q_vecs, d_vecs, q_mask, d_mask)):
        check_backward_geometry(q_vecs, d_vecs, q_mask, d_mask)
        return MaxSimAllPairs.apply(q_vecs, d_vecs, q_mask, d_mask, float(fill))
    return _maxsim_cuda(q_vecs, d_vecs, q_mask, d_mask, fill)


def maxsim_gathered(q_vecs: torch.Tensor, q_mask: torch.Tensor, tokens: torch.Tensor, first: torch.Tensor,
                    count: torch.Tensor, pad_tokens: int, *, fill: float = NEG_FILL) -> torch.Tensor:
    """(B, C) MaxSim of each query against its own candidates: q_vecs
    (B, Lq, D), q_mask (B, Lq), tokens (N, D) f32 or float16, first (B, C)
    and count (B, C) spans of tokens on the CPU (count <= ``pad_tokens``;
    count 0 marks an empty slot), the ``pad_tokens - count`` missing slots
    taking ``fill``. The spans are checked against N and ``pad_tokens``
    here, before any launch, so the kernel never reads outside ``tokens``;
    CUDA ``tokens`` then launch K14 (the spans uploaded), CPU ones run the
    plain version."""
    if tuple(first.shape) != tuple(count.shape) or first.dim() != 2 or first.shape[0] != q_vecs.shape[0]:
        raise ValueError(f"maxsim_gathered: spans {tuple(first.shape)} / {tuple(count.shape)} for queries "
                         f"{tuple(q_vecs.shape)}")
    if first.is_cuda or count.is_cuda:
        raise ValueError("maxsim_gathered: give the spans on the CPU (they are checked there before the upload)")
    first, count = first.to(torch.int64).contiguous(), count.to(torch.int32).contiguous()
    if first.numel() and (int(count.max()) > pad_tokens or int(count.min()) < 0 or int(first.min()) < 0
                          or int((first + count).max()) > tokens.shape[0]):
        raise ValueError(f"maxsim_gathered: spans outside the {tokens.shape[0]} token rows or past "
                         f"{pad_tokens} slots")
    if not tokens.is_cuda:
        return reference_maxsim_gathered(q_vecs, q_mask, tokens, first, count, pad_tokens, fill)
    if q_vecs.shape[-1] != tokens.shape[-1]:
        raise ValueError(f"maxsim_gathered: queries of width {q_vecs.shape[-1]}, tokens of {tokens.shape[-1]}")
    _check_widths(q_vecs.shape[-1], q_vecs.shape[1])
    # from pinned memory, asynchronously: a pageable copy would first wait
    # for the stream's earlier work
    first, count = (t.pin_memory().to(tokens.device, non_blocking=True) for t in (first, count))
    return _launch(q_vecs, q_mask, tokens, None, first, count, pad_tokens, 0, fill)
