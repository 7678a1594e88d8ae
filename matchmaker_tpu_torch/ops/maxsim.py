"""ColBERT MaxSim (late-interaction scoring): counterpart of
``matchmaker_tpu/ops/maxsim.py`` and of the TPU kernel K14,
``matchmaker_tpu/ops/pallas_kernels.py:maxsim_all_pairs_pallas_v2``
(``_maxsim_v2_kernel``).

Per (query, doc) pair: for each query token the max over the doc's tokens of
q·d, padded doc positions (mask 0) taking ``fill``; then the sum over query
tokens weighted by the query mask, a masked query token adding exactly 0.

- :func:`maxsim_pairwise`: (B,) scores of aligned pairs, plain torch (JAX
  computes it in jnp, outside any kernel);
- :func:`maxsim_all_pairs`: the (Bq, Bd) matrix. CPU tensors run the plain
  version :func:`reference_maxsim_all_pairs`; CUDA tensors launch the
  hand-written kernel of ``csrc/maxsim_kernels.cu`` (K14) or raise. The
  kernel takes any D % 8 == 0 (D above 256 streamed through shared memory in
  slabs) and 1 <= Lq <= 512 (:func:`check_kernel_geometry`, which runs on
  any device); it is forward-only: on the card, inputs that require grad are
  refused (the MaxSim backward comes with ColBERT training).

Every product is f32 (no TF32), as the TPU kernel's default
``compute_dtype=float32``. ``fill`` reaches the kernel: −1000 (``NEG_FILL``,
JAX's ``maxsim_all_pairs``) or −inf (the exact rescore of
retrieval/colbert_search.py). Raw ColBERT dots reach |s| ≈ 7000, so a live
max below −1000 is real and the two fills give different scores.
"""

from __future__ import annotations

import torch

from matchmaker_tpu_torch.ops import _build, matmul_f32

NEG_FILL = -1000.0
# csrc/maxsim_kernels.cu: the most query rows a block sums (the encoder's
# position limit); D is any multiple of 8
_KERNEL_MAX_LQ = 512


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


def check_kernel_geometry(q_vecs, d_vecs, q_mask, d_mask) -> None:
    """Raise ValueError unless K14 takes these shapes: q (Bq, Lq, D), d
    (Bd, Ld, D), masks (Bq, Lq) / (Bd, Ld), D % 8 == 0 and 1 <= Lq <= 512.
    Reads shapes only, so it runs on tensors on any device."""
    bq, lq, dim = q_vecs.shape
    bd, ld, dim_d = d_vecs.shape
    if dim != dim_d or tuple(q_mask.shape) != (bq, lq) or tuple(d_mask.shape) != (bd, ld):
        raise ValueError(f"maxsim_all_pairs: shapes q {tuple(q_vecs.shape)}, d {tuple(d_vecs.shape)}, "
                         f"q_mask {tuple(q_mask.shape)}, d_mask {tuple(d_mask.shape)} do not fit")
    if dim < 8 or dim % 8 or not 1 <= lq <= _KERNEL_MAX_LQ:
        raise ValueError(f"maxsim_all_pairs: the CUDA kernel takes D % 8 == 0 and 1 <= Lq <= {_KERNEL_MAX_LQ}, "
                         f"got D={dim}, Lq={lq}")


def _maxsim_cuda(q_vecs, d_vecs, q_mask, d_mask, fill, stream_d: bool = False):
    """K14 on the card. ``stream_d``: stream D in slabs even where D <= 256
    would stay resident (the same bits; chip_smoke.py times both forms)."""
    check_kernel_geometry(q_vecs, d_vecs, q_mask, d_mask)
    bq, lq, dim = q_vecs.shape
    bd, ld, _ = d_vecs.shape
    if any(t.requires_grad for t in (q_vecs, d_vecs, q_mask, d_mask)):
        raise NotImplementedError("maxsim_all_pairs: the CUDA kernel is forward-only; the MaxSim backward "
                                  "comes with ColBERT training (ROADMAP.md)")
    f32 = torch.float32
    # held in names until the launch: the kernel reads them on the stream
    q, d = q_vecs.to(f32).contiguous(), d_vecs.to(f32).contiguous()
    qm, dm = q_mask.to(f32).contiguous(), d_mask.to(f32).contiguous()
    for name, t in (("q_vecs", q), ("d_vecs", d), ("q_mask", qm), ("d_mask", dm)):
        _build.check_cuda(t, f"maxsim_all_pairs.{name}", f32)
    with torch.cuda.device(q.device):
        out = torch.empty((bq, bd), dtype=f32, device=q.device)
        if bq and bd:
            _build.call("mm_maxsim", _build.ptr(q), _build.ptr(d), _build.ptr(qm), _build.ptr(dm), _build.ptr(out),
                        bq, lq, bd, ld, dim, float(fill), int(stream_d), _build.stream(q.device))
            _build.LAUNCHES["maxsim_all_pairs"] += 1
    return out


def maxsim_all_pairs(q_vecs: torch.Tensor, d_vecs: torch.Tensor, q_mask: torch.Tensor, d_mask: torch.Tensor,
                     *, fill: float = NEG_FILL) -> torch.Tensor:
    """All-pairs MaxSim matrix (Bq, Bd) f32: q_vecs (Bq, Lq, D), d_vecs
    (Bd, Ld, D), q_mask (Bq, Lq), d_mask (Bd, Ld). Padded doc tokens
    (mask <= 0) take ``fill``. CUDA tensors: D % 8 == 0, 1 <= Lq <= 512,
    no autograd."""
    if not q_vecs.is_cuda:
        return reference_maxsim_all_pairs(q_vecs, d_vecs, q_mask, d_mask, fill)
    return _maxsim_cuda(q_vecs, d_vecs, q_mask, d_mask, fill)
