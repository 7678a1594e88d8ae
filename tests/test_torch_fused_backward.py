"""The port's differentiable fused layer halves
(matchmaker_tpu_torch/ops/fused_backward.py) against the JAX package's
custom-VJP halves with their Pallas backward kernels run in interpret mode on
the CPU, at the shapes and tolerances of tests/test_fused_encoder.py.

On CPU tensors the port's backward is its plain version, which follows the
TPU kernels step for step (what the CUDA kernels compute); the same numpy
inputs go to both packages."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from matchmaker_tpu.models.encoder import EncoderConfig as JaxEncoderConfig
from matchmaker_tpu.models.encoder import TransformerEncoderLM as JaxEncoder
from matchmaker_tpu.ops import fused_attention as jfa
from matchmaker_tpu.ops import fused_backward as jfb
from matchmaker_tpu_torch.models.encoder import EncoderConfig, TransformerEncoderLM
from matchmaker_tpu_torch.models.weights import flax_to_state_dict
from matchmaker_tpu_torch.ops import _build
from matchmaker_tpu_torch.ops import fused_attention as tfa
from matchmaker_tpu_torch.ops import fused_backward as tfb


def _attention_inputs(seed, b=5, l=21, hid=64):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(b, l, hid)) * 0.5).astype(np.float32)
    ws = [(rng.normal(size=(hid, hid)) * 0.1).astype(np.float32) for _ in range(4)]
    bs = [(rng.normal(size=(hid,)) * 0.05).astype(np.float32) for _ in range(4)]
    g = (rng.normal(size=(hid,)) * 0.1 + 1).astype(np.float32)
    be = (rng.normal(size=(hid,)) * 0.1).astype(np.float32)
    mask = np.ones((b, l), np.float32)
    mask[2, 15:] = 0
    cot = rng.normal(size=(b, l, hid)).astype(np.float32)
    return x, ws, bs, mask, g, be, cot


def _mlp_inputs(seed, b=4, l=19, hid=64, ff=256):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(b, l, hid)) * 0.5).astype(np.float32)
    w1 = (rng.normal(size=(hid, ff)) * 0.1).astype(np.float32)
    b1 = (rng.normal(size=(ff,)) * 0.05).astype(np.float32)
    w2 = (rng.normal(size=(ff, hid)) * 0.1).astype(np.float32)
    b2 = (rng.normal(size=(hid,)) * 0.05).astype(np.float32)
    g = (rng.normal(size=(hid,)) * 0.1 + 1).astype(np.float32)
    be = (rng.normal(size=(hid,)) * 0.1).astype(np.float32)
    cot = rng.normal(size=(b, l, hid)).astype(np.float32)
    return x, w1, b1, w2, b2, g, be, cot


def _leaves(arrays):
    return [torch.from_numpy(a).requires_grad_() for a in arrays]


def test_attention_block_train_grads_match_jax_pallas(monkeypatch):
    """K12's plain version against JAX's interpreted _attn_bwd_kernel: dx and
    every weight, bias and LayerNorm gradient; atol/rtol 1e-2."""
    monkeypatch.setattr(jfb, "FORCE_PALLAS_BWD", True)
    x, ws, bs, mask, g, be, cot = _attention_inputs(3)

    def loss(x, ws, bs, g, be):
        return (jfb.fused_attention_block_train(x, *ws, *bs, jnp.asarray(mask), 4, g, be) * cot).sum()

    want = jax.grad(loss, argnums=(0, 1, 2, 3, 4))(
        jnp.asarray(x), [jnp.asarray(w) for w in ws], [jnp.asarray(v) for v in bs], jnp.asarray(g), jnp.asarray(be))
    tx, tg, tbe = _leaves([x, g, be])
    tws, tbs = _leaves(ws), _leaves(bs)
    _build.reset_launches()
    out = tfb.fused_attention_block_train(tx, *tws, *tbs, torch.from_numpy(mask), 4, tg, tbe)
    (out * torch.from_numpy(cot)).sum().backward()
    assert _build.LAUNCHES["fused_attention_block_bwd"] == 0  # CPU tensor → plain version
    got = [tx.grad, *[w.grad for w in tws], *[v.grad for v in tbs], tg.grad, tbe.grad]
    for a, b in zip(got, jax.tree_util.tree_leaves(want)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-2, rtol=1e-2)


def test_mlp_block_train_grads_match_jax_pallas(monkeypatch):
    """K11's plain version against JAX's interpreted _mlp_bwd_kernel; atol/rtol 2e-3."""
    monkeypatch.setattr(jfb, "FORCE_PALLAS_BWD", True)
    x, w1, b1, w2, b2, g, be, cot = _mlp_inputs(4)

    def loss(*args):
        return (jfb.fused_mlp_block_train(*args, ff_chunks=2) * cot).sum()

    want = jax.grad(loss, argnums=tuple(range(7)))(*[jnp.asarray(a) for a in (x, w1, b1, w2, b2, g, be)])
    leaves = _leaves([x, w1, b1, w2, b2, g, be])
    _build.reset_launches()
    (tfb.fused_mlp_block_train(*leaves) * torch.from_numpy(cot)).sum().backward()
    assert _build.LAUNCHES["fused_mlp_block_bwd"] == 0
    for t, w in zip(leaves, want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), atol=2e-3, rtol=2e-3)


@pytest.mark.parametrize("half", ["attention", "mlp"])
def test_plain_backward_matches_autograd_of_plain_forward(half):
    """The hand-derived plain backward against torch.autograd of the plain
    forward (f32: the same function, so only summation order differs)."""
    if half == "attention":
        x, ws, bs, mask, g, be, cot = _attention_inputs(7, b=3, l=13)
        leaves = _leaves([x, *ws, *bs, g, be])
        rest = (torch.from_numpy(mask), 4)

        def fwd(fn, t):
            return fn(t[0], *t[1:9], *rest, t[9], t[10])

        fns = (tfa.fused_attention_block, tfb.fused_attention_block_train)
    else:
        x, w1, b1, w2, b2, g, be, cot = _mlp_inputs(8, b=3, l=11)
        leaves = _leaves([x, w1, b1, w2, b2, g, be])

        def fwd(fn, t):
            return fn(*t)

        fns = (tfa.fused_mlp_block, tfb.fused_mlp_block_train)
    grads = []
    for fn in fns:
        for t in leaves:
            t.grad = None
        (fwd(fn, leaves) * torch.from_numpy(cot)).sum().backward()
        grads.append([t.grad.clone() for t in leaves])
    for want, got in zip(*grads):
        torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-5)


@pytest.mark.parametrize("half", ["attention", "mlp"])
def test_save_acc_matches_jax(half):
    """``save_acc`` returns the pre-LN residual sum the JAX forward saves
    (f32 here, where the JAX kernel's compute dtype is f32 too); atol 2e-4."""
    if half == "attention":
        x, ws, bs, mask, g, be, _ = _attention_inputs(9, b=3, l=11)
        j_out, j_acc = jfa.fused_attention_block(jnp.asarray(x), *map(jnp.asarray, ws), *map(jnp.asarray, bs),
                                                 jnp.asarray(mask), 4, jnp.asarray(g), jnp.asarray(be),
                                                 save_acc=True)
        t_out, t_acc = tfa.fused_attention_block(torch.from_numpy(x), *map(torch.from_numpy, ws),
                                                 *map(torch.from_numpy, bs), torch.from_numpy(mask), 4,
                                                 torch.from_numpy(g), torch.from_numpy(be), save_acc=True)
    else:
        args = _mlp_inputs(10, b=3, l=9)[:7]
        j_out, j_acc = jfa.fused_mlp_block(*map(jnp.asarray, args), save_acc=True)
        t_out, t_acc = tfa.fused_mlp_block(*map(torch.from_numpy, args), save_acc=True)
    assert t_acc.dtype == torch.float32 and t_acc.shape == t_out.shape
    np.testing.assert_allclose(t_acc.numpy(), np.asarray(j_acc), atol=2e-4)
    np.testing.assert_allclose(t_out.numpy(), np.asarray(j_out), atol=5e-4)


@pytest.mark.parametrize("name", ["_gelu_grad", "_gelu_grad_poly"])
def test_gelu_grad_matches_jax(name):
    z = np.linspace(-12.0, 12.0, 20001, dtype=np.float32)
    want = np.asarray(getattr(jfb, name)(jnp.asarray(z)))
    got = getattr(tfb, name)(torch.from_numpy(z)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)


def test_gelu_grad_for_follows_dtype():
    assert tfb._gelu_grad_for(torch.bfloat16) is tfb._gelu_grad_poly
    assert tfb._gelu_grad_for(torch.float32) is tfb._gelu_grad


def test_ln_backward_matches_jax():
    rng = np.random.default_rng(11)
    acc = (rng.normal(size=(37, 64)) * 2 + 0.5).astype(np.float32)
    dy = rng.normal(size=(37, 64)).astype(np.float32)
    g = (rng.normal(size=(64,)) * 0.1 + 1).astype(np.float32)
    want = jfb._ln_backward(jnp.asarray(acc), jnp.asarray(dy), jnp.asarray(g), 1e-12)
    got = tfb._ln_backward(torch.from_numpy(acc), torch.from_numpy(dy), torch.from_numpy(g), 1e-12)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=2e-5, rtol=1e-5)


def test_bf16_backward_tracks_f32():
    """In bf16 (what the CUDA kernels compute) the gradients stay close to
    the f32 ones: the casts sit where the TPU kernels' do, and the weight
    gradients return in the weights' dtype."""
    x, ws, bs, mask, g, be, cot = _attention_inputs(12, b=3, l=20)
    grads = {}
    for dt in (torch.float32, torch.bfloat16):
        tx = torch.from_numpy(x).to(dt).requires_grad_()
        tws = [torch.from_numpy(w).to(dt).requires_grad_() for w in ws]
        out = tfb.fused_attention_block_train(tx, *tws, *map(torch.from_numpy, bs), torch.from_numpy(mask), 4,
                                              torch.from_numpy(g), torch.from_numpy(be))
        (out.float() * torch.from_numpy(cot)).sum().backward()
        assert tx.grad.dtype == dt and all(w.grad.dtype == dt for w in tws)
        grads[dt] = [tx.grad.float(), *[w.grad.float() for w in tws]]
    for a, b in zip(grads[torch.bfloat16], grads[torch.float32]):
        cos = torch.nn.functional.cosine_similarity(a.reshape(1, -1), b.reshape(1, -1)).item()
        assert cos > 0.99, cos


def _encoder_grads_jax(cfg_kw, ids, mask, monkeypatch):
    monkeypatch.setattr(jfb, "FORCE_PALLAS_BWD", True)
    m = JaxEncoder(JaxEncoderConfig.tiny(dropout=0.0, **cfg_kw), jnp.float32)
    params = m.init(jax.random.PRNGKey(0), ids, mask)["params"]

    def loss(p):
        out = m.apply({"params": p}, ids, mask)
        return (out * out).sum()

    return params, flax_to_state_dict(jax.grad(loss)(params))


@pytest.mark.parametrize("jax_fused", [False, True])
def test_fused_encoder_training_grads_match_jax(jax_fused, monkeypatch):
    """Encoder-level wiring (counterpart of test_fused_encoder_training_grads_match_flax):
    the port's fused tiny encoder under autograd against the JAX flax encoder
    (unfused) and the JAX fused encoder with its Pallas backward, same params."""
    rng = np.random.default_rng(5)
    ids = rng.integers(2, 900, size=(3, 17)).astype(np.int32)
    mask = np.ones((3, 17), np.float32)
    mask[1, 11:] = 0
    params, want = _encoder_grads_jax({"fused_attention": jax_fused}, ids, mask, monkeypatch)
    tm = TransformerEncoderLM(EncoderConfig.tiny(dropout=0.0, fused_attention=True), torch.float32)
    tm.load_state_dict(flax_to_state_dict(params))
    _build.reset_launches()
    out = tm(torch.from_numpy(ids).long(), torch.from_numpy(mask))
    assert out.grad_fn is not None
    (out * out).sum().backward()
    assert all(v == 0 for v in _build.LAUNCHES.values())
    for name, p in tm.named_parameters():
        assert p.grad is not None, name
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(), atol=1e-2, rtol=1e-2, err_msg=name)


def test_encoder_dropout_request_warns_or_raises():
    """A non-deterministic pass warns once on the fused layers (as the JAX
    package does: their halves apply no dropout) and applies dropout on the
    unfused ones, from the generator it is given; with rate 0 it is the
    deterministic pass."""
    import matchmaker_tpu_torch.models.encoder as enc

    ids, mask = torch.ones(2, 5, dtype=torch.long), torch.ones(2, 5)
    enc._warned_fused_dropout = False
    with pytest.warns(UserWarning, match="dropout is a NO-OP"):
        TransformerEncoderLM(EncoderConfig.tiny(fused_attention=True))(ids, mask, deterministic=False)
    torch.manual_seed(0)
    tm = TransformerEncoderLM(EncoderConfig.tiny())
    for p in tm.parameters():
        torch.nn.init.normal_(p, std=0.2)
    with torch.no_grad():
        base = tm(ids, mask)
        dropped = [tm(ids, mask, deterministic=False, generator=torch.Generator().manual_seed(s)) for s in (1, 1, 2)]
    assert not torch.equal(dropped[0], base) and torch.equal(dropped[0], dropped[1])
    assert not torch.equal(dropped[0], dropped[2])
    tm0 = TransformerEncoderLM(EncoderConfig.tiny(dropout=0.0))
    tm0.load_state_dict(tm.state_dict())
    with torch.no_grad():
        assert torch.equal(tm0(ids, mask, deterministic=False), base)


# weight gradients of one layer: (name, I, J); rows of the four backward shapes
# (64, 200), (32, 30), (256, 200), (16, 77)
WGRADS = [("dWo", 768, 768), ("dWqkv", 768, 2304), ("dW1", 768, 3072), ("dW2", 3072, 768)]
WGRAD_ROWS = {12800: {"dWo": (3, 67), "dW1": (4, 50), "dW2": (4, 50)},
              960: {"dWo": (3, 5), "dW1": (3, 5), "dW2": (3, 5)},
              51200: {"dWo": (3, 267), "dW1": (4, 200), "dW2": (4, 200)},
              1232: {"dWo": (3, 7), "dW1": (4, 5), "dW2": (4, 5)}}


@pytest.mark.parametrize("r", sorted(WGRAD_ROWS))
@pytest.mark.parametrize("name,i,j", WGRADS)
def test_wgrad_plan_splits_rows_in_a_fixed_order(r, name, i, j, monkeypatch):
    """The split plan of a weight gradient at the main path's rows: dWo (36
    output tiles) splits its rows three ways, dW1 and dW2 (144 tiles, one
    more round than 132 SMs) four ways where the rows allow, dWqkv (108
    tiles) not at all; the splits' row-tile ranges cover every row tile once,
    in order, none empty; _wgrad hands the plan to the kernel with an
    (splits, I, J) partial buffer only when it splits."""
    splits, per = tfb.wgrad_plan(r, i, j)
    k_tiles = -(-r // 64)
    assert (splits, per) == WGRAD_ROWS[r].get(name, (1, k_tiles))
    ranges = [(z * per, min(k_tiles, (z + 1) * per)) for z in range(splits)]
    assert ranges[0][0] == 0 and ranges[-1][1] == k_tiles
    assert all(hi - lo >= 4 for lo, hi in ranges) and all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))

    seen = []
    monkeypatch.setattr(_build, "ptr", lambda t: seen.append(tuple(t.shape)) or 0)
    monkeypatch.setattr(_build, "stream", lambda device: 0)
    monkeypatch.setattr(_build, "call", lambda fn, *args: seen.append((fn, *args[4:9])))
    out = tfb._wgrad(torch.zeros(r, i, dtype=torch.bfloat16), torch.zeros(r, j, dtype=torch.bfloat16))
    assert out.shape == (i, j) and out.dtype == torch.float32
    partial = (splits, i, j) if splits > 1 else (i, j)
    assert seen == [(r, i), (r, j), partial, (i, j), ("mm_wg_wgrad", r, i, j, splits, per)]


@pytest.mark.parametrize("half", ["attention", "mlp"])
def test_each_backward_half_is_one_c_call(half, monkeypatch):
    """On the card each half is one call of its C entry point, with as many
    arguments as its ctypes signature, the weight gradients' split plans of
    wgrad_plan, a workspace of the size its _bytes companion reports, and the
    column sums split out of one output vector; the half counts one launch.
    The card itself is faked: this checks the Python side of the call."""
    import contextlib

    b, l, hid, ff, heads = 2, 5, 768, 3072, 12
    m = b * l
    calls, sized = [], []
    monkeypatch.setattr(_build, "check_cuda", lambda *args: None)
    monkeypatch.setattr(_build, "stream", lambda device: 0)
    monkeypatch.setattr(_build, "workspace_bytes", lambda name, *sizes: sized.append((name, *sizes)) or 4096)
    monkeypatch.setattr(_build, "call", lambda name, *args: calls.append((name, args)))
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    tfb._workspace.cache_clear()
    _build.reset_launches()
    bf = torch.bfloat16
    x, dy = torch.zeros(b, l, hid, dtype=bf), torch.zeros(b, l, hid, dtype=bf)
    acc, g = torch.zeros(b, l, hid), torch.ones(hid)
    if half == "attention":
        qkv, attn = torch.zeros(b, l, 3 * hid, dtype=bf), torch.zeros(b, l, hid, dtype=bf)
        out = tfb._attention_block_bwd_cuda(x, torch.zeros(hid, 3 * hid, dtype=bf), torch.zeros(hid, hid, dtype=bf),
                                            torch.ones(b, l), heads, g, dy, (acc, qkv, attn), 1e-12)
        name, plans = "mm_attention_block_bwd", tfb.wgrad_plan(m, hid, hid) + tfb.wgrad_plan(m, hid, 3 * hid)
        want_sizes = (name + "_bytes", b, l, heads, hid, hid, plans[0], plans[2])
        shapes = [(b, l, hid), (hid, 3 * hid), (3 * hid,), (hid, hid), (hid,), (hid,), (hid,)]
    else:
        out = tfb._mlp_block_bwd_cuda(x, torch.zeros(hid, ff, dtype=bf), torch.zeros(ff), torch.zeros(ff, hid, dtype=bf),
                                      g, dy, (acc, torch.zeros(b, l, ff, dtype=bf)), 1e-12)
        name, plans = "mm_mlp_block_bwd", tfb.wgrad_plan(m, ff, hid) + tfb.wgrad_plan(m, hid, ff)
        want_sizes = (name + "_bytes", m, hid, ff, plans[0], plans[2])
        shapes = [(b, l, hid), (hid, ff), (ff,), (ff, hid), (hid,), (hid,), (hid,)]
    assert [c[0] for c in calls] == [name]
    args = calls[0][1]
    assert len(args) == len(_build._SIGNATURES[name])
    assert tuple(args[-5:-1]) == plans
    assert sized == [want_sizes] and len(want_sizes) - 1 == len(_build._SIZE_SIGNATURES[want_sizes[0]])
    assert [tuple(t.shape) for t in out] == shapes
    assert _build.LAUNCHES[f"fused_{half}_block_bwd"] == 1
