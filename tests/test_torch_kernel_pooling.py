"""The port's kernel-pooling ops, token embedder, sinusoid table and GloVe
loader against the JAX package on the CPU: ops/kernel_pooling.py's values
at rtol = atol = 1e-6 and gradients at 1e-5 (finite at all-zero rows),
``TokenEmbedder`` and ``sinusoidal_positions`` bit for bit, and
``load_glove_embeddings`` equal to JAX's on a file the test writes; the
flax ``nn.Conv`` of modules/conv.py (right-only padding) at 1e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from matchmaker_tpu.models import load_glove_embeddings as jax_load_glove
from matchmaker_tpu.modules import embedder as jembedder
from matchmaker_tpu.ops import kernel_pooling as jkp
from matchmaker_tpu_torch.data.tokenization import Vocabulary
from matchmaker_tpu_torch.models import load_glove_embeddings
from matchmaker_tpu_torch.models.weights import flax_to_state_dict
from matchmaker_tpu_torch.modules import embedder as tembedder
from matchmaker_tpu_torch.modules.conv import SequenceConv
from matchmaker_tpu_torch.ops import kernel_pooling as tkp
from tests._torch_threads import one_torch_thread  # noqa: F401  (autouse)


def _embeddings(seed, b=3, lq=6, ld=11, dim=16):
    """Query and document embeddings with padded (all-zero) rows, one
    document token equal to a query token (an exact match), and masks."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, lq, dim)).astype(np.float32)
    d = rng.normal(size=(b, ld, dim)).astype(np.float32)
    d[:, 2] = q[:, 1]
    q_mask = np.ones((b, lq), np.float32)
    d_mask = np.ones((b, ld), np.float32)
    q_mask[1, 4:] = 0
    d_mask[2, 7:] = 0
    d_mask[0, :] = 0
    return q * q_mask[..., None], d * d_mask[..., None], q_mask, d_mask


@pytest.mark.parametrize("n", [1, 2, 5, 11, 21])
def test_kernel_centres_and_widths_equal(n):
    assert tkp.gaussian_kernel_mus(n) == jkp.gaussian_kernel_mus(n)
    assert tkp.gaussian_kernel_sigmas(n) == jkp.gaussian_kernel_sigmas(n)
    assert tkp.gaussian_kernel_sigmas(n, 0.05) == jkp.gaussian_kernel_sigmas(n, 0.05)


def test_cosine_match_matrix_values_and_gradients():
    """Values at 1e-6; the gradient of a weighted sum at 1e-5 of its largest
    entry (rsqrt(eps) = 1e4 scales it at the all-zero padded rows) and
    finite there, where norm-then-divide would give NaN."""
    q, d, _, _ = _embeddings(0)
    w = np.random.default_rng(1).normal(size=(q.shape[0], q.shape[1], d.shape[1])).astype(np.float32)
    want = np.asarray(jkp.cosine_match_matrix(jnp.asarray(q), jnp.asarray(d)))
    tq, td = torch.from_numpy(q).requires_grad_(), torch.from_numpy(d).requires_grad_()
    got = tkp.cosine_match_matrix(tq, td)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-6, atol=1e-6)
    (got * torch.from_numpy(w)).sum().backward()
    jgq, jgd = jax.grad(lambda a, b: (jkp.cosine_match_matrix(a, b) * w).sum(), argnums=(0, 1))(q, d)
    for g, jg in ((tq.grad, jgq), (td.grad, jgd)):
        assert torch.isfinite(g).all()
        np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=1e-5, atol=1e-5 * float(np.abs(jg).max()))
    assert float(td.grad[0].abs().max()) > 1e3  # an all-zero document: large, finite


@pytest.mark.parametrize("mask_match,alpha,log_scale", [(True, False, 0.01), (False, True, 1.0), (False, False, 1.0),
                                                        (True, True, 0.5)])
def test_kernel_pooling_features_values_and_gradients(mask_match, alpha, log_scale):
    """Both ``mask_match_matrix`` modes, with and without an alpha scaler:
    the activations and the features at 1e-6, the gradients by the match
    matrix and the alpha scaler at 1e-5; an exact match lights the first
    (sigma 1e-4) kernel."""
    q, d, q_mask, d_mask = _embeddings(2)
    n = 11
    mu, sigma = np.asarray(jkp.gaussian_kernel_mus(n), np.float32), np.asarray(jkp.gaussian_kernel_sigmas(n),
                                                                               np.float32)
    a = np.random.default_rng(3).uniform(0.5, 1.5, size=(1, 1, n)).astype(np.float32) if alpha else None
    match = np.asarray(jkp.cosine_match_matrix(jnp.asarray(q), jnp.asarray(d)))

    def jax_fn(m, al):
        return jkp.kernel_pooling_features(m, q_mask, d_mask, mu, sigma, alpha_scaler=al, log_scale=log_scale,
                                           mask_match_matrix=mask_match)

    want = np.asarray(jax_fn(match, a))
    tm = torch.from_numpy(match.copy()).requires_grad_()
    ta = torch.from_numpy(a).requires_grad_() if alpha else None
    got = tkp.kernel_pooling_features(tm, torch.from_numpy(q_mask), torch.from_numpy(d_mask), torch.from_numpy(mu),
                                      torch.from_numpy(sigma), alpha_scaler=ta, log_scale=log_scale,
                                      mask_match_matrix=mask_match)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-6, atol=1e-6)
    acts = tkp.kernel_activations(torch.from_numpy(match), torch.from_numpy(mu), torch.from_numpy(sigma))
    np.testing.assert_allclose(acts.numpy(), np.asarray(jkp.kernel_activations(match, mu, sigma)), rtol=1e-6,
                               atol=1e-6)
    assert float(acts[1, 1, 2, 0]) > 0.99  # the planted exact match
    w = np.linspace(-1, 1, want.size, dtype=np.float32).reshape(want.shape)
    (got * torch.from_numpy(w)).sum().backward()
    grads = jax.grad(lambda m, al: (jax_fn(m, al) * w).sum(), argnums=(0, 1) if alpha else 0)(match, a)
    jgm = grads[0] if alpha else grads
    assert torch.isfinite(tm.grad).all()
    np.testing.assert_allclose(tm.grad.numpy(), np.asarray(jgm), rtol=1e-5, atol=1e-5)
    if alpha:
        np.testing.assert_allclose(ta.grad.numpy(), np.asarray(grads[1]), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("pretrained,trainable", [(False, True), (True, True), (True, False)])
def test_token_embedder_bit_for_bit(pretrained, trainable):
    """The masked lookup from the same table, bit for bit; a pretrained
    matrix becomes the table at init; ``trainable=False`` passes no
    gradient to it."""
    from matchmaker_tpu_torch.models.weights import init_parameters

    rng = np.random.default_rng(4)
    table = rng.normal(size=(50, 8)).astype(np.float32) if pretrained else None
    ids = rng.integers(0, 50, size=(3, 7)).astype(np.int32)
    mask = (rng.uniform(size=(3, 7)) > 0.3).astype(np.float32)
    jm = jembedder.TokenEmbedder(50, 8, pretrained=table, trainable=trainable)
    params = jm.init(jax.random.PRNGKey(0), ids, mask)["params"]
    want = np.asarray(jm.apply({"params": params}, ids, mask))
    tm = tembedder.TokenEmbedder(50, 8, pretrained=table, trainable=trainable)
    init_parameters(tm, torch.Generator().manual_seed(0))
    if pretrained:
        np.testing.assert_array_equal(tm.token_embedding.embedding.detach().numpy(), table)
    else:
        assert abs(float(tm.token_embedding.embedding.detach().std()) - 0.1) < 0.01
    tm.load_state_dict(flax_to_state_dict(params), strict=True)
    got = tm(torch.from_numpy(ids).long(), torch.from_numpy(mask))
    np.testing.assert_array_equal(got.detach().numpy(), want)
    assert got.requires_grad == trainable
    if trainable:
        got.sum().backward()
        assert tm.token_embedding.embedding.grad is not None


@pytest.mark.parametrize("length,dim,offset", [(200, 300, 0), (200, 300, 500), (512, 32, 0), (24, 33, 7)])
def test_sinusoidal_positions_bit_for_bit(length, dim, offset):
    got = tembedder.sinusoidal_positions(length, dim, offset)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, jembedder.sinusoidal_positions(length, dim, offset))


def test_load_glove_embeddings_equals_jax(tmp_path):
    """A text-format file with a wrong-width line and a word outside the
    vocabulary: the same matrix as JAX's (seeded rows for unseen words, PAD
    row zero)."""
    from matchmaker_tpu.data.tokenization import Vocabulary as JaxVocabulary

    words = [f"word{i}" for i in range(30)]
    rng = np.random.default_rng(5)
    path = tmp_path / "glove.txt"
    with open(path, "w") as f:
        for w in words[::2] + ["outside"]:
            f.write(w + " " + " ".join(f"{v:.6f}" for v in rng.normal(size=12)) + "\n")
        f.write("short 1.0 2.0\n")
    got = load_glove_embeddings(str(path), Vocabulary(words), 12)
    want = jax_load_glove(str(path), JaxVocabulary(words), 12)
    assert got.dtype == np.float32 and got.shape == (32, 12)
    np.testing.assert_array_equal(got, want)
    assert not got[0].any()


@pytest.mark.parametrize("width,dtype", [(1, np.float32), (2, np.float32), (3, np.float32), (3, "bfloat16")])
def test_sequence_conv_matches_flax_conv(width, dtype):
    """flax ``nn.Conv`` with padding [(0, n - 1)] on channels-last input
    (a bf16 input promoted to f32 against the f32 kernel, as IDCM's CK
    sampler feeds it): the port's right-padded sum of products, from the
    same kernel (stored (out, in, n)), at 1e-5."""
    import flax.linen as nn

    rng = np.random.default_rng(6)
    x = rng.normal(size=(2, 9, 6)).astype(np.float32)
    jx = jnp.asarray(x, dtype=jnp.bfloat16 if dtype == "bfloat16" else jnp.float32)
    conv = nn.Conv(5, kernel_size=(width,), padding=[(0, width - 1)])
    params = conv.init(jax.random.PRNGKey(1), jx)["params"]
    params = jax.tree_util.tree_map(lambda p: p + 0.1, params)  # a non-zero bias
    want = np.asarray(conv.apply({"params": params}, jx), np.float32)
    tm = SequenceConv(6, 5, width)
    tm.load_state_dict(flax_to_state_dict(params), strict=True)
    assert tm.kernel.shape == (5, 6, width)
    tx = torch.from_numpy(x).to(torch.bfloat16) if dtype == "bfloat16" else torch.from_numpy(x)
    got = tm(tx)
    assert got.dtype == torch.float32 and got.shape == (2, 9, 5)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5, atol=1e-5)
