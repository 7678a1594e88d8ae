"""Hugging Face checkpoint import on the port (models/hf_import.py), which
reads a local directory without ``transformers``: checkpoints written here
with ``transformers`` (DistilBERT and BERT, ``pytorch_model.bin`` and
``model.safetensors``) import exactly as ``flax_to_state_dict`` of the JAX
package's ``load_hf_encoder``, and the port's encoder on them matches
``transformers``' ``last_hidden_state`` at rtol = atol = 2e-4; the
hand-written safetensors reader and writer against the ``safetensors``
package; the imported tensors in every encoder of a model through
``init_params``, a chunk adapter's inner one too, where JAX's leaves it
random; hub names resolve only to the local cache."""

import dataclasses
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from matchmaker_tpu.models.hf_import import load_hf_encoder as jax_load_hf_encoder
from matchmaker_tpu_torch.data.tokenization import HashBertTokenizer
from matchmaker_tpu_torch.models import get_model, init_params
from matchmaker_tpu_torch.models import hf_import
from matchmaker_tpu_torch.models.encoder import EncoderConfig, TransformerEncoderLM, encoder_config_from_model_name
from matchmaker_tpu_torch.models.weights import flax_to_state_dict

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _hf_model(family):
    import transformers

    torch.manual_seed(0)
    if family == "distilbert":
        cfg = transformers.DistilBertConfig(vocab_size=120, dim=32, n_layers=2, n_heads=4, hidden_dim=64,
                                            max_position_embeddings=64, dropout=0.0, attention_dropout=0.0)
        model = transformers.DistilBertModel(cfg)
    else:
        cfg = transformers.BertConfig(vocab_size=120, hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
                                      intermediate_size=64, max_position_embeddings=64, type_vocab_size=2,
                                      hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
        model = transformers.BertModel(cfg)
    with torch.no_grad():  # LayerNorms off their defaults, so a swapped scale and bias would show
        for name, p in model.named_parameters():
            if "LayerNorm" in name or "layer_norm" in name:
                p.add_(torch.randn(p.shape) * 0.1)
    return model.eval()


@pytest.fixture(scope="module", params=[("distilbert", False), ("distilbert", True), ("bert", False),
                                        ("bert", True)], ids=lambda p: f"{p[0]}-{'safetensors' if p[1] else 'bin'}")
def checkpoint(request, tmp_path_factory):
    family, safe = request.param
    model = _hf_model(family)
    path = str(tmp_path_factory.mktemp(f"{family}_{safe}"))
    model.save_pretrained(path, safe_serialization=safe)
    assert os.path.isfile(os.path.join(path, "model.safetensors" if safe else "pytorch_model.bin"))
    return family, path, model


def test_import_equals_the_jax_import_exactly(checkpoint):
    family, path, _ = checkpoint
    jcfg, jparams = jax_load_hf_encoder(path)
    cfg, state = hf_import.load_hf_encoder(path)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    want = flax_to_state_dict(jparams)
    assert set(state) == set(want)
    for name, t in state.items():
        assert t.dtype == torch.float32 and torch.equal(t, want[name]), name
    assert set(state) == set(TransformerEncoderLM(cfg).state_dict())


def test_imported_encoder_matches_transformers(checkpoint):
    family, path, model = checkpoint
    rng = np.random.default_rng(1)
    ids = rng.integers(5, 120, size=(3, 12))
    mask = np.ones((3, 12), np.int64)
    mask[0, 9:] = 0
    mask[2, 4:] = 0
    ids[mask == 0] = 0
    cfg, state = hf_import.load_hf_encoder(path)
    enc = TransformerEncoderLM(cfg, torch.float32)
    enc.load_state_dict(state, strict=True)
    with torch.no_grad():
        want = model(input_ids=torch.from_numpy(ids), attention_mask=torch.from_numpy(mask)).last_hidden_state
        got = enc(torch.from_numpy(ids), torch.from_numpy(mask).float())
    live = mask.astype(bool)
    np.testing.assert_allclose(got.numpy()[live], want.numpy()[live], rtol=2e-4, atol=2e-4)


def test_init_params_fills_every_encoder_from_the_directory(checkpoint):
    """``bert_pretrained_model: <dir>``: the encoder's size from config.json,
    the tensors in every encoder slot (a chunk adapter's inner one too),
    the heads from the initialisers."""
    _, path, _ = checkpoint
    _, state = hf_import.load_hf_encoder(path)
    for name in ("bert_cat", "maxP->bert_cat", "bert_dot_dualencoder"):
        config = {"model": name, "bert_pretrained_model": path, "use_fp16": False}
        model = get_model(config, HashBertTokenizer(120))
        init_params(model, config, torch.Generator().manual_seed(0))
        sd = model.state_dict()
        slots = [k[: -len("word_embeddings.embedding")] for k in sd if k.endswith("word_embeddings.embedding")]
        assert slots and len(slots) == (2 if name == "bert_dot_dualencoder" else 1)
        for slot in slots:
            for key, t in state.items():
                assert torch.equal(sd[slot + key], t), slot + key
    assert encoder_config_from_model_name({"bert_pretrained_model": path}).hidden_size == 32


def test_jax_init_params_leaves_a_chunk_adapters_inner_encoder_random(tmp_path):
    """A known difference from the reference (ROADMAP §3): JAX's
    ``init_params`` fills only top-level encoder slots, so maxP->bert_cat's
    ``inner.encoder`` keeps its random initialisation there; the port fills
    it from the checkpoint. Everything else in the two parameter sets has
    the same names."""
    from matchmaker_tpu.data.tokenization import HashBertTokenizer as JaxHashBertTokenizer
    from matchmaker_tpu.models import get_model as jax_get_model
    from matchmaker_tpu.models import init_params as jax_init_params

    path = str(tmp_path)
    _hf_model("distilbert").save_pretrained(path)
    _, state = hf_import.load_hf_encoder(path)
    config = {"model": "maxP->bert_cat", "bert_pretrained_model": path, "use_fp16": False, "max_query_length": 8,
              "max_doc_length": 24, "idcm_chunk_size": 8, "idcm_overlap": 2}
    jax_state = flax_to_state_dict(jax_init_params(jax_get_model(config, JaxHashBertTokenizer(120)), config,
                                                   jax.random.PRNGKey(0)))
    port_state = init_params(get_model(config, HashBertTokenizer(120)), config, torch.Generator().manual_seed(0))
    assert set(jax_state) == set(port_state)
    inner = [k for k in port_state if k.startswith("inner.encoder.")]
    assert inner and set(inner) == {"inner.encoder." + k for k in state}
    for key in inner:
        want = state[key[len("inner.encoder."):]]
        assert torch.equal(port_state[key], want), key
        if bool(want.any()):  # the checkpoint's zero biases equal JAX's zero initialisation
            assert not torch.equal(jax_state[key], want), key


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16, torch.int64, torch.uint8])
def test_safetensors_reader_and_writer_match_the_package(tmp_path, dtype):
    from safetensors.torch import load_file, save_file

    g = torch.Generator().manual_seed(2)
    tensors = {"a.weight": (torch.randn(5, 3, generator=g) * 100).to(dtype), "b": torch.arange(7).to(dtype),
               "empty": torch.zeros(0, 4, dtype=dtype), "scalar": torch.tensor(3).to(dtype)}
    save_file(tensors, str(tmp_path / "package.safetensors"), metadata={"format": "pt"})
    hf_import.write_safetensors(str(tmp_path / "ours.safetensors"), tensors)
    for got in (hf_import.read_safetensors(str(tmp_path / "package.safetensors")),
                load_file(str(tmp_path / "ours.safetensors"))):
        assert set(got) == set(tensors)
        for k, t in tensors.items():
            assert got[k].dtype == dtype and got[k].shape == t.shape and torch.equal(got[k], t), k


def test_seeded_checkpoint_round_trips_bit_for_bit(tmp_path):
    """The smoke run's seeded DistilBERT directory, as .bin and as
    .safetensors, imports to the same tensors bit for bit, with a
    ``distilbert.`` prefix stripped."""
    cfg = EncoderConfig(vocab_size=50, hidden_size=16, num_layers=1, num_heads=2, intermediate_size=32,
                        max_position_embeddings=20, type_vocab_size=0)
    config, sd = hf_import.seeded_distilbert_checkpoint(cfg, seed=3)
    hf_import.save_hf_checkpoint(str(tmp_path / "bin"), config, {"distilbert." + k: v for k, v in sd.items()}, False)
    hf_import.save_hf_checkpoint(str(tmp_path / "st"), config, sd, True)
    (c1, s1), (c2, s2) = (hf_import.load_hf_encoder(str(tmp_path / d)) for d in ("bin", "st"))
    assert c1 == c2 and dataclasses.replace(c1, dropout=cfg.dropout) == cfg
    assert set(s1) == set(s2) and all(torch.equal(s1[k], s2[k]) for k in s1)
    assert torch.equal(s1["layer_0.attention.query.kernel"], sd["transformer.layer.0.attention.q_lin.weight"].t())


def test_hub_names_resolve_only_to_the_local_cache(tmp_path, monkeypatch):
    name = "someone/some-model"
    monkeypatch.setenv("HF_HUB_CACHE", str(tmp_path))
    assert hf_import.resolve_checkpoint_dir(name) is None and not hf_import.encoder_checkpoint_available(name)
    snap = tmp_path / "models--someone--some-model" / "snapshots" / "abc123"
    snap.mkdir(parents=True)
    (snap / "config.json").write_text(json.dumps({"model_type": "distilbert", "dim": 16, "n_heads": 2}))
    (tmp_path / "models--someone--some-model" / "refs").mkdir()
    (tmp_path / "models--someone--some-model" / "refs" / "main").write_text("abc123")
    assert hf_import.resolve_checkpoint_dir(name) == str(snap)
    assert hf_import.load_hf_encoder_config(name).hidden_size == 16
    assert hf_import.resolve_checkpoint_dir("distilbert-base-uncased") is None


def test_importing_a_checkpoint_loads_no_transformers(tmp_path):
    """The card has no ``transformers``: the import path never touches it."""
    cfg = EncoderConfig(vocab_size=50, hidden_size=16, num_layers=1, num_heads=2, intermediate_size=32,
                        max_position_embeddings=20)
    config, sd = hf_import.seeded_distilbert_checkpoint(cfg, seed=4)
    hf_import.save_hf_checkpoint(str(tmp_path), config, sd, True)
    code = ("import sys; from matchmaker_tpu_torch.models import get_model, init_params; "
            "from matchmaker_tpu_torch.data.tokenization import HashBertTokenizer; import torch; "
            f"c = {{'model': 'bert_cat', 'bert_pretrained_model': {str(tmp_path)!r}}}; "
            "init_params(get_model(c, HashBertTokenizer(50)), c, torch.Generator()); "
            "assert 'transformers' not in sys.modules, 'transformers was imported'")
    subprocess.run([sys.executable, "-c", code], check=True, cwd=REPO, timeout=120)
