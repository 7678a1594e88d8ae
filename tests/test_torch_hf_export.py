"""The port's Hugging Face export and run fusion against the JAX package on
the CPU.

``utils/hf_export.py``: a tiny DistilBERT-layout and a BERT-layout encoder
(with token types) from one set of JAX-initialised parameters, exported by
JAX's ``export_to_huggingface`` (through ``transformers``) and by the
port's (no ``transformers``) from the same weights through
``flax_to_state_dict``: every tensor of the port's ``model.safetensors``
equal to JAX's export's bit for bit, JAX's only other tensors the ones the
port's ``export-info.json`` lists as missing (BERT's pooler, which
``transformers`` initialises at random), the same ``head_weights.npz`` and
the architecture's ``config.json`` fields; re-reading the port's folder
through ``models/hf_import.py`` gives the encoder's tensors bit for bit.

``utils/ensemble.py``: ``fuse_runs`` (RRF and score average) on
tests/test_utils_tools.py's runs, written by both packages'
``save_sorted_results`` and by both CLIs, byte for byte."""

import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from matchmaker_tpu_torch.models.hf_import import load_hf_encoder, read_safetensors
from matchmaker_tpu_torch.models.weights import flax_to_state_dict
from tests._torch_threads import one_torch_thread  # noqa: F401  (autouse)


def _params(type_vocab_size):
    from matchmaker_tpu.models.bert_dot import BertDot as JaxBertDot
    from matchmaker_tpu.models.encoder import EncoderConfig as JaxEncoderConfig

    cfg = JaxEncoderConfig(vocab_size=120, hidden_size=32, num_layers=2, num_heads=4, intermediate_size=64,
                           max_position_embeddings=64, type_vocab_size=type_vocab_size)
    model = JaxBertDot(encoder_cfg=cfg, compute_dtype=jnp.float32)
    ids = np.ones((2, 10), np.int32)
    params = model.init(jax.random.PRNGKey(0), {"query_ids": ids, "query_mask": np.ones((2, 10), np.float32),
                                                "doc_ids": ids, "doc_mask": np.ones((2, 10), np.float32)})["params"]
    # a head beside the encoder, as BERT_CAT's score layer
    params = dict(params, score_layer={"kernel": jnp.asarray(np.random.default_rng(1).normal(size=(32, 1)),
                                                             jnp.float32)})
    return cfg, params


@pytest.mark.parametrize("model_type,type_vocab_size", [("distilbert", 0), ("bert", 2)])
def test_hf_export_equals_jax_export(tmp_path, model_type, type_vocab_size):
    from matchmaker_tpu.utils.hf_export import export_to_huggingface as jax_export
    from matchmaker_tpu_torch.models.encoder import EncoderConfig
    from matchmaker_tpu_torch.utils.hf_export import export_to_huggingface

    jcfg, params = _params(type_vocab_size)
    cfg = EncoderConfig(**{k: getattr(jcfg, k) for k in ("vocab_size", "hidden_size", "num_layers", "num_heads",
                                                         "intermediate_size", "max_position_embeddings",
                                                         "type_vocab_size")})
    jax_dir, port_dir = str(tmp_path / "jax"), str(tmp_path / "port")
    jax_export(params, jcfg, jax_dir, model_type=model_type)
    state = flax_to_state_dict(params)
    assert export_to_huggingface(state, cfg, port_dir, model_type=model_type) == port_dir

    want, got = read_safetensors(os.path.join(jax_dir, "model.safetensors")), \
        read_safetensors(os.path.join(port_dir, "model.safetensors"))
    with open(os.path.join(port_dir, "export-info.json")) as f:
        info = json.load(f)
    with open(os.path.join(jax_dir, "export-info.json")) as f:
        jax_info = json.load(f)
    assert info["unexpected_keys"] == [] == jax_info["unexpected_keys"]
    assert sorted(info["missing_keys"]) == sorted(k for k in jax_info["missing_keys"])
    assert set(want) - set(got) == set(info["missing_keys"]) and set(got) <= set(want)
    for key, value in got.items():
        assert value.dtype == torch.float32
        torch.testing.assert_close(value, want[key], atol=0, rtol=0, msg=key)

    with open(os.path.join(port_dir, "config.json")) as f:
        config = json.load(f)
    with open(os.path.join(jax_dir, "config.json")) as f:
        jax_config = json.load(f)
    fields = ("model_type", "vocab_size", "max_position_embeddings") + (
        ("dim", "n_layers", "n_heads", "hidden_dim") if model_type == "distilbert" else
        ("hidden_size", "num_hidden_layers", "num_attention_heads", "intermediate_size", "type_vocab_size"))
    assert {k: config[k] for k in fields} == {k: jax_config[k] for k in fields}

    with np.load(os.path.join(jax_dir, "head_weights.npz")) as w, \
            np.load(os.path.join(port_dir, "head_weights.npz")) as g:
        assert set(g.files) == set(w.files) == {"score_layer/kernel"}
        np.testing.assert_array_equal(g["score_layer/kernel"], w["score_layer/kernel"])

    enc_cfg, enc = load_hf_encoder(port_dir)
    assert (enc_cfg.hidden_size, enc_cfg.num_layers, enc_cfg.type_vocab_size) == \
        (32, 2, 0 if model_type == "distilbert" else type_vocab_size)
    mine = {k[len("encoder."):]: v for k, v in state.items() if k.startswith("encoder.")}
    assert set(enc) == set(mine)
    for key, value in enc.items():
        torch.testing.assert_close(value, mine[key], atol=0, rtol=0, msg=key)


def test_hf_export_needs_an_encoder(tmp_path):
    from matchmaker_tpu_torch.models.encoder import EncoderConfig
    from matchmaker_tpu_torch.utils.hf_export import export_to_huggingface

    with pytest.raises(ValueError, match="no encoder tower"):
        export_to_huggingface({"score_layer.kernel": torch.zeros(4, 1)}, EncoderConfig.tiny(), str(tmp_path))


RUNS = {"rrf": ("q1 d1 1 5.0\nq1 d2 2 4.0\n", "q1 d2 1 9.0\nq1 d3 2 1.0\n"),
        "avg": ("q1 d1 1 10.0\nq1 d2 2 0.0\nq2 d7 1 3.5\n", "q1 d1 1 10.0\nq1 d2 2 0.0\nq2 d7 1 1.0\nq2 d8 2 0.5\n")}


@pytest.mark.parametrize("method", ["rrf", "avg"])
def test_fuse_runs_writes_jax_files(tmp_path, method, monkeypatch):
    from matchmaker_tpu.evaluation import save_sorted_results as jax_save
    from matchmaker_tpu.utils import ensemble as jax_ensemble
    from matchmaker_tpu_torch.evaluation import save_sorted_results
    from matchmaker_tpu_torch.utils import ensemble

    paths = []
    for i, text in enumerate(RUNS[method]):
        paths.append(str(tmp_path / f"run{i}.txt"))
        with open(paths[-1], "w") as f:
            f.write(text)
    fused = ensemble.fuse_runs(paths, method)
    assert fused == jax_ensemble.fuse_runs(paths, method)
    save_sorted_results(fused, str(tmp_path / "port.txt"))
    jax_save(jax_ensemble.fuse_runs(paths, method), str(tmp_path / "jax.txt"))
    outputs = {}
    for name, module in (("port_cli", ensemble), ("jax_cli", jax_ensemble)):
        out = str(tmp_path / f"{name}.txt")
        monkeypatch.setattr(sys, "argv", ["ensemble", "--runs", *paths, "--out", out, "--method", method])
        assert module.main() == 0
        outputs[name] = open(out).read()
    want = open(str(tmp_path / "jax.txt")).read()
    assert open(str(tmp_path / "port.txt")).read() == want == outputs["port_cli"] == outputs["jax_cli"]
    if method == "rrf":
        assert want.splitlines()[0].split()[1] == "d2"  # the document in both runs
