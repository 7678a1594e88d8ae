"""Layered YAML configuration system: the port's copy of
``matchmaker_tpu/config.py``.

Behavioral contract with the reference (`matchmaker/utils/config.py:6-81` and
documentation/config_system.md): a run's config is the in-order merge of
multiple YAML files (later files win), followed by a ``--config-overwrites``
string of the form ``"key: value,key2: value2"`` parsed as YAML, followed by an
auto-fill pass that derives ``model_input_type`` / ``token_embedder_type`` from
the model name when they are set to ``"auto"``.

Fresh design on top of that contract: dotted-key overwrites (``a.b: c``),
an immutable-feeling `Config` mapping with attribute access and typed getters,
and deep (recursive) dict merging instead of the reference's shallow update.

PyYAML is imported inside the functions that read or write YAML, never when
this module is imported: a machine without PyYAML can still import the CLIs
and drive them with config dicts.
"""

from __future__ import annotations

import copy
import os
import re
from typing import Any, Dict, Iterable, Mapping, Optional


class ConfigError(KeyError):
    pass


_LOADER = None


def _config_loader():
    """SafeLoader that also resolves `1e-5`-style floats (YAML 1.1 quirk),
    built at first use."""
    global _LOADER
    if _LOADER is None:
        import yaml

        class _ConfigLoader(yaml.SafeLoader):
            pass

        _ConfigLoader.add_implicit_resolver(
            "tag:yaml.org,2002:float",
            re.compile(
                r"""^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+]?[0-9]+)?
                |[-+]?(?:[0-9][0-9_]*)(?:[eE][-+]?[0-9]+)
                |[-+]?\.[0-9_]+(?:[eE][-+]?[0-9]+)?
                |[-+]?\.(?:inf|Inf|INF)
                |\.(?:nan|NaN|NAN))$""",
                re.X,
            ),
            list("-+0123456789."),
        )
        _LOADER = _ConfigLoader
    return _LOADER


def _yaml_load(stream):
    import yaml

    return yaml.load(stream, Loader=_config_loader())


class Config(dict):
    """dict with attribute access and typed convenience getters."""

    def __getattr__(self, name: str) -> Any:
        try:
            v = self[name]
        except KeyError as e:
            raise AttributeError(name) from e
        return Config(v) if isinstance(v, dict) and not isinstance(v, Config) else v

    def get_path(self, dotted: str, default: Any = None) -> Any:
        node: Any = self
        for part in dotted.split("."):
            if not isinstance(node, Mapping) or part not in node:
                return default
            node = node[part]
        return node

    def require(self, key: str) -> Any:
        if key not in self:
            raise ConfigError(f"config key '{key}' is required but missing")
        return self[key]


def _deep_merge(base: Dict[str, Any], extra: Mapping[str, Any]) -> Dict[str, Any]:
    for k, v in extra.items():
        if k in base and isinstance(base[k], dict) and isinstance(v, Mapping):
            _deep_merge(base[k], v)
        else:
            base[k] = copy.deepcopy(v)
    return base


def _set_dotted(target: Dict[str, Any], dotted: str, value: Any) -> None:
    parts = dotted.split(".")
    node = target
    for p in parts[:-1]:
        node = node.setdefault(p, {})
    node[parts[-1]] = value


def _split_overwrites(s: str):
    """Split on commas NOT inside {}/[] so flow-style values survive —
    e.g. ``validation_cont: {tsv: a.tsv, qrels: q.tsv}, loss: margin-mse``
    (the docs/msmarco_runbook.md step-1 command) is two chunks, not four."""
    chunks, depth, start = [], 0, 0
    for i, c in enumerate(s):
        if c in "{[":
            depth += 1
        elif c in "}]":
            depth -= 1
        elif c == "," and depth == 0:
            chunks.append(s[start:i])
            start = i + 1
    chunks.append(s[start:])
    return chunks


def parse_overwrites(overwrites: Optional[str]) -> Dict[str, Any]:
    """Parse ``"k1: v1,k2: v2"`` (reference CLI format). Dotted keys and
    flow-style nested values (``k: {a: 1, b: 2}``) supported."""
    if not overwrites:
        return {}
    out: Dict[str, Any] = {}
    for chunk in _split_overwrites(overwrites):
        chunk = chunk.strip()
        if not chunk:
            continue
        parsed = _yaml_load(chunk)
        if not isinstance(parsed, dict):
            raise ValueError(f"config overwrite '{chunk}' must be 'key: value'")
        for k, v in parsed.items():
            _set_dotted(out, str(k), v)
    return out


# model-name → input pipeline behavior, mirroring the reference's auto-fill
# table (utils/config.py:56-80): cross-encoders consume one concatenated
# sequence, bi-encoders consume independent query/doc sequences, GloVe-era
# models use a plain embedding table.
_CONCATENATED_MODELS = ("bert_cat", "parade", "prettr", "idcm", "maxp", "meanp")
_EMBEDDING_MODELS = (
    "knrm",
    "conv_knrm",
    "matchpyramid",
    "pacrr",
    "co_pacrr",
    "duet",
    "drmm",
    "tk",
    "tkl",
    "tk_sparse",
)


def model_base_name(name: str) -> str:
    """Strip adapter prefixes: ``maxP->bert_cat`` → ``bert_cat``."""
    return name.split("->")[-1].strip().lower()


def auto_fill(config: Dict[str, Any]) -> Dict[str, Any]:
    name = model_base_name(str(config.get("model", "")))
    wrapper = str(config.get("model", "")).split("->")[0].strip().lower() if "->" in str(config.get("model", "")) else ""

    # matches reference _auto_config_info (utils/config.py:56-67): only
    # bert_cat/bert_cls consume one concatenated sequence; everything else —
    # including the chunking models (IDCM/PreTTR/maxP/parade), which split
    # documents internally — reads independent query/doc sequences.
    if config.get("model_input_type", "auto") == "auto":
        if name in ("bert_cat", "bert_cls") and wrapper not in ("maxp", "meanp"):
            config["model_input_type"] = "concatenated"
        else:
            # adapters (maxP->/meanP->) always take independent q/doc inputs
            # and build the concatenated chunk sequences internally
            config["model_input_type"] = "independent"

    if config.get("token_embedder_type", "auto") == "auto":
        if name in _EMBEDDING_MODELS:
            config["token_embedder_type"] = "embedding"
        else:
            config["token_embedder_type"] = "huggingface_bpe"
    return config


def resolve_hub_config(name: str) -> Optional[str]:
    """HF-hub model name (``org/model``) → local config stub path, searched in
    the repo's ``configs/huggingface_modelhub/`` and the cwd's (reference
    utils/config.py:30-36 + config/huggingface_modelhub/)."""
    if os.path.isabs(name) or os.path.exists(name):
        return None
    repo_configs = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "configs")
    for base in (repo_configs, os.path.join(os.getcwd(), "configs"), os.path.join(os.getcwd(), "config")):
        stub = os.path.join(base, "huggingface_modelhub", name + ".yaml")
        if os.path.exists(stub):
            return stub
    return None


def get_config(config_paths: Iterable[str], overwrites: Optional[str] = None) -> Config:
    """Merge YAML files in order (later wins), apply overwrites, auto-fill.
    Paths that don't exist but name a known HF-hub model resolve to the local
    stub in configs/huggingface_modelhub/."""
    merged: Dict[str, Any] = {}
    for path in config_paths:
        if not os.path.exists(path):
            stub = resolve_hub_config(path)
            if stub is None:
                raise FileNotFoundError(
                    f"{path} does not exist locally and is not a known huggingface "
                    "config (add a stub under configs/huggingface_modelhub/)"
                )
            path = stub
        with open(path, "r", encoding="utf-8") as f:
            loaded = _yaml_load(f) or {}
        if not isinstance(loaded, dict):
            raise ValueError(f"config file {path} must contain a mapping")
        _deep_merge(merged, loaded)
    _deep_merge(merged, parse_overwrites(overwrites))
    return Config(auto_fill(merged))


def get_config_single(path: str, overwrites: Optional[str] = None) -> Config:
    return get_config([path], overwrites)


def save_config(config: Mapping[str, Any], path: str) -> None:
    import yaml

    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w", encoding="utf-8") as f:
        yaml.safe_dump(dict(config), f, sort_keys=False)
