"""Dense retrieval entry point of the port: encode → index → search.

Counterpart of ``matchmaker_tpu/cli/dense_retrieval.py``, same modes, config
keys and run-folder files:

    encode+index+search : encode the corpus, build the index, search the query sets
    index+search        : reuse the encoded vector blocks of the run folder
    search              : reuse the saved index of the run folder

Extra key: ``device`` (default ``"cuda"``). Weights come from
``trained_model`` (a ``best-model.npz`` or a JAX run's ``best-model.flax``,
or the folder holding one; see training/checkpoints.py); without it the
model starts from seeded random weights.

Every ``faiss_index_type`` of retrieval/indexes.py:build_index is served
(``flat``, ``scann`` binmax or ``tree_ah``, ``ivf``, ``hnsw``,
``streaming`` / ``sharded_ondisk``); a streaming index is the run's
``encoded/`` folder itself, read block by block at search time, and
``search`` mode reloads any of them from the run's ``index/`` folder.

``model: colbert`` serves late interaction: the corpus is encoded into
per-token vectors (``multi_vector_corpus`` is on for ColBERT and ``->``
models), the index defaults to ``mips_per_bin: 1`` and
``mips_tile_rows: 4096`` (YAML keys override), and every query token
searches it for ``colbert_per_token_candidates`` (48) rows, merged by MaxSim
on the device (``colbert_device_merge``, default on) and rescored exactly
from the run's ``encoded/`` folder when ``colbert_rescore_n`` > 0
(retrieval/colbert_search.py).

More than one device (parallel/): the index is built on ``make_mesh()``
over the ``device``: every visible card for ``cuda``, or the one named
(``cuda:1``, ``cpu``). A mesh of one entry takes the unsharded routes; over
more, FlatIndex, IVF and tree-AH shard the corpus (retrieval/indexes.py)
and the encode splits each batch over the cards, one parameter replica a
card. Under a process group (``MATCHMAKER_COORDINATOR`` and its
companions, one process a card, joined first thing) the mesh spans the
processes: each encodes every N-th batch, the primary writes the blocks,
builds and saves the index, which every other process then loads, each
process searches its own shards and the partials merge across processes,
and only the primary writes the run folder.

Usage:
    python -m matchmaker_tpu_torch.cli.dense_retrieval encode+index+search \\
        --config-file cfg.yaml --run-name my_index
"""

from __future__ import annotations

import csv
import os
import sys
import traceback

import torch

from matchmaker_tpu_torch.config import get_config, model_base_name
from matchmaker_tpu_torch.data.tokenization import build_tokenizer
from matchmaker_tpu_torch.evaluation import save_sorted_results
from matchmaker_tpu_torch.experiment import get_parser, prepare_experiment
from matchmaker_tpu_torch.metrics import calculate_metrics_plain, load_qrels, print_metric_summary, unrolled_to_ranked_result
from matchmaker_tpu_torch.models import get_model, init_params
from matchmaker_tpu_torch.obs.perf_monitor import PerformanceMonitor
from matchmaker_tpu_torch.parallel import multihost
from matchmaker_tpu_torch.parallel.mesh import batch_sharding, make_mesh, shard_params
from matchmaker_tpu_torch.parallel.multihost import maybe_initialize_distributed
from matchmaker_tpu_torch.retrieval.colbert_search import TokenVectorStore, colbert_search_queries
from matchmaker_tpu_torch.retrieval.encode import encode_corpus, load_encoded
from matchmaker_tpu_torch.retrieval.indexes import StreamingFlatIndex, build_index
from matchmaker_tpu_torch.retrieval.search import search_queries
from matchmaker_tpu_torch.training.checkpoints import load_state


def make_encode_fn(model, sequence_type: str, mesh=None, replicas=None):
    """(ids, mask) → vectors, without autograd. Over a ``mesh`` of more
    than one distinct device each batch splits over them in contiguous rows
    (parallel/mesh.py:batch_sharding), each encoded by that device's one of
    ``replicas`` (shard_params' order), and the vectors come back on the
    batch's device."""
    split = None if mesh is None else batch_sharding(mesh)
    if split is not None and len(split.devices) > 1 and len(replicas or ()) != len(split.devices):
        raise ValueError(f"{len(split.devices)} mesh devices need as many parameter replicas")

    def encode(ids: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        with torch.inference_mode():
            if split is None or len(split.devices) == 1:
                return model.encode(ids, mask, sequence_type)
            return torch.cat([m.encode(ids[lo:hi].to(d), mask[lo:hi].to(d), sequence_type).to(ids.device)
                              for m, d, (lo, hi) in zip(replicas, split.devices, split.split(ids.shape[0]))
                              if hi > lo])

    return encode


def _trained_weights(path: str):
    try:
        return load_state(path)
    except FileNotFoundError as e:
        raise FileNotFoundError(f"trained_model: {e}") from None


def run(mode: str, config, run_folder: str) -> int:
    perf = PerformanceMonitor.get()
    device = torch.device(config.get("device", "cuda"))
    if multihost.process_count() > 1 and device.type == "cuda":
        device = multihost.rank_device()
    mesh = make_mesh(device=device)
    device = mesh.local_devices[0]
    tokenizer = build_tokenizer(config)
    model = get_model(config, tokenizer)
    seed = config.get("random_seed", 42)
    init_params(model, config, torch.Generator().manual_seed(seed))
    trained_model = config.get("trained_model")
    if trained_model:
        model.load_state_dict(_trained_weights(trained_model))
    else:
        print(f"[dense_retrieval] no trained_model: random weights from seed {seed}")
    model.to(device).eval()
    replicas = shard_params(model, mesh)  # one a distinct device of the mesh

    encode_folder = os.path.join(run_folder, "encoded")
    if "encode" in mode:
        cfg_enc = dict(config)
        cfg_enc["batch_size_inference"] = config.get("collection_batch_size", 128)
        encode_corpus(make_encode_fn(model, "doc_encode", mesh, replicas), cfg_enc, tokenizer, config["collection_tsv"],
                      encode_folder, device, sequence_type="doc")

    colbert = model_base_name(config.get("model", "")) == "colbert"
    index_cfg = dict(config)
    if colbert:
        # the JAX package's ColBERT token-index operating point: per_bin 1
        # and 4096-row tiles (its candidate pool oversamples the per-token k
        # by > 100x); YAML keys still override
        index_cfg.setdefault("mips_per_bin", 1)
        index_cfg.setdefault("mips_tile_rows", 4096)
    index_folder = os.path.join(run_folder, "index")
    indexer = build_index(index_cfg, device, mesh)
    if "index" in mode:
        perf.start_block("indexing")
        if isinstance(indexer, StreamingFlatIndex):
            # the encode folder's blocks on disk are the index
            indexer.encode_folder = encode_folder
            indexer.index_from_folder(encode_folder)
            n_rows = len(indexer.row_ids)
        elif multihost.is_primary():
            vectors, row_ids = load_encoded(encode_folder)
            indexer.prepare(vectors.shape[1])
            indexer.index(row_ids, vectors)
            n_rows = vectors.shape[0]
        perf.stop_block("indexing", n_rows if multihost.is_primary() else 0)
        if multihost.is_primary():
            indexer.save(index_folder)
        multihost.barrier()
        if not multihost.is_primary() and not isinstance(indexer, StreamingFlatIndex):
            indexer.load(index_folder)  # the primary's index state, clusters and all
    else:
        indexer.load(index_folder)

    multi_vector = bool(config.get("multi_vector_corpus", colbert or "->" in config.get("model", "")))
    cfg_q = dict(config)
    cfg_q["batch_size_inference"] = config.get("query_batch_size", 32)
    rescore_n = int(config.get("colbert_rescore_n", 0))
    rescore_store = None
    if colbert and rescore_n > 0 and os.path.isdir(encode_folder):
        rescore_store = TokenVectorStore(encode_folder)
    for name, qset in (config.get("query_sets") or {}).items():
        if colbert:
            # late interaction: per-token candidate search, MaxSim merge, and
            # the optional exact rescore from the stored doc vectors
            results = colbert_search_queries(
                make_encode_fn(model, "query_encode", mesh, replicas), cfg_q, tokenizer, indexer, qset["queries_tsv"],
                top_n=qset.get("top_n", 100), device=device,
                per_token_candidates=config.get("colbert_per_token_candidates", 48),
                rescore_store=rescore_store, rescore_n=rescore_n,
                device_merge=bool(config.get("colbert_device_merge", True)))
        else:
            results = search_queries(make_encode_fn(model, "query_encode", mesh, replicas), cfg_q, tokenizer, indexer,
                                     qset["queries_tsv"], top_n=qset.get("top_n", 100), device=device,
                                     dedup=multi_vector)
        save_sorted_results(results, os.path.join(run_folder, f"{name}-output.txt"))
        if qset.get("qrels") and multihost.is_primary():
            metrics = calculate_metrics_plain(
                unrolled_to_ranked_result(results),
                load_qrels(qset["qrels"]),
                qset.get("binarization_point", 1.0),
            )
            with open(os.path.join(run_folder, f"{name}-metrics.csv"), "w", newline="") as f:
                w = csv.writer(f)
                w.writerow(list(metrics.keys()))
                w.writerow(list(metrics.values()))
            print(f"[{name}]", end=" ")
            print_metric_summary(metrics)

    n_proc = multihost.process_count()
    perf.save_summary(os.path.join(run_folder, "efficiency-metrics.json" if n_proc == 1
                                   else f"efficiency-metrics-p{multihost.process_index()}.json"))
    perf.print_summary()
    return 0


def main() -> int:
    parser = get_parser()
    parser.add_argument("mode", choices=["encode+index+search", "index+search", "search"])
    args = parser.parse_args()
    if args.continue_folder:
        run_folder = args.continue_folder
        config = get_config([os.path.join(run_folder, "config.yaml")] + (args.config_file or []),
                            args.config_overwrites)
        maybe_initialize_distributed(config)
    else:
        config = get_config(args.config_file, args.config_overwrites)
        maybe_initialize_distributed(config)
        run_folder = multihost.on_primary(
            lambda: prepare_experiment(config["expirement_base_path"], args.run_name, config))
    print(f"[matchmaker-tpu-torch] dense retrieval ({args.mode}) run folder: {run_folder}")
    try:
        return run(args.mode, config, run_folder)
    except Exception:
        traceback.print_exc()
        return 1
    finally:
        multihost.shutdown()


if __name__ == "__main__":
    sys.exit(main())
