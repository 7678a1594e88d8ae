#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``matchmaker_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases (any failed check raises, and the script exits non-zero):
1. the card's name and power limit; no CUDA device → exit 1;
2. build the CUDA kernels from ``matchmaker_tpu_torch/csrc``;
3. every kernel against its plain PyTorch version on the card, at the main
   paths' shapes: the encoder halves (bf16 K1/K2 and int8 K10/K9) at
   DistilBERT width for (B, L) = (256, 128), (256, 200), (64, 30); their
   backward kernels (K11, K12) at the training shapes (64, 200) and
   (32, 30), at (256, 200) and at an odd L = 77 with padded keys, every
   gradient compared; at the training rows, each backward product of the
   Hopper GEMM beside torch.matmul of the same shapes, and the attention-core
   backward alone against its plain version and bound; the binmax scan (bf16
   K3, mixed K8, int8 K7), level 2 and unpack on 262,144 x 768 rows and 256
   queries (K7 bit-identical; K3 and K7 beside one torch.matmul /
   torch._int_mm of the product alone; K3 also at ColBERT's token scan,
   8,192 query rows of width 128, per_bin 1, 4096-row tiles; K8 beside
   torch.matmul of the bf16-converted codes); level 2 (K4) bit for bit at
   widths 32 and 128 over the per_bin-8 candidates (256 x 16,384), at
   width 128 over ColBERT's per-token scan of 1.35M token rows (8,192 x
   11,264) and, in phase 5, at width 32 over the 1M-row search's own
   candidates; unpack (K6) exact at (256, 1000), (256, 4000) and (8,192,
   48); each with its device time (kernel durations from torch.profiler),
   its CUDA-event and host time a call, beside K4 torch.topk of the groups
   and beside K6 an empty kernel at its grid; ColBERT's MaxSim (K14), all
   pairs at (Bq, Lq, Bd, Ld, D) = (128, 32, 256, 200, 128), (32, 32, 64,
   200, 128), the single-query rescore shape (1, 32, 64, 128, 128) with
   fill -inf, an odd (7, 30, 21, 77, 128) with dots below -1000, the
   public checkpoint's width (1, 32, 64, 128, 768) and 200 query tokens
   (8, 200, 64, 200, 128), and its gathered form at the ColBERT run's
   batched rescore (256 queries x 32 tokens against their own 64 candidates
   of float16 token rows, 128 slots) (rtol = atol = 1e-4, reruns
   bit-identical); K14's training form (all pairs, each max's doc token
   saved) and the MaxSim backward kernel against plain autograd at the
   ColBERT training shape (32, 30, 64, 200, 128), an odd (7, 30, 21, 77,
   128) with dots below -1000 and a shape with exact ties (the forward at
   rtol = atol = 1e-4, the saved tokens equal to the plain argmax on >=
   99.99 % of (b, l, k) and near ties elsewhere, dq and dd at rtol = atol =
   1e-4 where the tokens agree, ties split evenly, reruns bit-identical);
   the standalone
   attention K13 at (B, L) = (256, 128) and (64, 30), 12 heads x 64, beside
   one scaled_dot_product_attention call; the probes' kernels: the
   attention inner loop K15 (three variants) at (256, 200) and (16, 77) with
   padded keys beside K13 and scaled_dot_product_attention, the int8 product
   K16 (bit-identical) at 16,384 x 768 x 3,072 and M = 1,000 beside
   torch._int_mm, the row-packed MLP K17/K18 (one cluster kernel) at
   (256, 200) and (16, 77) by device time beside K2 and the bf16
   torch.matmul chain; with CUDA-event timings of both and each kernel's
   bound (bytes or operations at the H100's data-sheet rates); at the
   encoder halves' headline
   (256, 128) each launch of K1, K2, K10 and K9 alone (each bf16 product
   with its TFLOP/s beside one torch.addmm call of the same shapes, each
   int8 product with its TOP/s beside one torch._int_mm call on codes of
   the same K-major shapes, the attention core beside one
   scaled_dot_product_attention call, the quantizations, the LayerNorm) and
   K1 and K2 beside their chains of PyTorch calls; and K1, K2, K12 and K11
   at the re-rankers' (B, L) = (16, 230) (a BERT_CAT training batch of 30 +
   200 tokens), (128, 230) (its eval batch), (64, 94) (the maxP / PARADE
   chunks of a training batch), (384, 94) (IDCM's cascade at eval batch
   128: 3 chunks a document), (640, 94) (IDCM's 40 chunks a document at
   batch 16: stage 1's and the full path's pass) and (32, 200) (phase 12's
   list batch: 4 lists of 8 documents), each with its device time and
   bound;
4. the main path, ``cli.dense_retrieval.run("encode+index+search")``, on a
   seeded 16,384-passage collection with a DistilBERT-width BERT_DOT
   (random weights from a seed), searching one query set at top-100 and one
   at top-10 (the latter takes the level-2 tournament): output files, the
   launch count of every kernel in that run, recall against an exact search
   of the same bf16 rows, and a re-encode with the plain versions;
   4b. the int8 serving path through the same CLI: ``encoder_int8`` with an
   int8 index, searched with ``mips_int8_queries: float`` (K8) and with int8
   queries plus ``mips_twostage`` (K7 + rescore): launch counts of K9/K10
   (6 x encode batches) and of the scan kernels, recall against an exact
   search of the int8-encoded rows, their cosine to phase 4's bf16 encode,
   device-only encode psg/s with the int8 halves;
   4c. ColBERT serving through the same CLI on the same collection and
   queries: a DistilBERT-width ``ColBert`` (bf16, compression 128, 8 query
   [MASK]s, random weights from a seed) encodes per-token vectors into a
   binmax token index (per_bin 1, 4096-row tiles), every query token
   searches 48 candidates, the device merges them by MaxSim and K14 rescores
   64 of them exactly: files, token rows and index bytes, launch counts
   against the prediction (K13: none), per-token recall@48 against an exact
   search (>= 0.95) with the misses' causes counted (token_recall_causes),
   the device merge against the host merge, the run's
   scores against the plain exact MaxSim, recall@10 against an exhaustive
   exact MaxSim over all passages (reported), encode psg/s, search QPS and
   device-only per-token search QPS;
5. ``FlatIndex`` search at 1,048,576 x 768 rows, Q = 256, k = 1000 (the
   keep-8/32 level-2 path): recall@1000 against an exact search and QPS;
   5b. the same rows in an int8 ``FlatIndex``, searched by the mixed, the
   int8 + two-stage and the default int8 (K7 alone; recall reported, not
   gated) routes: recall@1000 and QPS;
6. the training path, ``cli.train``'s ``Trainer``: a DistilBERT-width
   BERT_DOT (bf16, fused layers, random weights from a seed) takes 100
   Margin-MSE + in-batch-negative steps of 32 seeded synthetic triples with
   teacher scores (query 30, doc 200 tokens), validates by re-ranking at
   steps 50 and 100, keeps the best checkpoint, runs the test pass and hands
   ``best-model.npz`` to the dense-retrieval CLI; checked: the launch count of
   K1, K2, K11 and K12 against the prediction, a finite loss every step, the
   run-folder files; then one step with the kernels against one with the
   plain versions (loss and every parameter's gradient), a one-batch overfit
   (30 steps halve Margin-MSE), device-only triples/s and a profile of three
   steps;
   6b. ColBERT training through the same Trainer: a DistilBERT-width
   ``ColBert`` (configs/train/defaults.yaml + models/colbert.yaml:
   compression 128, 8 query [MASK]s, in-batch margin-mse over the
   all-pairs MaxSim; bf16, fused layers) takes 30 steps of phase 6's
   triples, validates once and runs the test pass: launch counts against
   the prediction (K14's training form and the backward kernel once a
   step), a finite loss every step, the run-folder files, triples/s through
   the Trainer and device-only, one step with the kernels against one with
   the plain versions (loss within 1e-2; every gradient's cosine >= 0.99
   under Margin-MSE + in-batch KLDivTeacherList), a one-batch overfit (30
   steps halve Margin-MSE);
7. the probes' own path: ``python -m matchmaker_tpu_torch.probes.<name>``'s
   main() for attn_inner (K15), int8_matmul (K16) and mlp_rows (K17/K18) at
   the JAX probes' shapes, the launch counts set to 0 before each and read
   after (every probe kernel launched), their JSON lines in the report;
8. the TAS-Balanced recipe, ``cli/tasb_recipe.py``'s run_recipe with the JAX
   recipe's configuration (mini-lm) cut in scale (``recipe_args``): every
   stage's wall time, the teacher's pairwise accuracy, the cluster count,
   MRR@10 >= 0.2 and Recall@100 >= 0.6 (tests/test_tasb_recipe.py:31-32),
   K14's training form, backward and plain launch and the search's scan
   launched; then the effectiveness check at 1,500 docs, MRR@10 >= 0.5
   (tests/test_effectiveness.py:45);
9. cross-encoder re-ranking and the Margin-MSE loop on the planted corpus
   (data/synthetic.py), DistilBERT width, bf16, fused layers: (a) a seeded
   DistilBERT checkpoint written as ``pytorch_model.bin`` and as a
   hand-written ``model.safetensors``, both imported (models/hf_import.py)
   bit for bit, without ``transformers``; (b) BERT_CAT (ranknet, batch 16,
   query 30 / doc 200) warm-started from it through cli.train's Trainer:
   launch counts of K1, K2, K11 and K12 against the prediction, a finite
   loss every step, the re-ranking run files, one step with the kernels
   against one with the plain versions (loss within 1e-2, every gradient's
   cosine >= 0.99 under a pointwise loss), a one-batch overfit, triples/s;
   (c) cli.score_teacher's score_triples with that run as the teacher over
   the train triples, against the plain versions' scores (cosine >= 0.999,
   max |d| <= 0.1), pairwise accuracy, and pairs/s over the train triples
   repeated to ``rerank_timing_triples``; (d) a BERT_DOT student
   trained with Margin-MSE on that file, its dense retrieval's run files;
   (e) PreTTR, PARADE (tf, 2 aggregator layers, secondary outputs saved),
   maxP->bert_cat and meanP->bert_cat, 10 steps each and the test pass:
   launch counts against the prediction, one eval batch's scores against
   the plain versions';
10. the kernel-pooling family and IDCM on the planted corpus, a vocabulary
   of 400,000 entries (GloVe 6B's size; the corpus's words first) with
   300-d embeddings from a text-format embedding file the phase writes from
   a seed, and documents of 2,000 tokens (the planted document in a random
   chunk of noise-vocabulary filler) for TKL and IDCM: (a) KNRM, Conv-KNRM,
   TK, TK-Sparse (sparsity weight 0.4) and TKL (log saturation) with their
   configs/train/models files, 40 steps of 32 triples each through
   cli.train's Trainer with one validation and the test pass: a finite loss
   every step, no kernel launched, the run files, one batch scored on the
   card and on the CPU from the same weights (cosine >= 0.9999, max |d| <=
   1e-3), the exact-match kernel's activation of each token against itself
   >= 0.99 on the card (the TF32 guard); TK and KNRM also a one-batch
   overfit (30 steps halve the loss) and triples/s device-only; (b) IDCM
   at DistilBERT width (bf16, fused layers, random weights from a seed),
   models/idcm.yaml: stage 1 (``sample_n`` -1, BERT on all 40 chunks, 10
   steps of 16 with MSETeacherPointwisePassages over teacher passage scores
   the phase writes): K1/K2/K11/K12 launches against the prediction, one
   step's gradients against the plain versions' (cosine >= 0.99); stage 2
   (selection training, kldivloss) warm-started from stage 1, writing then
   replaying ``submodel_train_cache_path`` (the replay launches no K1/K2,
   its losses the write run's), ``submodel_validation_cache_path`` written
   and replayed the same way; the cascade re-ranking at eval batch 128 (K1
   and K2 six times a batch, the CK sampler none; one batch's scores
   against the plain versions' at the encoder halves' bar; MRR@10) and the
   full path (``sample_n`` -1, batch 16) over the same documents, each
   one's pairs/s over the tuples repeated to ``idcm_timing_pairs``.

11. the rest of the index layer: (a) ``cli.dense_retrieval.run``
   ("encode+index+search" for the first kind, "index+search" on a copy of
   its encoded blocks for the others, then "search" from the saved index)
   over phase 4's collection and model once per index kind: IVF (64
   lists, 8 probed), ScaNN tree-AH (sqrt N leaves, 100 searched), HNSW (M
   16, efC 80, efSearch 128) and streaming (the encode folder's blocks):
   the run and index files, K1/K2 launches as predicted and no other
   kernel, the reloaded index ranking as the first run,
   recall@100 against the exact f32 search of the stored rows (streaming:
   no miss past a near-tie); (b) at phase 5's 1,048,576 x 768 clustered
   rows, Q 256, k 1000: IVF (2,048 lists, 64 probed: the reference's mean
   list size), tree-AH (1,024 leaves, 100 searched, reorder x1), FlatIndex
   float16 + scan (no miss past a near-tie against the exact search of the
   same bf16-rounded rows), int8 + scan + two-stage (oversample 4, float16
   rescore; recall@1000 >= 0.99 against exact f32) and streaming over
   float16 blocks of 50,000 rows written under build/ (no miss past a
   near-tie against the exact search of the stored rows), each with its
   build seconds, index bytes, recall and QPS, and HNSW on the host at
   32,768 rows (adds/s); (c) each route's state in a port index on the
   CPU: 8 queries' scores within 1e-3 relative and no miss past a 1e-3
   near-tie. The host's int8 codes and tree-AH's residual codes run
   row-parallel on every core (bit for bit the serial ones).
12. the rest of the model zoo and of the losses, in phase 10's directory
   (its planted corpus, 400,000-entry vocabulary and embedding file), run
   after phase 10: (a) PACRR, CO-PACRR (configs/train/models/pacrr.yaml),
   DRMM, MatchPyramid and Duet, 20 steps of 32 triples each through
   cli.train's Trainer with one validation and the test pass: a finite loss
   every step, no kernel launched, the run files, one batch scored on the
   card and on the CPU from the same weights (cosine >= 0.9999, max |d| <=
   1e-3; DRMM's histogram entries that change bin counted, each within 1e-6
   of a bin edge), triples/s device-only, a one-batch overfit (30 steps
   halve RankNet); (b) from a seeded DistilBERT checkpoint directory the
   phase writes: TK over ``bert_vectors`` frozen and trainable (K1/K2
   launches as predicted; frozen, no K11/K12 and no encoder gradient;
   trainable, K11/K12 as often as K1/K2 in training and every gradient's
   cosine >= 0.99 against the plain versions' under a pointwise loss), one
   eval batch against the plain versions, and KNRM over
   ``bert_embedding`` (its table the checkpoint's word embeddings bit for
   bit, no kernel); (c) listwise BERT_DOT on the list sampler (4 lists of
   8 over a candidate run the phase writes) under listnet, lambdarank and
   mrr, 20 steps each through the Trainer: launches as predicted, one
   step's loss (1e-2) and gradients (cosine >= 0.99) against the plain
   versions', lists/s device-only, 30 steps on one list batch putting the
   positive (for mrr, a labelled document) first in >= 90 % of its lists;
   (d) BERT_CAT with the QA heads (batch 16, 30 + 200 tokens) over QA
   triples the phase writes, with and without the uncertainty weighting,
   20 steps each and one validation with QA answer evaluation: launches as
   predicted (the answer walk's forwards counted), one step's loss and
   gradients against the plain versions' (``qa_span_layer`` and
   ``mtl_log_vars`` included), 30 steps on one batch halving the span
   loss, QA EM/F1; (e) (c)'s encoder exported by utils/hf_export.py and
   re-read bit for bit, (a)'s PACRR and DRMM runs fused by RRF.
13. JAX run folders, gradient accumulation, hub teachers, the fused
   effectiveness check and MiniLM's width (phase 3 holds the attention
   cores at head widths 32 and 16, hidden 384, against their plain
   versions at (16, 230), K1/K2/K11/K12 at (128, 30), (128, 200), (8, 30)
   and (8, 200), and bench.py's encoder_int8_mlp mix, K1 + K9, at (1024,
   128)): (a) in phase 4's directory, a seeded DistilBERT-width BERT_DOT
   written as a JAX run folder (``best-model.flax`` by
   ``state_dict_to_flax`` + ``write_flax``) and as a port run
   (``best-model.npz``), both served by cli.dense_retrieval over phase 4's
   collection (run files and encoded rows equal bit for bit); cli.train
   warm-started from the ``.flax`` with ``gradient_accumulation_steps: 4``
   at batch 8 for 40 micro-steps (launches as predicted, a finite loss
   every step, the parameters unchanged bit for bit after micro-steps 1-3),
   and one accumulated update of 4 x 8 triples against one step over the
   32 from the same weights (every parameter's update cosine >= 0.99); (b)
   the ColBERT hub teacher (configs/huggingface_modelhub/) from a seeded
   DistilBERT checkpoint in a temporary ``HF_HUB_CACHE``, the stub's keys
   handed in, teaching a BERT_DOT student with in-batch scoring for 10
   steps (its encoder the checkpoint's bit for bit; K14's all-pairs form
   once a step); (c) phase 8's effectiveness check with the mini encoder
   (4 x 256) through the fused halves, MRR@10 >= 0.5; (d) BERT_CAT at
   cross-encoder/ms-marco-MiniLM-L-6-v2's published widths (6 layers,
   hidden 384, 12 heads of 32, FF 1,536, vocabulary 30,522; seeded
   weights written as a BERT checkpoint) at batch 16 x 230: 10 steps
   through the Trainer (launches as predicted), one eval batch and one
   step's gradients (cosine >= 0.99, pointwise loss) against the plain
   versions, the int8 forward (K10 + K9) on one eval batch against its
   plain versions.
14. more than one device: (a) at phase 5's 1,048,576 x 768 rows, Q 256,
   k 1000, FlatIndex's bf16 binmax, int8 (default), mixed, int8 rescore
   and float16-scan routes over a mesh of four cuda:0 entries (four shards
   of 262,144 rows, views of one upload) against the same route unsharded
   on the same rows: the launches of one sharded search as predicted (one
   scan and one unpack a shard; level 2 where the gate, read on a shard's
   rows, picks it), every row that both return scored alike, the sharded
   search never below the unsharded one rank by rank and every unsharded
   hit it drops scoring no more than its last (scores with their low 14
   mantissa bits cleared; a near tie of 1e-6 of the query's largest
   allowed), recall@1000 against the exact search at phase 5's floors (the
   default int8 route reported), shard 1's scan against its plain version
   (K7 bit for bit), QPS beside the unsharded route's (four shards on one
   card: not a multi-card rate); (b) IVF (2,048 lists, 64 probed) and
   tree-AH over the same mesh on the unsharded IVF's state: recall against
   it >= 0.99, every returned score the row's exact score within 1e-3 of
   the query's largest; (c) two processes on the one card over gloo (the
   backend rule), BERT_DOT at DistilBERT width, a global batch of 32 (16 a
   process), query 30, doc 200, Margin-MSE + in-batch negatives: one step
   against the one-process step on the same global batch (loss within
   1e-2 relative, every parameter's update cosine >= 0.99, phase 13's lr 1
   and Adam eps 1), then 10 steps through the Trainer in each process
   (K1/K2/K11/K12 as predicted in each), the run folder written by the
   primary alone, triples/s (host-paced, two ranks on one card); with two
   cards or more, the same over nccl on two cards ("skipped: one card"
   otherwise).

The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``. Details go to build/chip_smoke.json.
"""

from __future__ import annotations

import contextlib
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

FULL = dict(
    layer_shapes=[(256, 128), (256, 200), (64, 30)],  # (B, L) of the encoder halves
    hid=768, heads=12, ff=3072, n_layers=6, vocab=30522, model_name="distilbert-base-uncased",
    scan_rows=262_144, scan_queries=256, scan_k=1000,
    passages=16_384, queries=256, doc_len=128, top_n=100, top_n_small=10, batch=256,
    scale_rows=1_048_576, scale_k=1000, scale_clusters=1024,
    reps=10,
    bwd_shapes=[(64, 200), (32, 30), (256, 200), (16, 77)],  # (B, L) of the backward kernels
    bwd_reps=5,
    train_batches=100, train_batch=32, train_query_len=30, train_doc_len=200, validate_every=50,
    val_queries=32, val_docs=10, eval_batch=256, dr_passages=2048, dr_queries=64, dr_top_n=10, dr_batch=256,
    overfit_steps=30,
    # K14 all pairs (Bq, Lq, Bd, Ld, D, fill, live dots below -1000): the
    # headline of matchmaker_tpu/ops/pallas_kernels.py:17, the teacher
    # shape, one query's rescore (colbert_rescore_n docs, the store's padded
    # tokens: the gathered form's slots), an odd padded shape, one query's
    # rescore at the public checkpoint's width 768, 200 query tokens (two
    # row tiles)
    maxsim_shapes=[(128, 32, 256, 200, 128, -1000.0, False), (32, 32, 64, 200, 128, -1000.0, False),
                   (1, 32, 64, 128, 128, float("-inf"), False), (7, 30, 21, 77, 128, -1000.0, True),
                   (1, 32, 64, 128, 768, float("-inf"), False), (8, 200, 64, 200, 128, -1000.0, False)],
    # the training form and the backward kernels (Bq, Lq, Bd, Ld, D, fill,
    # live dots below -1000, exact ties): the ColBERT training phase's
    # in-batch shape (the headline), an odd padded shape, exact ties, a
    # ColBERT batch of 128 against its 256 in-batch docs, the public
    # checkpoint's width 768
    maxsim_train_shapes=[(32, 30, 64, 200, 128, -1000.0, False, False), (7, 30, 21, 77, 128, -1000.0, True, False),
                         (4, 30, 16, 200, 128, -1000.0, False, True), (128, 30, 256, 200, 128, -1000.0, False, False),
                         (32, 30, 64, 200, 768, -1000.0, False, False)],
    colbert_train_batches=30,
    # phase 3's sequences past 512: the attention kernels' timed (B, L), the
    # headline first; phase 15: 2,000-token documents whole through BERT_DOT
    # and ColBERT from a checkpoint of 2,048 positions (passages, queries,
    # the CLI's encode batch, the passages held to the plain versions,
    # Trainer steps at a batch of triples, the triples of the plain step)
    long_timed_shapes=[(4, 2048), (8, 1024), (1, 8192), (4, 512)],
    long_positions=2048, long_passages=2048, long_queries=64, long_doc_len=2000, long_encode_batch=64,
    long_plain_docs=8, long_steps=10, long_batch=16, long_grad_rows=4,
    # phase 8: cli/tasb_recipe.py's run_recipe (the JAX recipe's own
    # configuration, mini-lm) cut in scale to fit the time limit, and the
    # effectiveness check at tests/test_effectiveness.py:38-45's scale
    recipe_args=dict(n_docs=20_000, n_train_queries=400, n_eval_queries=100, mlm_steps=300, teacher_epochs=6,
                     tas_batches_per_epoch=100, student_epochs=3),
    effectiveness_args=dict(n_docs=1500, n_train_queries=150, n_eval_queries=20, epochs=6),
    mha_shapes=[(256, 128), (64, 30)],  # (B, L) of K13 at 12 heads x 64
    colbert_token_rows=1_350_000,  # phase 4c's token rows, the per-token search's K4/K6 shapes in phase 3
    colbert_dim=128, colbert_query_len=32, colbert_query_batch=256, colbert_candidates=48, colbert_rescore_n=64,
    colbert_top_n=10, colbert_checked_queries=32,
    # the probes' kernels (K15-K18) at each probe's headline shape and an odd
    # one: K15 (B, L, masked keys), K16 (M, K, N), K17/K18 (B, L)
    probe_attn_shapes=[(256, 200, False), (16, 77, True)],
    probe_int8_shapes=[(16384, 768, 3072), (1000, 768, 3072)],
    probe_mlp_shapes=[(256, 200), (16, 77)],
    # phase 7: each probe's main() with these arguments (the defaults: the
    # JAX probes' own shapes)
    probe_args={"attn_inner": [], "int8_matmul": [], "mlp_rows": []},
    # phase 3: K1, K2, K12 and K11 at the re-rankers' (B, L): a BERT_CAT
    # training batch (16 x (30 + 200)), its eval batch, the maxP / PARADE
    # chunks of a training batch (16 x 4 chunks of 30 + 50 + 2 x 7 tokens),
    # IDCM's (phase 10), phase 12's list batch (4 lists x 8 documents of 200)
    rerank_shapes=[(16, 230), (128, 230), (64, 94), (384, 94), (640, 94), (32, 200)],
    # phase 9: the re-rankers on the planted corpus (data/synthetic.py)
    rerank_batch=16, rerank_query_len=30, rerank_doc_len=200, rerank_steps=40, rerank_validate_every=20,
    rerank_eval_batch=128, rerank_val_queries=32, rerank_val_docs=8, rerank_docs=2048, rerank_other_steps=10,
    student_steps=10, prettr_join=3, chunk_size=50, chunk_overlap=7,
    # phase 9 (c): the teacher-scoring rate over the train triples repeated
    # to at least this many (the parity check scores them once)
    rerank_timing_triples=4096,
    # phase 10: the kernel-pooling family (batch 32, query 30, doc 200, TKL's
    # and IDCM's documents 2,000 tokens) over a vocabulary of GloVe 6B's
    # size, 300-d embeddings (the first pool_glove_rows words in the
    # embedding file, the rest seeded as load_glove_embeddings seeds unseen
    # words); IDCM at DistilBERT width, stage 1 and 2 at batch 16, the
    # cascade's and the full path's rates over the re-ranking tuples
    # repeated to idcm_timing_pairs (the checks score them once)
    pool_steps=40, pool_batch=32, pool_eval_batch=128, pool_val_queries=32, pool_val_docs=8, pool_docs=2048,
    pool_long_words=2000, pool_vocab=400_000, pool_glove_rows=20_000, pool_dim=300, pool_cpu_rows=16,
    idcm_batch=16, idcm_steps=10, idcm_grad_rows=4, idcm_timing_pairs=4096,
    # phase 11 (b): the index routes at scale_rows (IVF at the reference's
    # mean list size: 8.8M rows / 20,000 lists ~ 1M / 2,048), the streaming
    # index's blocks, HNSW on the host at hnsw_rows (65,536 until phase 12
    # came, 32,768 until phase 13 (f) came: its host build, 18.0 s, the
    # phase's longest step, each time cut in half to keep the run's time);
    # (c) the CPU's queries
    scale_ivf_lists=2048, scale_ivf_nprobe=64, scale_ah_leaves=1024, scale_ah_search=100, stream_block_rows=50_000,
    hnsw_rows=16_384, index_cpu_queries=8,
    # phase 12: the classic models over phase 10's vocabulary and embedding
    # file (batch pool_batch), TK over bert_vectors and KNRM over
    # bert_embedding (batch pool_batch), listwise BERT_DOT (list_queries lists
    # of list_size documents, list_candidates a query in the run file),
    # BERT_CAT with QA heads (batch rerank_batch)
    zoo_steps=10, zoo_ctx_steps=10, list_steps=20, list_queries=4, list_size=8, list_candidates=20, qa_steps=20,
    # phase 3: K1, K2, K12 and K11 at the training shapes no other phase
    # times: batch 128 (query 30, doc 200) and phase 13 (a)'s accumulation
    # micro-batch of 8; bench.py's encoder_int8_mlp mix (K1 + K9) at its
    # (B, L); the attention cores at head widths 32 and 16 at phase 13 (d)'s
    # BERT_CAT batch
    train_shapes=[(128, 30), (128, 200), (8, 30), (8, 200)], int8_mlp_mix_shape=(1024, 128),
    head_width_shape=(16, 230),
    # phase 13: (a) the warm start's micro-steps, micro-batch and k; (b) the
    # hub teacher's student steps; (d) MiniLM's BERT_CAT steps; (e)
    # TinyBERT's BERT_DOT steps
    accum_steps=40, accum_batch=8, accum_k=4, hub_steps=10, minilm_steps=10, tinybert_steps=10,
    # phase 13 (f): BERT-large's Trainer steps; the new widths' layers and
    # steps; phase 3's shapes of the new widths (B, L)
    bert_large_steps=10, bert_large_grad_rows=8, width_layers=4, width_steps=3,
    wide_width_shapes=[(32, 200), (256, 128)],
    # phase 14: (a) and (b) over a mesh of multi_shards cuda:0 entries at
    # phase 5's rows; (c) two processes, a global batch of mp_batch, mp_steps
    # steps through the Trainer, and one step on the padded last batch of a
    # file, mp_valid valid rows of the global batch (process 1 holds
    # mp_valid - mp_batch / 2)
    multi_shards=4, mp_batch=32, mp_steps=10, mp_valid=20,
)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def _time_ms(fn, device, reps: int) -> float:
    """Mean ms per call after two warm-up calls (CUDA events on a card)."""
    import torch

    for _ in range(2):
        fn()
    if device.type != "cuda":
        start = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - start) * 1e3 / reps
    torch.cuda.synchronize()
    begin, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    begin.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return begin.elapsed_time(end) / reps


def _kernel_times(prof):
    """(name, device us, launches) of each kernel a torch.profiler window
    recorded. Kernels only: a kernel launched through ctypes is also counted
    as self device time of the CPU range around it (the autograd Function),
    and a GPU user annotation (Optimizer.step) spans kernels of its own."""
    from torch.autograd import DeviceType

    rows = []
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA or getattr(ev, "is_user_annotation", False):
            continue
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(ev, "self_cuda_time_total", 0)
        if dev_us > 0:
            rows.append((ev.key, dev_us, ev.count))
    return rows


def _device_ms(fn, device, reps: int = 100):
    """Device time per call of ``fn``: the durations of the kernels it
    launches, from torch.profiler over ``reps`` calls after two warm-up
    calls. Unlike ``_time_ms`` the host's time between launches does not
    count, so a launch of a few us is measured, not its wrapper. Now and
    then the profiler hands back a window without its kernels: after three
    such windows, ``_graph_ms``. None off the card."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    if device.type != "cuda":
        return None
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        total_us = sum(us for _, us, _ in _kernel_times(prof))
        if total_us > 0:
            return total_us / 1e3 / reps
    return _graph_ms(fn, reps)


def _graph_ms(fn, reps: int = 100):
    """Device time per call of ``fn`` without the profiler: ``reps`` calls
    captured in one CUDA graph on a side stream, one replay timed with CUDA
    events (a replay launches them back to back, with no host in between)."""
    import torch

    graph, side = torch.cuda.CUDAGraph(), torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
        with torch.cuda.graph(graph, stream=side):
            for _ in range(reps):
                fn()
    torch.cuda.current_stream().wait_stream(side)
    graph.replay()
    torch.cuda.synchronize()
    begin, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    begin.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return begin.elapsed_time(end) / reps


def _host_ms(fn, device, reps: int = 100):
    """Host time per call of ``fn`` (the wrapper's checks, allocation and
    launch, not the kernel): the host clock around ``reps`` calls queued
    behind a sleeping kernel, so that no call waits for the card."""
    import torch

    for _ in range(2):
        fn()
    if device.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda._sleep(200_000_000)
    start = time.perf_counter()
    for _ in range(reps):
        fn()
    host = (time.perf_counter() - start) * 1e3 / reps
    if device.type == "cuda":
        torch.cuda.synchronize()
    return host


def _pair_ms(kernel, plain, device, reps, plain_reps=None):
    """Kernel and plain timed in turns (plain, kernel, kernel, plain), the
    plain over ``plain_reps`` calls a turn (default ``reps``)."""
    plain_reps = plain_reps or reps
    p1 = _time_ms(plain, device, plain_reps)
    k1 = _time_ms(kernel, device, reps)
    k2 = _time_ms(kernel, device, reps)
    p2 = _time_ms(plain, device, plain_reps)
    return (k1 + k2) / 2, (p1 + p2) / 2


# H100 SXM data-sheet peaks (dense): the card's memory rate and each input
# type's tensor-core rate, for the least time a kernel's work could take
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bf16": 989e12, "int8": 1979e12, "tf32": 495e12, "f32": 67e12}


def bound(n_bytes, **ops):
    """(bound_ms, bound_by): the larger of the bytes the function must move
    over the memory rate and its operations, by input type, over that
    type's peak rate."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = sum(n / PEAK_OPS_PER_S[kind] for kind, n in ops.items()) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(*tensors):
    """Bytes of tensors (each read or written once); nested tuples and
    lists count their tensors, anything else counts nothing."""
    total = 0
    for t in tensors:
        if isinstance(t, (tuple, list)):
            total += nbytes(*t)
        elif hasattr(t, "element_size"):
            total += t.numel() * t.element_size()
    return total


def _record(entry, shape, kernel, plain, device, reps, headline, bound_of=None):
    """Time kernel and plain at one shape into entry["timings"]; the
    headline shape also gives the entry's "ms" / "plain_ms" and, from
    ``bound_of`` = (bound_ms, bound_by), its bound. The plain version, 10
    to 100 times the kernel's time and only a reference beside it, is timed
    over reps // 5 calls a turn: at ``reps`` it took most of phase 3's time."""
    ms, plain_ms = _pair_ms(kernel, plain, device, reps, plain_reps=max(2, reps // 5))
    timing = {"shape": shape, "ms": ms, "plain_ms": plain_ms}
    if bound_of:
        timing.update(bound_ms=bound_of[0], bound_by=bound_of[1])
    entry.setdefault("timings", []).append(timing)
    print(f"[kernels]   timed {shape}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms"
          + (f", bound {bound_of[0]:.4f} ms ({bound_of[1]})" if bound_of else ""))
    if headline:
        entry.update(ms=ms, plain_ms=plain_ms, timed_shape=shape)
        if bound_of:
            entry.update(bound_ms=bound_of[0], bound_by=bound_of[1])


def _device_beside(entry, kernel, device, headline, reps=100):
    """The device time of ``kernel`` (``_device_ms`` over ``reps`` calls)
    and its multiple of the bound, into the timing _record just wrote and,
    at the headline, into the entry."""
    timing = entry["timings"][-1]
    dev = _device_ms(kernel, device, reps)
    timing.update(device_ms=dev, x_bound=dev / timing["bound_ms"] if dev is not None else None)
    print(f"[kernels]   device {_fmt(dev)}" + (f", {timing['x_bound']:.2f}x bound" if dev is not None else ""))
    if headline:
        entry.update(device_ms=dev, x_bound=timing["x_bound"])


def _split_ties(q, d, dm, fill):
    """(Bq, Lq, Bd) bool: the (b, l, k) whose max among the plain f32 dots
    (reference_maxsim_all_pairs' own product) two doc rows hold that are
    not equal element for element. Autograd through the plain version splits
    the gradient between them; the kernels and reference_maxsim_bwd give it
    all to the first (ops/maxsim.py), so the two gradients differ there by
    design (a batch of 128 x 256 docs meets about one such tie)."""
    import torch

    from matchmaker_tpu_torch.ops import matmul_f32

    bq, lq, dim = q.shape
    bd, ld, _ = d.shape
    flat = matmul_f32(q.reshape(bq * lq, dim), d.reshape(bd * ld, dim).T).reshape(bq, lq, bd, ld)
    live = dm > 0
    top = torch.where(live[None, None], flat, fill).topk(min(2, ld), dim=-1)
    del flat
    split = torch.zeros(bq, lq, bd, dtype=torch.bool, device=q.device)
    if ld < 2:
        return split
    tie = (top.values[..., 0] == top.values[..., 1]).nonzero().tolist()
    for b, l, k in tie:
        i1, i2 = int(top.indices[b, l, k, 0]), int(top.indices[b, l, k, 1])
        split[b, l, k] = bool(live[k, i1] and live[k, i2]) and not bool((d[k, i1] == d[k, i2]).all())
    return split


def _library_beside(entry, library, device, reps, headline, call):
    """The time of ``library``, the chain of PyTorch calls that computes the
    kernel's function, by CUDA events (``library_ms``) and device time, into
    the timing _record just wrote and, at the headline, into the entry."""
    timing = entry["timings"][-1]
    timing.update(library_ms=_time_ms(library, device, reps), library_device_ms=_device_ms(library, device),
                  library_call=call)
    print(f"[kernels]   library chain ({call}): events {timing['library_ms']:.4f} ms, device "
          f"{_fmt(timing['library_device_ms'])}")
    if headline:
        entry.update(library_ms=timing["library_ms"], library_device_ms=timing["library_device_ms"], library_call=call)


def _library_level2(x, width):
    """The nearest library call to K4: each group's 8 largest values and
    their offsets, ``torch.topk(x.view(Q, G, w), 8)``, with ties in no set
    order and nothing packed (a yardstick; the port never calls it)."""
    import torch

    return torch.topk(x.view(x.shape[0], -1, width), 8, dim=-1)


def level2_timings(mb, packed, width, device, reps):
    """K4 (``mb._level2_reduce``, ``mb`` a checkout's ops.mips_binmax) at one
    shape: its share of output elements bit-identical (int32 view) to
    ``_level2_plain``, its device time (``_device_ms``), the CUDA-event time
    over back-to-back calls (``_time_ms``: the wrapper's per-call time when
    the host is the slower), its host time a call, its byte bound, and the
    ``torch.topk`` yardstick's device and event times."""
    import torch
    import torch.nn.functional as F

    x = F.pad(packed, (0, -packed.shape[1] % 1024), value=float("-inf"))  # _level2_reduce's own padding
    got = mb._level2_reduce(packed, width)
    want = mb._level2_plain(x, width)
    fin = torch.isfinite(want)
    rec = {"shape": [*packed.shape, width],
           "identical": float((got.view(torch.int32) == want.view(torch.int32)).float().mean()),
           "max_abs_err": float((got - want)[fin].abs().max()) if bool(fin.any()) else 0.0}
    del want, fin

    def kernel():
        return mb._level2_reduce(packed, width)

    rec.update(device_ms=_device_ms(kernel, device), ms=_time_ms(kernel, device, reps),
               host_ms=_host_ms(kernel, device),
               library_device_ms=_device_ms(lambda: _library_level2(x, width), device),
               library_ms=_time_ms(lambda: _library_level2(x, width), device, reps))
    rec["bound_ms"], rec["bound_by"] = bound(nbytes(packed, got))
    return rec


def unpack_timings(mb, build, top, pos, tile, per_bin, level2, device, reps):
    """K6 (``mb.unpack_candidates``; ``build`` the checkout's ops._build) on
    selected candidates at one shape: ids equal to ``_unpack_plain``'s and
    values bit for bit, its device, event and host times, its byte bound,
    and, where the checkout has ``mm_unpack_floor``, the device time of an
    empty kernel at K6's grid: the floor the card gives a launch there."""
    import torch

    gv, gi = mb.unpack_candidates(top, pos, tile, per_bin, level2)
    wv, wi = mb._unpack_plain(top, pos, tile, per_bin, level2)
    rec = {"shape": list(top.shape), "per_bin": per_bin, "level2": level2,
           "exact": bool(torch.equal(gi, wi) and torch.equal(gv.view(torch.int32), wv.view(torch.int32)))}

    def kernel():
        return mb.unpack_candidates(top, pos, tile, per_bin, level2)

    rec.update(device_ms=_device_ms(kernel, device), ms=_time_ms(kernel, device, reps),
               host_ms=_host_ms(kernel, device), floor_device_ms=None)
    if device.type == "cuda" and "mm_unpack_floor" in build._SIGNATURES:
        rec["floor_device_ms"] = _device_ms(
            lambda: build.call("mm_unpack_floor", top.numel(), build.stream(device)), device)
    rec["bound_ms"], rec["bound_by"] = bound(nbytes(top, pos, gv, gi))
    return rec


def _fmt(ms):
    return "not measured" if ms is None else f"{ms:.4f} ms"


def time_level2(entry, mb, packed, width, device, reps, headline):
    """level2_timings, held bit for bit and recorded beside the plain
    version's time (_record) into ``entry``."""
    import torch.nn.functional as F

    rec = level2_timings(mb, packed, width, device, reps)
    print(f"[kernels] level 2 width={width} over {list(packed.shape)}: identical {rec['identical']:.6f}; device "
          f"{_fmt(rec['device_ms'])}, events {_fmt(rec['ms'])}, host {_fmt(rec['host_ms'])} a call, bound "
          f"{rec['bound_ms']:.4f} ms ({rec['bound_by']}); torch.topk yardstick device "
          f"{_fmt(rec['library_device_ms'])}, events {_fmt(rec['library_ms'])}")
    check(rec["identical"] == 1.0, f"level 2 width {width} over {list(packed.shape)}: {rec['identical']} identical")
    entry["max_abs_err"] = max(entry["max_abs_err"], rec["max_abs_err"])
    x = F.pad(packed, (0, -packed.shape[1] % 1024), value=float("-inf"))
    _record(entry, rec["shape"], lambda: mb._level2_reduce(packed, width), lambda: mb._level2_plain(x, width),
            device, reps, headline, bound_of=(rec["bound_ms"], rec["bound_by"]))
    extra = {key: rec[key] for key in ("device_ms", "host_ms", "library_device_ms", "library_ms")}
    entry["timings"][-1].update(extra)
    if headline:
        entry.update(extra, library_call="torch.topk(x.view(Q, C/w, w), 8, dim=-1): values and int64 offsets, "
                                         "ties unordered, nothing packed")


def time_unpack(entry, mb, build, packed, k, tile, per_bin, level2, device, reps, headline):
    """unpack_timings on the top k of ``packed`` (level-1 or level-2
    candidates), held exact and recorded beside the plain version's time."""
    import torch

    top, pos = torch.topk(packed, k, dim=1)
    rec = unpack_timings(mb, build, top, pos, tile, per_bin, level2, device, reps)
    print(f"[kernels] unpack {list(top.shape)} (per_bin {per_bin}, level 2 {level2}): exact {rec['exact']}; device "
          f"{_fmt(rec['device_ms'])}, events {_fmt(rec['ms'])}, host {_fmt(rec['host_ms'])} a call, bound "
          f"{rec['bound_ms']:.4f} ms ({rec['bound_by']}), empty kernel at its grid {_fmt(rec['floor_device_ms'])}")
    check(rec["exact"], f"unpack at {list(top.shape)}: ids or values differ from the plain version")
    _record(entry, rec["shape"] + [per_bin, level2], lambda: mb.unpack_candidates(top, pos, tile, per_bin, level2),
            lambda: mb._unpack_plain(top, pos, tile, per_bin, level2), device, reps, headline,
            bound_of=(rec["bound_ms"], rec["bound_by"]))
    extra = {key: rec[key] for key in ("device_ms", "host_ms", "floor_device_ms")}
    entry["timings"][-1].update(extra)
    if headline:
        entry.update(extra)


def _attention_ops(b, l, hid, heads):
    """(projection, attention-core) operations of an attention half."""
    m = b * l
    return 2 * m * hid * 3 * hid + 2 * m * hid * hid, 4 * b * heads * l * l * (hid // heads)


def _mlp_bwd_ops(m, hid, ff):
    """Operations of an MLP-half backward (K11) over m rows: the gelu'
    recompute, dW2, dz, dW1 and dx, five M x HID x FF products."""
    return 10 * m * hid * ff


def _rows_close(a, b):
    import torch

    a = a.float().reshape(-1, a.shape[-1])
    b = b.float().reshape(-1, b.shape[-1])
    cos = torch.nn.functional.cosine_similarity(a, b, dim=-1)
    return float(cos.min()), float((a - b).abs().max())


# The int8 halves' plain versions repeat the kernels' rounding step by step,
# so kernel and plain differ only where a rounding flips on a few elements
# (mean |d| <= 3e-6 on an H100). A wrong scale granularity (gelu codes per
# row instead of per row and FF chunk, attention codes per row instead of
# per head group) moves most elements and the mean |d| to >= 1e-3 at this
# width, while the row cosine stays above 0.99998: the mean is the tight bar.
INT8_HALF_MEAN_ABS = 5e-5


def _mean_abs(a, b):
    return float((a.float() - b.float()).abs().mean())


def fresh_perf_monitor() -> None:
    """The CLIs and the Trainer record into a process-wide PerformanceMonitor
    whose blocks add up over every run in the process; each run here starts
    a fresh one, so its efficiency-metrics.json holds its own blocks alone."""
    from matchmaker_tpu_torch.obs.perf_monitor import PerformanceMonitor

    PerformanceMonitor._instance = None


# ---- phase 3: kernels against their plain versions ------------------------

def _layer_params(sz, device, seed):
    import torch

    g = torch.Generator(device=device).manual_seed(seed)
    hid, ff = sz["hid"], sz["ff"]

    def w(rows, cols):
        return (torch.randn(rows, cols, generator=g, device=device) * rows ** -0.5).to(torch.bfloat16)

    def v(n, std, mean=0.0):
        return torch.randn(n, generator=g, device=device) * std + mean

    attn = (w(hid, hid), w(hid, hid), w(hid, hid), w(hid, hid), v(hid, 0.02), v(hid, 0.02), v(hid, 0.02),
            v(hid, 0.02))
    ln1 = (v(hid, 0.1, 1.0), v(hid, 0.1))
    mlp = (w(hid, ff), v(ff, 0.02), w(ff, hid), v(hid, 0.02))
    ln2 = (v(hid, 0.1, 1.0), v(hid, 0.1))
    return attn, ln1, mlp, ln2


def phase_encoder_kernels(sz, device):
    import torch

    from matchmaker_tpu_torch.ops import fused_attention as fa

    attn, ln1, mlp, ln2 = _layer_params(sz, device, seed=11)
    out = {"fused_attention_block": {"max_abs_err": 0.0}, "fused_mlp_block": {"max_abs_err": 0.0}}
    for i, (b, l) in enumerate(sz["layer_shapes"]):
        x, mask, _ = _half_inputs(sz, b, l, device, 100 + i)
        a_args = (*attn, mask, sz["heads"], *ln1)
        m_args = (*mlp, *ln2)
        proj, core = _attention_ops(b, l, sz["hid"], sz["heads"])
        cases = (("fused_attention_block", fa.fused_attention_block, fa.reference_attention_block, a_args,
                  dict(bf16=proj + core)),
                 ("fused_mlp_block", fa.fused_mlp_block, fa.reference_mlp_block, m_args,
                  dict(bf16=4 * b * l * sz["hid"] * sz["ff"])))
        for name, kernel, plain, args, ops in cases:
            got, want = kernel(x, *args), plain(x, *args)
            cos, err = _rows_close(got, want)
            print(f"[kernels] {name} B={b} L={l}: min row cosine {cos:.6f}, max |d| {err:.4g}")
            check(got.shape == x.shape and bool(torch.isfinite(got.float()).all()), f"{name} output at {(b, l)}")
            check(cos >= 0.999 and err <= 0.1, f"{name} vs plain at {(b, l)}: cos {cos}, max |d| {err}")
            out[name]["max_abs_err"] = max(out[name]["max_abs_err"], err)
            _record(out[name], [b, l, sz["hid"]], lambda k=kernel, a=args: k(x, *a),
                    lambda p=plain, a=args: p(x, *a), device, sz["reps"], headline=i == 0,
                    bound_of=bound(nbytes(x, args, got), **ops))
        if i == 0:
            for name, rec in bf16_half_parts(fa, sz, b, l, device, sz["reps"]).items():
                out[name].update(rec)
    return out


def _half_inputs(sz, b, l, device, seed):
    """x (B, L, HID) bf16 and a ragged key mask (B, L), from a seed."""
    import torch

    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn(b, l, sz["hid"], generator=g, device=device).to(torch.bfloat16)
    lengths = torch.randint(max(1, l // 4), l + 1, (b,), generator=g, device=device)
    mask = (torch.arange(l, device=device)[None, :] < lengths[:, None]).float()
    return x, mask, g


# the products of each encoder half (bf16 and int8) in launch order: (name,
# K, N) in units of (hid, ff); the other launches by entry point
_ATTENTION_PRODUCTS = (("QKV", "hid", "3hid"), ("Wo", "hid", "hid"))
_MLP_PRODUCTS = (("W1", "hid", "ff"), ("W2", "ff", "hid"))
HALF_PRODUCTS = {"fused_attention_block": _ATTENTION_PRODUCTS, "fused_mlp_block": _MLP_PRODUCTS,
                 "fused_attention_int8_block": _ATTENTION_PRODUCTS, "fused_mlp_int8_block": _MLP_PRODUCTS}
HALF_OTHER_PARTS = {"mm_attention_core": "attention core", "mm_attention_core_f32": "attention core",
                    "mm_layernorm": "LayerNorm", "mm_layernorm_ld": "LayerNorm"}


def _core_part(rec, sz, b, l, mask, g, device, reps):
    """The attention core's TFLOP/s (QK^T and P.V over all L keys) and one
    scaled_dot_product_attention call on inputs of its shape beside it."""
    import torch

    from matchmaker_tpu_torch.probes import attn_inner as ai

    heads, hid = sz["heads"], sz["hid"]
    ops = 4 * b * heads * l * l * (hid // heads)
    q, k, v = (torch.randn(b, l, hid, generator=g, device=device).to(torch.bfloat16) for _ in range(3))
    lib = _time_ms(lambda: ai.sdpa(q, k, v, mask, heads), device, reps)
    rec.update(tflops=ops / rec["ms"] / 1e9, sdpa_ms=lib, sdpa_tflops=ops / lib / 1e9,
               peak_share=ops / rec["ms"] / 1e9 / (PEAK_OPS_PER_S["bf16"] / 1e12))
    return (f", {rec['tflops']:.1f} TFLOP/s ({100 * rec['peak_share']:.1f} % of 989); "
            f"scaled_dot_product_attention {lib:.4f} ms ({rec['sdpa_tflops']:.1f} TFLOP/s)")


def _library_chains(sz, b, l, x, mask, attn, ln1, mlp, ln2, device, reps):
    """Each bf16 half as a chain of PyTorch calls in bf16 (a yardstick the
    port never calls): K1 addmm (QKV), scaled_dot_product_attention, the
    residual add, addmm (Wo), layer_norm; K2 addmm (W1), gelu, the residual
    add, addmm (W2), layer_norm. Returns {half: ms}."""
    import torch
    import torch.nn.functional as F

    from matchmaker_tpu_torch.probes import attn_inner as ai

    bf, hid, heads, m = torch.bfloat16, sz["hid"], sz["heads"], b * l
    wq, wk, wv, wo, bq, bk, bv, bo = attn
    wqkv, bqkv = torch.cat([wq, wk, wv], dim=1), torch.cat([bq, bk, bv]).to(bf)
    w1, b1, w2, b2 = mlp
    x2 = x.reshape(m, hid)
    g1, be1, g2, be2 = (t.to(bf) for t in (*ln1, *ln2))
    bo, b1, b2 = bo.to(bf), b1.to(bf), b2.to(bf)

    def attention():
        q, k, v = torch.addmm(bqkv, x2, wqkv).view(b, l, 3 * hid).chunk(3, dim=-1)
        a = ai.sdpa(q, k, v, mask, heads).reshape(m, hid)
        return F.layer_norm(torch.addmm(x2 + bo, a, wo), (hid,), g1, be1)

    def mlp_half():
        h = F.gelu(torch.addmm(b1, x2, w1))
        return F.layer_norm(torch.addmm(x2 + b2, h, w2), (hid,), g2, be2)

    return {"fused_attention_block": _time_ms(attention, device, reps),
            "fused_mlp_block": _time_ms(mlp_half, device, reps)}


def bf16_half_parts(fa, sz, b, l, device, reps, seed=11):
    """Where K1's and K2's time goes at (B, L): each launch alone (see
    _launch_parts_ms), each product's TFLOP/s against the card's 989 with
    one torch.addmm call of the same shapes beside it, the attention core
    beside one scaled_dot_product_attention call, and the whole half beside
    its chain of PyTorch calls (library_chain_ms); yardsticks the port never
    calls. ``fa`` is a checkout's ``ops.fused_attention``; K1 runs through
    the encoder's packed entry."""
    import torch

    attn, ln1, mlp, ln2 = _layer_params(sz, device, seed)
    x, mask, g = _half_inputs(sz, b, l, device, 200)
    wq, wk, wv, wo, bq, bk, bv, bo = attn
    wqkv, bqkv = torch.cat([wq, wk, wv], dim=1), torch.cat([bq, bk, bv])
    heads, m = sz["heads"], b * l
    halves = {"fused_attention_block": lambda: fa.fused_attention_block_qkv(x, wqkv, bqkv, wo, bo, mask, heads,
                                                                            *ln1),
              "fused_mlp_block": lambda: fa.fused_mlp_block(x, *mlp, *ln2)}
    chains = _library_chains(sz, b, l, x, mask, attn, ln1, mlp, ln2, device, reps) if device.type == "cuda" else {}
    dims = {"hid": sz["hid"], "3hid": 3 * sz["hid"], "ff": sz["ff"]}
    out = {}
    for name, fn in halves.items():
        launches, total = _launch_parts_ms(fn, device, reps)
        products, parts = list(HALF_PRODUCTS[name]), []
        for entry, ms in launches:
            rec, note = {"entry": entry, "ms": ms}, ""
            if "gemm" in entry:
                label, k, n = products.pop(0)
                k, n = dims[k], dims[n]
                a = torch.randn(m, k, generator=g, device=device).to(torch.bfloat16)
                w = (torch.randn(k, n, generator=g, device=device) * k ** -0.5).to(torch.bfloat16)
                bias = torch.zeros(n, device=device, dtype=torch.bfloat16)
                lib = _time_ms(lambda: torch.addmm(bias, a, w), device, reps)
                ops = 2 * m * k * n
                rec.update(part=f"{label} product ({m} x {k} x {n})", tflops=ops / ms / 1e9, addmm_ms=lib,
                           addmm_tflops=ops / lib / 1e9, peak_share=ops / ms / 1e9 / (PEAK_OPS_PER_S["bf16"] / 1e12))
                note = (f", {rec['tflops']:.1f} TFLOP/s ({100 * rec['peak_share']:.1f} % of 989); torch.addmm "
                        f"{lib:.4f} ms ({rec['addmm_tflops']:.1f} TFLOP/s)")
            else:
                rec["part"] = HALF_OTHER_PARTS.get(entry, entry)
                if rec["part"] == "attention core":
                    note = _core_part(rec, sz, b, l, mask, g, device, reps)
            parts.append(rec)
            print(f"[kernels]   {name} part {rec['part']} ({entry}): {ms:.4f} ms{note}")
        out[name] = {"parts": parts, "parts_total_ms": total}
        if name in chains:
            out[name]["library_chain_ms"] = chains[name]
        print(f"[kernels]   {name} at {(b, l)}: {total:.4f} ms a call, {sum(r['ms'] for r in parts):.4f} ms in "
              f"its {len(parts)} launches" + (f"; PyTorch chain {chains[name]:.4f} ms" if name in chains else ""))
    return out


def grads_close(got, want, scale_of=None):
    """Per-tensor check of a backward kernel's gradients against the plain
    version's: cosine >= 0.999 and max |d| <= 2e-2 * max |plain| (f32 sums
    over up to 51,200 rows in another order, bf16 rounding of dz/dq/dk/dv at
    the same points). A gradient that is zero in exact arithmetic holds only
    rounding noise; ``scale_of`` names the gradient whose size bounds it.
    Returns the largest max |d| over the tensors."""
    import torch

    worst = 0.0
    for name, g in got.items():
        a, b = g.float().reshape(-1), want[name].float().reshape(-1)
        err = float((a - b).abs().max())
        worst = max(worst, err)
        if scale_of and name in scale_of:
            ref = float(want[scale_of[name]].float().abs().max())
            check(err <= 2e-2 * ref, f"{name}: max |d| {err} vs {ref} (a zero gradient's noise)")
            continue
        cos = float(torch.nn.functional.cosine_similarity(a, b, dim=0))
        check(cos >= 0.999 and err <= 2e-2 * float(b.abs().max()),
              f"{name}: cosine {cos}, max |d| {err}, max |plain| {float(b.abs().max())}")
    return worst


_ATTN_GRADS = ("dx", "dwq", "dwk", "dwv", "dwo", "dbq", "dbk", "dbv", "dbo", "dg", "dbe")
_MLP_GRADS = ("dx", "dw1", "db1", "dw2", "db2", "dg", "dbe")


def _zero_attention_grads(l):
    """The attention gradients that are zero in exact arithmetic, each with
    the gradient whose size bounds its rounding noise: the key bias always
    (each softmax row's gradient sums to zero); with one key (L = 1) the
    softmax is constant, so all of dq and dk."""
    if l == 1:
        return {"dwq": "dwv", "dwk": "dwv", "dbq": "dbv", "dbk": "dbv"}
    return {"dbk": "dbq"}


def _named_attention_grads(dx, dwqkv, dbqkv, dwo, dbo, dg, dbe):
    out = dict(dx=dx, dwo=dwo, dbo=dbo, dg=dg, dbe=dbe)
    for i, n in enumerate("qkv"):
        out[f"dw{n}"] = dwqkv.chunk(3, dim=1)[i]
        out[f"db{n}"] = dbqkv.chunk(3)[i]
    return out


def phase_backward_kernels(sz, device):
    """K12 and K11 against their plain versions on the same inputs: the
    kernels after the K1/K2 training forward, the plain backward after the
    plain forward."""
    import torch

    from matchmaker_tpu_torch.ops import fused_attention as fa
    from matchmaker_tpu_torch.ops import fused_backward as fb

    attn, ln1, mlp, ln2 = _layer_params(sz, device, seed=13)
    wq, wk, wv, wo, bq, bk, bv, bo = attn
    wqkv, bqkv = torch.cat([wq, wk, wv], dim=1), torch.cat([bq, bk, bv])
    heads = sz["heads"]
    out = {"fused_attention_block_bwd": {"max_abs_err": 0.0}, "fused_mlp_block_bwd": {"max_abs_err": 0.0}}
    for i, (b, l) in enumerate(sz["bwd_shapes"]):
        g = torch.Generator(device=device).manual_seed(200 + i)
        x = torch.randn(b, l, sz["hid"], generator=g, device=device).to(torch.bfloat16)
        dy = torch.randn(b, l, sz["hid"], generator=g, device=device).to(torch.bfloat16)
        lengths = torch.randint(max(1, l // 4), l + 1, (b,), generator=g, device=device)
        mask = (torch.arange(l, device=device)[None, :] < lengths[:, None]).float()
        _, a_saved = fb.attention_block_fwd(x, wqkv, bqkv, wo, bo, mask, heads, *ln1)
        _, a_acc = fa.reference_attention_block(x, *attn, mask, heads, *ln1, save_acc=True)
        _, m_saved = fb.mlp_block_fwd(x, *mlp, *ln2)
        _, m_acc = fa.reference_mlp_block(x, *mlp, *ln2, save_acc=True)
        w1, b1, w2, _ = mlp
        cases = (
            ("fused_attention_block_bwd",
             lambda: fb.attention_block_bwd(x, wqkv, bqkv, wo, mask, heads, ln1[0], dy, a_saved),
             lambda: fb.reference_attention_block_bwd(x, wq, wk, wv, wo, bq, bk, bv, mask, heads, ln1[0], dy, a_acc),
             lambda r: _named_attention_grads(*r), lambda r: dict(zip(_ATTN_GRADS, r)), _zero_attention_grads(l)),
            ("fused_mlp_block_bwd",
             lambda: fb.mlp_block_bwd(x, w1, b1, w2, ln2[0], dy, m_saved),
             lambda: fb.reference_mlp_block_bwd(x, w1, b1, w2, ln2[0], dy, m_acc),
             lambda r: dict(zip(_MLP_GRADS, r)), lambda r: dict(zip(_MLP_GRADS, r)), None),
        )
        m, hid, ff = b * l, sz["hid"], sz["ff"]
        proj, core = _attention_ops(b, l, hid, heads)
        # weight and input gradients of every projection (2x the forward's
        # projections), and the attention core's S recompute, dP, dV, dQ, dK
        ops = {"fused_attention_block_bwd": dict(bf16=2 * proj + 5 * core // 2),
               "fused_mlp_block_bwd": dict(bf16=_mlp_bwd_ops(m, hid, ff))}
        inputs = {"fused_attention_block_bwd": (x, wqkv, bqkv, wo, mask, ln1[0], dy, a_saved),
                  "fused_mlp_block_bwd": (x, w1, b1, w2, ln2[0], dy, m_saved)}
        for name, kernel, plain, name_k, name_p, scale_of in cases:
            got, want = name_k(kernel()), name_p(plain())
            check(got["dx"].shape == x.shape and all(bool(torch.isfinite(t).all()) for t in got.values()),
                  f"{name} gradients at {(b, l)}")
            err = grads_close(got, want, scale_of)
            print(f"[kernels] {name} B={b} L={l}: {len(got)} gradients within cosine 0.999, "
                  f"max |d| <= 2e-2 max |plain| (largest |d| {err:.4g})")
            out[name]["max_abs_err"] = max(out[name]["max_abs_err"], err)
            _record(out[name], [b, l, sz["hid"]], kernel, plain, device, sz["bwd_reps"], headline=i == 0,
                    bound_of=bound(nbytes(inputs[name], list(got.values())), **ops[name]))
    return out


def phase_backward_parts(sz, device):
    """K11's and K12's parts alone at the main path's rows (docs (64, 200),
    queries (32, 30)): every product of the Hopper GEMM beside one
    torch.matmul of each of its products (a yardstick; the port never calls
    it), and the attention-core backward against its plain version and its
    bound."""
    import torch

    from matchmaker_tpu_torch.ops import fused_backward as fb

    hid, ff, heads = sz["hid"], sz["ff"], sz["heads"]
    out = {"products": [], "attention_core": []}
    for b, l in sz["bwd_shapes"][:2]:
        m = b * l
        g = torch.Generator(device=device).manual_seed(300 + m)

        def rand(*shape, std=1.0):
            return (torch.randn(*shape, generator=g, device=device) * std).to(torch.bfloat16)

        x, dacc, a = rand(m, hid), rand(m, hid), rand(m, hid)
        dqkv, dz, h = rand(m, 3 * hid), rand(m, ff), rand(m, ff)
        wo, wqkv = rand(hid, hid, std=hid ** -0.5), rand(hid, 3 * hid, std=hid ** -0.5)
        w1, w2 = rand(hid, ff, std=hid ** -0.5), rand(ff, hid, std=ff ** -0.5)
        b1 = torch.randn(ff, generator=g, device=device) * 0.05
        aux = torch.randn(m, hid, generator=g, device=device)
        y = torch.empty((m, hid), dtype=torch.bfloat16, device=device)
        # (name, flops, kernel, the same products through torch.matmul)
        cases = [
            ("K12 da = dacc.Wo^T", 2 * m * hid * hid, lambda: fb._bwd_gemm(dacc, wo, y, fb._EPI_BF16),
             lambda: torch.matmul(dacc, wo.t())),
            ("K12 dx = dqkv.Wqkv^T + dacc", 2 * m * hid * 3 * hid,
             lambda: fb._bwd_gemm(dqkv, wqkv, y, fb._EPI_RESID_BF16, aux=aux), lambda: torch.matmul(dqkv, wqkv.t())),
            ("K12 dWo = a^T.dacc", 2 * m * hid * hid, lambda: fb._wgrad(a, dacc), lambda: torch.matmul(a.t(), dacc)),
            ("K12 dWqkv = x^T.dqkv", 2 * m * hid * 3 * hid, lambda: fb._wgrad(x, dqkv),
             lambda: torch.matmul(x.t(), dqkv)),
            ("K11 dz = (dacc.W2^T) * gelu'(x.W1 + b1)", 4 * m * hid * ff, lambda: fb._gelu_dz(x, w1, b1, dacc, w2),
             lambda: (torch.matmul(dacc, w2.t()), torch.matmul(x, w1))),
            ("K11 dx = dz.W1^T + dacc", 2 * m * hid * ff, lambda: fb._bwd_gemm(dz, w1, y, fb._EPI_RESID_BF16, aux=aux),
             lambda: torch.matmul(dz, w1.t())),
            ("K11 dW2 = h^T.dacc", 2 * m * hid * ff, lambda: fb._wgrad(h, dacc), lambda: torch.matmul(h.t(), dacc)),
            ("K11 dW1 = x^T.dz", 2 * m * hid * ff, lambda: fb._wgrad(x, dz), lambda: torch.matmul(x.t(), dz)),
        ]
        for name, flops, kernel, library in cases if device.type == "cuda" else ():  # card-only wrappers
            ms, lib_ms = _pair_ms(kernel, library, device, sz["reps"])
            rec = {"product": name, "rows": m, "ms": ms, "tflops": flops / ms / 1e9, "matmul_ms": lib_ms,
                   "matmul_tflops": flops / lib_ms / 1e9}
            out["products"].append(rec)
            print(f"[kernels] backward product {name}, M={m}: {ms:.4f} ms ({rec['tflops']:.1f} TFLOP/s); "
                  f"torch.matmul {lib_ms:.4f} ms ({rec['matmul_tflops']:.1f} TFLOP/s)")

        # the attention core alone, at the half's shapes
        d = hid // heads
        qkv, da = rand(b, l, 3 * hid), rand(b, l, hid)
        lengths = torch.randint(max(1, l // 4), l + 1, (b,), generator=g, device=device)
        mask = (torch.arange(l, device=device)[None, :] < lengths[:, None]).float()
        q, k, v = (t.reshape(b, l, heads, d).transpose(1, 2) for t in qkv.chunk(3, dim=-1))
        dah = da.reshape(b, l, heads, d).transpose(1, 2)
        got = fb.attention_core_bwd(qkv, mask, da, heads)
        want = torch.cat([t.transpose(1, 2).reshape(b, l, hid)
                          for t in fb._attention_core_plain(q, k, v, dah, mask, d ** -0.5)[1:]], dim=-1)
        err = grads_close(dict(zip(("dq", "dk", "dv"), got.chunk(3, dim=-1))),
                          dict(zip(("dq", "dk", "dv"), want.chunk(3, dim=-1))))
        ms, plain_ms = _pair_ms(lambda: fb.attention_core_bwd(qkv, mask, da, heads),
                                lambda: fb._attention_core_plain(q, k, v, dah, mask, d ** -0.5), device, sz["reps"])
        flops = 10 * b * heads * l * l * d  # S, dP, dV, dQ, dK
        bound_ms, bound_by = bound(nbytes(qkv, mask, da, got), bf16=flops)
        rec = {"shape": [b, l, hid], "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
               "tflops": flops / ms / 1e9, "max_abs_err": err}
        out["attention_core"].append(rec)
        print(f"[kernels] attention-core backward B={b} L={l}: {ms:.4f} ms ({rec['tflops']:.1f} TFLOP/s of its five "
              f"products), plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}); dq/dk/dv within cosine "
              f"0.999 of plain (largest |d| {err:.4g})")
    return out


def _clustered(n, d, n_clusters, device, seed, n_queries):
    """Normalised clustered rows in contiguous clusters and queries near
    random rows (the recipe of tests/test_binmax_recall.py)."""
    import torch

    g = torch.Generator(device=device).manual_seed(seed)
    centers = torch.randn(n_clusters, d, generator=g, device=device)
    centers = centers / centers.norm(dim=1, keepdim=True)
    assign = torch.sort(torch.randint(0, n_clusters, (n,), generator=g, device=device)).values
    rows = centers[assign] + 0.35 * torch.randn(n, d, generator=g, device=device)
    rows = rows / rows.norm(dim=1, keepdim=True)
    q = rows[torch.randint(0, n, (n_queries,), generator=g, device=device)]
    q = q + 0.05 * torch.randn(n_queries, d, generator=g, device=device)
    return rows, q / q.norm(dim=1, keepdim=True)


def _overlap(a, b):
    k = a.shape[1]
    return float(np.mean([len(set(x) & set(y)) / k for x, y in zip(a.tolist(), b.tolist())]))


def colbert_scan_check(out, sz, device):
    """K3 at ColBERT's token scan: 8,192 query rows (256 queries x 32
    tokens) of width colbert_dim over the phase's rows, per_bin 1,
    4096-row tiles, n_valid mid-bin: >= 99.9 % identical candidates against
    the plain version (run in 1,024-row query chunks), and both timed. Then
    K4 (width 128) and K6 (the top colbert_candidates) at ColBERT's
    per-token search over colbert_token_rows rows (the phase 4c index's
    1.35M): on the scan's own output, bit for bit against their plain
    versions, timed on the card (time_level2, time_unpack)."""
    import torch
    import torch.nn.functional as F

    from matchmaker_tpu_torch.ops import _build
    from matchmaker_tpu_torch.ops import mips_binmax as mb

    entry = out["binmax_candidates"]
    n, tile, dim = sz["scan_rows"], 4096, sz["colbert_dim"]
    n_q = sz["colbert_query_batch"] * sz["colbert_query_len"]
    rows, q = _clustered(n, dim, 256, device, seed=7, n_queries=n_q)
    c, qb = rows.to(torch.bfloat16), q.to(torch.bfloat16)
    del rows
    n_valid = n - 1000

    def plain():
        return torch.cat([mb._scan_plain(qb[i:i + 1024], c, n_valid, 1, tile) for i in range(0, n_q, 1024)])

    got, want = mb.binmax_candidates(qb, c, n_valid=n_valid, per_bin=1, tile_rows=tile), plain()
    pos = torch.arange(got.shape[1], device=device).expand_as(got).contiguous()
    _, gi = mb._unpack_plain(got, pos, tile, 1)
    _, wi = mb._unpack_plain(want, pos, tile, 1)
    share = float((gi == wi).float().mean())
    del pos, gi, wi, want
    print(f"[kernels] binmax scan at ColBERT's token scan ({n_q} query rows x {dim}, per_bin 1, tiles of {tile}): "
          f"identical candidates {share:.6f}")
    check(share >= 0.999, f"binmax scan at ColBERT's shape: {share} identical")
    entry["colbert_shape_identical"] = share
    _record(entry, [n, dim, n_q, 1, tile],
            lambda: mb.binmax_candidates(qb, c, n_valid=n_valid, per_bin=1, tile_rows=tile), plain, device,
            max(2, sz["reps"] // 5), headline=False, bound_of=bound(nbytes(qb, c, got), bf16=2 * n_q * n * dim))
    del c, got

    # the per-token search's level 2 and unpack: the scan writes its
    # candidates -inf-padded to a multiple of 1,024 columns (binmax_candidates
    # with level2), so K4 takes them without a copy
    n_tok = sz["colbert_token_rows"]
    rows, _ = _clustered(n_tok, dim, 1024, device, seed=8, n_queries=1)
    tokens = rows.to(torch.bfloat16)
    del rows
    tokens = F.pad(tokens, (0, 0, 0, -n_tok % mb.padding_grain(tile, 1)))
    packed = mb.binmax_candidates(qb, tokens, n_valid=n_tok, per_bin=1, tile_rows=tile)
    packed = F.pad(packed, (0, -packed.shape[1] % 1024), value=float("-inf"))
    del tokens
    reps = max(2, sz["reps"] // 5)
    time_level2(out["level2_reduce"], mb, packed, mb.L2_WIDE, device, reps, headline=False)
    time_unpack(out["unpack_candidates"], mb, _build, mb._level2_reduce(packed, mb.L2_WIDE),
                sz["colbert_candidates"], tile, 1, mb.L2_WIDE, device, reps, headline=False)


def phase_binmax_kernels(sz, device):
    import torch

    from matchmaker_tpu_torch.ops import _build
    from matchmaker_tpu_torch.ops import mips_binmax as mb

    n, tile = sz["scan_rows"], 2048
    rows, q = _clustered(n, sz["hid"], 256, device, seed=5, n_queries=sz["scan_queries"])
    c, qb = rows.to(torch.bfloat16), q.to(torch.bfloat16)
    out = {"binmax_candidates": {"max_abs_err": 0.0}, "level2_reduce": {"max_abs_err": 0.0},
           "unpack_candidates": {"max_abs_err": 0.0}}
    packed = {}
    for per_bin in (2, 4, 8):
        got = mb.binmax_candidates(qb, c, n_valid=n, per_bin=per_bin)
        want = mb._scan_plain(qb, c, n, per_bin, tile)
        pos = torch.arange(got.shape[1], device=device).expand_as(got).contiguous()
        gv, gi = mb._unpack_plain(got, pos, tile, per_bin)
        wv, wi = mb._unpack_plain(want, pos, tile, per_bin)
        same = gi == wi
        err = float((gv - wv).abs()[same & torch.isfinite(wv)].max())
        share = float(same.float().mean())
        print(f"[kernels] binmax scan per_bin={per_bin}: identical candidates {share:.6f}, max |d| {err:.3g}")
        check(share >= 0.999, f"binmax scan per_bin {per_bin}: {share} identical")
        out["binmax_candidates"]["max_abs_err"] = max(out["binmax_candidates"]["max_abs_err"], err)
        _record(out["binmax_candidates"], [n, sz["hid"], sz["scan_queries"], per_bin],
                lambda pb=per_bin: mb.binmax_candidates(qb, c, n_valid=n, per_bin=pb),
                lambda pb=per_bin: mb._scan_plain(qb, c, n, pb, tile), device, sz["reps"], headline=per_bin == 8,
                bound_of=bound(nbytes(qb, c, got), bf16=2 * qb.shape[0] * n * sz["hid"]))
        packed[per_bin] = got
    # the product alone, a yardstick for the scan's tensor-core work, not a
    # bound: it writes the (Q, N) scores and selects nothing
    product_ms = _time_ms(lambda: torch.matmul(qb, c.T), device, sz["reps"])
    out["binmax_candidates"].update(product_library_ms=product_ms,
                                    product_library_call="torch.matmul(queries, corpus.T), bf16 (the product alone)")
    print(f"[kernels]   product alone: torch.matmul {product_ms:.4f} ms "
          f"({2 * qb.shape[0] * n * sz['hid'] / product_ms / 1e9:.1f} TFLOP/s)")
    colbert_scan_check(out, sz, device)
    # K4 at both widths over the per_bin-8 candidates; K6 on the top k of the
    # width-32 reduction, and on the top 4k of the per_bin-4 candidates (the
    # two-stage route's fetch, no level 2)
    for width in (mb.L2_MID, mb.L2_WIDE):
        time_level2(out["level2_reduce"], mb, packed[8], width, device, sz["reps"], headline=width == mb.L2_MID)
    k = sz["scan_k"]
    time_unpack(out["unpack_candidates"], mb, _build, mb._level2_reduce(packed[8], mb.L2_MID), k, tile, 8, mb.L2_MID,
                device, sz["reps"], headline=True)
    time_unpack(out["unpack_candidates"], mb, _build, packed[4], 4 * k, tile, 4, None, device, sz["reps"],
                headline=False)
    # the whole scan through the kernels against the plain pipeline
    for per_bin, kk in ((2, k), (4, k), (8, k), (8, k // 10)):
        _, ids = mb.binmax_scan_topk(qb, c, kk, n_valid=n, per_bin=per_bin)
        n_cands = n // 128 * per_bin
        level2 = mb.L2_WIDE if n_cands >= 128 * kk else (mb.L2_MID if n_cands >= 16 * kk else None)
        plain = mb._scan_plain(qb, c, n, per_bin, tile)
        if level2:
            plain = mb._level2_plain(plain, level2)
        ptop, ppos = torch.topk(plain, kk, dim=1)
        _, pids = mb._unpack_plain(ptop, ppos, tile, per_bin, level2)
        ov = _overlap(ids.cpu().numpy(), pids.cpu().numpy())
        print(f"[kernels] binmax_scan_topk per_bin={per_bin} k={kk} level2={level2}: id overlap {ov:.6f}")
        check(ov >= 0.999, f"binmax top-{kk} overlap {ov} at per_bin {per_bin}")
    return out


def _int8_layer_params(sz, device, seed):
    """Per-column int8 codes and f32 scales of random f32 weights (the
    encoder quantizes its f32 parameters the same way), f32 biases and LN."""
    import torch

    from matchmaker_tpu_torch.ops.fused_int8 import quantize_weights_per_col

    g = torch.Generator(device=device).manual_seed(seed)
    hid, ff = sz["hid"], sz["ff"]

    def q(rows, cols):
        return quantize_weights_per_col(torch.randn(rows, cols, generator=g, device=device) * rows ** -0.5)

    def v(n, std, mean=0.0):
        return torch.randn(n, generator=g, device=device) * std + mean

    attn = (*q(hid, hid), *q(hid, hid), *q(hid, hid), *q(hid, hid), v(hid, 0.02), v(hid, 0.02), v(hid, 0.02),
            v(hid, 0.02))
    mlp = (*q(hid, ff), v(ff, 0.02), *q(ff, hid), v(hid, 0.02))
    return attn, mlp, (v(hid, 0.1, 1.0), v(hid, 0.1)), (v(hid, 0.1, 1.0), v(hid, 0.1))


def _int8_kmajor(fi, attn, mlp):
    """The halves' weights as the encoder holds them: K-major codes, Q/K/V
    packed (attention: wqkv_t, sqkv, bqkv, wo_t, so, bo; MLP: w1_t, s1, b1,
    w2_t, s2, b2)."""
    w1q, s1, b1, w2q, s2, b2 = mlp
    return fi.kmajor_attention_weights(*attn), (fi.kmajor_codes(w1q), s1, b1, fi.kmajor_codes(w2q), s2, b2)


def _launch_parts_ms(fn, device, reps):
    """Each C launch of one call of ``fn`` alone: CUDA events around every
    ``_build.call`` over ``reps`` calls, queued behind a sleeping kernel so
    that the host's launch gaps do not reach the card's clock. Returns
    ([(entry point, mean ms)] in call order, mean ms of a whole call)."""
    import torch

    from matchmaker_tpu_torch.ops import _build

    if device.type != "cuda":  # the plain versions: no launches to time
        return [], _time_ms(fn, device, reps)
    real_call, events = _build.call, []

    def timed_call(entry, *args):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        real_call(entry, *args)
        end.record()
        events.append((entry, start, end))

    fn()
    torch.cuda.synchronize()
    begin, finish = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    _build.call = timed_call
    try:
        torch.cuda._sleep(50_000_000)
        begin.record()
        for _ in range(reps):
            fn()
        finish.record()
    finally:
        _build.call = real_call
    torch.cuda.synchronize()
    n = len(events) // reps
    parts = [(events[j][0], sum(events[r * n + j][1].elapsed_time(events[r * n + j][2]) for r in range(reps)) / reps)
             for j in range(n)]
    return parts, begin.elapsed_time(finish) / reps


# the quantizations of each int8 half in launch order
INT8_QUANTS = {"fused_attention_int8_block": ("x quantization", "attention-output quantization (row, head group)"),
               "fused_mlp_int8_block": ("x quantization", "gelu-output quantization (row, FF chunk)")}


def int8_half_parts(fi, sz, b, l, device, reps, seed=12):
    """Where K10's and K9's time goes at (B, L): each launch alone (see
    _launch_parts_ms), each int8 product's TOP/s against the card's 1,979,
    and beside it one torch._int_mm call on codes of the same K-major shapes
    (a yardstick; the port never calls it). ``fi`` is a checkout's
    ``ops.fused_int8``; one without the K-major entry points (an earlier
    tree) runs its public functions."""
    import torch

    attn, mlp, ln1, ln2 = _int8_layer_params(sz, device, seed)
    x, mask, g = _half_inputs(sz, b, l, device, 300)
    heads, m = sz["heads"], b * l
    if hasattr(fi, "fused_mlp_int8_block_kmajor"):
        attn_t, mlp_t = _int8_kmajor(fi, attn, mlp)
        halves = {"fused_attention_int8_block":
                  lambda: fi.fused_attention_int8_block_qkv_kmajor(x, *attn_t, mask, heads, *ln1),
                  "fused_mlp_int8_block": lambda: fi.fused_mlp_int8_block_kmajor(x, *mlp_t, *ln2)}
    else:
        halves = {"fused_attention_int8_block": lambda: fi.fused_attention_int8_block(x, *attn, mask, heads, *ln1),
                  "fused_mlp_int8_block": lambda: fi.fused_mlp_int8_block(x, *mlp, *ln2)}
    dims = {"hid": sz["hid"], "3hid": 3 * sz["hid"], "ff": sz["ff"]}
    out = {}
    for name, fn in halves.items():
        launches, total = _launch_parts_ms(fn, device, reps)
        products, quants = list(HALF_PRODUCTS[name]), list(INT8_QUANTS[name])
        parts = []
        for entry, ms in launches:
            rec, note = {"entry": entry, "ms": ms}, ""
            if "gemm" in entry:
                label, k, n = products.pop(0)
                k, n = dims[k], dims[n]
                a = torch.randint(-127, 128, (m, k), generator=g, device=device, dtype=torch.int8)
                w_t = torch.randint(-127, 128, (n, k), generator=g, device=device, dtype=torch.int8)
                lib = _time_ms(lambda: torch._int_mm(a, w_t.t()), device, reps)
                ops = 2 * m * k * n
                rec.update(part=f"{label} product ({m} x {k} x {n})", tops=ops / ms / 1e9, int_mm_ms=lib,
                           int_mm_tops=ops / lib / 1e9, peak_share=ops / ms / 1e9 / (PEAK_OPS_PER_S["int8"] / 1e12))
                note = (f", {rec['tops']:.1f} TOP/s ({100 * rec['peak_share']:.1f} % of 1,979); torch._int_mm "
                        f"{rec['int_mm_ms']:.4f} ms ({rec['int_mm_tops']:.1f} TOP/s)")
            elif entry == "mm_quant_groups":
                rec["part"] = quants.pop(0)
            else:
                rec["part"] = HALF_OTHER_PARTS.get(entry, entry)
                if rec["part"] == "attention core":
                    note = _core_part(rec, sz, b, l, mask, g, device, reps)
            parts.append(rec)
            print(f"[kernels]   {name} part {rec['part']} ({entry}): {ms:.4f} ms{note}")
        print(f"[kernels]   {name} at {(b, l)}: {total:.4f} ms a call, {sum(r['ms'] for r in parts):.4f} ms in "
              f"its {len(parts)} launches")
        out[name] = {"parts": parts, "parts_total_ms": total}
    return out


def phase_int8_encoder_kernels(sz, device):
    """K10 and K9 against their plain versions at the encoder halves' shapes,
    held to K1/K2's bar (row cosine >= 0.999, max |d| <= 0.1) and to a mean
    |d| <= INT8_HALF_MEAN_ABS. The kernels run as the encoder runs them
    (K-major codes, Q/K/V packed); at the headline shape each launch is
    also timed alone (int8_half_parts)."""
    import torch

    from matchmaker_tpu_torch.ops import fused_int8 as fi

    attn, mlp, ln1, ln2 = _int8_layer_params(sz, device, seed=12)
    attn_t, mlp_t = _int8_kmajor(fi, attn, mlp)
    out = {name: {"max_abs_err": 0.0, "mean_abs_err": 0.0}
           for name in ("fused_attention_int8_block", "fused_mlp_int8_block")}
    for i, (b, l) in enumerate(sz["layer_shapes"]):
        x, mask, _ = _half_inputs(sz, b, l, device, 300 + i)
        proj, core = _attention_ops(b, l, sz["hid"], sz["heads"])
        heads = sz["heads"]
        cases = (("fused_attention_int8_block",
                  lambda: fi.fused_attention_int8_block_qkv_kmajor(x, *attn_t, mask, heads, *ln1),
                  lambda: fi.reference_attention_int8_block(x, *attn, mask, heads, *ln1),
                  (x, attn_t, mask, ln1), dict(int8=proj, bf16=core)),
                 ("fused_mlp_int8_block", lambda: fi.fused_mlp_int8_block_kmajor(x, *mlp_t, *ln2),
                  lambda: fi.reference_mlp_int8_block(x, *mlp, *ln2), (x, mlp_t, ln2),
                  dict(int8=4 * b * l * sz["hid"] * sz["ff"])))
        for name, kernel, plain, inputs, ops in cases:
            got, want = kernel(), plain()
            cos, err = _rows_close(got, want)
            mean = _mean_abs(got, want)
            print(f"[kernels] {name} B={b} L={l}: min row cosine {cos:.6f}, max |d| {err:.4g}, mean |d| {mean:.4g}")
            check(got.shape == x.shape and bool(torch.isfinite(got.float()).all()), f"{name} output at {(b, l)}")
            check(cos >= 0.999 and err <= 0.1, f"{name} vs plain at {(b, l)}: cos {cos}, max |d| {err}")
            check(mean <= INT8_HALF_MEAN_ABS, f"{name} vs plain at {(b, l)}: mean |d| {mean} > {INT8_HALF_MEAN_ABS}")
            out[name]["max_abs_err"] = max(out[name]["max_abs_err"], err)
            out[name]["mean_abs_err"] = max(out[name]["mean_abs_err"], mean)
            _record(out[name], [b, l, sz["hid"]], kernel, plain, device, sz["reps"], headline=i == 0,
                    bound_of=bound(nbytes(inputs, got), **ops))
        if i == 0:
            for name, rec in int8_half_parts(fi, sz, b, l, device, sz["reps"]).items():
                out[name].update(rec)
    return out


def phase_int8_binmax_kernels(sz, device):
    """K8 (bf16 queries) and K7 (int8 query codes) against their plain
    versions over an int8 corpus: >= 99.9 % identical candidates."""
    import torch

    from matchmaker_tpu_torch.ops import mips_binmax as mb
    from matchmaker_tpu_torch.ops.mips_quant import quantize_corpus_binwise, quantize_queries

    n, tile = sz["scan_rows"], 2048
    rows, q = _clustered(n, sz["hid"], 256, device, seed=6, n_queries=sz["scan_queries"])
    codes, scales = (torch.from_numpy(a).to(device) for a in quantize_corpus_binwise(rows.cpu().numpy()))
    del rows
    qb = q.to(torch.bfloat16)
    q8, qs = quantize_queries(q)
    out = {"binmax_candidates_int8f": {"max_abs_err": 0.0}, "binmax_candidates_int8": {"max_abs_err": 0.0}}
    cases = (("binmax_candidates_int8f", qb, None, "bf16",
              lambda pb: mb._scan_int8f_plain(qb, codes, scales, n, pb, tile)),
             ("binmax_candidates_int8", q8, qs, "int8",
              lambda pb: mb._scan_int8_plain(q8, codes, scales, qs, n, pb, tile)))
    for name, queries, q_scales, kind, plain in cases:
        for per_bin in (2, 4, 8):
            def kernel(pb=per_bin, qq=queries, qsc=q_scales):
                return mb.binmax_candidates(qq, codes, n_valid=n, per_bin=pb, corpus_scales=scales,
                                            query_scales=qsc)

            got, want = kernel(), plain(per_bin)
            pos = torch.arange(got.shape[1], device=device).expand_as(got).contiguous()
            gv, gi = mb._unpack_plain(got, pos, tile, per_bin)
            wv, wi = mb._unpack_plain(want, pos, tile, per_bin)
            same = gi == wi
            err = float((gv - wv).abs()[same & torch.isfinite(wv)].max())
            share = float(same.float().mean())
            bits = float((got.view(torch.int32) == want.view(torch.int32)).float().mean())
            print(f"[kernels] {name} per_bin={per_bin}: identical candidates {share:.6f}, max |d| {err:.3g}, "
                  f"bit-identical packed values {bits:.6f}")
            check(share >= 0.999, f"{name} per_bin {per_bin}: {share} identical")
            if q_scales is not None:  # K7: exact sums, the plain version's rounding and tie rule
                check(bits == 1.0, f"{name} per_bin {per_bin}: {bits} of the packed values bit-identical")
            out[name]["max_abs_err"] = max(out[name]["max_abs_err"], err)
            _record(out[name], [n, sz["hid"], sz["scan_queries"], per_bin], kernel,
                    lambda pb=per_bin: plain(pb), device, sz["reps"], headline=per_bin == 8,
                    bound_of=bound(nbytes(queries, q_scales, codes, scales, got),
                                   **{kind: 2 * queries.shape[0] * n * sz["hid"]}))
    # the products alone, yardsticks for the scans' tensor-core work, not
    # bounds: they write the (Q, N) scores and select nothing
    c16 = codes.to(torch.bfloat16)
    product_ms = _time_ms(lambda: torch.matmul(qb, c16.T), device, sz["reps"])
    del c16
    out["binmax_candidates_int8f"].update(
        product_library_ms=product_ms, product_library_call="torch.matmul(queries, codes.to(bf16).T) (the product "
                                                            "alone)")
    print(f"[kernels]   product alone: torch.matmul of the bf16 codes {product_ms:.4f} ms "
          f"({2 * qb.shape[0] * n * sz['hid'] / product_ms / 1e9:.1f} TFLOP/s)")
    if device.type == "cuda":  # torch._int_mm needs the card
        product_ms = _time_ms(lambda: torch._int_mm(q8, codes.T), device, sz["reps"])
        out["binmax_candidates_int8"].update(
            product_library_ms=product_ms, product_library_call="torch._int_mm(query codes, corpus codes.T) "
                                                                "(the product alone)")
        print(f"[kernels]   product alone: torch._int_mm {product_ms:.4f} ms "
              f"({2 * q8.shape[0] * n * sz['hid'] / product_ms / 1e9:.1f} TOP/s)")
    return out


def _maxsim_inputs(bq, lq, bd, ld, dim, below_fill, device, seed):
    """Random f32 token vectors and masks with zeros (one all-padding query
    row, one all-padding doc); ``below_fill``: every third doc's live dots
    below -1000 (raw ColBERT dots reach |s| ~ 7000)."""
    import torch

    g = torch.Generator(device=device).manual_seed(seed)
    q = torch.randn(bq, lq, dim, generator=g, device=device)
    d = torch.randn(bd, ld, dim, generator=g, device=device)
    if below_fill:
        q, d[::3] = q.abs() * 5, -d[::3].abs() * 40
    q_mask = (torch.rand(bq, lq, generator=g, device=device) > 0.2).float()
    d_mask = (torch.rand(bd, ld, generator=g, device=device) > 0.2).float()
    q_mask[:, 0] = d_mask[:, 0] = 1.0
    q_mask[-1, lq // 2:] = 0.0
    d_mask[-1] = 0.0
    return q, d, q_mask, d_mask


def _gathered_inputs(sz, device, seed):
    """The batched rescore's launch at the ColBERT run's shapes: a query
    batch (colbert_query_batch x colbert_query_len, width colbert_dim, 8
    padded query tokens in every fourth query), a float16 token matrix of
    ``passages`` documents of 1..T tokens (T the store's padded tokens,
    maxsim_shapes[2][3]) and each query's colbert_rescore_n candidate spans,
    drawn with replacement, on the CPU as maxsim_gathered takes them."""
    import torch

    g = torch.Generator(device=device).manual_seed(seed)
    b, lq, c, dim, pad = (sz["colbert_query_batch"], sz["colbert_query_len"], sz["colbert_rescore_n"],
                          sz["colbert_dim"], sz["maxsim_shapes"][2][3])
    counts = torch.randint(1, pad + 1, (sz["passages"],), generator=g, device=device)
    starts = torch.cumsum(counts, 0) - counts
    tokens = (torch.randn(int(counts.sum()), dim, generator=g, device=device) * 2).half()
    pick = torch.randint(0, sz["passages"], (b, c), generator=g, device=device)
    q = torch.randn(b, lq, dim, generator=g, device=device) * 2
    qm = torch.ones(b, lq, device=device)
    qm[::4, lq - 8:] = 0.0
    return q, qm, tokens, starts[pick].cpu(), counts[pick].int().cpu(), pad


def _k14_check(out, got, want, shape, fill):
    """K14 against its plain version: non-finite entries identical, the rest
    within rtol = atol = 1e-4 (the bar of tests/test_perf_ops.py:91)."""
    import torch

    fin = torch.isfinite(want)
    check(got.shape == want.shape and torch.equal(fin, torch.isfinite(got))
          and torch.equal(got[~fin], want[~fin]), f"K14 non-finite entries at {shape}")
    err = float((got - want)[fin].abs().max()) if bool(fin.any()) else 0.0
    rel_ok = bool(((got - want).abs()[fin] <= 1e-4 + 1e-4 * want.abs()[fin]).all())
    print(f"[kernels] maxsim {shape} fill {fill}: max |d| {err:.4g}, "
          f"max |plain| {float(want[fin].abs().max()) if bool(fin.any()) else 0.0:.4g}")
    check(rel_ok, f"K14 vs plain at {shape}: max |d| {err}")
    out["max_abs_err"] = max(out["max_abs_err"], err)


def phase_maxsim_kernel(sz, device):
    """K14 against its plain version, rtol = atol = 1e-4 (the bar of
    tests/test_perf_ops.py:91): the all-pairs form at the ColBERT shapes
    with fill -1000 and -inf (f32 docs), and the gathered form at the
    ColBERT run's batched rescore (its launch on the main path: 256 queries
    against their own 64 candidates of float16 token rows, fill -inf), the
    headline. Bound: the bytes, or the TF32 products the split issues (3 for
    f32 docs, 2 for float16) over the live (query token, doc token) pairs
    at the TF32 rate."""
    import torch

    from matchmaker_tpu_torch.ops import maxsim as ms

    out = {"maxsim_all_pairs": {"max_abs_err": 0.0}}
    entry = out["maxsim_all_pairs"]
    for i, (bq, lq, bd, ld, dim, fill, below) in enumerate(sz["maxsim_shapes"]):
        q, d, qm, dm = _maxsim_inputs(bq, lq, bd, ld, dim, below, device, seed=400 + i)
        got = ms.maxsim_all_pairs(q, d, qm, dm, fill=fill)
        want = ms.reference_maxsim_all_pairs(q, d, qm, dm, fill)
        _k14_check(entry, got, want, (bq, lq, bd, ld, dim), fill)
        check(torch.equal(got, ms.maxsim_all_pairs(q, d, qm, dm, fill=fill)), f"K14 reruns differ at {(bq, lq)}")
        ops = 2 * dim * int((qm > 0).sum()) * int((dm > 0).sum())
        _record(entry, [bq, lq, bd, ld, dim], lambda a=(q, d, qm, dm), f=fill: ms.maxsim_all_pairs(*a, fill=f),
                lambda a=(q, d, qm, dm), f=fill: ms.reference_maxsim_all_pairs(*a, f), device, sz["reps"],
                headline=False, bound_of=bound(nbytes(q, d, qm, dm, got), tf32=3 * ops))
    q, qm, tokens, first, count, pad = _gathered_inputs(sz, device, seed=409)
    fill = float("-inf")

    def plain():
        slots = torch.arange(pad, device=device)
        rows = first.to(device)[..., None] + slots
        live = (slots < count.to(device)[..., None]).float()
        return torch.stack([ms.reference_maxsim_all_pairs(q[i:i + 1], tokens[rows[i].clamp(max=len(tokens) - 1)]
                                                          .float(), qm[i:i + 1], live[i], fill)[0]
                            for i in range(q.shape[0])])

    got = ms.maxsim_gathered(q, qm, tokens, first, count, pad, fill=fill)
    shape = [q.shape[0], q.shape[1], first.shape[1], pad, q.shape[2]]
    _k14_check(entry, got, plain(), ("gathered", *shape), fill)
    check(torch.equal(got, ms.maxsim_gathered(q, qm, tokens, first, count, pad, fill=fill)),
          "K14's gathered form: reruns differ")
    live_q = (qm > 0).sum(1).double().cpu()
    ops = int(2 * q.shape[2] * float((live_q * count.double().sum(1)).sum()))
    # the token rows of the distinct spans, once each (a document drawn twice
    # is read from device memory once; its second use can come from L2)
    distinct = torch.unique(torch.stack([first.flatten(), count.flatten().long()], 1), dim=0)
    read = int(distinct[:, 1].sum()) * q.shape[2] * tokens.element_size()
    _record(entry, ["gathered", *shape], lambda: ms.maxsim_gathered(q, qm, tokens, first, count, pad, fill=fill),
            plain, device, sz["reps"], headline=True,
            bound_of=bound(read + nbytes(q, qm, first, count, got), tf32=2 * ops))
    entry["headline"] = ("the ColBERT run's batched rescore: one launch for a query batch against each query's own "
                         "candidates (float16 token spans)")
    return out


def _maxsim_training_inputs(bq, lq, bd, ld, dim, below_fill, ties, device, seed):
    """_maxsim_inputs' tensors; ``ties``: in every doc token 5 repeats token
    3, the sum of the batch's query rows, so the two tie exactly, for the
    kernel and the plain dots alike, at the max of many (query token, doc)
    pairs."""
    q, d, qm, dm = _maxsim_inputs(bq, lq, bd, ld, dim, below_fill, device, seed)
    if ties:
        d[:, 3] = q.sum(dim=(0, 1))
        d[:, 5] = d[:, 3]
        dm[:, 3] = dm[:, 5] = 1.0
    return q, d, qm, dm


def _library_maxsim_argmax(q, d, qm, dm, fill):
    """The training form as a chain of PyTorch calls: one einsum for every
    dot, the masked fill, max with its argmax (-1 where a masked slot holds
    it), the masked sum over query tokens (a yardstick; the port never
    calls it)."""
    import torch

    live = dm > 0
    s = torch.einsum("bld,kmd->blkm", q, d).masked_fill(~live[None, None], fill)
    best, idx = s.max(dim=-1)
    idx = torch.where(torch.gather(live.expand(q.shape[0], q.shape[1], -1, -1), -1, idx[..., None])[..., 0], idx, -1)
    out = torch.where(qm[:, :, None] != 0, best * qm[:, :, None], torch.zeros((), device=q.device)).sum(dim=1)
    return out, idx.int()


def _library_maxsim_bwd(q, d, qm, dm, argmax, g):
    """The backward as a chain of PyTorch calls: the saved tokens' doc rows
    gathered for dq, w q added into them by index_add_ for dd (exact ties
    not split: a yardstick; the port never calls it)."""
    import torch

    bd, ld, dim = d.shape
    a = argmax.long()
    w = torch.where(a >= 0, g[:, None, :] * qm[:, :, None], torch.zeros((), device=q.device))
    rows = torch.arange(bd, device=q.device)[None, None, :] * ld + a.clamp(min=0)
    dq = (w[..., None] * d.reshape(-1, dim)[rows]).sum(dim=2)
    dd = torch.zeros(bd * ld, dim, device=q.device).index_add_(0, rows.reshape(-1),
                                                              (w[..., None] * q[:, :, None, :]).reshape(-1, dim))
    return dq, dd.reshape(bd, ld, dim)


def _maxsim_training_shape(fwd, bwd, case, seed, sz, device, headline):
    """One shape of phase_maxsim_training (its gates, timings, bounds and
    library chains) into the entries ``fwd`` and ``bwd``; ``case`` is
    (Bq, Lq, Bd, Ld, D, fill, live dots below -1000, exact ties). Returns
    the tokens' agreement."""
    import torch

    from matchmaker_tpu_torch.ops import maxsim as ms

    bq, lq, bd, ld, dim, fill, below, ties = case
    shape = [bq, lq, bd, ld, dim]
    q, d, qm, dm = _maxsim_training_inputs(bq, lq, bd, ld, dim, below, ties, device, seed=seed)
    g = torch.randn(bq, bd, generator=torch.Generator(device=device).manual_seed(seed - 493), device=device)
    got, idx = ms.maxsim_all_pairs_argmax(q, d, qm, dm, fill)
    want, want_idx, top1, top2 = ms.reference_maxsim_argmax(q, d, qm, dm, fill, with_top2=True)
    _k14_check(fwd, got, want, shape, fill)
    agree = idx == want_idx
    share = float(agree.float().mean())
    near = bool(((top1 - top2).abs() <= 1e-5 * top1.abs())[~agree].all())
    print(f"[kernels] maxsim training form {shape}: tokens agree on {share:.6f} of (b, l, k), "
          f"{int((~agree).sum())} differ, all near ties: {near}")
    check(share >= 0.9999 and near, f"K14's training form at {shape}: tokens agree on {share}, near ties {near}")
    dq, dd = ms.maxsim_all_pairs_bwd(q, d, qm, dm, idx, g)
    qg, dg = q.clone().requires_grad_(), d.clone().requires_grad_()
    ref = ms.reference_maxsim_all_pairs(qg, dg, qm, dm, fill)
    pq, pd = torch.autograd.grad(ref, (qg, dg), g, retain_graph=True)
    split = _split_ties(q, d, dm, fill)
    sure = agree & ~split  # the max's token is one row for the kernel and for autograd
    rows, docs = sure.all(dim=2), sure.all(dim=(0, 1))
    rq, rd = ms.reference_maxsim_bwd(q, d, qm, dm, idx, g)
    err = 0.0
    for name, a, b in (("dq", dq[rows], pq[rows]), ("dd", dd[docs], pd[docs]), ("dq vs its plain version", dq, rq),
                       ("dd vs its plain version", dd, rd)):
        close = bool(((a - b).abs() <= 1e-4 + 1e-4 * b.abs()).all())
        err = max(err, float((a - b).abs().max()) if a.numel() else 0.0)
        check(close, f"the MaxSim backward's {name} at {shape}: max |d| {err}")
    check(bool((dd[dm <= 0] == 0).all()), f"a gradient reached a masked doc token at {shape}")
    if ties:
        check(bool(docs.all()) and bool((idx == 3).any()) and torch.equal(dd[:, 3], dd[:, 5])
              and bool(dd[:, 3].abs().max() > 0), f"the exact ties did not split evenly at {shape}")
    again = ms.maxsim_all_pairs_argmax(q, d, qm, dm, fill)
    check(torch.equal(again[0], got) and torch.equal(again[1], idx), f"the training form's reruns differ at {shape}")
    again = ms.maxsim_all_pairs_bwd(q, d, qm, dm, idx, g)
    check(torch.equal(again[0], dq) and torch.equal(again[1], dd), f"the backward's reruns differ at {shape}")
    bwd["max_abs_err"] = max(bwd["max_abs_err"], err)
    print(f"[kernels] maxsim backward {shape}: dq on {int(rows.sum())} of {rows.numel()} query rows, dd on "
          f"{int(docs.sum())} of {bd} docs against autograd ({int(split.sum())} maxima tied between unequal "
          f"rows left out), all against reference_maxsim_bwd, max |d| {err:.4g}; max |plain| dq "
          f"{float(pq.abs().max()):.4g}, dd {float(pd.abs().max()):.4g}")
    live = 2 * dim * int((qm > 0).sum()) * int((dm > 0).sum())
    _record(fwd, shape, lambda a=(q, d, qm, dm), f=fill: ms.maxsim_all_pairs_argmax(*a, f),
            lambda a=(q, d, qm, dm), f=fill: ms.reference_maxsim_argmax(*a, f), device, sz["reps"], headline,
            bound_of=bound(nbytes(q, d, qm, dm, got, idx), tf32=3 * live))
    _device_beside(fwd, lambda a=(q, d, qm, dm), f=fill: ms.maxsim_all_pairs_argmax(*a, f), device, headline)
    lib_out, lib_idx = _library_maxsim_argmax(q, d, qm, dm, fill)
    lib_agree = lib_idx == want_idx
    check(float(lib_agree.float().mean()) >= 0.9999
          and bool(((top1 - top2).abs() <= 1e-5 * top1.abs())[~lib_agree].all())
          and bool(((lib_out - want).abs() <= 1e-4 + 1e-4 * want.abs()).all()),
          f"the forward's chain of library calls disagrees with the plain version at {shape}")
    _library_beside(fwd, lambda a=(q, d, qm, dm), f=fill: _library_maxsim_argmax(*a, f), device, sz["reps"],
                    headline, "einsum + masked_fill + max (argmax) + masked sum")
    used = int(((g[:, None, :] * qm[:, :, None] != 0) & (idx >= 0)).sum())
    _record(bwd, shape, lambda a=(q, d, qm, dm, idx, g): ms.maxsim_all_pairs_bwd(*a),
            lambda a=(q, d, qm, dm, idx, g): ms.reference_maxsim_bwd(*a), device, sz["reps"], headline,
            bound_of=bound(nbytes(q, d, qm, dm, idx, g, dq, dd), f32=4 * dim * used))
    _device_beside(bwd, lambda a=(q, d, qm, dm, idx, g): ms.maxsim_all_pairs_bwd(*a), device, headline)
    _library_beside(bwd, lambda a=(q, d, qm, dm, idx, g): _library_maxsim_bwd(*a), device, sz["reps"], headline,
                    "gather of the tokens' doc rows (dq) + index_add_ (dd), ties not split")
    return {"shape": shape, "tokens_agree": share, "differ": int((~agree).sum()), "ties": ties,
            "maxima_tied_between_unequal_rows": int(split.sum())}


def phase_maxsim_training(sz, device):
    """The training form (the all-pairs launch that also saves each (query
    token, doc)'s max doc token) and the backward kernels against plain
    autograd through reference_maxsim_all_pairs, at the ColBERT training
    phase's shape (the headline), an odd shape with live dots below -1000,
    a shape with exact ties, a batch of 128 against its 256 in-batch docs
    and the public checkpoint's width 768. Gates: the forward at K14's bar
    (rtol = atol = 1e-4); the saved tokens equal to the plain argmax on >=
    99.99 % of (b, l, k), every other one a near tie (|top1 - top2| <= 1e-5
    |top1|); dq and dd within rtol = atol = 1e-4 of autograd on the query
    rows and docs whose tokens all agree and whose maxima no two unequal
    rows share (_split_ties), and of reference_maxsim_bwd everywhere; the
    tie's two rows equal dd; reruns bit-identical. Bounds: the training form by its TF32 products over the
    live pairs (three a multiply-add) against its bytes; the backward by its
    bytes (q, docs, the tokens and g read once, dq and dd written once)
    against its f32 FMAs over the (b, l, k) whose max is a live token. At
    every shape the device time and its multiple of the bound, and as
    ``library_ms`` the chain of PyTorch calls that computes the same
    function (no single call does): einsum + max / argmax for the forward,
    a gather + index_add_ for the backward (CUDA events; its device time
    beside it)."""
    out = {name: {"max_abs_err": 0.0, "library_ms": None} for name in ("maxsim_all_pairs_argmax",
                                                                        "maxsim_all_pairs_bwd")}
    fwd, bwd = out["maxsim_all_pairs_argmax"], out["maxsim_all_pairs_bwd"]
    agreement = [_maxsim_training_shape(fwd, bwd, shape, 500 + i, sz, device, i == 0)
                 for i, shape in enumerate(sz["maxsim_train_shapes"])]
    fwd["headline"] = ("the ColBERT training phase's in-batch all-pairs MaxSim (32 queries x 30 tokens against "
                       "64 docs x 200), forward with each max's doc token saved")
    bwd["headline"] = "its backward at the same shape"
    fwd["token_agreement"] = agreement
    return out


def phase_mha_kernel(sz, device):
    """K13 (no caller on any path) against its plain version at 12 heads x
    64, held to the encoder halves' bar; library_ms: one
    scaled_dot_product_attention call with the same additive mask at the
    headline shape (a yardstick the port never calls)."""
    import torch

    from matchmaker_tpu_torch.ops import fused_attention as fa
    from matchmaker_tpu_torch.probes import attn_inner as ai

    out = {"fused_mha": {"max_abs_err": 0.0}}
    heads, hid = sz["heads"], sz["hid"]
    for i, (b, l) in enumerate(sz["mha_shapes"]):
        g = torch.Generator(device=device).manual_seed(500 + i)
        q, k, v = (torch.randn(b, l, hid, generator=g, device=device).to(torch.bfloat16) for _ in range(3))
        lengths = torch.randint(max(1, l // 4), l + 1, (b,), generator=g, device=device)
        mask = (torch.arange(l, device=device)[None, :] < lengths[:, None]).float()
        got, want = fa.fused_mha(q, k, v, mask, heads), fa.mha_reference(q, k, v, mask, heads)
        cos, err = _rows_close(got, want)
        print(f"[kernels] fused_mha B={b} L={l}: min row cosine {cos:.6f}, max |d| {err:.4g}")
        check(got.shape == q.shape and bool(torch.isfinite(got.float()).all()), f"fused_mha output at {(b, l)}")
        check(cos >= 0.999 and err <= 0.1, f"fused_mha vs plain at {(b, l)}: cos {cos}, max |d| {err}")
        out["fused_mha"]["max_abs_err"] = max(out["fused_mha"]["max_abs_err"], err)
        ops = 4 * heads * (hid // heads) * l * int(mask.sum())  # QK^T and PV over the live keys
        _record(out["fused_mha"], [b, l, hid], lambda a=(q, k, v, mask): fa.fused_mha(*a, heads),
                lambda a=(q, k, v, mask): fa.mha_reference(*a, heads), device, sz["reps"], headline=i == 0,
                bound_of=bound(nbytes(q, k, v, mask, got), bf16=ops))
        if i == 0 and device.type == "cuda":
            lcos, _ = _rows_close(ai.sdpa(q, k, v, mask, heads), want)
            out["fused_mha"]["library_ms"] = _time_ms(lambda a=(q, k, v, mask): ai.sdpa(*a, heads), device,
                                                      sz["reps"])
            print(f"[kernels]   library scaled_dot_product_attention {out['fused_mha']['library_ms']:.4f} ms "
                  f"(min row cosine to plain {lcos:.6f})")
    return out


# ---- phase 3, the probes' kernels (K15-K18) ---------------------------------

def _probe_mlp_weights(sz, device, seed):
    import torch

    g = torch.Generator(device=device).manual_seed(seed)
    hid, ff = sz["hid"], sz["ff"]
    w1 = (torch.randn(hid, ff, generator=g, device=device) * hid ** -0.5).to(torch.bfloat16)
    w2 = (torch.randn(ff, hid, generator=g, device=device) * ff ** -0.5).to(torch.bfloat16)
    b1, b2 = (torch.randn(n, generator=g, device=device) * 0.02 for n in (ff, hid))
    ln_scale = torch.randn(hid, generator=g, device=device) * 0.1 + 1.0
    ln_bias = torch.randn(hid, generator=g, device=device) * 0.1
    return w1, b1, w2, b2, ln_scale, ln_bias


def phase_probe_kernels(sz, device):
    """The probes' kernels against their plain versions at each probe's
    headline shape and an odd one. K15: each variant against its own plain
    version (f32_p against the f32-P one, the stub against the stub) at
    K13's bar; beside it K13's fused_mha and, as library_ms, one
    scaled_dot_product_attention call. K16: bit-identical, and equal to
    one torch._int_mm call on the same operands, its library_ms. K15, K16
    and their library calls also by device time (_device_ms) at both
    shapes, each kernel's with its multiple of the bound. K17/K18 at K2's
    bar, by device time at both shapes; no single library call computes the
    MLP half, so library_ms is None, and beside each wrapper's row stand the
    chain of bf16 torch.matmul calls (chain_ms, chain_device_ms) and K2
    (fused_mlp_block_ms, fused_mlp_block_device_ms). Bounds: the live keys'
    products (K15), the int8 products or the bytes (K16), the live rows'
    products (K17/K18)."""
    import torch

    from matchmaker_tpu_torch.ops import fused_attention as fa
    from matchmaker_tpu_torch.probes import attn_inner as ai
    from matchmaker_tpu_torch.probes import int8_matmul as im
    from matchmaker_tpu_torch.probes import mlp_rows as mr

    out = {name: {"max_abs_err": 0.0} for name in ("attn_inner", "int8_matmul", "mlp_rows2d", "mlp_rowsblk")}
    hid, heads = sz["hid"], sz["heads"]
    on_card = device.type == "cuda"

    entry = out["attn_inner"]
    for i, (b, l, masked) in enumerate(sz["probe_attn_shapes"]):
        g = torch.Generator(device=device).manual_seed(600 + i)
        q, k, v = ((torch.randn(b, l, hid, generator=g, device=device) * 0.3).to(torch.bfloat16) for _ in range(3))
        mask = torch.ones(b, l, device=device)
        if masked:
            lengths = torch.randint(max(1, l // 4), l + 1, (b,), generator=g, device=device)
            mask = (torch.arange(l, device=device)[None, :] < lengths[:, None]).float()
        ops = 4 * hid * l * int(mask.sum())  # QK^T and PV over the live keys, every head
        for variant in ai.VARIANTS:
            got, want = ai.attn_inner(q, k, v, mask, variant, heads), ai.reference_attn_inner(q, k, v, mask, variant,
                                                                                              heads)
            cos, err = _rows_close(got, want)
            print(f"[kernels] attn_inner {variant} B={b} L={l}: min row cosine {cos:.6f}, max |d| {err:.4g}")
            check(got.shape == q.shape and bool(torch.isfinite(got.float()).all()), f"attn_inner {variant} output")
            check(cos >= 0.999 and err <= 0.1, f"attn_inner {variant} vs plain at {(b, l)}: cos {cos}, max |d| {err}")
            entry["max_abs_err"] = max(entry["max_abs_err"], err)
            _record(entry, [b, l, hid, variant], lambda a=(q, k, v, mask), vr=variant: ai.attn_inner(*a, vr, heads),
                    lambda a=(q, k, v, mask), vr=variant: ai.reference_attn_inner(*a, vr, heads), device, sz["reps"],
                    headline=i == 0 and variant == "batched", bound_of=bound(nbytes(q, k, v, mask, got), bf16=ops))
            _device_beside(entry, lambda a=(q, k, v, mask), vr=variant: ai.attn_inner(*a, vr, heads), device,
                           headline=i == 0 and variant == "batched")
        # the yardsticks at this shape, beside each variant's row
        lib = {"fused_mha_ms": _time_ms(lambda a=(q, k, v, mask): fa.fused_mha(*a, heads), device, sz["reps"]),
               "fused_mha_device_ms": _device_ms(lambda a=(q, k, v, mask): fa.fused_mha(*a, heads), device),
               "library_ms": None, "library_device_ms": None}
        if on_card:
            lib.update(library_ms=_time_ms(lambda a=(q, k, v, mask): ai.sdpa(*a, heads), device, sz["reps"]),
                       library_device_ms=_device_ms(lambda a=(q, k, v, mask): ai.sdpa(*a, heads), device))
        for timing in entry["timings"][-len(ai.VARIANTS):]:
            timing.update(lib)
        print(f"[kernels]   B={b} L={l}: K13 fused_mha device {_fmt(lib['fused_mha_device_ms'])}, events "
              f"{_fmt(lib['fused_mha_ms'])}; library scaled_dot_product_attention device "
              f"{_fmt(lib['library_device_ms'])}, events {_fmt(lib['library_ms'])}")
        if i == 0:
            entry.update(lib, library_call="torch.nn.functional.scaled_dot_product_attention, the same additive "
                                           "mask in bf16")
            # P kept f32 (hi + lo) against rounded to bf16, both against the f32-P plain version
            want = ai.reference_attn_inner(q, k, v, mask, "f32_p", heads)
            entry.update({f"{vr}_vs_f32_plain_mean_abs": _mean_abs(ai.attn_inner(q, k, v, mask, vr, heads), want)
                          for vr in ("f32_p", "batched")})
            print(f"[kernels]   mean |d| to the f32-P plain version: f32_p {entry['f32_p_vs_f32_plain_mean_abs']:.4g}, "
                  f"batched {entry['batched_vs_f32_plain_mean_abs']:.4g}")

    entry = out["int8_matmul"]
    for i, (m, k, n) in enumerate(sz["probe_int8_shapes"]):
        g = torch.Generator(device=device).manual_seed(700 + i)
        xq = torch.randint(-127, 128, (m, k), generator=g, device=device, dtype=torch.int8)
        wq_t = torch.randint(-127, 128, (n, k), generator=g, device=device, dtype=torch.int8)
        got = im.int8_matmul(xq, wq_t)
        check(torch.equal(got, im.reference_int8_matmul(xq, wq_t)), f"int8_matmul not bit-identical at {(m, k, n)}")
        print(f"[kernels] int8_matmul {(m, k, n)}: bit-identical to the plain version")
        _record(entry, [m, k, n], lambda a=(xq, wq_t): im.int8_matmul(*a),
                lambda a=(xq, wq_t): im.reference_int8_matmul(*a), device, sz["reps"], headline=i == 0,
                bound_of=bound(nbytes(xq, wq_t, got), int8=2 * m * k * n))
        _device_beside(entry, lambda a=(xq, wq_t): im.int8_matmul(*a), device, headline=i == 0)
        if on_card:
            check(torch.equal(torch._int_mm(xq, wq_t.T), got),
                  f"torch._int_mm disagrees with the kernel at {(m, k, n)}")
            lib = {"library_ms": _time_ms(lambda a=(xq, wq_t): torch._int_mm(a[0], a[1].T), device, sz["reps"]),
                   "library_device_ms": _device_ms(lambda a=(xq, wq_t): torch._int_mm(a[0], a[1].T), device)}
            entry["timings"][-1].update(lib)
            if i == 0:
                entry.update(lib, library_call="torch._int_mm(xq, wq_t.T): the same operands, B K-major")
            print(f"[kernels]   library torch._int_mm device {_fmt(lib['library_device_ms'])}, events "
                  f"{_fmt(lib['library_ms'])}")
        del xq, wq_t, got

    weights = _probe_mlp_weights(sz, device, 800)
    for i, (b, l) in enumerate(sz["probe_mlp_shapes"]):
        g = torch.Generator(device=device).manual_seed(810 + i)
        x = torch.randn(b, l, hid, generator=g, device=device).to(torch.bfloat16)
        want = mr.reference_mlp_rows(x, *weights)
        ops = 4 * b * l * hid * sz["ff"]
        for name, fn in (("mlp_rows2d", mr.mlp_rows2d), ("mlp_rowsblk", mr.mlp_rowsblk)):
            got = fn(x, *weights)
            cos, err = _rows_close(got, want)
            print(f"[kernels] {name} B={b} L={l}: min row cosine {cos:.6f}, max |d| {err:.4g}")
            check(got.shape == x.shape and bool(torch.isfinite(got.float()).all()), f"{name} output")
            check(cos >= 0.999 and err <= 0.1, f"{name} vs plain at {(b, l)}: cos {cos}, max |d| {err}")
            out[name]["max_abs_err"] = max(out[name]["max_abs_err"], err)
            _record(out[name], [b, l, hid], lambda f=fn: f(x, *weights), lambda: mr.reference_mlp_rows(x, *weights),
                    device, sz["reps"], headline=i == 0, bound_of=bound(nbytes(x, weights, got), bf16=ops))
            _device_beside(out[name], lambda f=fn: f(x, *weights), device, headline=i == 0)
        # the yardsticks at this shape, beside each wrapper's row
        lib = {"chain_ms": _time_ms(lambda: mr.matmul_chain(x, *weights), device, sz["reps"]),
               "chain_device_ms": _device_ms(lambda: mr.matmul_chain(x, *weights), device),
               "fused_mlp_block_ms": _time_ms(lambda: fa.fused_mlp_block(x, *weights), device, sz["reps"]),
               "fused_mlp_block_device_ms": _device_ms(lambda: fa.fused_mlp_block(x, *weights), device),
               "library_ms": None}
        for name in ("mlp_rows2d", "mlp_rowsblk"):
            out[name]["timings"][-1].update(lib)
            if i == 0:
                out[name].update(lib)
        print(f"[kernels]   B={b} L={l}: bf16 torch.matmul chain device {_fmt(lib['chain_device_ms'])}, events "
              f"{_fmt(lib['chain_ms'])}; K2 fused_mlp_block device {_fmt(lib['fused_mlp_block_device_ms'])}, events "
              f"{_fmt(lib['fused_mlp_block_ms'])}")
    return out


# ---- phase 4: the main path through the CLI --------------------------------

def _write_collection(root, sz, seed=1):
    rng = np.random.default_rng(seed)
    words = np.array([f"t{i}" for i in range(20_000)])
    lens = rng.integers(40, 121, size=sz["passages"])
    passages = [" ".join(words[rng.integers(0, len(words), size=n)]) for n in lens]
    with open(os.path.join(root, "collection.tsv"), "w") as f:
        for i, p in enumerate(passages):
            f.write(f"{i}\t{p}\n")
    targets = rng.choice(sz["passages"], size=sz["queries"], replace=False)
    with open(os.path.join(root, "queries.tsv"), "w") as fq, open(os.path.join(root, "qrels.txt"), "w") as fr:
        for qi, t in enumerate(targets):
            toks = passages[t].split()
            fq.write(f"{qi}\t{' '.join(rng.choice(toks, size=int(rng.integers(3, 7))))}\n")
            fr.write(f"{qi} 0 {t} 1\n")


def _main_config(root, sz, device):
    return {
        "model": "bert_dot", "bert_pretrained_model": sz["model_name"], "random_seed": 1234,
        "use_fp16": True, "encoder_fused_attention": True,
        "faiss_index_type": "flat", "mips_quantization": "float16", "mips_kernel": "binmax",
        "token_dtype": "float16", "collection_tsv": os.path.join(root, "collection.tsv"),
        "collection_batch_size": sz["batch"], "max_doc_length": sz["doc_len"], "max_query_length": 30,
        "device": str(device),
        "query_sets": {name: {"queries_tsv": os.path.join(root, "queries.tsv"),
                              "qrels": os.path.join(root, "qrels.txt"), "top_n": sz[key],
                              "binarization_point": 1} for name, key, _ in QUERY_SETS},
    }


# run-file name, its top_n, its recall floor against an exact search: the
# top-100 set takes level 1 only (floor of tests/test_binmax_recall.py:62),
# the top-10 set the keep-8/32 level 2 (floor of tests/test_binmax_recall.py:99)
QUERY_SETS = (("dev", "top_n", 0.97), ("dev_top10", "top_n_small", 0.95))


@contextlib.contextmanager
def plain_encoder_blocks():
    """Route the encoder's fused halves to their plain versions: the plain
    forwards, and under autograd the plain forwards differentiated by
    PyTorch (in place of K1/K2 with K12/K11)."""
    import matchmaker_tpu_torch.models.encoder as enc
    from matchmaker_tpu_torch.ops import fused_attention as fa

    def plain_attention(x, wqkv, bqkv, wo, bo, *rest, **kw):  # the weights as packed, heads padded or not
        hid = x.shape[-1]  # on a card the packing pads the hidden width too: cut back
        wq, wk, wv = wqkv[:hid].chunk(3, dim=1)
        bq, bk, bv = bqkv.chunk(3)
        return fa.reference_attention_block(x, wq, wk, wv, wo[:, :hid], bq, bk, bv, bo, *rest, **kw)

    def plain_mlp(x, w1, b1, w2, *rest, **kw):
        hid, ff = x.shape[-1], b1.shape[0]
        return fa.reference_mlp_block(x, w1[:hid, :ff], b1, w2[:ff, :hid], *rest, **kw)

    names = ("fused_attention_block_qkv", "fused_mlp_block", "fused_attention_block_qkv_train",
             "fused_mlp_block_train")
    saved = {n: getattr(enc, n) for n in names}
    for n, fn in zip(names, (plain_attention, plain_mlp) * 2):
        setattr(enc, n, fn)
    try:
        yield
    finally:
        for n, fn in saved.items():
            setattr(enc, n, fn)


def _encode_file(model, config, tokenizer, path, seq_type, batch, device, limit=None):
    import torch

    from matchmaker_tpu_torch.data.loaders import single_sequence_loader

    cfg = dict(config, batch_size_inference=batch)
    vecs, ids = [], []
    for b, sids in single_sequence_loader(cfg, tokenizer, path, seq_type):
        with torch.inference_mode():
            v = model.encode(torch.from_numpy(b["seq_ids"]).to(device), torch.from_numpy(b["seq_mask"]).to(device),
                             seq_type + "_encode")
        vecs.append(v[:len(sids)].float())
        ids += sids
        if limit and len(ids) >= limit:
            break
    return torch.cat(vecs), ids


def phase_main_path(sz, device, root):
    import torch

    from matchmaker_tpu_torch.cli.dense_retrieval import run
    from matchmaker_tpu_torch.data.tokenization import build_tokenizer
    from matchmaker_tpu_torch.models import get_model, init_params
    from matchmaker_tpu_torch.ops import _build
    from matchmaker_tpu_torch.retrieval.encode import load_encoded

    _write_collection(root, sz)
    config = _main_config(root, sz, device)
    run_folder = os.path.join(root, "run")
    os.makedirs(run_folder)
    fresh_perf_monitor()
    _build.reset_launches()
    t0 = time.perf_counter()
    check(run("encode+index+search", dict(config), run_folder) == 0, "run() returned non-zero")
    if device.type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    result = {"wall_s": wall, "launches": launches}
    print(f"[main] launches in the CLI run: {launches}")

    for rel in ("efficiency-metrics.json", "encoded/encode_meta.json", "index/flat_vectors.npy",
                "index/flat_ids.npy") + tuple(f"{name}-{kind}" for name, _, _ in QUERY_SETS
                                              for kind in ("output.txt", "metrics.csv")):
        check(os.path.isfile(os.path.join(run_folder, rel)), f"missing {rel}")
    rankings = {}
    for name, key, _ in QUERY_SETS:
        ranking = rankings[name] = {}
        with open(os.path.join(run_folder, f"{name}-output.txt")) as f:
            for line in f:
                qid, did, _, score = line.split()
                ranking.setdefault(qid, []).append(did)
        check(len(ranking) == sz["queries"] and all(len(v) == sz[key] for v in ranking.values()),
              f"every query of {name} must have {sz[key]} hits")
    if device.type == "cuda":
        for name in SERVING:  # every kernel of the path, level 2 through the top-10 set
            check(launches[name] > 0, f"the main path launched no {name} kernel")
    with open(os.path.join(run_folder, "efficiency-metrics.json")) as f:
        perf = json.load(f)[-1]["blocks"]
    result["encode_psg_per_s"] = perf["encode"]["items_per_second"]
    result["search_qps"] = perf["search_total"]["items_per_second"]
    result["metrics"] = {}
    for name, _, _ in QUERY_SETS:
        with open(os.path.join(run_folder, f"{name}-metrics.csv")) as f:
            head, vals = [line.strip().split(",") for line in f][:2]
        result["metrics"][name] = dict(zip(head, map(float, vals)))

    # exact search over the same bf16-rounded rows and queries
    tokenizer = build_tokenizer(config)
    model = get_model(config, tokenizer)
    init_params(model, config, torch.Generator().manual_seed(config["random_seed"]))
    model.to(device).eval()
    q_vecs, qids = _encode_file(model, config, tokenizer, os.path.join(root, "queries.tsv"), "query", 32, device)
    check(bool(torch.isfinite(q_vecs).all()), "query vectors not finite")
    vectors, row_ids = load_encoded(os.path.join(run_folder, "encoded"))
    check(vectors.shape == (sz["passages"], sz["hid"]) and bool(np.isfinite(vectors).all()), "encoded vectors")
    rows = torch.from_numpy(vectors).to(device).to(torch.bfloat16).float()
    with torch.inference_mode():
        scores = q_vecs.to(torch.bfloat16).float() @ rows.T
    col_std = scores.std(dim=1).mean().item()
    for name, key, floor in QUERY_SETS:
        k = sz[key]
        top = torch.topk(scores, k, dim=1)
        exact = {qid: [str(row_ids[i]) for i in idx] for qid, idx in zip(qids, top.indices.cpu().tolist())}
        recall = float(np.mean([len(set(exact[q]) & set(rankings[name][q])) / k for q in exact]))
        spread = (top.values[:, 0] - top.values[:, -1]).mean().item()
        print(f"[main] {name}: recall@{k} vs exact bf16 search {recall:.4f}; mean top-1 score "
              f"{top.values[:, 0].mean().item():.4f}, mean top-1 - top-{k} score spread {spread:.4f}, "
              f"mean per-query score std {col_std:.4f}")
        result[f"recall@{k}"] = recall
        result[f"top_spread@{k}"] = spread
        check(recall >= floor, f"{name}: recall@{k} {recall} < {floor}")
    result["score_std"] = col_std

    # re-encode passages with the plain versions on the same device
    coll = os.path.join(root, "collection.tsv")
    k_vecs, _ = _encode_file(model, config, tokenizer, coll, "doc", sz["batch"], device, limit=sz["batch"])
    with plain_encoder_blocks():
        p_vecs, _ = _encode_file(model, config, tokenizer, coll, "doc", sz["batch"], device, limit=sz["batch"])
    cos, err = _rows_close(k_vecs, p_vecs)
    print(f"[main] re-encode of {len(k_vecs)} passages, kernels vs plain: min cosine {cos:.6f}, max |d| {err:.4g}")
    result.update(reencode_min_cos=cos, reencode_max_abs=err)
    check(cos >= 0.999, f"re-encode cosine {cos}")

    # encoder throughput at the main path's batch, device time only
    batch_ids = torch.randint(104, sz["vocab"], (sz["batch"], sz["doc_len"]), device=device)
    batch_mask = torch.ones(sz["batch"], sz["doc_len"], device=device)

    def encode_once():
        with torch.inference_mode():
            model.encode(batch_ids, batch_mask, "doc_encode")

    ms = _time_ms(encode_once, device, sz["reps"])
    result["encode_device_psg_per_s"] = sz["batch"] / ms * 1e3
    return result


# the int8 serving runs: encoder_int8 with an int8 index, searched with bf16
# queries against the codes (K8), then with int8 queries and the exact
# rescore (K7 + rescore)
INT8_RUNS = (("mixed", {"mips_int8_queries": "float"}, "binmax_candidates_int8f"),
             ("int8_twostage", {"mips_int8_queries": "int8", "mips_twostage": True}, "binmax_candidates_int8"))
# phase 5b also searches the default int8 route (int8 queries, K7 alone);
# its recall is reported, not gated: K7 is bit-identical to its plain version
SCALE_INT8_RUNS = INT8_RUNS + (("int8", {"mips_int8_queries": "int8"}, "binmax_candidates_int8"),)
GATED_INT8_RUNS = {name for name, _, _ in INT8_RUNS}


def predicted_int8_serving_launches(sz):
    """K9/K10 launch once per layer and encode batch: the collection's
    batches and each query set's batches of 32 (the CLI's query_batch_size)."""
    batches = -(-sz["passages"] // sz["batch"]) + len(QUERY_SETS) * -(-sz["queries"] // 32)
    return sz["n_layers"] * batches


def phase_main_path_int8(sz, device, root, bf16_run):
    """The int8 serving path through cli.dense_retrieval.run on phase 4's
    collection: launch counts; recall against an exact search of the
    unquantized encoded rows and against one of the rows the int8 index
    holds (the encoded rows' codes times their bin scales, which both
    routes' final scores are exact products of), each held to the bf16
    route's floors; the cosine of the int8-encoded vectors to phase 4's bf16
    encode; device-only encode psg/s with the int8 halves."""
    import torch

    from matchmaker_tpu_torch.cli.dense_retrieval import run
    from matchmaker_tpu_torch.data.tokenization import build_tokenizer
    from matchmaker_tpu_torch.models import get_model, init_params
    from matchmaker_tpu_torch.ops import _build
    from matchmaker_tpu_torch.retrieval.encode import load_encoded
    from matchmaker_tpu_torch.retrieval.indexes import FlatIndex

    base = dict(_main_config(root, sz, device), encoder_int8=True, mips_quantization="int8")
    result = {}
    vectors = row_ids = None
    for name, extra, scan in INT8_RUNS:
        config = dict(base, **extra)
        folder = os.path.join(root, f"run_{name}")
        os.makedirs(folder)
        fresh_perf_monitor()
        _build.reset_launches()
        t0 = time.perf_counter()
        check(run("encode+index+search", dict(config), folder) == 0, f"int8 run {name} returned non-zero")
        if device.type == "cuda":
            torch.cuda.synchronize()
        launches = dict(_build.LAUNCHES)
        out = result[name] = {"wall_s": time.perf_counter() - t0, "launches": launches}
        print(f"[main-int8] {name}: launches {launches}")
        if device.type == "cuda":
            want = predicted_int8_serving_launches(sz)
            for k in ("fused_attention_int8_block", "fused_mlp_int8_block"):
                check(launches[k] == want, f"{name}: {k} launched {launches[k]} times, predicted {want}")
            check(launches["fused_attention_block"] == launches["fused_mlp_block"] == 0,
                  f"{name}: a bf16 encoder half ran in the int8 encode")
            needed = (scan, "unpack_candidates") + (("level2_reduce",) if name == "mixed" else ())
            for k in needed:
                check(launches[k] > 0, f"{name}: the int8 path launched no {k} kernel")
        with open(os.path.join(folder, "efficiency-metrics.json")) as f:
            perf = json.load(f)[-1]["blocks"]
        out.update(encode_psg_per_s=perf["encode"]["items_per_second"],
                   search_qps=perf["search_total"]["items_per_second"])
        if vectors is None:
            vectors, row_ids = load_encoded(os.path.join(folder, "encoded"))
            check(vectors.shape == (sz["passages"], sz["hid"]) and bool(np.isfinite(vectors).all()),
                  "int8-encoded vectors")
        out["rankings"] = {}
        for qname, _, _ in QUERY_SETS:
            ranking = out["rankings"][qname] = {}
            with open(os.path.join(folder, f"{qname}-output.txt")) as f:
                for line in f:
                    qid, did, _, _ = line.split()
                    ranking.setdefault(qid, []).append(did)

    # per-passage cosine against phase 4's bf16-kernel encode of the same passages
    bf16_vectors, bf16_ids = load_encoded(os.path.join(bf16_run, "encoded"))
    check(list(bf16_ids) == list(row_ids), "the two encodes list the passages in another order")
    a, b = torch.from_numpy(vectors).float(), torch.from_numpy(bf16_vectors).float()
    cos = float(torch.nn.functional.cosine_similarity(a, b, dim=1).min())
    result["vs_bf16_min_cos"] = cos
    print(f"[main-int8] int8 vs bf16 encode of {len(a)} passages: min cosine {cos:.6f}")
    check(cos >= 0.99, f"int8-encoded passages vs the bf16 encode: min cosine {cos}")

    # exact searches with the int8 encoder's queries: over the rows the index
    # holds (its permuted codes times bin scales) and over the encoded rows
    config = dict(base, **INT8_RUNS[0][1])
    tokenizer = build_tokenizer(config)
    model = get_model(config, tokenizer)
    init_params(model, config, torch.Generator().manual_seed(config["random_seed"]))
    model.to(device).eval()
    q_vecs, qids = _encode_file(model, config, tokenizer, os.path.join(root, "queries.tsv"), "query", 32, device)
    index = FlatIndex(config, device)
    index.index(row_ids, vectors)
    index._ensure_device()
    codes, bin_scales, _ = index._device_vectors
    held = (codes.float() * bin_scales[:, 0].repeat_interleave(128)[:, None])[:len(row_ids)]
    qf = q_vecs.to(torch.bfloat16).float()
    with torch.inference_mode():
        exact_scores = {"held": (qf @ held.T, index.row_ids),
                        "encoded": (qf @ torch.from_numpy(vectors).to(device).to(torch.bfloat16).float().T, row_ids)}
    for name, _, _ in INT8_RUNS:
        for qname, key, floor in QUERY_SETS:
            k = sz[key]
            ranking = result[name]["rankings"][qname]
            for against, (scores, ids) in exact_scores.items():
                top = torch.topk(scores, k, dim=1).indices.cpu().tolist()
                exact = {qid: [str(ids[i]) for i in idx] for qid, idx in zip(qids, top)}
                recall = float(np.mean([len(set(exact[q]) & set(ranking[q])) / k for q in exact]))
                result[name][f"recall@{k}_vs_{against}"] = recall
                print(f"[main-int8] {name} {qname}: recall@{k} vs exact search of the {against} rows {recall:.4f}")
                check(recall >= floor, f"int8 {name} {qname}: recall@{k} vs the {against} rows {recall} < {floor}")
        del result[name]["rankings"]

    batch_ids = torch.randint(104, sz["vocab"], (sz["batch"], sz["doc_len"]), device=device)
    batch_mask = torch.ones(sz["batch"], sz["doc_len"], device=device)

    def encode_once():
        with torch.inference_mode():
            model.encode(batch_ids, batch_mask, "doc_encode")

    ms = _time_ms(encode_once, device, sz["reps"])
    result["encode_device_psg_per_s"] = sz["batch"] / ms * 1e3
    print(f"[main-int8] device-only encode with the int8 halves at {sz['batch']}x{sz['doc_len']}: "
          f"{result['encode_device_psg_per_s']:.1f} psg/s")
    if device.type == "cuda":
        result["encode_profile"] = _profile_steps(lambda _: encode_once(), None, ms, tag="main-int8")
    return result


# ---- phase 4c: ColBERT serving through the same CLI --------------------------

def _colbert_config(root, sz, device):
    """The DistilBERT-width ColBERT of configs/train/models/colbert.yaml
    (compression 128, 8 query [MASK]s), bf16 fused layers, random weights
    from a seed; a binmax token index with the CLI's ColBERT defaults
    (per_bin 1, 4096-row tiles, 48 candidates a token, the device merge) and
    the exact rescore of 64 candidates."""
    return dict(_main_config(root, sz, device), model="colbert", colbert_compression_dim=sz["colbert_dim"],
                query_augment_mask_number=8, max_query_length=sz["colbert_query_len"],
                query_batch_size=sz["colbert_query_batch"], colbert_rescore_n=sz["colbert_rescore_n"],
                query_sets={"colbert": {"queries_tsv": os.path.join(root, "queries.tsv"),
                                        "qrels": os.path.join(root, "qrels.txt"), "top_n": sz["colbert_top_n"],
                                        "binarization_point": 1}})


def predicted_colbert_launches(sz):
    """K1/K2 once per layer and encode batch (the collection's and the
    queries'); K3, K4 (the pool oversamples 48 by >= 128x) and K6 once per
    query batch; K14 once per query batch (the batched rescore); K13 and
    every kernel not named here never."""
    q_batches = -(-sz["queries"] // sz["colbert_query_batch"])
    encode = sz["n_layers"] * (-(-sz["passages"] // sz["batch"]) + q_batches)
    return {"fused_attention_block": encode, "fused_mlp_block": encode, "binmax_candidates": q_batches,
            "level2_reduce": q_batches, "unpack_candidates": q_batches, "maxsim_all_pairs": q_batches,
            "fused_mha": 0}


def _padded_docs(folder, device):
    """Every stored document's token vectors as one padded (N, T, D) f32
    tensor with its mask and ids (T the store's padded max tokens)."""
    import torch

    from matchmaker_tpu_torch.retrieval.encode import load_encoded

    with open(os.path.join(folder, "encode_meta.json")) as f:
        n_blocks = json.load(f)["blocks"]
    sizes = [np.load(os.path.join(folder, f"token_reps_{i}.npy"), mmap_mode="r").shape[0] for i in range(n_blocks)]
    base = np.cumsum([0] + sizes)
    data = np.load(os.path.join(folder, "doc_infos.npz"), allow_pickle=True)
    ids, spans = data["ids"], data["spans"]
    vectors, _ = load_encoded(folder)
    starts = base[spans[:, 0]] + spans[:, 1]
    lengths = spans[:, 2] - spans[:, 1]
    t = -(-int(lengths.max()) // 8) * 8
    doc = np.repeat(np.arange(len(ids)), lengths)
    pos = np.arange(len(doc)) - np.repeat(np.cumsum(lengths) - lengths, lengths)
    rows = np.repeat(starts, lengths) + pos
    docs = torch.zeros((len(ids), t, vectors.shape[1]), dtype=torch.float32, device=device)
    mask = torch.zeros((len(ids), t), dtype=torch.float32, device=device)
    di, pi = torch.from_numpy(doc).to(device), torch.from_numpy(pos).to(device)
    docs[di, pi] = torch.from_numpy(vectors[rows]).to(device).float()
    mask[di, pi] = 1.0
    return docs, mask, [str(x) for x in ids]


def token_recall_causes(q, corpus, found, k, bin_rows=128, keep=8, group=128):
    """Why a per-token binmax search (per_bin 1, keep-8-of-128 level 2)
    misses rows of the exact top k: ``q`` (T, D) query rows as searched,
    ``corpus`` (N, D) the index's rows in its own order, ``found`` (T, k)
    the search's rows. Counts over all T tokens: the misses; the exact top
    k's rows that share a 128-row bin with a better one (level 1 keeps one
    a bin: level1_collisions); the rows of bins past the 8th best in one
    level-2 group of 128 bins (with per_bin 1 a candidate's column is its
    bin: level2_overflow); the tokens whose k-th and (k+1)-th exact scores
    tie; the found rows outside the exact top k that score exactly the
    k-th score (a tie swapped, no loss); the other misses that such a found
    row passed in the final top-k because their scores agree once the low
    14 mantissa bits, where levels 1 and 2 pack their offsets, are dropped
    (packing_order); and the misses none of these explains."""
    import torch

    def packed(x):  # a score as the final top-k of packed candidates compares it
        return (x.contiguous().view(torch.int32) & ~0x3FFF).view(torch.float32)

    out = dict.fromkeys(("misses", "level1_collisions", "level2_overflow", "ties_at_k", "tie_swaps",
                         "packing_order", "unexplained"), 0)
    out.update(tokens=int(q.shape[0]), k=k)
    for s in range(0, q.shape[0], 512):
        scores = q[s:s + 512] @ corpus.T
        top_vals, top = torch.topk(scores, k + 1, dim=1)
        exact, kth = top[:, :k].cpu().numpy(), top_vals[:, k - 1]
        out["ties_at_k"] += int((top_vals[:, k] == kth).sum())
        got_scores = scores.gather(1, torch.from_numpy(np.clip(found[s:s + 512], 0, None)).to(scores.device))
        for row, (e, f) in enumerate(zip(exact.tolist(), found[s:s + 512].tolist())):
            lost, bins, per_group = set(), set(), {}
            for r in e:  # best first
                b = r // bin_rows
                if b in bins:
                    lost.add(r)
                    out["level1_collisions"] += 1
                    continue
                bins.add(b)
                per_group[b // group] = per_group.get(b // group, 0) + 1
                if per_group[b // group] > keep:
                    lost.add(r)
                    out["level2_overflow"] += 1
            missed = sorted(set(e) - set(f) - lost)
            out["misses"] += len(set(e) - set(f))
            swapped = [j for j, r in enumerate(f) if r >= 0 and r not in set(e)]
            passed = 0
            if swapped:
                out["tie_swaps"] += int((got_scores[row, swapped] == kth[row]).sum())
                if missed:
                    top_swapped = packed(got_scores[row, swapped]).max()
                    passed = int((packed(scores[row, missed]) <= top_swapped).sum())
            out["packing_order"] += passed
            out["unexplained"] += len(missed) - passed
    return out


def phase_colbert(sz, device, root):
    """ColBERT serving, ``cli.dense_retrieval.run("encode+index+search")``
    on phase 4's collection and queries: run-folder files, token rows and
    the index's device bytes, the launch count of every kernel against
    predicted_colbert_launches; for one query batch, per-token recall@48 of
    ``search_rows`` against an exact search of the same bf16 token rows
    (>= 0.95, tests/test_binmax_recall.py:99) and the device merge against
    the host merge; every (query, doc, score) of the run file for 32 queries
    against the plain exact MaxSim of the re-encoded query and the stored
    document (rtol 1e-4); recall@10 of the run against an exhaustive exact
    MaxSim over every passage through K14 (reported, not gated); encode
    psg/s and search QPS through the CLI, device-only per-token search QPS."""
    import torch

    from matchmaker_tpu_torch.cli.dense_retrieval import run
    from matchmaker_tpu_torch.data.loaders import single_sequence_loader
    from matchmaker_tpu_torch.data.tokenization import build_tokenizer
    from matchmaker_tpu_torch.models import get_model, init_params
    from matchmaker_tpu_torch.ops import _build
    from matchmaker_tpu_torch.ops import maxsim as ms
    from matchmaker_tpu_torch.retrieval import colbert_search as cs
    from matchmaker_tpu_torch.retrieval.encode import load_encoded
    from matchmaker_tpu_torch.retrieval.indexes import build_index

    config = _colbert_config(root, sz, device)
    folder = os.path.join(root, "run_colbert")
    os.makedirs(folder)
    fresh_perf_monitor()
    _build.reset_launches()
    t0 = time.perf_counter()
    check(run("encode+index+search", dict(config), folder) == 0, "ColBERT run() returned non-zero")
    if device.type == "cuda":
        torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    result = {"wall_s": time.perf_counter() - t0, "launches": launches}
    print(f"[colbert] launches in the CLI run: {launches}")
    for rel in ("efficiency-metrics.json", "encoded/encode_meta.json", "encoded/doc_infos.npz",
                "index/flat_vectors.npy", "index/flat_ids.npy", "colbert-output.txt", "colbert-metrics.csv"):
        check(os.path.isfile(os.path.join(folder, rel)), f"colbert: missing {rel}")
    if device.type == "cuda":
        want = dict.fromkeys(launches, 0)  # every other kernel: none
        want.update(predicted_colbert_launches(sz))
        for name, n in want.items():
            check(launches[name] == n, f"colbert: {name} launched {launches[name]} times, predicted {n}")
    with open(os.path.join(folder, "efficiency-metrics.json")) as f:
        perf = json.load(f)[-1]["blocks"]
    result.update(encode_psg_per_s=perf["encode"]["items_per_second"],
                  search_qps=perf["search_total"]["items_per_second"],
                  search_blocks_s={k: perf[k]["total_seconds"] for k in perf if k.startswith("search_")})
    print(f"[colbert] CLI search blocks (s): {result['search_blocks_s']}")
    with open(os.path.join(folder, "colbert-metrics.csv")) as f:
        head, vals = [line.strip().split(",") for line in f][:2]
    result["metrics"] = dict(zip(head, map(float, vals)))
    run_file = {}
    with open(os.path.join(folder, "colbert-output.txt")) as f:
        for line in f:
            qid, did, _, score = line.split()
            run_file.setdefault(qid, []).append((did, float(score)))
    check(len(run_file) == sz["queries"] and all(len(v) == sz["colbert_top_n"] for v in run_file.values()),
          f"colbert: every query must have {sz['colbert_top_n']} hits")

    # the token index as the CLI built it (the same config, rows and permutation)
    enc = os.path.join(folder, "encoded")
    vectors, row_ids = load_encoded(enc)
    check(vectors.shape[1] == sz["colbert_dim"] and bool(np.isfinite(vectors).all()), "colbert token vectors")
    index_cfg = dict(config, mips_per_bin=1, mips_tile_rows=4096)
    index = build_index(index_cfg, device)
    index.prepare(vectors.shape[1])
    index.index(row_ids, vectors)
    index._ensure_device()
    result.update(token_rows=int(vectors.shape[0]), tokens_per_passage=vectors.shape[0] / sz["passages"],
                  index_device_bytes=index._device_vectors.numel() * index._device_vectors.element_size())
    print(f"[colbert] {result['token_rows']} token rows ({result['tokens_per_passage']:.2f} a passage), "
          f"index on the device {result['index_device_bytes'] / 1e9:.3f} GB")

    # the queries re-encoded as the CLI encodes them (one batch of 256)
    tokenizer = build_tokenizer(config)
    model = get_model(config, tokenizer)
    init_params(model, config, torch.Generator().manual_seed(config["random_seed"]))
    model.to(device).eval()
    cfg_q = dict(config, batch_size_inference=sz["colbert_query_batch"])
    batch, qids = next(iter(single_sequence_loader(cfg_q, tokenizer, os.path.join(root, "queries.tsv"), "query")))
    with torch.inference_mode():
        q_vecs = model.encode(torch.from_numpy(batch["seq_ids"]).to(device),
                              torch.from_numpy(batch["seq_mask"]).to(device), "query_encode").float()
    q_mask = batch["seq_mask"]
    b, lq, dim = q_vecs.shape
    flat = q_vecs.reshape(b * lq, dim)
    k = sz["colbert_candidates"]

    # per-token search against an exact search of the same bf16 rows (live query tokens)
    scores, rows = index.search_rows(flat.cpu().numpy(), k)
    live = np.flatnonzero(q_mask.reshape(-1) > 0)
    corpus = index._device_vectors[:index._row_count].float()
    qb = flat.to(torch.bfloat16).float()
    hits = 0
    for s in range(0, len(live), 512):
        part = torch.from_numpy(live[s:s + 512]).to(device)
        with torch.inference_mode():
            exact = torch.topk(qb[part] @ corpus.T, k, dim=1).indices.cpu().numpy()
        hits += sum(len(set(a) & set(e)) for a, e in zip(rows[live[s:s + 512]].tolist(), exact.tolist()))
    result["token_recall"] = hits / (len(live) * k)
    print(f"[colbert] per-token recall@{k} of search_rows vs exact bf16 search over {len(live)} live query "
          f"tokens: {result['token_recall']:.4f}")
    check(result["token_recall"] >= 0.95, f"colbert per-token recall@{k} {result['token_recall']}")
    result["token_recall_causes"] = token_recall_causes(qb[torch.from_numpy(live).to(device)], corpus, rows[live], k)
    print(f"[colbert] where recall@{k} falls short: {json.dumps(result['token_recall_causes'])}")

    # the device merge against the host merge on that batch
    vocab, row_slot = np.unique(np.asarray(index.row_ids).astype(str), return_inverse=True)
    slots = np.where(rows >= 0, row_slot[np.clip(rows, 0, len(row_slot) - 1)], -1).reshape(b, lq, k)
    keep = max(sz["colbert_top_n"], sz["colbert_rescore_n"])
    t0 = time.perf_counter()
    dev = cs.aggregate_maxsim_device(scores.reshape(b, lq, k), slots, q_mask, keep, vocab=vocab, device=device)
    t1 = time.perf_counter()
    host = cs.aggregate_maxsim_batch(scores.reshape(b, lq, k), slots, q_mask, keep, vocab=vocab)
    result.update(device_merge_s=t1 - t0, host_merge_s=time.perf_counter() - t1)
    # unpacked candidate scores keep 16 mantissa bits (the lane bits are
    # cleared), so totals tie often: a document may differ only where it ties
    # with the last kept score (1e-5 relative)
    worst, swapped = 0.0, 0
    for qi, (d_row, h_row) in enumerate(zip(dev, host)):
        dd, hd = dict(d_row), dict(h_row)
        check(len(dd) == len(hd), f"colbert: merges of query {qi} keep {len(dd)} and {len(hd)} docs")
        worst = max([worst] + [abs(v - hd[x]) / max(abs(hd[x]), 1e-30) for x, v in d_row if x in hd])
        for row, other in ((dd, hd), (hd, dd)):
            cut = min(row.values())
            for x in set(row) - set(other):
                swapped += 1
                check(abs(row[x] - cut) <= 1e-5 * abs(cut), f"colbert: merges of query {qi} differ above the "
                      f"cut: {x} at {row[x]}, cut {cut}")
    result.update(merge_max_rel=worst, merge_tie_swaps=swapped)
    print(f"[colbert] device merge vs host merge over {b} queries, {keep} kept: max relative |d| {worst:.3g}; "
          f"{swapped} documents differ, each tied with its list's last score")
    check(worst <= 1e-5, f"colbert: device vs host merge relative |d| {worst}")

    # the batched rescore (the CLI's: one K14 launch for the batch) against
    # the per-query rescore, then the run file's scores against the plain
    # exact MaxSim
    store = cs.TokenVectorStore(enc)
    pad_t = -(-store.max_tokens // 8) * 8
    result["store_padded_tokens"] = pad_t
    check(pad_t == sz["maxsim_shapes"][2][3], f"colbert: the store's padded tokens {pad_t} are not phase 3's "
          f"rescore shape")
    rescore_n, top_n = sz["colbert_rescore_n"], sz["colbert_top_n"]
    lists = [row[:rescore_n] for row in dev]
    rows_dev = store.device_rows(device)  # the store's float16 rows, uploaded once
    batched = cs.exact_rescore_batch(q_vecs, q_mask, lists, store, top_n, rescore_n, pad_t, rows_dev)
    if device.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    cs.exact_rescore_batch(q_vecs, q_mask, lists, store, top_n, rescore_n, pad_t, rows_dev)
    result["rescore_ms_per_batch"] = (time.perf_counter() - t0) * 1e3
    q_host = q_vecs.cpu().numpy()
    t0 = time.perf_counter()
    worst = 0.0
    for qi in range(sz["colbert_checked_queries"]):
        one = cs.exact_rescore(q_host[qi], q_mask[qi], lists[qi], store, top_n, rescore_n, pad_t, device)
        check([d for d, _ in one] == [d for d, _ in batched[qi]], f"colbert: batched and per-query rescores "
              f"of query {qi} rank different documents")
        worst = max([worst] + [abs(a - c) / max(abs(c), 1e-30) for (_, a), (_, c) in zip(batched[qi], one)])
    result["rescore_ms_per_query"] = (time.perf_counter() - t0) * 1e3 / sz["colbert_checked_queries"]
    result["batched_vs_per_query_max_rel"] = worst
    print(f"[colbert] host clock: device merge {result['device_merge_s'] * 1e3:.1f} ms and host merge "
          f"{result['host_merge_s'] * 1e3:.1f} ms for {b} queries; batched exact rescore "
          f"{result['rescore_ms_per_batch']:.3f} ms for the batch of {b} ({result['rescore_ms_per_batch'] / b:.4f} "
          f"ms a query), the per-query rescore {result['rescore_ms_per_query']:.3f} ms a query; the same documents, "
          f"scores within {worst:.3g} relative")
    check(worst <= 1e-5, f"colbert: batched vs per-query rescore relative |d| {worst}")
    worst = 0.0
    for qi in range(sz["colbert_checked_queries"]):
        docs = run_file[qids[qi]]
        d = torch.zeros((len(docs), pad_t, dim), device=device)
        dm = torch.zeros((len(docs), pad_t), device=device)
        for j, (did, _) in enumerate(docs):
            v = torch.from_numpy(store.get(did)).to(device)
            d[j, :len(v)], dm[j, :len(v)] = v, 1.0
        qm = torch.from_numpy((q_mask[qi:qi + 1] > 0).astype(np.float32)).to(device)
        plain = ms.reference_maxsim_all_pairs(q_vecs[qi:qi + 1], d, qm, dm, float("-inf"))[0].cpu().numpy()
        got = np.array([sc for _, sc in docs])
        worst = max(worst, float((np.abs(got - plain) / np.maximum(np.abs(plain), 1.0)).max()))
        check(np.allclose(got, plain, rtol=1e-4, atol=1e-4), f"colbert: rescored scores of query {qids[qi]}")
    result["rescore_max_rel"] = worst
    print(f"[colbert] rescored run scores of {sz['colbert_checked_queries']} queries vs plain exact MaxSim: "
          f"max relative |d| {worst:.3g}")

    # recall@10 against an exhaustive exact MaxSim over every passage (K14)
    docs, dmask, doc_ids = _padded_docs(enc, device)
    qm_all = torch.from_numpy((q_mask > 0).astype(np.float32)).to(device)
    with torch.inference_mode():
        full = torch.cat([ms.maxsim_all_pairs(q_vecs, docs[s:s + 2048], qm_all, dmask[s:s + 2048],
                                              fill=float("-inf")) for s in range(0, len(doc_ids), 2048)], dim=1)
    top = torch.topk(full, sz["colbert_top_n"], dim=1).indices.cpu().tolist()
    recall = float(np.mean([len({doc_ids[i] for i in top[qi]} & {x for x, _ in run_file[qid]}) / sz["colbert_top_n"]
                            for qi, qid in enumerate(qids)]))
    result["recall@10_vs_exhaustive"] = recall
    print(f"[colbert] recall@{sz['colbert_top_n']} of the run vs exhaustive exact MaxSim over {len(doc_ids)} "
          f"passages: {recall:.4f} (reported, not gated)")
    del docs, dmask, full

    # device-only per-token search of one query batch
    ms_search = _time_ms(lambda: index._search_device(flat, k), device, sz["reps"])
    result.update(token_search_ms=ms_search, token_search_device_qps=b / ms_search * 1e3)
    print(f"[colbert] encode {result['encode_psg_per_s']:.1f} psg/s and search {result['search_qps']:.1f} QPS "
          f"through the CLI; device-only per-token search of {b * lq} query rows {ms_search:.3f} ms "
          f"({result['token_search_device_qps']:.1f} QPS)")
    return result


# ---- phase 5: search at scale ----------------------------------------------

def phase_scale(sz, device):
    import torch

    from matchmaker_tpu_torch.ops import _build
    from matchmaker_tpu_torch.retrieval.indexes import FlatIndex

    n, k = sz["scale_rows"], sz["scale_k"]
    rows, q = _clustered(n, sz["hid"], sz["scale_clusters"], device, seed=9, n_queries=256)
    vectors, queries = rows.cpu().numpy(), q.cpu().numpy()
    del rows
    index = FlatIndex({"token_dtype": "float16", "mips_quantization": "float16", "mips_kernel": "binmax"},
                      device)
    index.prepare(vectors.shape[1])
    index.index(np.arange(n), vectors)
    del vectors
    _build.reset_launches()
    scores, ids = index.search(queries, k)
    launches = dict(_build.LAUNCHES)
    check(np.isfinite(scores).all() and ((ids >= 0) & (ids < n)).all(), "padding leaked into the results")
    if device.type == "cuda":
        check(launches["level2_reduce"] > 0, "the scale search launched no level-2 kernel")
    corpus = index._device_vectors[:n]
    with torch.inference_mode():
        exact = torch.topk(torch.from_numpy(queries).to(device).to(torch.bfloat16).float() @ corpus.float().T,
                           k, dim=1).indices.cpu().numpy()
    recall = _overlap(ids, index.row_ids[exact])
    start = time.perf_counter()
    reps = 5
    for _ in range(reps):
        index.search_rows(queries, k)
    qps = len(queries) * reps / (time.perf_counter() - start)
    qb = torch.from_numpy(queries).to(device)
    from matchmaker_tpu_torch.ops import mips_binmax as mb

    per_bin = index._per_bin(k)
    ms = _time_ms(lambda: mb.binmax_scan_topk(qb, index._device_vectors, k, n_valid=n, per_bin=per_bin),
                  device, sz["reps"])
    print(f"[scale] {n} rows x {sz['hid']}, Q={len(queries)}, k={k}, per_bin={per_bin}: recall@{k} {recall:.4f}, "
          f"search_rows {qps:.1f} QPS, device scan+top-k {ms:.3f} ms ({len(queries) / ms * 1e3:.1f} QPS)")
    check(recall >= 0.95, f"recall@{k} {recall} < 0.95")
    # K4 at this search's own candidates (its level 2 follows the pool size)
    n_cands = n // 128 * per_bin
    level2 = mb.L2_WIDE if n_cands >= 128 * k else (mb.L2_MID if n_cands >= 16 * k else None)
    l2 = None
    if level2:
        cands = mb.binmax_candidates(qb, index._device_vectors, n_valid=n, per_bin=per_bin)
        l2 = level2_timings(mb, cands, level2, device, sz["reps"])
        print(f"[scale] level 2 width={level2} over the search's candidates {list(cands.shape)}: identical "
              f"{l2['identical']:.6f}; device {_fmt(l2['device_ms'])}, events {_fmt(l2['ms'])}, host "
              f"{_fmt(l2['host_ms'])} a call, bound {l2['bound_ms']:.4f} ms; torch.topk yardstick device "
              f"{_fmt(l2['library_device_ms'])}")
        check(l2["identical"] == 1.0, f"level 2 at the scale search's candidates: {l2['identical']} identical")
    return {"launches": launches, "recall": recall, "qps": qps, "device_ms": ms,
            "device_qps": len(queries) / ms * 1e3, "per_bin": per_bin, "level2_reduce": l2}


def phase_scale_int8(sz, device):
    """FlatIndex int8 search at scale: the mixed route (K8), the int8 +
    two-stage route (K7 + rescore) and the default int8 route (K7 alone),
    each an index built from its config, recall@k against an exact search
    of the unquantized rows (>= 0.95 for the mixed and two-stage routes;
    reported for the default route) and QPS."""
    import torch

    from matchmaker_tpu_torch.ops import _build
    from matchmaker_tpu_torch.retrieval.indexes import FlatIndex

    n, k = sz["scale_rows"], sz["scale_k"]
    rows, q = _clustered(n, sz["hid"], sz["scale_clusters"], device, seed=9, n_queries=256)
    queries = q.cpu().numpy()
    with torch.inference_mode():
        exact = torch.topk(q.to(torch.bfloat16).float() @ rows.to(torch.bfloat16).float().T, k,
                           dim=1).indices.cpu().numpy()
    vectors = rows.cpu().numpy()
    del rows
    result = {}
    for name, extra, scan in SCALE_INT8_RUNS:
        index = FlatIndex({"token_dtype": "float16", "mips_quantization": "int8", "mips_kernel": "binmax", **extra},
                          device)
        index.prepare(vectors.shape[1])
        index.index(np.arange(n), vectors)
        index._ensure_device()
        _build.reset_launches()
        scores, ids = index.search(queries, k)
        launches = dict(_build.LAUNCHES)
        check(np.isfinite(scores).all() and ((ids >= 0) & (ids < n)).all(), f"int8 {name}: padding leaked")
        if device.type == "cuda":
            check(launches[scan] > 0, f"int8 {name} at scale launched no {scan} kernel")
        recall = _overlap(ids, exact)
        qb = torch.from_numpy(queries).to(device)
        start = time.perf_counter()
        reps = 5
        for _ in range(reps):
            index.search_rows(queries, k)
        qps = len(queries) * reps / (time.perf_counter() - start)
        ms = _time_ms(lambda: index._search_int8(qb, k), device, sz["reps"])
        print(f"[scale-int8] {name}: {n} rows x {sz['hid']}, Q={len(queries)}, k={k}: recall@{k} {recall:.4f}, "
              f"search_rows {qps:.1f} QPS, device search {ms:.3f} ms ({len(queries) / ms * 1e3:.1f} QPS)")
        if name in GATED_INT8_RUNS:
            check(recall >= 0.95, f"int8 {name}: recall@{k} {recall} < 0.95")
        result[name] = {"launches": launches, "recall": recall, "qps": qps, "device_ms": ms,
                        "device_qps": len(queries) / ms * 1e3}
        del index
    return result


# ---- phase 6: the training path through cli.train's Trainer ----------------

def _write_train_data(root, sz, seed=2):
    """Seeded synthetic triples with teacher scores, a re-rank validation
    set (its first document per query relevant: it holds the query's words)
    and a collection with queries for the dense retrieval at the end."""
    rng = np.random.default_rng(seed)
    words = np.array([f"t{i}" for i in range(20_000)])

    def text(lo, hi):
        return " ".join(words[rng.integers(0, len(words), size=int(rng.integers(lo, hi)))])

    paths = {k: os.path.join(root, f) for k, f in (("train", "train.tsv"), ("val", "val.tsv"),
                                                    ("val_qrels", "val_qrels.txt"))}
    with open(paths["train"], "w") as f:
        for _ in range(sz["train_batches"] * sz["train_batch"]):
            f.write(f"{rng.uniform(5, 10):.3f}\t{rng.uniform(0, 5):.3f}\t{text(3, 12)}\t{text(150, 260)}"
                    f"\t{text(150, 260)}\n")
    with open(paths["val"], "w") as fv, open(paths["val_qrels"], "w") as fq:
        for qi in range(sz["val_queries"]):
            rel = text(150, 260)
            query = " ".join(rng.choice(rel.split(), size=5))
            for di in range(sz["val_docs"]):
                fv.write(f"q{qi}\td{qi}_{di}\t{query}\t{rel if di == 0 else text(150, 260)}\n")
            fq.write(f"q{qi} 0 d{qi}_0 1\n")
    dr_root = os.path.join(root, "dr")
    os.makedirs(dr_root)
    _write_collection(dr_root, dict(sz, passages=sz["dr_passages"], queries=sz["dr_queries"]), seed=3)
    paths.update(collection=os.path.join(dr_root, "collection.tsv"), queries=os.path.join(dr_root, "queries.tsv"),
                 qrels=os.path.join(dr_root, "qrels.txt"))
    return paths


def _train_config(paths, sz, device):
    """configs/train/defaults.yaml + configs/train/models/bert_dot.yaml at
    DistilBERT width, fused layers, with gradient clipping at 1.0, the run cut
    to ``train_batches`` steps with two validations, and the dense retrieval
    at the end."""
    return {
        "model": "bert_dot", "bert_pretrained_model": sz["model_name"], "random_seed": 1234, "use_fp16": True,
        "encoder_fused_attention": True, "device": str(device), "enable_tensorboard": False,
        "loss": "margin-mse", "train_pairwise_distillation": True, "in_batch_negatives": True,
        "in_batch_neg_loss": "margin-mse", "in_batch_neg_weight": 1.0, "in_batch_main_weight": 1.0,
        "param_group0_learning_rate": 7.0e-6, "param_group1_learning_rate": 7.0e-4,
        "embedding_optimizer_learning_rate": 7.0e-6, "weight_decay": 0.0, "lr_schedule": "cosine",
        "optimizer_warmup_steps": 1000, "max_training_steps": 300000, "gradient_clip_norm": 1.0,
        "batch_size_train": sz["train_batch"], "batch_size_eval": sz["eval_batch"],
        "max_query_length": sz["train_query_len"], "max_doc_length": sz["train_doc_len"], "epochs": 1,
        "validate_every_n_batches": sz["validate_every"], "max_training_batches": sz["train_batches"],
        "validation_metric": "MRR@10", "early_stopping_patience": 30, "train_tsv": paths["train"],
        "validation_cont": {"tsv": paths["val"], "qrels": paths["val_qrels"], "binarization_point": 1},
        "test": {"synthetic": {"tsv": paths["val"], "qrels": paths["val_qrels"], "binarization_point": 1}},
        "run_dense_retrieval_eval": True, "collection_tsv": paths["collection"], "collection_batch_size": sz["dr_batch"],
        "query_batch_size": 32, "faiss_index_type": "flat", "mips_quantization": "float16", "mips_kernel": "binmax",
        "token_dtype": "float16",
        "query_sets": {"dr_dev": {"queries_tsv": paths["queries"], "qrels": paths["qrels"], "top_n": sz["dr_top_n"],
                                  "binarization_point": 1}},
    }


def predicted_train_launches(sz):
    """K1/K2 launch once per layer and encode: two encodes (queries, packed
    docs) per training step, per eval batch and per test batch; one per
    corpus and query batch of the dense retrieval. K11/K12: once per layer
    and encode of a training step."""
    layers = sz["n_layers"]
    train = sz["train_batches"] * layers * 2
    eval_batches = -(-sz["val_queries"] * sz["val_docs"] // sz["eval_batch"])
    evals = (sz["train_batches"] // sz["validate_every"] + 1) * eval_batches * 2 * layers
    dense = (-(-sz["dr_passages"] // sz["dr_batch"]) + -(-sz["dr_queries"] // 32)) * layers
    forward = train + evals + dense
    return {"fused_attention_block": forward, "fused_mlp_block": forward,
            "fused_attention_block_bwd": train, "fused_mlp_block_bwd": train}


def _device_batch(config, tokenizer, path, device):
    import torch

    from matchmaker_tpu_torch.data.loaders import triple_training_loader

    batch = next(iter(triple_training_loader(config, tokenizer, path)))
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}


def _profile_steps(step, batch, step_ms, n=3, tag="train", watch=None):
    """Device time by kernel over n calls of ``step(batch)`` (torch.profiler),
    and the device's busy share of ``step_ms``, the call's time CUDA events
    measured without the profiler (whose own overhead stretches the wall
    time); ``watch`` {name: substring}: the ms a call of the kernels whose
    names hold each substring."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    step(batch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            step(batch)
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    rows = sorted(((key, us / 1e3 / n, count // n) for key, us, count in _kernel_times(prof)), key=lambda r: -r[1])
    busy = sum(r[1] for r in rows)
    print(f"[{tag}] profile of {n} calls: kernels {busy:.2f} ms a call, {busy / step_ms:.1%} of the "
          f"{step_ms:.2f} ms call without the profiler ({wall_ms / n:.2f} ms wall under it)")
    for key, ms, count in rows[:14]:
        print(f"[{tag}]   {ms:8.3f} ms/call {ms / busy if busy else 0:6.1%}  x{count:<4d} {key[:110]}")
    out = {"device_ms_per_step": busy, "busy_share": busy / step_ms, "profiled_wall_ms_per_step": wall_ms / n,
           "top": [{"kernel": k[:200], "ms_per_step": ms, "calls_per_step": c} for k, ms, c in rows[:25]]}
    if watch:
        out["watch"] = {name: sum(ms for k, ms, _ in rows if key in k) for name, key in watch.items()}
    return out


def _hardest_negatives(model, batch):
    """Each query's in-batch hardest negative (column of the B x 2B score
    matrix outside the diagonal: q.[d_pos; d_neg]^T, or the all-pairs
    MaxSim for token vectors), as the in-batch loss picks it."""
    import torch

    from matchmaker_tpu_torch.ops import maxsim as ms

    with torch.no_grad():
        pos, neg = model.forward_triple(batch)
        q = pos["query_vecs"].float()
        d = torch.cat([pos["doc_vecs"], neg["doc_vecs"]]).float()
        if q.dim() == 3:
            scores = ms.maxsim_all_pairs(q, d, pos["query_vecs_mask"],
                                         torch.cat([pos["doc_vecs_mask"], neg["doc_vecs_mask"]]))
        else:
            scores = q @ d.t()
    b = q.shape[0]
    scores[:, :b] = scores[:, :b].masked_fill(torch.eye(b, dtype=torch.bool, device=q.device), float("-inf"))
    return scores.argmax(dim=1)


@contextlib.contextmanager
def plain_maxsim():
    """Route the training step's all-pairs MaxSim to its plain version,
    differentiated by PyTorch (in place of K14's training form and the
    backward kernel)."""
    import matchmaker_tpu_torch.training.train_step as ts
    from matchmaker_tpu_torch.ops import maxsim as ms

    saved = ts.maxsim_all_pairs
    ts.maxsim_all_pairs = ms.reference_maxsim_all_pairs
    try:
        yield
    finally:
        ts.maxsim_all_pairs = saved


def _kernels_vs_plain_step(model, config, batch, smooth_config, tag, unreached=(), exact_zero=None):
    """One step's loss and gradients from the same parameters through the
    kernels and through the plain versions (encoder halves, and the
    all-pairs MaxSim where the model has one). The configured loss is
    compared as it is (relative gap <= 1e-2). The gradients are compared
    under ``smooth_config``'s loss (cosine >= 0.99 for every parameter): the
    in-batch pairwise loss picks each query's hardest negative by an argmax,
    and a score difference at bf16 rounding level can move that pick to
    another document, which changes the gradient whatever the kernels
    compute; the number of picks that move is reported. Every parameter
    gets a gradient in both runs but those whose names start with one of
    ``unreached`` (the parts of the model the loss does not reach), which
    get none in either. ``exact_zero``: {parameter: reference parameter}
    for gradients zero in exact arithmetic (as each key bias's): their
    rounding noise is bounded by 2e-2 of the reference's largest gradient
    instead."""
    import torch

    from matchmaker_tpu_torch.losses import get_loss
    from matchmaker_tpu_torch.training.train_step import make_loss_fn

    full = make_loss_fn(model, get_loss(config), config)
    smooth = make_loss_fn(model, get_loss(smooth_config), smooth_config)

    def run():
        with torch.no_grad():
            loss = float(full(batch)[0])
        model.zero_grad(set_to_none=True)
        smooth(batch)[0].backward()
        grads = {n: p.grad.detach().float().clone() for n, p in model.named_parameters() if p.grad is not None}
        return loss, grads, _hardest_negatives(model, batch) if config.get("in_batch_negatives") else None

    lk, gk, hk = run()
    with plain_encoder_blocks(), plain_maxsim():
        lp, gp, hp = run()
    model.zero_grad(set_to_none=True)
    names = {n for n, _ in model.named_parameters()}
    expected = {n for n in names if n.startswith(tuple(unreached))}
    for run_name, grads in (("kernels", gk), ("plain", gp)):
        check(names - set(grads) == expected, f"{tag}: the {run_name} run left {sorted(names - set(grads))} without "
              f"a gradient; expected {sorted(expected)}")
    rel = abs(lk - lp) / max(abs(lp), 1e-12)
    moved = int((hk != hp).sum()) if hk is not None else 0
    cosines, key_bias, plain_noise = {}, 0.0, 0.0
    for name, a in gk.items():
        b = gp[name]
        if name.endswith("attention.key.bias"):
            # zero in exact arithmetic (each softmax row's gradient sums to
            # zero): rounding noise, bounded by the query bias's gradient
            ref = float(gp[name.replace("key.bias", "query.bias")].abs().max())
            ratio = float((a - b).abs().max()) / ref
            key_bias = max(key_bias, ratio)
            plain_noise = max(plain_noise, float(b.abs().max()) / ref)  # the plain version's own noise, reported
            check(ratio <= 2e-2, f"{name}: gradient noise {ratio:.4g} of the query bias's, above 2e-2")
            continue
        if name in (exact_zero or {}):
            ratio = float((a - b).abs().max()) / float(gp[exact_zero[name]].abs().max())
            key_bias = max(key_bias, ratio)
            check(ratio <= 2e-2, f"{name}: gradient noise {ratio:.4g} of {exact_zero[name]}'s, above 2e-2")
            continue
        cosines[name] = float(torch.nn.functional.cosine_similarity(a.reshape(-1), b.reshape(-1), dim=0))
    worst = sorted(cosines.items(), key=lambda kv: kv[1])[:3]
    n_queries = len(hk) if hk is not None else 0
    print(f"[{tag}] one step, kernels vs plain: loss {lk:.6g} vs {lp:.6g} (relative gap {rel:.3g}); in-batch "
          f"hardest negative moved for {moved} of {n_queries} queries; gradients of {len(cosines)} parameters "
          f"under {smooth_config.get('in_batch_neg_loss') if smooth_config.get('in_batch_negatives') else 'no'} "
          f"in-batch loss, worst cosines " + ", ".join(f"{n} {c:.6f}" for n, c in worst)
          + f"; noise of the gradients zero in exact arithmetic (key biases) {key_bias:.4g} of their references' "
          f"(bar 2e-2; the plain version's own key-bias gradient {plain_noise:.4g} of them)")
    check(rel <= 1e-2, f"{tag}: loss with the kernels {lk} vs plain {lp}")
    check(worst[0][1] >= 0.99, f"{tag}: gradient cosine {worst[0][1]} at {worst[0][0]}")
    return {"plain_loss_gap": rel, "plain_grad_cos": worst[0][1], "hardest_negatives_moved": moved,
            "key_bias_noise": key_bias, "key_bias_plain_noise": plain_noise}


def _f32_twin(model):
    """A copy of ``model`` that computes in f32 (its parameters are f32
    already): the plain versions on it are the function without bf16
    rounding."""
    import copy

    import torch

    caches = {}
    for m in model.modules():  # the packed weights a layer keeps: rebuilt from the parameters
        for attr in ("_fused_cache", "_int8_cache"):
            if getattr(m, attr, None) is not None:
                caches[m, attr] = getattr(m, attr)
                setattr(m, attr, None)
    try:
        twin = copy.deepcopy(model)
    finally:
        for (m, attr), v in caches.items():
            setattr(m, attr, v)
    for m in twin.modules():
        if hasattr(m, "compute_dtype"):
            m.compute_dtype = torch.float32
    return twin


def _step_vs_f32(model, config, batch, smooth_config, tag, grad_rows=None):
    """One step through the kernels (bf16) and through the plain versions
    (bf16), each against the plain versions on an f32 twin of the model
    (:func:`_f32_twin`): the same function without bf16 rounding. Where a
    deep bf16 stack leaves a quantity at its rounding noise in both bf16
    runs (BERT-large at random weights: the plain bf16 key-bias gradient,
    zero in exact arithmetic, reaches 0.79 of the query bias's; deep
    layers' key-kernel gradients of the two bf16 runs agree to cosine 0.008;
    a Margin-MSE loss over 8 triples moves 1.6-5.3 % with the rounding),
    kernels vs plain compares noise with noise; so each is held to the f32
    twin instead, the kernels' error at most twice the plain bf16
    version's plus 1e-3 (the two round at different points: independent
    errors of one size): the batch's scores (mean |d| over the mean |score|,
    every triple, no gradient) and every parameter's gradient (relative
    norm of the difference, on the first ``grad_rows`` triples: the plain
    versions' f32 intermediates of the whole batch do not fit the card).
    The configured loss is reported against both. Returns the errors and
    the kernels-vs-plain-bf16 loss gap and worst gradient cosine (reported,
    not gated)."""
    import torch

    from matchmaker_tpu_torch.losses import get_loss
    from matchmaker_tpu_torch.training.train_step import forward_triple, make_loss_fn

    part = {k: v[:grad_rows] for k, v in batch.items()} if grad_rows else batch

    def run(m):
        full = make_loss_fn(m, get_loss(config), config)
        smooth = make_loss_fn(m, get_loss(smooth_config), smooth_config)
        with torch.no_grad():
            loss = float(full(batch)[0])
            pos, neg = forward_triple(m, batch)
            scores = torch.cat([pos["score"], neg["score"]]).float()
        m.zero_grad(set_to_none=True)
        smooth(part)[0].backward()
        grads = {n: p.grad.detach().float().clone() for n, p in m.named_parameters() if p.grad is not None}
        m.zero_grad(set_to_none=True)
        return loss, scores, grads

    lk, sk, gk = run(model)
    with plain_encoder_blocks(), plain_maxsim():
        lp, sp, gp = run(model)
        twin = _f32_twin(model)
        lf, sf, gf = run(twin)
        del twin
    check(set(gk) == set(gp) == set(gf), f"{tag}: the three runs' gradients cover other parameters")
    worst, cos_bf16 = (0.0, None), (1.0, None)
    for name, f in gf.items():
        scale = float(f.norm())
        ek, ep = float((gk[name] - f).norm()) / scale, float((gp[name] - f).norm()) / scale
        check(ek <= 2 * ep + 1e-3, f"{tag}: {name}'s gradient, kernels {ek:.4g} from f32 against the plain bf16 "
              f"version's {ep:.4g}")
        worst = max(worst, (ek / max(ep, 1e-12), name))
        if not name.endswith("attention.key.bias"):  # zero in exact arithmetic: no direction to compare
            c = float(torch.nn.functional.cosine_similarity(gk[name].reshape(-1), gp[name].reshape(-1), dim=0))
            cos_bf16 = min(cos_bf16, (c, name))
    mean = float(sf.abs().mean())
    score_k, score_p = float((sk - sf).abs().mean()) / mean, float((sp - sf).abs().mean()) / mean
    res = {"f32_score_err": score_k, "plain_f32_score_err": score_p, "f32_grad_error_ratio": worst[0],
           "f32_loss_gap": abs(lk - lf) / abs(lf), "plain_f32_loss_gap": abs(lp - lf) / abs(lf),
           "plain_loss_gap": abs(lk - lp) / abs(lp), "plain_grad_cos": cos_bf16[0]}
    print(f"[{tag}] one step against the f32 twin: scores' mean |d| kernels {score_k:.4g}, plain bf16 {score_p:.4g} "
          f"of the mean |score| ({sk.numel()} scores); every gradient's error from f32 within twice the plain bf16 "
          f"version's + 1e-3 (largest ratio {worst[0]:.3g} at {worst[1]}, {part['query_ids'].shape[0]} triples); "
          f"loss kernels {lk:.6g}, plain bf16 {lp:.6g}, f32 {lf:.6g}; kernels vs plain bf16 (reported): loss gap "
          f"{res['plain_loss_gap']:.3g}, worst gradient cosine {cos_bf16[0]:.6f} at {cos_bf16[1]}")
    check(score_k <= 2 * score_p + 1e-3, f"{tag}: the scores with the kernels {score_k} from f32, the plain bf16 "
          f"{score_p}")
    return res


def _train_through_trainer(sz, device, config, run_folder, steps, tag, before=None, teacher_config=None):
    """cli.train's Trainer on ``config`` for ``steps`` steps, its step
    recorded: the launch counts of the run, a finite loss every step, the
    Trainer's triples/s (validation included); the trainer, the result.
    ``before(trainer)`` runs before the training; ``teacher_config``: the
    dynamic teacher's config, handed to the Trainer."""
    import torch

    from matchmaker_tpu_torch.ops import _build
    from matchmaker_tpu_torch.training.trainer import Trainer

    os.makedirs(run_folder)
    fresh_perf_monitor()
    t0 = time.perf_counter()
    trainer = Trainer(config, run_folder, teacher_config=teacher_config)
    setup_s = time.perf_counter() - t0
    if before is not None:
        before(trainer)
    step_losses = []
    trainer_step = trainer.train_step

    def recording_step(batch):
        stats = trainer_step(batch)
        step_losses.append(stats["loss"])
        return stats

    trainer.train_step = recording_step
    _build.reset_launches()
    t0 = time.perf_counter()
    trainer.train()
    if device.type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    trainer.train_step = trainer_step
    print(f"[{tag}] launches in the cli.train run: {launches}")
    result = {"wall_s": wall, "setup_s": setup_s, "launches": launches, "steps": trainer.global_step}
    check(trainer.global_step == steps and len(step_losses) == steps,
          f"{tag}: {trainer.global_step} training steps, {len(step_losses)} losses")
    losses = torch.stack(step_losses).float().cpu()
    check(bool(torch.isfinite(losses).all()), f"{tag}: a non-finite training loss")
    result.update(loss_first=float(losses[0]), loss_last=float(losses[-1]))
    with open(os.path.join(run_folder, "efficiency-metrics.json")) as f:
        train_block = json.load(f)[-1]["blocks"]["train"]
    result["cli_triples_per_s"] = steps * sz["train_batch"] / train_block["total_seconds"]
    return trainer, result


def _step_speed(sz, device, trainer, batch, tag, watch=None, profile=True):
    """Device-only triples/s of the Trainer's step on one batch (CUDA
    events) and, on a card and with ``profile``, a profile of three steps
    (``watch``: see _profile_steps)."""
    ms = _time_ms(lambda: trainer.train_step(batch), device, sz["reps"])
    result = {"step_ms": ms, "device_triples_per_s": sz["train_batch"] / ms * 1e3}
    if device.type == "cuda" and profile:
        result["profile"] = _profile_steps(trainer.train_step, batch, ms, tag=tag, watch=watch)
    return result


def _overfit(sz, trainer, config, batch, tag, lr=1e-4, key="ranking_loss"):
    """A one-batch overfit from the current weights, no warmup, a constant
    learning rate: ``overfit_steps`` (30) steps must halve the ranking loss
    (Margin-MSE, RankNet), or the step's ``key`` stat. ``lr``: the
    encoder's learning rate, the heads' ten times it."""
    from matchmaker_tpu_torch.training.optim import build_optimizer
    from matchmaker_tpu_torch.training.train_step import make_train_step

    fit_config = dict(config, lr_schedule="constant", optimizer_warmup_steps=0, param_group0_learning_rate=lr,
                      embedding_optimizer_learning_rate=lr, param_group1_learning_rate=10 * lr)
    fit_step = make_train_step(trainer.model, trainer.losses, build_optimizer(fit_config, trainer.model), fit_config)
    fit = [float(fit_step(batch)[key]) for _ in range(sz["overfit_steps"])]
    name = config["loss"] if key == "ranking_loss" else key
    print(f"[{tag}] one-batch overfit, {sz['overfit_steps']} steps: {name} {fit[0]:.4f} -> {fit[-1]:.4f}")
    check(fit[-1] <= 0.5 * fit[0], f"{tag}: overfitting one batch took {name} only from {fit[0]} to {fit[-1]}")
    return {"overfit_first": fit[0], "overfit_last": fit[-1]}


def phase_train(sz, device, root):
    import torch

    paths = _write_train_data(root, sz)
    config = _train_config(paths, sz, device)
    run_folder = os.path.join(root, "train_run")
    trainer, result = _train_through_trainer(sz, device, config, run_folder, sz["train_batches"], "train")
    launches = result["launches"]
    if device.type == "cuda":
        want = predicted_train_launches(sz)
        for name, n in want.items():
            check(launches[name] == n, f"{name}: {launches[name]} launches, predicted {n}")
        for name in ("binmax_candidates", "unpack_candidates"):
            check(launches[name] > 0, f"the dense retrieval after training launched no {name} kernel")
    for rel in ("training-loss.csv", "validation-metrics-cont.csv", "best-model.npz", "best-info.csv",
                "efficiency-metrics.json", "test-synthetic-output.txt", "test-synthetic-metrics.csv",
                "dense-retrieval/dr_dev-output.txt", "dense-retrieval/dr_dev-metrics.csv"):
        check(os.path.isfile(os.path.join(run_folder, rel)), f"missing {rel} in the training run folder")
    with open(os.path.join(run_folder, "validation-metrics-cont.csv")) as f:
        check(len(f.read().strip().splitlines()) == 1 + sz["train_batches"] // sz["validate_every"],
              "one validation row per validation")

    batch = _device_batch(config, trainer.tokenizer, paths["train"], device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    result.update(_step_speed(sz, device, trainer, batch, "train"))
    print(f"[train] {trainer.global_step} steps: loss {result['loss_first']:.4f} -> {result['loss_last']:.4f}; "
          f"{result['cli_triples_per_s']:.1f} triples/s through the Trainer (validation included), "
          f"{result['device_triples_per_s']:.1f} device-only ({result['step_ms']:.2f} ms a step)")
    if device.type == "cuda":
        result["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
        print(f"[train] peak device memory over the profiled steps {result['peak_mem_gb']:.2f} GB")
    # the gradients under Margin-MSE alone (the in-batch loss's hardest negative is an argmax)
    result.update(_kernels_vs_plain_step(trainer.model, config, batch, dict(config, in_batch_negatives=False),
                                         "train"))
    result.update(_overfit(sz, trainer, config, batch, "train"))
    return result


# ---- phase 6b: ColBERT training through the same Trainer -----------------------

def _colbert_train_config(paths, sz, device):
    """configs/train/defaults.yaml + configs/train/models/colbert.yaml (model
    colbert, compression 128, 8 query [MASK]s, in-batch margin-mse) at
    DistilBERT width, fused layers, as phase 6's config: the run cut to
    ``colbert_train_batches`` steps with one validation and the test pass,
    no dense retrieval."""
    return dict(_train_config(paths, sz, device), model="colbert", colbert_compression_dim=128,
                query_augment_mask_number=8, in_batch_negatives=True, in_batch_neg_loss="margin-mse",
                validate_every_n_batches=sz["colbert_train_batches"], max_training_batches=sz["colbert_train_batches"],
                run_dense_retrieval_eval=False)


def predicted_colbert_train_launches(sz):
    """K1/K2 once per layer and encode: two encodes (queries, packed docs) a
    training step, an eval batch and a test batch; K11/K12 once per layer
    and encode of a training step; K14's training form and the backward
    kernel once a step (the in-batch all-pairs MaxSim); K14's plain launch
    never (re-ranking scores pairs in torch, as JAX does in jnp)."""
    layers, steps = sz["n_layers"], sz["colbert_train_batches"]
    eval_batches = -(-sz["val_queries"] * sz["val_docs"] // sz["eval_batch"])
    forward = steps * layers * 2 + 2 * eval_batches * 2 * layers
    return {"fused_attention_block": forward, "fused_mlp_block": forward,
            "fused_attention_block_bwd": steps * layers * 2, "fused_mlp_block_bwd": steps * layers * 2,
            "maxsim_all_pairs_argmax": steps, "maxsim_all_pairs_bwd": steps, "maxsim_all_pairs": 0}


def phase_train_colbert(sz, device, root):
    """ColBERT training through cli.train's Trainer at DistilBERT width
    (phase 6's data and checks): launch counts against the prediction, a
    finite loss every step, the run-folder files, triples/s through the
    Trainer and device-only, one step with the kernels against one with the
    plain versions, and a one-batch overfit (30 steps halve Margin-MSE).
    The gradients are compared under Margin-MSE plus the in-batch
    KLDivTeacherList over the same all-pairs MaxSim (against JAX's [I | 0]
    teacher): smooth in the scores, unlike the in-batch margin-mse's
    hardest-negative argmax, and it keeps K14's training form and backward
    kernel in the comparison."""
    steps = sz["colbert_train_batches"]
    paths = _write_train_data(root, dict(sz, train_batches=steps))
    config = _colbert_train_config(paths, sz, device)
    run_folder = os.path.join(root, "colbert_train_run")
    trainer, result = _train_through_trainer(sz, device, config, run_folder, steps, "train_colbert")
    launches = result["launches"]
    if device.type == "cuda":
        for name, n in predicted_colbert_train_launches(sz).items():
            check(launches[name] == n, f"ColBERT training: {name} {launches[name]} launches, predicted {n}")
    for rel in ("validation-metrics-cont.csv", "best-model.npz", "best-info.csv", "efficiency-metrics.json",
                "test-synthetic-output.txt", "test-synthetic-metrics.csv"):
        check(os.path.isfile(os.path.join(run_folder, rel)), f"missing {rel} in the ColBERT training run folder")

    batch = _device_batch(config, trainer.tokenizer, paths["train"], device)
    # the MaxSim pair's kernels and the step's copies (the f32 copies of
    # bf16 MaxSim inputs among them) beside the step's kernel time
    result.update(_step_speed(sz, device, trainer, batch, "train_colbert",
                              watch={"training form": "msim_train::", "backward": "msim_bwd::", "copies": "copy"}))
    print(f"[train_colbert] {steps} steps: loss {result['loss_first']:.4f} -> {result['loss_last']:.4f}; "
          f"{result['cli_triples_per_s']:.1f} triples/s through the Trainer (validation included), "
          f"{result['device_triples_per_s']:.1f} device-only ({result['step_ms']:.2f} ms a step; with the "
          f"first training kernels, PERF.md: 912.9-1,003.2 device-only)")
    if "profile" in result:
        part = result["maxsim_pair_ms_per_step"] = result["profile"]["watch"]
        print(f"[train_colbert] the MaxSim pair a step: training form {part['training form']:.4f} ms, backward "
              f"{part['backward']:.4f} ms, copy kernels {part['copies']:.4f} ms, of "
              f"{result['profile']['device_ms_per_step']:.2f} ms of kernels")
    result.update(_kernels_vs_plain_step(trainer.model, config, batch, dict(config, in_batch_neg_loss="KLDivTeacherList"),
                                         "train_colbert"))
    result.update(_overfit(sz, trainer, config, batch, "train_colbert"))
    return result


# ---- phase 8: the TAS-Balanced recipe and the effectiveness check --------------

def phase_recipe(sz, device, root):
    """cli/tasb_recipe.py's run_recipe with the JAX recipe's configuration
    (the mini-lm encoder, MLM warm start, a normalized ColBERT teacher, the
    TAS-Balanced student with the dynamic in-batch teacher, the scann
    search) at ``recipe_args``' scale, on the card: each stage's wall time,
    the teacher's pairwise accuracy, the cluster count, MRR@10 and
    Recall@100, gated on tests/test_tasb_recipe.py:31-32 (>= 0.2, >= 0.6);
    the launches of the whole run, K14's training form and backward (the
    teacher's training), its plain launch (the teacher's in-batch matrix)
    and the search's K3/K6 at least once each. Then cli/effectiveness_check
    at tests/test_effectiveness.py:38-45's scale, gated on MRR@10 >= 0.5."""
    from matchmaker_tpu_torch.cli.effectiveness_check import run_check
    from matchmaker_tpu_torch.cli.tasb_recipe import run_recipe, summarize
    from matchmaker_tpu_torch.ops import _build

    result = {}
    work = os.path.join(root, "tasb")
    fresh_perf_monitor()
    _build.reset_launches()
    t0 = time.perf_counter()
    out = run_recipe(work, device=str(device), **sz["recipe_args"])
    result["recipe_wall_s"] = time.perf_counter() - t0
    result["launches"] = launches = dict(_build.LAUNCHES)
    result.update(out, **summarize(work))
    print(f"[recipe] {sz['recipe_args']}: stages (s) {out['timings_s']}, {result['recipe_wall_s']:.1f} s in all; "
          f"teacher pairwise accuracy {result['teacher_pairwise_accuracy']:.4f} (margin "
          f"{result['teacher_margin_mean']:.3f} +/- {result['teacher_margin_std']:.3f} over "
          f"{result['scored_pairs']} pairs), {result['clusters']} clusters; MRR@10 {out['MRR@10']:.4f}, "
          f"Recall@100 {out['Recall@100']:.4f} over {out['QueriesRanked']:.0f} queries")
    print(f"[recipe] launches: {({k: v for k, v in launches.items() if v})}")
    check(out["MRR@10"] >= 0.2 and out["Recall@100"] >= 0.6,
          f"the recipe's MRR@10 {out['MRR@10']} / Recall@100 {out['Recall@100']} below 0.2 / 0.6")
    if device.type == "cuda":
        for name in ("maxsim_all_pairs_argmax", "maxsim_all_pairs_bwd", "maxsim_all_pairs", "binmax_candidates",
                     "unpack_candidates"):
            check(launches[name] > 0, f"the recipe launched no {name} kernel")
    fresh_perf_monitor()
    t0 = time.perf_counter()
    check_out = run_check(os.path.join(root, "eff"), device=str(device), **sz["effectiveness_args"])
    result["effectiveness"] = dict(check_out, wall_s=time.perf_counter() - t0)
    print(f"[recipe] effectiveness check {sz['effectiveness_args']}: MRR@10 {check_out['MRR@10']:.4f}, "
          f"Recall@100 {check_out['Recall@100']:.4f} in {result['effectiveness']['wall_s']:.1f} s")
    check(check_out["MRR@10"] >= 0.5, f"the effectiveness check's MRR@10 {check_out['MRR@10']} below 0.5")
    return result


# ---- phase 3, the re-rankers' shapes -------------------------------------------

def phase_rerank_kernels(sz, device, kern, shapes=None, path="rerank"):
    """K1, K2, K12 and K11 against their plain versions at the re-rankers'
    shapes (``rerank_shapes``: a BERT_CAT training batch of 30 + 200 = 230
    tokens, its eval batch, the 94-token maxP / PARADE chunks of a training
    batch, IDCM's, phase 12's list batch), or at ``shapes`` (``path``
    names them), ragged masks; each timed beside its plain version, with its
    device time and bound, into the kernel's timings (``path: rerank``)."""
    import torch

    from matchmaker_tpu_torch.ops import fused_attention as fa
    from matchmaker_tpu_torch.ops import fused_backward as fb

    attn, ln1, mlp, ln2 = _layer_params(sz, device, seed=17)
    wq, wk, wv, wo, bq, bk, bv, bo = attn
    wqkv, bqkv = torch.cat([wq, wk, wv], dim=1), torch.cat([bq, bk, bv])
    w1, b1, w2, _ = mlp
    heads, hid, ff = sz["heads"], sz["hid"], sz["ff"]
    for i, (b, l) in enumerate(shapes or sz["rerank_shapes"]):
        x, mask, g = _half_inputs(sz, b, l, device, 300 + i)
        dy = torch.randn(b, l, hid, generator=g, device=device).to(torch.bfloat16)
        a_args, m_args = (*attn, mask, heads, *ln1), (*mlp, *ln2)
        proj, core = _attention_ops(b, l, hid, heads)
        for name, kernel, plain, args, ops in (
                ("fused_attention_block", fa.fused_attention_block, fa.reference_attention_block, a_args,
                 dict(bf16=proj + core)),
                ("fused_mlp_block", fa.fused_mlp_block, fa.reference_mlp_block, m_args, dict(bf16=4 * b * l * hid * ff))):
            got, want = kernel(x, *args), plain(x, *args)
            cos, err = _rows_close(got, want)
            print(f"[kernels] {name} B={b} L={l} ({path}): min row cosine {cos:.6f}, max |d| {err:.4g}")
            check(got.shape == x.shape and bool(torch.isfinite(got.float()).all()), f"{name} output at {(b, l)}")
            check(cos >= 0.999 and err <= 0.1, f"{name} vs plain at {(b, l)}: cos {cos}, max |d| {err}")
            entry = kern[name]
            entry["max_abs_err"] = max(entry["max_abs_err"], err)
            run = lambda k=kernel, a=args: k(x, *a)  # noqa: E731
            _record(entry, [b, l, hid], run, lambda p=plain, a=args: p(x, *a), device, sz["reps"], headline=False,
                    bound_of=bound(nbytes(x, args, got), **ops))
            _device_beside(entry, run, device, headline=False)
            entry["timings"][-1]["path"] = path
        _, a_saved = fb.attention_block_fwd(x, wqkv, bqkv, wo, bo, mask, heads, *ln1)
        _, a_acc = fa.reference_attention_block(x, *attn, mask, heads, *ln1, save_acc=True)
        _, m_saved = fb.mlp_block_fwd(x, *mlp, *ln2)
        _, m_acc = fa.reference_mlp_block(x, *mlp, *ln2, save_acc=True)
        m = b * l
        for name, kernel, plain, name_k, name_p, scale_of, inputs, ops in (
                ("fused_attention_block_bwd",
                 lambda: fb.attention_block_bwd(x, wqkv, bqkv, wo, mask, heads, ln1[0], dy, a_saved),
                 lambda: fb.reference_attention_block_bwd(x, wq, wk, wv, wo, bq, bk, bv, mask, heads, ln1[0], dy,
                                                          a_acc),
                 lambda r: _named_attention_grads(*r), lambda r: dict(zip(_ATTN_GRADS, r)), _zero_attention_grads(l),
                 (x, wqkv, bqkv, wo, mask, ln1[0], dy, a_saved), dict(bf16=2 * proj + 5 * core // 2)),
                ("fused_mlp_block_bwd", lambda: fb.mlp_block_bwd(x, w1, b1, w2, ln2[0], dy, m_saved),
                 lambda: fb.reference_mlp_block_bwd(x, w1, b1, w2, ln2[0], dy, m_acc),
                 lambda r: dict(zip(_MLP_GRADS, r)), lambda r: dict(zip(_MLP_GRADS, r)), None,
                 (x, w1, b1, w2, ln2[0], dy, m_saved), dict(bf16=_mlp_bwd_ops(m, hid, ff)))):
            got, want = name_k(kernel()), name_p(plain())
            check(got["dx"].shape == x.shape and all(bool(torch.isfinite(t).all()) for t in got.values()),
                  f"{name} gradients at {(b, l)}")
            err = grads_close(got, want, scale_of)
            print(f"[kernels] {name} B={b} L={l} ({path}): {len(got)} gradients within cosine 0.999, "
                  f"max |d| <= 2e-2 max |plain| (largest |d| {err:.4g})")
            entry = kern[name]
            entry["max_abs_err"] = max(entry["max_abs_err"], err)
            _record(entry, [b, l, hid], kernel, plain, device, sz["bwd_reps"], headline=False,
                    bound_of=bound(nbytes(inputs, list(got.values())), **ops))
            _device_beside(entry, kernel, device, headline=False)
            entry["timings"][-1]["path"] = path
    return kern


# ---- phase 9: cross-encoder re-ranking and the Margin-MSE loop ------------------

RERANK_MODELS = ("prettr", "parade", "maxP->bert_cat", "meanP->bert_cat")


def _rerank_data(root, sz):
    """The planted corpus (data/synthetic.py): train triples for the
    re-rankers' steps, a collection of ``rerank_docs`` passages with queries
    and qrels for the student's dense retrieval, and a re-ranking tuple file
    (each eval query's relevant passage and ``rerank_val_docs`` - 1 others)
    for validation and test."""
    import random

    from matchmaker_tpu_torch.data.synthetic import make_planted_corpus

    n_triples = sz["rerank_steps"] * sz["rerank_batch"]
    paths = make_planted_corpus(os.path.join(root, "corpus"), n_train_queries=-(-n_triples // 3),
                                n_eval_queries=sz["rerank_val_queries"], n_docs=sz["rerank_docs"], seed=9)
    with open(paths["collection"]) as f:
        docs = dict(line.rstrip("\n").split("\t", 1) for line in f)
    with open(paths["queries"]) as f:
        queries = dict(line.rstrip("\n").split("\t", 1) for line in f)
    with open(paths["qrels"]) as f:
        rel = {line.split()[0]: line.split()[2] for line in f}
    rng = random.Random(10)
    ids = sorted(docs)
    paths["val"] = os.path.join(root, "val_tuples.tsv")
    with open(paths["val"], "w") as f:
        for qid, query in queries.items():
            others = [d for d in rng.sample(ids, sz["rerank_val_docs"]) if d != rel[qid]][:sz["rerank_val_docs"] - 1]
            for did in [rel[qid]] + others:
                f.write(f"{qid}\t{did}\t{query}\t{docs[did]}\n")
    return paths


def _rerank_config(paths, sz, device, model, ckpt, steps, **kw):
    """configs/train/defaults.yaml + configs/train/models/<model>.yaml
    (bert_cat: ranknet, batch 16; prettr: joined after layer 3; parade: tf
    with 2 aggregator layers; maxP / meanP over chunks of 50 + 2 x 7) at
    DistilBERT width, fused layers, warm-started from the imported
    checkpoint, query 30 / doc 200, the run cut to ``steps`` steps with one
    validation each ``rerank_validate_every`` and the test pass."""
    from matchmaker_tpu_torch.config import auto_fill

    val = {"tsv": paths["val"], "qrels": paths["qrels"], "binarization_point": 1}
    return auto_fill({
        "model": model, "bert_pretrained_model": ckpt, "random_seed": 1234, "use_fp16": True,
        "encoder_fused_attention": True, "device": str(device), "enable_tensorboard": False, "loss": "ranknet",
        "param_group0_learning_rate": 7.0e-6, "param_group1_learning_rate": 7.0e-4,
        "embedding_optimizer_learning_rate": 7.0e-6, "weight_decay": 0.0, "lr_schedule": "cosine",
        "optimizer_warmup_steps": 1000, "max_training_steps": 300000, "gradient_clip_norm": 1.0,
        "batch_size_train": sz["rerank_batch"], "batch_size_eval": sz["rerank_eval_batch"],
        "max_query_length": sz["rerank_query_len"], "max_doc_length": sz["rerank_doc_len"], "epochs": 1,
        "validate_every_n_batches": min(steps, sz["rerank_validate_every"]), "max_training_batches": steps,
        "validation_metric": "MRR@10", "early_stopping_patience": 30, "train_tsv": paths["train_tsv"],
        "prettr_join_layer_idx": sz["prettr_join"], "parade_aggregate_type": "tf", "parade_aggregate_layers": 2,
        "idcm_chunk_size": sz["chunk_size"], "idcm_overlap": sz["chunk_overlap"],
        "validation_cont": val, "test": {"planted": dict(val)}, **kw})


def predicted_rerank_launches(sz, model, steps, validations):
    """K1/K2 once per layer and pass, K11/K12 once per layer and pass of a
    training step. A step scores the positive and the negative pairs in two
    passes, an eval batch (validations and the test pass) in one. A pass runs
    each layer once (BERT_CAT, PARADE and the chunk adapters over the B x C
    chunk rows), PreTTR's its first ``prettr_join`` layers twice (the query
    and the document towers) and the rest once (their join)."""
    per_pass = sz["n_layers"] + (sz["prettr_join"] if model == "prettr" else 0)
    eval_batches = -(-sz["rerank_val_queries"] * sz["rerank_val_docs"] // sz["rerank_eval_batch"])
    train = steps * 2 * per_pass
    forward = train + (validations + 1) * eval_batches * per_pass
    return {"fused_attention_block": forward, "fused_mlp_block": forward,
            "fused_attention_block_bwd": train, "fused_mlp_block_bwd": train}


def _check_launches(launches, want, tag, device):
    if device.type == "cuda":
        for name, n in want.items():
            check(launches[name] == n, f"{tag}: {name} {launches[name]} launches, predicted {n}")


def _import_checkpoints(sz, root):
    """Part (a): a seeded DistilBERT checkpoint at the phase's width written
    twice, ``pytorch_model.bin`` (torch.save, Hugging Face names with the
    ``distilbert.`` prefix) and a hand-written ``model.safetensors``; both
    imported (models/hf_import.py) to the same tensors bit for bit, each the
    checkpoint's own; and through ``bert_pretrained_model: <dir>`` into a
    BERT_CAT's encoder; importing both in a fresh interpreter loads no
    ``transformers`` module."""
    import importlib.util

    import torch

    from matchmaker_tpu_torch.data.tokenization import HashBertTokenizer
    from matchmaker_tpu_torch.models import get_model, hf_import, init_params
    from matchmaker_tpu_torch.models.encoder import EncoderConfig

    cfg = EncoderConfig(vocab_size=sz["vocab"], hidden_size=sz["hid"], num_layers=sz["n_layers"],
                        num_heads=sz["heads"], intermediate_size=sz["ff"], max_position_embeddings=512)
    config, sd = hf_import.seeded_distilbert_checkpoint(cfg, seed=15)
    dirs = {"bin": os.path.join(root, "ckpt_bin"), "safetensors": os.path.join(root, "ckpt_safetensors")}
    t0 = time.perf_counter()
    hf_import.save_hf_checkpoint(dirs["bin"], config, {"distilbert." + k: v for k, v in sd.items()}, False)
    hf_import.save_hf_checkpoint(dirs["safetensors"], config, sd, True)
    write_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    (c_bin, s_bin), (c_st, s_st) = (hf_import.load_hf_encoder(d) for d in (dirs["bin"], dirs["safetensors"]))
    read_s = time.perf_counter() - t0
    check(c_bin == c_st and (c_bin.hidden_size, c_bin.num_layers) == (sz["hid"], sz["n_layers"]),
          f"checkpoint configs {c_bin} / {c_st}")
    check(set(s_bin) == set(s_st) and all(torch.equal(s_bin[k], s_st[k]) for k in s_bin),
          "the .bin and .safetensors imports differ")
    check(torch.equal(s_st["layer_0.attention.query.kernel"], sd["transformer.layer.0.attention.q_lin.weight"].t())
          and torch.equal(s_st["word_embeddings.embedding"], sd["embeddings.word_embeddings.weight"]),
          "the import is not the checkpoint's tensors")
    bert_cat = {"model": "bert_cat", "model_input_type": "concatenated", "bert_pretrained_model": dirs["safetensors"]}
    model = get_model(bert_cat, HashBertTokenizer(sz["vocab"]))
    init_params(model, bert_cat, torch.Generator().manual_seed(0))
    enc = model.encoder.state_dict()
    check(set(enc) == set(s_st) and all(torch.equal(enc[k], s_st[k]) for k in enc),
          "bert_pretrained_model: <dir> did not fill the BERT_CAT encoder")
    # in a fresh interpreter: an earlier phase's tokenizer factory may have
    # imported transformers where the machine has it
    code = ("import sys; from matchmaker_tpu_torch.models import hf_import; "
            + "".join(f"hf_import.load_hf_encoder({d!r}); " for d in dirs.values())
            + "sys.exit(3 if 'transformers' in sys.modules else 0)")
    fresh = subprocess.run([sys.executable, "-c", code], cwd=ROOT, timeout=600)
    check(fresh.returncode == 0, f"importing the checkpoints in a fresh interpreter: exit {fresh.returncode} (3: "
          "it loaded transformers)")
    n_bytes = sum(t.numel() * t.element_size() for t in sd.values())
    print(f"[rerank] (a) checkpoint of {n_bytes / 1e6:.1f} MB written as .bin and .safetensors in {write_s:.2f} s, "
          f"both imported in {read_s:.2f} s, bit for bit; a fresh interpreter importing both loads no transformers "
          f"(installed here: {importlib.util.find_spec('transformers') is not None})")
    return dirs, {"checkpoint_mb": n_bytes / 1e6, "write_s": write_s, "import_s": read_s}


def _eval_batch_vs_plain(trainer, path, device, tag):
    """The scores of the first eval batch of ``path`` with the kernels and
    with the plain versions (valid rows): cosine >= 0.999, max |d| <= 0.1."""
    import torch

    from matchmaker_tpu_torch.data.loaders import reranking_inference_loader

    batch, _, _ = next(iter(reranking_inference_loader(trainer.config, trainer.tokenizer, path)))
    batch = {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
    valid = batch["valid"] > 0
    trainer.model.eval()
    got = trainer.eval_step(batch)["score"].float()[valid]
    with plain_encoder_blocks():
        want = trainer.eval_step(batch)["score"].float()[valid]
    cos = float(torch.nn.functional.cosine_similarity(got, want, dim=0))
    err = float((got - want).abs().max())
    print(f"[rerank] {tag}: one eval batch ({int(valid.sum())} pairs), kernels vs plain: cosine {cos:.6f}, "
          f"max |d| {err:.4g}")
    check(cos >= 0.999 and err <= 0.1, f"{tag}: eval scores, kernels vs plain: cosine {cos}, max |d| {err}")
    return {"eval_cos": cos, "eval_max_abs": err}


def _free(trainer, device):
    import torch

    del trainer
    if device.type == "cuda":
        torch.cuda.empty_cache()


def phase_rerank(sz, device, root):
    """Phase 9: (a) checkpoint import; (b) BERT_CAT training through
    cli.train's Trainer; (c) teacher scoring (cli.score_teacher's
    score_triples) with (b)'s run; (d) a BERT_DOT student trained with
    Margin-MSE on (c)'s file, its dense retrieval at the end; (e) PreTTR,
    PARADE, maxP->bert_cat and meanP->bert_cat through the Trainer."""
    import torch

    from matchmaker_tpu_torch.cli.score_teacher import score_triples
    from matchmaker_tpu_torch.obs.perf_monitor import PerformanceMonitor

    result = {"launches": {}}

    def add_launches(launches):
        for k, v in launches.items():
            result["launches"][k] = result["launches"].get(k, 0) + v

    paths = _rerank_data(root, sz)
    dirs, result["import"] = _import_checkpoints(sz, root)
    ckpt = dirs["safetensors"]
    rsz = dict(sz, train_batch=sz["rerank_batch"])

    # (b) BERT_CAT
    steps = sz["rerank_steps"]
    config = _rerank_config(paths, sz, device, "bert_cat", ckpt, steps)
    run_folder = os.path.join(root, "bert_cat_run")
    trainer, res = _train_through_trainer(rsz, device, config, run_folder, steps, "rerank bert_cat")
    add_launches(res["launches"])
    _check_launches(res["launches"], predicted_rerank_launches(sz, "bert_cat", steps,
                                                               steps // config["validate_every_n_batches"]),
                    "BERT_CAT training", device)
    for rel in ("validation-metrics-cont.csv", "best-model.npz", "best-info.csv", "test-planted-output.txt",
                "test-planted-metrics.csv"):
        check(os.path.isfile(os.path.join(run_folder, rel)), f"missing {rel} in the BERT_CAT run folder")
    batch = _device_batch(config, trainer.tokenizer, paths["train_tsv"], device)
    res.update(_step_speed(rsz, device, trainer, batch, "rerank bert_cat"))
    print(f"[rerank] (b) BERT_CAT {steps} steps: loss {res['loss_first']:.4f} -> {res['loss_last']:.4f}; "
          f"{res['cli_triples_per_s']:.1f} triples/s through the Trainer (validation included), "
          f"{res['device_triples_per_s']:.1f} device-only ({res['step_ms']:.2f} ms a step of "
          f"{sz['rerank_batch']} x 2 x {sz['rerank_query_len'] + sz['rerank_doc_len']} tokens)")
    # gradients under a pointwise loss: a pairwise loss's gradient is the
    # difference of the positive and the negative pass's, which cancels for
    # parameters that move both scores alike (exactly, for the last
    # LayerNorm's bias: it shifts both CLS vectors by the same amount), so
    # what is left of it is bf16 rounding whatever the kernels compute
    res.update(_kernels_vs_plain_step(trainer.model, config, batch, dict(config, loss="MSETeacherPointwise"),
                                      "rerank bert_cat"))
    # 3e-4: a cross-encoder's RankNet starts at ln 2 with the two scores of a
    # triple alike, and only its encoder can tell the passages apart
    res.update(_overfit(rsz, trainer, config, batch, "rerank bert_cat", lr=3e-4))
    res.update(_eval_batch_vs_plain(trainer, paths["val"], device, "bert_cat"))
    result["bert_cat"] = res
    _free(trainer, device)

    # (c) teacher scoring
    scored = {}
    for plain in (False, True):
        fresh_perf_monitor()
        out = os.path.join(root, f"teacher_scores{'_plain' if plain else ''}.tsv")
        with plain_encoder_blocks() if plain else contextlib.nullcontext():
            n = score_triples(run_folder, paths["train_tsv"], out, batch_size=sz["rerank_eval_batch"], config=config,
                              device=str(device))
        block = PerformanceMonitor.get().summary()["teacher_scoring"]
        with open(out) as f:
            rows = [line.rstrip("\n").split("\t") for line in f]
        with open(paths["train_tsv"]) as f:
            n_triples = sum(1 for _ in f)
        check(n == len(rows) == n_triples and all(len(r) == 5 for r in rows),
              f"teacher scoring wrote {len(rows)} rows for {n} of {n_triples} triples")
        scored[plain] = (torch.tensor([[float(r[0]), float(r[1])] for r in rows]), block["total_seconds"], out)
    (got, secs, score_file), (want, _, _) = scored[False], scored[True]
    cos = float(torch.nn.functional.cosine_similarity(got.reshape(-1), want.reshape(-1), dim=0))
    err = float((got - want).abs().max())
    acc = float((got[:, 0] > got[:, 1]).float().mean())
    check(cos >= 0.999 and err <= 0.1, f"teacher scores, kernels vs plain: cosine {cos}, max |d| {err}")
    # the rate: the train triples repeated, so that the first batch's cold
    # costs are a small share of the window
    timing = os.path.join(root, "timing_triples.tsv")
    with open(paths["train_tsv"]) as f:
        lines = f.readlines()
    with open(timing, "w") as f:
        f.writelines(lines * -(-sz["rerank_timing_triples"] // len(lines)))
    fresh_perf_monitor()
    n_timed = score_triples(run_folder, timing, os.path.join(root, "timing_scores.tsv"),
                            batch_size=sz["rerank_eval_batch"], config=config, device=str(device))
    timed_secs = PerformanceMonitor.get().summary()["teacher_scoring"]["total_seconds"]
    result["teacher"] = {"triples": n, "parity_pairs_per_s": 2 * n / secs, "timed_triples": n_timed,
                         "pairs_per_s": 2 * n_timed / timed_secs, "pairwise_accuracy": acc, "scores_cos": cos,
                         "scores_max_abs": err, "seconds": timed_secs}
    print(f"[rerank] (c) score_triples: {2 * n_timed / timed_secs:.1f} pairs/s over {n_timed} triples (batch "
          f"{sz['rerank_eval_batch']}, tokenization included; {2 * n / secs:.1f} over the {n} of the parity check), "
          f"teacher pairwise accuracy {acc:.4f}; kernels vs plain scores: cosine {cos:.6f}, max |d| {err:.4g}")

    # (d) the Margin-MSE student
    s_steps = sz["student_steps"]
    student = dict(_rerank_config(paths, sz, device, "bert_dot", ckpt, s_steps), model="bert_dot",
                   model_input_type="independent", loss="margin-mse", train_pairwise_distillation=True,
                   train_tsv=score_file, run_dense_retrieval_eval=True, collection_tsv=paths["collection"],
                   collection_batch_size=sz["dr_batch"], query_batch_size=32, faiss_index_type="flat",
                   mips_quantization="float16", mips_kernel="binmax", token_dtype="float16",
                   query_sets={"dr_dev": {"queries_tsv": paths["queries"], "qrels": paths["qrels"],
                                          "top_n": sz["dr_top_n"], "binarization_point": 1}})
    s_folder = os.path.join(root, "student_run")
    trainer, res = _train_through_trainer(rsz, device, student, s_folder, s_steps, "rerank student")
    add_launches(res["launches"])
    for rel in ("best-model.npz", "test-planted-output.txt", "dense-retrieval/dr_dev-output.txt",
                "dense-retrieval/dr_dev-metrics.csv"):
        check(os.path.isfile(os.path.join(s_folder, rel)), f"missing {rel} in the student's run folder")
    if device.type == "cuda":
        for name in ("fused_attention_block", "fused_attention_block_bwd", "binmax_candidates"):
            check(res["launches"][name] > 0, f"the student's run launched no {name} kernel")
    print(f"[rerank] (d) BERT_DOT student, Margin-MSE on the teacher's file, {s_steps} steps: loss "
          f"{res['loss_first']:.4f} -> {res['loss_last']:.4f}, dense retrieval files present")
    result["student"] = res
    _free(trainer, device)

    # (e) the other re-rankers
    o_steps = sz["rerank_other_steps"]
    for model in RERANK_MODELS:
        kw = {"test": {"planted": {"tsv": paths["val"], "qrels": paths["qrels"], "binarization_point": 1,
                                   "save_secondary_output": True}}} if model == "parade" else {}
        cfg = _rerank_config(paths, sz, device, model, ckpt, o_steps, **kw)
        folder = os.path.join(root, model.replace("->", "_") + "_run")
        trainer, res = _train_through_trainer(rsz, device, cfg, folder, o_steps, f"rerank {model}")
        add_launches(res["launches"])
        _check_launches(res["launches"], predicted_rerank_launches(sz, model, o_steps, 1), model, device)
        for rel in ("validation-metrics-cont.csv", "test-planted-output.txt", "test-planted-metrics.csv") + (
                ("test-planted-secondary.npz",) if model == "parade" else ()):
            check(os.path.isfile(os.path.join(folder, rel)), f"missing {rel} in the {model} run folder")
        res.update(_eval_batch_vs_plain(trainer, paths["val"], device, model))
        print(f"[rerank] (e) {model} {o_steps} steps: loss {res['loss_first']:.4f} -> {res['loss_last']:.4f}, "
              f"{res['cli_triples_per_s']:.1f} triples/s through the Trainer (validation included)")
        result[model] = res
        _free(trainer, device)
    return result


# ---- phase 10: the kernel-pooling family and IDCM -------------------------------

POOLING_MODELS = ("knrm", "conv_knrm", "tk", "tk_sparse", "tkl")
# configs/train/models/<model>.yaml; Conv-KNRM has no file: the JAX defaults
POOLING_CONFIGS = {
    "knrm": {"knrm_kernels": 11, "loss": "margin", "param_group1_learning_rate": 1.0e-3},
    "conv_knrm": {"conv_knrm_ngrams": 3, "conv_knrm_kernels": 11, "conv_knrm_conv_out_dim": 128},
    "tk": {"tk_att_heads": 10, "tk_att_layer": 2, "tk_att_ff_dim": 100, "tk_use_diff_posencoding": True,
           "tk_mix_hybrid_context": True, "tk_kernels_mu": [1.0, 0.9, 0.7, 0.5, 0.3, 0.1, -0.1, -0.3, -0.5, -0.7, -0.9],
           "tk_kernels_sigma": [0.0001] + [0.1] * 10},
    "tk_sparse": {"minimize_sparsity_weight": 0.4, "tk_att_heads": 10, "tk_att_layer": 2, "tk_att_ff_dim": 100},
    "tkl": {"max_doc_length": 2000, "tkl_chunk_size": 40, "tkl_overlap": 5, "tkl_sliding_window_size": 30,
            "tkl_top_k_chunks": 3, "tkl_saturation": "log", "tk_att_heads": 10, "tk_att_layer": 2,
            "tk_att_ff_dim": 100},
}
IDCM_CONFIG = {"max_doc_length": 2000, "idcm_chunk_size": 50, "idcm_overlap": 7, "idcm_sample_n": 3,
               "idcm_top_k_chunks": 3, "idcm_sample_context": "ck", "idcm_sample_train_type": "kldivloss",
               "idcm_train_selection": False}
# what stage 1's loss does not reach: the sampler (``sample_n`` -1 skips
# it) and the top-k weights (a passage loss reads the chunk scores alone)
IDCM_STAGE1_UNREACHED = ("kernel_alpha_scaler", "sampling_binweights.", "sample_cnn3.", "sample_projector.",
                         "tk_projector.", "tk_contextualizer.", "top_k_scoring")


def _long_doc(rng, text, words, noise, chunk):
    """A document of ``words`` noise-vocabulary words with ``text`` placed
    at the start (plus 5 words) of a random chunk of ``chunk`` tokens; the
    text's first word index."""
    filler = [rng.choice(noise) for _ in range(words)]
    planted = text.split()
    start = rng.randrange(0, words // chunk) * chunk + 5
    filler[start:start + len(planted)] = planted
    return " ".join(filler[:words]), start


def _pooling_data(root, sz):
    """The planted corpus (data/synthetic.py): train triples and a re-ranking
    tuple file (each eval query's relevant document and ``pool_val_docs`` - 1
    others); the same triples and tuples with documents of
    ``pool_long_words`` words (the planted document in a random chunk of
    noise-vocabulary filler) for TKL and IDCM, the IDCM triples with teacher
    passage scores (the planted chunk 8, every other chunk 1); a vocabulary
    of ``pool_vocab`` entries (the corpus's 800 words first) and a
    text-format embedding file of its first ``pool_glove_rows`` words
    (``pool_dim`` wide), written from a seed."""
    import random

    from matchmaker_tpu_torch.data.synthetic import make_planted_corpus

    n_triples = sz["pool_steps"] * sz["pool_batch"]
    paths = make_planted_corpus(os.path.join(root, "corpus"), n_train_queries=-(-n_triples // 3),
                                n_eval_queries=sz["pool_val_queries"], n_docs=sz["pool_docs"], seed=11)
    with open(paths["collection"]) as f:
        docs = dict(line.rstrip("\n").split("\t", 1) for line in f)
    with open(paths["queries"]) as f:
        queries = dict(line.rstrip("\n").split("\t", 1) for line in f)
    with open(paths["qrels"]) as f:
        rel = {line.split()[0]: line.split()[2] for line in f}
    rng = random.Random(12)
    ids = sorted(docs)
    tuples = []
    for qid, query in queries.items():
        others = [d for d in rng.sample(ids, sz["pool_val_docs"]) if d != rel[qid]][:sz["pool_val_docs"] - 1]
        tuples += [(qid, did, query, docs[did]) for did in [rel[qid]] + others]
    paths["val"] = os.path.join(root, "val_tuples.tsv")
    with open(paths["val"], "w") as f:
        f.writelines(f"{q}\t{d}\t{qt}\t{dt}\n" for q, d, qt, dt in tuples)

    noise = [f"noise{i}" for i in range(400)]
    words, chunk = sz["pool_long_words"], sz["chunk_size"]
    n_chunks = -(-words // chunk)
    paths["long_val"] = os.path.join(root, "long_val_tuples.tsv")
    with open(paths["long_val"], "w") as f:
        for q, d, qt, dt in tuples:
            f.write(f"{q}\t{d}\t{qt}\t{_long_doc(rng, dt, words, noise, chunk)[0]}\n")
    paths["long_train"] = os.path.join(root, "long_train.tsv")
    paths["idcm_train"] = os.path.join(root, "idcm_train.tsv")
    with open(paths["train_tsv"]) as f, open(paths["long_train"], "w") as lt, open(paths["idcm_train"], "w") as it:
        for line in f:
            query, pos, neg = line.rstrip("\n").split("\t")
            pos_long, start = _long_doc(rng, pos, words, noise, chunk)
            neg_long = _long_doc(rng, neg, words, noise, chunk)[0]
            lt.write(f"{query}\t{pos_long}\t{neg_long}\n")
            # HashBertTokenizer puts [CLS] first: word w is token w + 1
            psg = ["1.0"] * n_chunks
            psg[(start + 1) // chunk] = "8.0"
            it.write(f"8.0\t{' '.join(psg)}\t1.0\t{' '.join(['1.0'] * n_chunks)}\t{query}\t{pos_long}\t{neg_long}\n")

    with open(paths["vocab"]) as f:
        corpus_words = [w for w in f.read().split("\n") if w]
    paths["pool_vocab"] = os.path.join(root, "vocab_400k.txt")
    with open(paths["pool_vocab"], "w") as f:
        f.write("\n".join(corpus_words + [f"x{i}" for i in range(sz["pool_vocab"] - 2 - len(corpus_words))]) + "\n")
    vocab_words = corpus_words + [f"x{i}" for i in range(sz["pool_glove_rows"] - len(corpus_words))]
    vectors = np.random.default_rng(13).normal(0.0, 0.4, size=(len(vocab_words), sz["pool_dim"])).astype(np.float32)
    paths["glove"] = os.path.join(root, "glove.txt")
    with open(paths["glove"], "w") as f:
        for w, row in zip(vocab_words, np.char.mod("%.5f", vectors)):
            f.write(w + " " + " ".join(row) + "\n")
    return paths


def _pooling_config(paths, sz, device, model, steps=None):
    """configs/train/defaults.yaml + the model's file, 300-d embeddings from
    the seeded embedding file over the 400,000-entry vocabulary, batch 32,
    query 30 / doc 200 (TKL 2,000), the run cut to ``steps`` (phase 10:
    ``pool_steps``) steps with one validation at the end and the test
    pass. Phase 12's classic models take the same configuration."""
    from matchmaker_tpu_torch.config import auto_fill

    long_docs = model == "tkl"
    val = {"tsv": paths["long_val" if long_docs else "val"], "qrels": paths["qrels"], "binarization_point": 1}
    steps = steps or sz["pool_steps"]
    return auto_fill({
        "model": model, "random_seed": 1234, "device": str(device), "enable_tensorboard": False,
        "token_embedder_type": "embedding", "vocab_directory": paths["pool_vocab"],
        "pre_trained_embedding": paths["glove"], "token_embedding_size": sz["pool_dim"], "loss": "ranknet",
        "param_group0_learning_rate": 7.0e-6, "param_group1_learning_rate": 7.0e-4,
        "embedding_optimizer_learning_rate": 7.0e-6, "weight_decay": 0.0, "lr_schedule": "cosine",
        "optimizer_warmup_steps": 1000, "max_training_steps": 300000,
        "batch_size_train": sz["pool_batch"], "batch_size_eval": sz["pool_eval_batch"],
        "max_query_length": sz["rerank_query_len"], "max_doc_length": sz["rerank_doc_len"], "epochs": 1,
        "validate_every_n_batches": steps, "max_training_batches": steps, "validation_metric": "MRR@10",
        "train_tsv": paths["long_train" if long_docs else "train_tsv"], "validation_cont": val,
        "test": {"planted": dict(val)}, **{**POOLING_CONFIGS, **ZOO_CONFIGS}[model],
        **({"max_doc_length": sz["pool_long_words"]} if long_docs else {})})


def _exact_match_acts(model, name, ids, mask):
    """The exact-match kernel's (mu 1, sigma 1e-4) activation of each live
    token against itself (query and document the same tokens) through the
    model's representation and ``cosine_match_matrix``: KNRM's embeddings,
    Conv-KNRM's 2-gram convolution, TK's, TK-Sparse's and TKL's
    contextualization (both sides at the query's positions)."""
    import torch

    from matchmaker_tpu_torch.ops.kernel_pooling import cosine_match_matrix, kernel_activations

    with torch.no_grad():
        emb = model.embedder(ids, mask)
        if name == "knrm":
            rep = emb
        elif name == "conv_knrm":
            rep = torch.relu(model.conv_2gram(emb))
        else:
            rep = model.contextualize(emb, mask, model.pos_q)
        acts = kernel_activations(cosine_match_matrix(rep, rep), model.mu, model.sigma)[..., 0]
    return torch.diagonal(acts, dim1=1, dim2=2)[mask > 0]


def _scores_on_card_and_cpu(trainer, path, device, rows):
    """The first eval batch of ``path`` (its first ``rows`` pairs, on the
    CPU), the model's copy on the CPU, and the batch's scores on the card and
    on the CPU from the same weights with their cosine and max |d|."""
    import copy

    import torch

    from matchmaker_tpu_torch.data.loaders import reranking_inference_loader

    batch, _, _ = next(iter(reranking_inference_loader(trainer.config, trainer.tokenizer, path)))
    batch = {k: torch.from_numpy(v[:rows]) for k, v in batch.items()}
    trainer.model.eval()
    cpu_model = copy.deepcopy(trainer.model).cpu()
    with torch.inference_mode():
        got = trainer.model({k: v.to(device) for k, v in batch.items()})["score"].float().cpu()
        want = cpu_model(batch)["score"].float()
    cos = float(torch.nn.functional.cosine_similarity(got, want, dim=0))
    return batch, cpu_model, cos, float((got - want).abs().max())


def _card_vs_cpu(trainer, path, device, name, rows):
    """The first eval batch of ``path`` (its first ``rows`` pairs) scored on
    the card and on the CPU from the same weights: cosine >= 0.9999, max |d|
    <= 1e-3; the exact-match guard on its queries (>= 0.99)."""
    batch, _, cos, err = _scores_on_card_and_cpu(trainer, path, device, rows)
    acts = _exact_match_acts(trainer.model, name, batch["query_ids"].to(device), batch["query_mask"].to(device))
    print(f"[pooling] {name}: {rows} pairs on the card vs the CPU: cosine {cos:.7f}, max |d| {err:.4g}; "
          f"exact-match kernel activation of a token against itself: min {float(acts.min()):.6f} over {acts.numel()}")
    check(cos >= 0.9999 and err <= 1e-3, f"{name}: card vs CPU scores: cosine {cos}, max |d| {err}")
    check(float(acts.min()) >= 0.99, f"{name}: exact-match activation {float(acts.min())} on the card")
    return {"cpu_cos": cos, "cpu_max_abs": err, "exact_match_min": float(acts.min())}


def phase_pooling(sz, device, paths):
    """Phase 10 (a): each kernel-pooling model through cli.train's Trainer
    (``pool_steps`` steps, one validation, the test pass): a finite loss
    every step, no encoder kernel launched, the run files, the scores of
    one batch on the card against the CPU and the exact-match guard; TK and
    KNRM also their triples/s device-only (CUDA events over 10 steps) and a
    one-batch overfit (30 steps halve the loss)."""
    result = {}
    psz = dict(sz, train_batch=sz["pool_batch"])
    for name in POOLING_MODELS:
        config = _pooling_config(paths, sz, device, name)
        folder = os.path.join(os.path.dirname(paths["glove"]), f"{name}_run")
        trainer, res = _train_through_trainer(psz, device, config, folder, sz["pool_steps"], f"pooling {name}")
        check(not any(res["launches"].values()), f"{name}: a kernel launched in a kernel-pooling run: "
              f"{res['launches']}")
        for rel in ("validation-metrics-cont.csv", "best-model.npz", "test-planted-output.txt",
                    "test-planted-metrics.csv"):
            check(os.path.isfile(os.path.join(folder, rel)), f"missing {rel} in the {name} run folder")
        check(tuple(trainer.model.embedder.token_embedding.embedding.shape) == (sz["pool_vocab"], sz["pool_dim"]),
              f"{name}: token table {tuple(trainer.model.embedder.token_embedding.embedding.shape)}")
        res.update(_card_vs_cpu(trainer, config["test"]["planted"]["tsv"], device, name, sz["pool_cpu_rows"]))
        if name in ("tk", "knrm"):
            batch = _device_batch(config, trainer.tokenizer, config["train_tsv"], device)
            res.update(_step_speed(psz, device, trainer, batch, f"pooling {name}"))
            res.update(_overfit(psz, trainer, config, batch, f"pooling {name}", lr=1e-3))
        print(f"[pooling] {name} {sz['pool_steps']} steps: loss {res['loss_first']:.4f} -> {res['loss_last']:.4f}, "
              f"{res['cli_triples_per_s']:.1f} triples/s through the Trainer (validation included)"
              + (f", {res['device_triples_per_s']:.1f} device-only" if "device_triples_per_s" in res else ""))
        res.pop("profile", None)
        result[name] = res
        _free(trainer, device)
    return result


def _idcm_config(paths, sz, device, **kw):
    """configs/train/defaults.yaml + models/idcm.yaml over a DistilBERT-width
    encoder (random weights from a seed), bf16, fused layers, documents of
    2,000 tokens (chunks of 50 + 2 x 7), query 30; no validation (the
    phases below evaluate through evaluate_model)."""
    from matchmaker_tpu_torch.config import auto_fill

    return auto_fill({
        "model": "idcm", "bert_pretrained_model": sz["model_name"], "random_seed": 1234, "use_fp16": True,
        "encoder_fused_attention": True, "device": str(device), "enable_tensorboard": False, "loss": "ranknet",
        "param_group0_learning_rate": 7.0e-6, "param_group1_learning_rate": 7.0e-4,
        "embedding_optimizer_learning_rate": 7.0e-6, "weight_decay": 0.0, "lr_schedule": "cosine",
        "optimizer_warmup_steps": 1000, "max_training_steps": 300000,
        "batch_size_train": sz["idcm_batch"], "batch_size_eval": sz["rerank_eval_batch"],
        "max_query_length": sz["rerank_query_len"], "epochs": 1, "validate_every_n_batches": -1,
        "max_training_batches": sz["idcm_steps"], "train_tsv": paths["long_train"], "validation_metric": "MRR@10",
        **IDCM_CONFIG, "max_doc_length": sz["pool_long_words"], "idcm_chunk_size": sz["chunk_size"],
        "idcm_overlap": sz["chunk_overlap"], **kw})


def predicted_idcm_launches(sz, train_steps=0, backward=True, eval_batches=0):
    """K1/K2 once a layer and pass, K11/K12 once a layer and pass of a step
    that trains BERT: a training step has two passes (positive, negative),
    an eval batch one (the cascade over its B x sample_n selected chunks,
    the full path over its B x C chunks); the CK sampler launches none."""
    forward = (2 * train_steps + eval_batches) * sz["n_layers"]
    train = 2 * train_steps * sz["n_layers"] if backward else 0
    return {"fused_attention_block": forward, "fused_mlp_block": forward, "fused_attention_block_bwd": train,
            "fused_mlp_block_bwd": train}


def _eval_rate(step, config, tokenizer, path, device, tag, pairs):
    """Pairs/s of evaluate_model over the tuples of ``path`` repeated to
    about ``pairs`` (tokenized once beforehand, so the rate is the device
    path and the batches' host work; a first pass over ``path`` alone takes
    the cold costs outside the window) and its launches."""
    import torch

    from matchmaker_tpu_torch.data.loaders import reranking_inference_loader
    from matchmaker_tpu_torch.evaluation import evaluate_model
    from matchmaker_tpu_torch.obs.perf_monitor import PerformanceMonitor
    from matchmaker_tpu_torch.ops import _build

    batches = list(reranking_inference_loader(config, tokenizer, path))
    cache = {path: batches}
    evaluate_model(step, config, tokenizer, path, device, cache)
    cache[path] = batches * max(1, round(pairs / sum(len(qids) for _, qids, _ in batches)))
    fresh_perf_monitor()
    _build.reset_launches()
    results = evaluate_model(step, config, tokenizer, path, device, cache)
    if device.type == "cuda":
        torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    block = PerformanceMonitor.get().summary()["eval"]
    n = sum(len(v) for v in results.values())
    rate = n / block["total_seconds"]
    print(f"[idcm] {tag}: {rate:.1f} pairs/s over {n} pairs ({len(cache[path])} batches of "
          f"{config['batch_size_eval']}); launches {launches}")
    return rate, launches, len(cache[path]), n


def phase_idcm(sz, device, paths):
    """Phase 10 (b): IDCM's two training stages and its cascade through
    cli.train's Trainer and evaluate_model, DistilBERT width: stage 1 (BERT
    on every chunk, MSETeacherPointwisePassages over the smoke's teacher
    passage scores) with its launches and one step's gradients against the
    plain versions'; stage 2 (selection training, kldivloss) warm-started
    from stage 1 writing then replaying ``submodel_train_cache_path`` (the
    replay launches no encoder kernel and gives the same losses); the
    validation cache written then replayed; the cascade re-ranking at eval
    batch 128 (launches, scores against the plain versions', MRR) and the
    full path (``sample_n`` -1) over the same documents, each one's pairs/s
    over the tuples repeated to ``idcm_timing_pairs``."""
    import torch

    from matchmaker_tpu_torch.evaluation import evaluate_model, validate_model
    from matchmaker_tpu_torch.ops import _build
    from matchmaker_tpu_torch.training.trainer import Trainer

    result = {"launches": {}}
    root = os.path.dirname(paths["glove"])
    n_chunks = -(-sz["pool_long_words"] // sz["chunk_size"])
    isz = dict(sz, train_batch=sz["idcm_batch"])
    steps = sz["idcm_steps"]

    def add(launches):
        for k, v in launches.items():
            result["launches"][k] = result["launches"].get(k, 0) + v

    # stage 1
    s1 = _idcm_config(paths, sz, device, idcm_sample_n=-1, loss="MSETeacherPointwisePassages",
                      train_pairwise_distillation=True, max_training_passages=n_chunks,
                      train_tsv=paths["idcm_train"])
    s1_folder = os.path.join(root, "idcm_stage1")
    trainer, res = _train_through_trainer(isz, device, s1, s1_folder, steps, "idcm stage 1")
    add(res["launches"])
    _check_launches(res["launches"], predicted_idcm_launches(sz, steps), "IDCM stage 1", device)
    batch = _device_batch(s1, trainer.tokenizer, s1["train_tsv"], device)
    check(tuple(batch["pos_passage_scores"].shape) == (sz["idcm_batch"], n_chunks), "teacher passage scores")
    res.update(_step_speed(isz, device, trainer, batch, "idcm stage 1"))
    res.pop("profile", None)
    # the gradients on the batch's first rows: the plain versions under
    # autograd keep f32 intermediates of every layer (the whole batch's two
    # passes at (640, 94) would not fit on the card)
    grad_batch = {k: v[:sz["idcm_grad_rows"]] for k, v in batch.items()}
    res.update(_kernels_vs_plain_step(trainer.model, s1, grad_batch, s1, "idcm stage 1",
                                      unreached=IDCM_STAGE1_UNREACHED))
    print(f"[idcm] stage 1, {steps} steps of {sz['idcm_batch']} triples ({sz['idcm_batch']} x {n_chunks} chunks of "
          f"{sz['rerank_query_len']} + {sz['chunk_size']} + 2 x {sz['chunk_overlap']} tokens a pass): loss "
          f"{res['loss_first']:.4f} -> {res['loss_last']:.4f}, {res['cli_triples_per_s']:.1f} triples/s through the "
          f"Trainer, {res['device_triples_per_s']:.1f} device-only")
    result["stage1"] = res
    stage1_weights = os.path.join(s1_folder, "best-model.npz")
    _free(trainer, device)

    # stage 2: write, then replay the train cache
    cache = os.path.join(root, "idcm_train_cache")
    s2 = _idcm_config(paths, sz, device, idcm_train_selection=True, warmstart_model_path=stage1_weights,
                      submodel_train_cache_path=cache, batch_size_eval=sz["idcm_batch"])
    runs = {}
    for name in ("write", "replay"):
        folder = os.path.join(root, f"idcm_stage2_{name}")
        trainer, res = _train_through_trainer(isz, device, s2, folder, steps, f"idcm stage 2 {name}")
        add(res["launches"])
        _check_launches(res["launches"], predicted_idcm_launches(sz, steps if name == "write" else 0, False),
                        f"IDCM stage 2 ({name})", device)
        check(os.path.isfile(os.path.join(cache, "cache-meta.json")), "no train cache written")
        with open(os.path.join(folder, "efficiency-metrics.json")) as f:
            res["train_seconds"] = json.load(f)[-1]["blocks"]["train"]["total_seconds"]
        runs[name] = (trainer, res)
        if name == "write":
            _free(trainer, device)
    trainer, replay = runs["replay"]
    write = runs["write"][1]
    gap = abs(write["loss_last"] - replay["loss_last"]) / max(abs(write["loss_last"]), 1e-12)
    print(f"[idcm] stage 2 (selection training, kldivloss), {steps} steps: write run {write['cli_triples_per_s']:.1f} "
          f"triples/s, replay run {replay['cli_triples_per_s']:.1f} (no BERT); last loss {write['loss_last']:.6f} vs "
          f"{replay['loss_last']:.6f}")
    check(gap <= 1e-3, f"IDCM stage 2: the replay's last loss {replay['loss_last']} vs the write run's "
          f"{write['loss_last']}")
    result["stage2"] = {"write": write, "replay": replay, "loss_gap": gap}

    # the validation cache: written, then replayed
    vconfig = dict(s2, submodel_validation_cache_path=os.path.join(root, "idcm_val_cache"))
    trainer.model.eval()
    val = {}
    for name in ("write", "replay"):
        _build.reset_launches()
        val[name] = evaluate_model(trainer.eval_step, vconfig, trainer.tokenizer, paths["long_val"], device)
        launches = dict(_build.LAUNCHES)
        add(launches)
        n_batches = -(-sum(len(v) for v in val[name].values()) // vconfig["batch_size_eval"])
        _check_launches(launches, predicted_idcm_launches(sz, eval_batches=n_batches if name == "write" else 0,
                                                          backward=False), f"validation cache ({name})", device)
    diff = max(abs(a[1] - b[1]) for q in val["write"] for a, b in zip(val["write"][q], val["replay"][q]))
    check(diff <= 1e-5, f"the validation cache's replay moved a score by {diff}")
    print(f"[idcm] validation cache written ({n_batches} batches of {vconfig['batch_size_eval']}, BERT on every "
          f"chunk) and replayed with no encoder kernel; largest score change {diff:.3g}")
    stage2_weights = os.path.join(root, "idcm_stage2_replay", "best-model.npz")
    _free(trainer, device)

    # the cascade and the full path over the same documents
    rates = {}
    for name, kw in (("cascade", {}), ("full", {"idcm_sample_n": -1, "batch_size_eval": sz["idcm_batch"]})):
        config = _idcm_config(paths, sz, device, warmstart_model_path=stage2_weights, **kw)
        os.makedirs(os.path.join(root, f"idcm_{name}"))
        trainer = Trainer(config, os.path.join(root, f"idcm_{name}"))
        trainer.model.eval()
        rate, launches, n_batches, n_timed = _eval_rate(trainer.eval_step, config, trainer.tokenizer,
                                                        paths["long_val"], device, name, sz["idcm_timing_pairs"])
        add(launches)
        _check_launches(launches, predicted_idcm_launches(sz, eval_batches=n_batches, backward=False),
                        f"IDCM {name}", device)
        rates[name] = {"pairs_per_s": rate, "timed_pairs": n_timed, "eval_batch": config["batch_size_eval"],
                       "launches": launches}
        if name == "cascade":
            rates[name].update(_eval_batch_vs_plain(trainer, paths["long_val"], device, "idcm cascade"))
            metrics, _, _ = validate_model("end", trainer.eval_step, config, trainer.tokenizer, trainer.run_folder,
                                           {"tsv": paths["long_val"], "qrels": paths["qrels"],
                                            "binarization_point": 1}, device)
            rates[name]["MRR@10"] = float(metrics["MRR@10"])
        _free(trainer, device)
    result.update(rates)
    print(f"[idcm] re-ranking {sz['pool_val_queries']} x {sz['pool_val_docs']} documents of "
          f"{sz['pool_long_words']} tokens, the rates over {rates['cascade']['timed_pairs']} pairs: cascade "
          f"(sample_n 3, batch {rates['cascade']['eval_batch']}) "
          f"{rates['cascade']['pairs_per_s']:.1f} pairs/s, MRR@10 {rates['cascade']['MRR@10']:.4f}; full path "
          f"(BERT on all {n_chunks} chunks, batch {rates['full']['eval_batch']}) {rates['full']['pairs_per_s']:.1f} "
          f"pairs/s")
    return result


@contextlib.contextmanager
def embedding_file_read_once():
    """Phases 10 (a) and 12 (a) build every model from the one embedding
    file over the one vocabulary: the port's ``load_glove_embeddings``
    reads it once (each model gets its own copy of the matrix) where it
    read the file and seeded its 400,000 rows again for every model."""
    from matchmaker_tpu_torch import models

    original, read = models.load_glove_embeddings, {}

    def once(path, vocab, dim):
        key = (path, len(vocab), dim)
        if key not in read:
            read[key] = original(path, vocab, dim)
        return read[key].copy()

    models.load_glove_embeddings = once
    try:
        yield
    finally:
        models.load_glove_embeddings = original


def phase_kernel_pooling(sz, device, root):
    """Phase 10: (a) the kernel-pooling family, (b) IDCM."""
    t0 = time.perf_counter()
    paths = _pooling_data(root, sz)
    data_s = time.perf_counter() - t0
    print(f"[pooling] data written in {data_s:.1f} s: a {sz['pool_vocab']}-entry vocabulary, {sz['pool_glove_rows']} "
          f"embedding rows of {sz['pool_dim']}, documents of {sz['pool_long_words']} tokens for TKL and IDCM")
    with embedding_file_read_once():
        result = {"data_s": data_s, "pooling": phase_pooling(sz, device, paths)}
    result["idcm"] = phase_idcm(sz, device, paths)
    result["launches"] = result["idcm"]["launches"]
    result["paths"] = paths  # phase 12 runs over the same files
    return result


# ---- phase 12: the rest of the model zoo and of the losses ----------------------

ZOO_MODELS = ("pacrr", "co_pacrr", "drmm", "matchpyramid", "duet")
# configs/train/models/pacrr.yaml (CO-PACRR takes it too); DRMM, MatchPyramid
# and Duet have no file: the JAX defaults
PACRR_CONFIG = {"pacrr_unified_query_length": 30, "pacrr_unified_document_length": 200,
                "pacrr_max_conv_kernel_size": 3, "pacrr_conv_output_size": 32, "pacrr_kmax_pooling_size": 5}
ZOO_CONFIGS = {"pacrr": PACRR_CONFIG, "co_pacrr": PACRR_CONFIG, "drmm": {}, "matchpyramid": {}, "duet": {}}
LIST_LOSSES = ("listnet", "lambdarank", "mrr")
# TK over the encoder's 768-wide vectors: 8 heads (the JAX default; the
# repo's 10 heads do not divide 768), the rest of configs/train/models/tk.yaml
TK_VECTORS_CONFIG = dict(POOLING_CONFIGS["tk"], tk_att_heads=8)


def _zoo_card_vs_cpu(trainer, path, device, name, rows):
    """The first eval batch of ``path`` (its first ``rows`` pairs) scored on
    the card and on the CPU from the same weights: cosine >= 0.9999, max |d|
    <= 1e-3 (phase 10's bar). DRMM: the histogram bin of every live (query,
    document) cosine on the card against the CPU's, the moved entries
    counted, each of them within 1e-6 of a bin edge."""
    import torch

    from matchmaker_tpu_torch.models.drmm import histogram_bins
    from matchmaker_tpu_torch.ops.kernel_pooling import cosine_match_matrix

    batch, cpu_model, cos, err = _scores_on_card_and_cpu(trainer, path, device, rows)
    card_batch = {k: v.to(device) for k, v in batch.items()}
    result = {"cpu_cos": cos, "cpu_max_abs": err}
    note = ""
    if name == "drmm":
        with torch.inference_mode():
            match = {}
            for side, (model, b) in (("card", (trainer.model, card_batch)), ("cpu", (cpu_model, batch))):
                q = model.embedder(b["query_ids"], b["query_mask"])
                d = model.embedder(b["doc_ids"], b["doc_mask"])
                match[side] = cosine_match_matrix(q, d).cpu()
        live = (batch["query_mask"][:, :, None] * batch["doc_mask"][:, None, :]) > 0
        bins = cpu_model.bin_count
        moved = (histogram_bins(match["card"], bins) != histogram_bins(match["cpu"], bins)) & live
        scaled = (match["cpu"].double() + 1.0) * bins / 2.0
        near_edge = (scaled - scaled.round()).abs() <= 1e-6 * bins / 2.0
        result.update(histogram_entries=int(live.sum()), histogram_moved=int(moved.sum()),
                      histogram_moved_off_edge=int((moved & ~near_edge).sum()),
                      max_cosine_gap=float((match["card"] - match["cpu"]).abs().max()))
        note = (f"; histogram: {result['histogram_moved']} of {result['histogram_entries']} live cosines changed bin "
                f"({result['histogram_moved_off_edge']} of them farther than 1e-6 from an edge), largest cosine "
                f"gap {result['max_cosine_gap']:.3g}")
        check(result["histogram_moved_off_edge"] == 0, f"DRMM: {result['histogram_moved_off_edge']} cosines changed "
              "bin on the card away from a bin edge")
    del cpu_model
    print(f"[zoo] {name}: {rows} pairs on the card vs the CPU: cosine {cos:.7f}, max |d| {err:.4g}{note}")
    check(cos >= 0.9999 and err <= 1e-3, f"{name}: card vs CPU scores: cosine {cos}, max |d| {err}")
    return result


def phase_classic(sz, device, paths):
    """Phase 12 (a): PACRR, CO-PACRR, DRMM, MatchPyramid and Duet through
    cli.train's Trainer over phase 10's vocabulary and embedding file
    (``zoo_steps`` steps, one validation, the test pass): a finite loss
    every step, no kernel launched, the run files, one batch's scores on the
    card against the CPU (DRMM's moved histogram entries counted), triples/s
    device-only (CUDA events over 10 steps) and a one-batch overfit (30
    steps halve RankNet)."""
    result = {}
    psz = dict(sz, train_batch=sz["pool_batch"])
    for name in ZOO_MODELS:
        t0 = time.perf_counter()
        config = _pooling_config(paths, sz, device, name, steps=sz["zoo_steps"])
        folder = os.path.join(os.path.dirname(paths["glove"]), f"{name}_run")
        trainer, res = _train_through_trainer(psz, device, config, folder, sz["zoo_steps"], f"zoo {name}")
        check(not any(res["launches"].values()), f"{name}: a kernel launched: {res['launches']}")
        for rel in ("validation-metrics-cont.csv", "best-model.npz", "test-planted-output.txt",
                    "test-planted-metrics.csv"):
            check(os.path.isfile(os.path.join(folder, rel)), f"missing {rel} in the {name} run folder")
        spans = {}
        t1 = time.perf_counter()
        res.update(_zoo_card_vs_cpu(trainer, config["test"]["planted"]["tsv"], device, name, sz["pool_cpu_rows"]))
        spans["card_vs_cpu_s"], t1 = time.perf_counter() - t1, time.perf_counter()
        batch = _device_batch(config, trainer.tokenizer, config["train_tsv"], device)
        # no three-step profile here: it took 13 s of the phase's 55 (the spans below); PERF.md §5 keeps the busy shares
        res.update(_step_speed(psz, device, trainer, batch, f"zoo {name}", profile=False))
        spans["speed_s"], t1 = time.perf_counter() - t1, time.perf_counter()
        res.update(_overfit(psz, trainer, config, batch, f"zoo {name}", lr=1e-3))
        spans["overfit_s"] = time.perf_counter() - t1
        res["part_s"] = time.perf_counter() - t0
        res["spans"] = dict(spans, setup_s=res["setup_s"], train_s=res["wall_s"])
        print(f"[zoo] {name} {sz['zoo_steps']} steps: loss {res['loss_first']:.4f} -> {res['loss_last']:.4f}, "
              f"{res['cli_triples_per_s']:.1f} triples/s through the Trainer (validation included), "
              f"{res['device_triples_per_s']:.1f} device-only ({res['step_ms']:.2f} ms a step); the model's part "
              f"{res['part_s']:.1f} s: " + ", ".join(f"{k[:-2]} {v:.1f}" for k, v in res["spans"].items()))
        res["run_file"] = os.path.join(folder, "test-planted-output.txt")
        result[name] = res
        _free(trainer, device)
    return result


def _zoo_checkpoint(sz, root):
    """A seeded DistilBERT checkpoint directory at the phase's width
    (``model.safetensors`` + ``config.json``), as phase 9 writes one."""
    from matchmaker_tpu_torch.models import hf_import
    from matchmaker_tpu_torch.models.encoder import EncoderConfig

    cfg = EncoderConfig(vocab_size=sz["vocab"], hidden_size=sz["hid"], num_layers=sz["n_layers"],
                        num_heads=sz["heads"], intermediate_size=sz["ff"], max_position_embeddings=512)
    config, sd = hf_import.seeded_distilbert_checkpoint(cfg, seed=21)
    path = os.path.join(root, "zoo_ckpt")
    hf_import.save_hf_checkpoint(path, config, sd, True)
    return path


def _zoo_bert_config(paths, sz, device, model, ckpt, steps, batch, **kw):
    """configs/train/defaults.yaml at DistilBERT width (bf16, fused layers)
    from the phase's checkpoint, query 30 / doc 200, the run cut to
    ``steps`` steps with one validation at the end."""
    from matchmaker_tpu_torch.config import auto_fill

    val = {"tsv": paths["val"], "qrels": paths["qrels"], "binarization_point": 1}
    return auto_fill({
        "model": model, "bert_pretrained_model": ckpt, "random_seed": 1234, "use_fp16": True,
        "encoder_fused_attention": True, "device": str(device), "enable_tensorboard": False, "loss": "ranknet",
        "param_group0_learning_rate": 7.0e-6, "param_group1_learning_rate": 7.0e-4,
        "embedding_optimizer_learning_rate": 7.0e-6, "weight_decay": 0.0, "lr_schedule": "cosine",
        "optimizer_warmup_steps": 1000, "max_training_steps": 300000, "gradient_clip_norm": 1.0,
        "batch_size_train": batch, "batch_size_eval": sz["pool_eval_batch"],
        "max_query_length": sz["rerank_query_len"], "max_doc_length": sz["rerank_doc_len"], "epochs": 1,
        "validate_every_n_batches": steps, "max_training_batches": steps, "validation_metric": "MRR@10",
        "train_tsv": paths["train_tsv"], "validation_cont": val, **kw})


def _val_batches(sz):
    return -(-sz["pool_val_queries"] * sz["pool_val_docs"] // sz["pool_eval_batch"])


def predicted_encode_launches(sz, steps, encodes_per_step, backward, eval_forwards):
    """K1/K2 once a layer and encode; K11/K12 once a layer and encode of a
    training step when the encoder trains. ``eval_forwards``: encodes
    outside training (eval batches, the QA answer forwards)."""
    layers = sz["n_layers"]
    train = steps * encodes_per_step * layers
    forward = train + eval_forwards * layers
    return {"fused_attention_block": forward, "fused_mlp_block": forward,
            "fused_attention_block_bwd": train if backward else 0, "fused_mlp_block_bwd": train if backward else 0}


def phase_contextual(sz, device, paths, ckpt):
    """Phase 12 (b): TK over ``bert_vectors`` (DistilBERT from the phase's
    checkpoint directory) frozen and trainable, and KNRM over
    ``bert_embedding`` from the same directory, through the Trainer
    (``zoo_ctx_steps`` steps, one validation): launches as predicted (a
    step encodes the query and the document of both passes; frozen, no
    backward kernel), one eval batch's scores against the plain versions'
    (the encoder halves' bar), trainable, every gradient's cosine >= 0.99
    under a pointwise loss; KNRM's table the checkpoint's word embeddings
    bit for bit and no kernel launched."""
    import torch

    from matchmaker_tpu_torch.models import get_model, init_params
    from matchmaker_tpu_torch.models.hf_import import load_hf_encoder

    result = {"launches": {}}
    steps, batch_size = sz["zoo_ctx_steps"], sz["pool_batch"]
    csz = dict(sz, train_batch=batch_size)
    root = os.path.dirname(paths["glove"])
    for frozen in (True, False):
        tag = f"zoo tk bert_vectors {'frozen' if frozen else 'trainable'}"
        config = _zoo_bert_config(paths, sz, device, "tk", ckpt, steps, batch_size, token_embedder_type="bert_vectors",
                                  train_embedding=not frozen, **TK_VECTORS_CONFIG)
        folder = os.path.join(root, f"tk_vectors_{'frozen' if frozen else 'trainable'}")
        trainer, res = _train_through_trainer(csz, device, config, folder, steps, tag)
        for k, v in res["launches"].items():
            result["launches"][k] = result["launches"].get(k, 0) + v
        # a step: the query and the document of both passes; an eval batch: its query and document
        _check_launches(res["launches"], predicted_encode_launches(sz, steps, 4, not frozen, 2 * _val_batches(sz)),
                        tag, device)
        check(type(trainer.model).__name__ == "ContextualVectorsAdapter" and not hasattr(trainer.model.inner, "embedder"),
              f"{tag}: not a bert_vectors adapter over a table-less TK")
        res.update(_eval_batch_vs_plain(trainer, paths["val"], device, tag))
        batch = _device_batch(config, trainer.tokenizer, config["train_tsv"], device)
        if frozen:
            from matchmaker_tpu_torch.training.train_step import make_loss_fn

            trainer.model.zero_grad(set_to_none=True)
            make_loss_fn(trainer.model, trainer.losses, config)(batch)[0].backward()
            reached = [n for n, p in trainer.model.named_parameters() if n.startswith("encoder.") and p.grad is not None]
            check(not reached, f"{tag}: a gradient reached the frozen encoder: {reached[:3]}")
            trainer.model.zero_grad(set_to_none=True)
        else:
            trainer.model.train()
            res.update(_kernels_vs_plain_step(trainer.model, config, batch, dict(config, loss="MSETeacherPointwise"),
                                              tag))
        res.update(_step_speed(csz, device, trainer, batch, tag))
        res.pop("profile", None)
        print(f"[zoo] {tag}: {steps} steps, loss {res['loss_first']:.4f} -> {res['loss_last']:.4f}, "
              f"{res['device_triples_per_s']:.1f} triples/s device-only; launches {res['launches']}")
        result["tk_vectors_frozen" if frozen else "tk_vectors_trainable"] = res
        _free(trainer, device)

    config = _zoo_bert_config(paths, sz, device, "knrm", ckpt, steps, batch_size, token_embedder_type="bert_embedding",
                              loss="margin", param_group1_learning_rate=1.0e-3)
    folder = os.path.join(root, "knrm_bert_embedding")
    trainer, res = _train_through_trainer(csz, device, config, folder, steps, "zoo knrm bert_embedding")
    check(not any(res["launches"].values()), f"KNRM over bert_embedding launched a kernel: {res['launches']}")
    table = load_hf_encoder(ckpt)[1]["word_embeddings.embedding"]
    res["table_shape"] = list(trainer.model.embedder.token_embedding.embedding.shape)
    check(res["table_shape"] == list(table.shape), f"KNRM over bert_embedding: table {res['table_shape']}")
    # the Trainer's start: get_model + init_params on the same config
    fresh = get_model(config, trainer.tokenizer)
    init_params(fresh, config, torch.Generator().manual_seed(config["random_seed"]))
    check(torch.equal(fresh.embedder.token_embedding.embedding, table), "KNRM over bert_embedding: the table is not "
          "the checkpoint's word embeddings")
    del fresh
    print(f"[zoo] knrm over bert_embedding: a {tuple(table.shape)} table from the checkpoint, {steps} steps, loss "
          f"{res['loss_first']:.4f} -> {res['loss_last']:.4f}, no kernel launched")
    result["knrm_bert_embedding"] = res
    _free(trainer, device)
    return result


def _list_files(root, paths, sz, seed=22):
    """A candidate run for the list sampler: every eval query of phase 10's
    planted corpus with ``list_candidates`` random documents of the
    collection in rank order (its relevant one among them for half the
    queries, which the sampler drops from the candidates)."""
    import random

    rng = random.Random(seed)
    with open(paths["collection"]) as f:
        ids = sorted(line.split("\t", 1)[0] for line in f)
    with open(paths["qrels"]) as f:
        rel = {line.split()[0]: line.split()[2] for line in f}
    run = os.path.join(root, "list_candidates.txt")
    with open(run, "w") as f:
        for i, qid in enumerate(sorted(rel)):
            cands = rng.sample(ids, sz["list_candidates"]) + ([rel[qid]] if i % 2 else [])
            for rank, did in enumerate(cands, 1):
                f.write(f"{qid} Q0 {did} {rank} {1.0 / rank:.6f} smoke\n")
    return run


def _list_scores(model, batch):
    """(Q, L) f32 scores of a list batch's (query, document) pairs, no autograd."""
    import torch

    from matchmaker_tpu_torch.training.train_step import list_scores

    with torch.no_grad():
        return list_scores(model, batch).float()


def _positive_first(model, batch):
    """The shares of a list batch's lists whose positive (slot 0), and whose
    labelled document (the positive or a candidate: what the smooth MRR
    loss counts as relevant), the model scores above every other one."""
    import torch

    top = _list_scores(model, batch).argmax(dim=1)
    labelled = torch.gather(batch["list_labels"], 1, top[:, None])[:, 0] > 0
    return float((top == 0).float().mean()), float(labelled.float().mean())


def _list_scores_vs_plain(model, losses, batch, tag, bounded_loss):
    """A list batch's scores with the kernels and with the plain versions,
    held to the encoder halves' bar; the lists whose predicted order moved
    and those whose best-scored labelled document (the one the smooth MRR
    loss takes its max at) moved, counted. With ``bounded_loss`` the loss
    is compared over the lists whose order did not move, within 1e-2
    relative plus the first-order change the score differences make (sum
    |dL/ds| |s_kernels - s_plain| at the plain scores): LambdaLoss weighs
    each pair by the documents' places in the predicted order, a step
    function of the scores, and sums log-sigmoids of score differences, so
    a bf16-sized score error moves it by far more than 1e-2 of its value
    where the differences are a few units; the smooth MRR loss of a list
    already ranked right is near 0 (1e-5), where a relative gap says
    nothing. The scores themselves are held to the encoder halves' bar."""
    import torch

    got = _list_scores(model, batch)
    with plain_encoder_blocks():
        want = _list_scores(model, batch)
    cos = float(torch.nn.functional.cosine_similarity(got.reshape(-1), want.reshape(-1), dim=0))
    err = float((got - want).abs().max())
    same = (torch.argsort(-got, dim=1, stable=True) == torch.argsort(-want, dim=1, stable=True)).all(dim=1)
    labelled = batch["list_labels"] > 0
    picks = [torch.where(labelled, x, float("-inf")).argmax(dim=1) for x in (got, want)]
    picks_moved = int((picks[0] != picks[1]).sum())
    moved = int((~same).sum())
    check(cos >= 0.999 and err <= 0.1 * max(1.0, float(want.abs().max())),
          f"{tag}: list scores, kernels vs plain: cosine {cos}, max |d| {err}")
    result = {"scores_cos": cos, "scores_max_abs": err, "lists_reordered": moved, "labelled_pick_moved": picks_moved}
    note = ""
    if bounded_loss:
        labels = batch["list_labels"][same]
        mask = torch.ones_like(labels)
        plain_scores = want[same].clone().requires_grad_(True)
        with torch.enable_grad():
            lp_t = losses.ranking_loss(plain_scores, labels, mask)
            lp_t.backward()
        lk, lp = float(losses.ranking_loss(got[same], labels, mask)), float(lp_t)
        first_order = float((plain_scores.grad.abs() * (got[same] - want[same]).abs()).sum())
        gap = abs(lk - lp) / max(abs(lp), 1e-12)
        note = (f"; the loss over the {int(same.sum())} lists ordered alike {lk:.6g} vs {lp:.6g} (relative gap "
                f"{gap:.3g}; first-order change of the score differences {first_order:.4g})")
        check(abs(lk - lp) <= 1e-2 * abs(lp) + first_order, f"{tag}: the loss over the lists ordered alike, kernels "
              f"{lk} vs plain {lp}, beyond 1e-2 and the first-order change {first_order}")
        result.update(ordered_loss_gap=gap, ordered_loss_first_order=first_order)
    print(f"[{tag}] list scores, kernels vs plain: cosine {cos:.6f}, max |d| {err:.4g}; {moved} of {got.shape[0]} "
          f"lists ordered differently, {picks_moved} with another best-scored labelled document{note}")
    return result


def phase_listwise(sz, device, paths, ckpt):
    """Phase 12 (c): BERT_DOT (DistilBERT from the phase's checkpoint) on the
    list sampler's batches (``queries_per_batch`` lists of ``list_size``
    documents: the positive, candidates of a run file the phase writes and
    random documents) under listnet, lambdarank and mrr, ``list_steps``
    steps each through the Trainer with one validation: K1/K2/K11/K12 as
    predicted (a step encodes its Q·L repeated queries and its Q·L
    documents once each: K11/K12 at (32, 30) and (32, 200)), one step's
    loss and gradients against the plain versions' (phase 6's bar), lists/s
    device-only, 30 steps on one list batch putting the positive first in
    >= 90 % of its lists. Returns the last run's trainer for (e)."""
    import torch

    from matchmaker_tpu_torch.data.list_sampler import ListwiseDynamicSampler
    from matchmaker_tpu_torch.training.optim import build_optimizer
    from matchmaker_tpu_torch.training.train_step import make_train_step

    result = {"launches": {}}
    root = os.path.dirname(paths["glove"])
    steps, qpb, lsize = sz["list_steps"], sz["list_queries"], sz["list_size"]
    run = _list_files(root, paths, sz)
    lsz = dict(sz, train_batch=qpb)
    sampler_files = {"dynamic_sampler_collection": paths["collection"], "dynamic_sampler_queries": paths["queries"],
                     "dynamic_sampler_qrels": paths["qrels"], "dynamic_sampler_candidates": run}
    trainer = None
    for loss in LIST_LOSSES:
        if trainer is not None:
            _free(trainer, device)
        config = _zoo_bert_config(paths, sz, device, "bert_dot", ckpt, steps, qpb, loss=loss, dynamic_sampler="listwise",
                                  list_size=lsize, queries_per_batch=qpb, tas_batches_per_epoch=steps, **sampler_files)
        tag = f"zoo listwise {loss}"
        trainer, res = _train_through_trainer(lsz, device, config, os.path.join(root, f"list_{loss}"), steps, tag)
        for k, v in res["launches"].items():
            result["launches"][k] = result["launches"].get(k, 0) + v
        _check_launches(res["launches"], predicted_encode_launches(sz, steps, 2, True, 2 * _val_batches(sz)), tag,
                        device)
        sampler = ListwiseDynamicSampler(collection_file=paths["collection"], query_file=paths["queries"],
                                         qrels_file=paths["qrels"], candidate_file=run, list_size=lsize,
                                         queries_per_batch=qpb, seed=7)
        host = next(iter(sampler.batches(config, trainer.tokenizer, max_batches=1)))
        batch = {k: torch.from_numpy(v).to(device) for k, v in host.items()}
        check(tuple(batch["list_doc_ids"].shape) == (qpb, lsize, sz["rerank_doc_len"]), "list batch shape")
        trainer.model.train()
        res.update(_list_scores_vs_plain(trainer.model, trainer.losses, batch, tag, loss != "listnet"))
        # the loss and the gradients under ListNet: LambdaLoss's pair
        # weights step with the predicted order, and the smooth MRR takes a
        # max over the labelled documents, whose pick can move with
        # rounding (as phase 6's in-batch hardest negative can); their own
        # losses are compared above
        smooth = dict(config, loss="listnet")
        res.update(_kernels_vs_plain_step(trainer.model, smooth, batch, smooth, tag))
        ms = _time_ms(lambda: trainer.train_step(batch), device, sz["reps"])
        res.update(step_ms=ms, device_lists_per_s=qpb / ms * 1e3, device_pairs_per_s=qpb * lsize / ms * 1e3)
        before, _ = _positive_first(trainer.model, batch)
        fit_config = dict(config, lr_schedule="constant", optimizer_warmup_steps=0, param_group0_learning_rate=1e-4,
                          embedding_optimizer_learning_rate=1e-4, param_group1_learning_rate=1e-3)
        fit_step = make_train_step(trainer.model, trainer.losses, build_optimizer(fit_config, trainer.model), fit_config)
        fit = [float(fit_step(batch)["loss"]) for _ in range(sz["overfit_steps"])]
        after, labelled = _positive_first(trainer.model, batch)
        res.update(overfit_first=fit[0], overfit_last=fit[-1], positive_first_before=before,
                   positive_first_after=after, labelled_first_after=labelled)
        print(f"[zoo] {tag}: {steps} steps of {qpb} lists x {lsize}, loss {res['loss_first']:.4f} -> "
              f"{res['loss_last']:.4f}; {res['device_lists_per_s']:.1f} lists/s device-only ({ms:.2f} ms a step); "
              f"one-batch overfit {fit[0]:.4f} -> {fit[-1]:.4f}, positive first in {before:.2f} -> {after:.2f} of "
              f"the lists, a labelled document first in {labelled:.2f}")
        # the smooth MRR loss counts the candidates (label 1) as relevant too: it puts a labelled document first
        first = labelled if loss == "mrr" else after
        check(first >= 0.9, f"{tag}: after {sz['overfit_steps']} steps on one list batch the "
              f"{'labelled document' if loss == 'mrr' else 'positive'} leads only {first:.2f} of its lists")
        result[loss] = res
    return result, trainer


def _qa_files(root, paths, sz):
    """QA triples from phase 10's train triples: the positive's answer is
    the char span of its first occurrence of the query's first word
    (``start,end``); the validation's gold answers, each eval query's first
    word."""
    qa_train = os.path.join(root, "qa_train.tsv")
    with open(paths["train_tsv"]) as f, open(qa_train, "w") as g:
        for line in f:
            query, pos, neg = line.rstrip("\n").split("\t")
            word, start = query.split()[0], 0
            for token in pos.split(" "):
                if token == word:
                    break
                start += len(token) + 1
            span = f"{start},{start + len(word)}" if start < len(pos) else ""
            g.write(f"{span}\t{query}\t{pos}\t{neg}\n")
    answers = os.path.join(root, "qa_answers.tsv")
    with open(paths["queries"]) as f, open(answers, "w") as g:
        for line in f:
            qid, query = line.rstrip("\n").split("\t", 1)
            g.write(f"{qid}\t{query.split()[0]}\n")
    return qa_train, answers


def phase_qa(sz, device, paths, ckpt):
    """Phase 12 (d): BERT_CAT with ``train_qa_spans`` (ranknet + the span
    and answerability losses) at batch 16 of 30 + 200 tokens over QA
    triples the phase writes, with the uncertainty weighting
    (``mtl_log_vars``) and without, ``qa_steps`` steps each through the
    Trainer and one validation, the weighted run's with ``qa_answers``:
    K1/K2/K11/K12 as predicted (the QA answer walk's forwards counted),
    one step's loss and gradients (``qa_span_layer`` and ``mtl_log_vars``
    included, under a pointwise ranking loss) against the plain versions',
    30 steps on one batch halving the span loss, QA EM/F1 and the answers
    file."""
    import csv

    result = {"launches": {}}
    root = os.path.dirname(paths["glove"])
    steps, batch_size = sz["qa_steps"], sz["rerank_batch"]
    qa_train, answers = _qa_files(root, paths, sz)
    qsz = dict(sz, train_batch=batch_size)
    for weighting in (True, False):
        tag = f"zoo qa {'weighted' if weighting else 'lambda'}"
        val = {"tsv": paths["val"], "qrels": paths["qrels"], "binarization_point": 1,
               **({"qa_answers": answers} if weighting else {})}
        config = _zoo_bert_config(paths, sz, device, "bert_cat", ckpt, steps, batch_size, train_qa_spans=True,
                                  qa_loss="StartEndCrossEntropy", qa_uncertainty_weighting=weighting, train_tsv=qa_train,
                                  validation_cont=val, batch_size_eval=sz["rerank_eval_batch"])
        folder = os.path.join(root, f"qa_{'weighted' if weighting else 'lambda'}")
        qa_forwards = []

        def count_qa_forwards(trainer):
            step = trainer.eval_step

            def counting(batch, **kw):
                if batch["seq_ids"].shape[0] == 1:
                    qa_forwards.append(1)
                return step(batch, **kw)

            trainer.eval_step = counting

        trainer, res = _train_through_trainer(qsz, device, config, folder, steps, tag, before=count_qa_forwards)
        for k, v in res["launches"].items():
            result["launches"][k] = result["launches"].get(k, 0) + v
        eval_batches = -(-sz["pool_val_queries"] * sz["pool_val_docs"] // sz["rerank_eval_batch"])
        _check_launches(res["launches"], predicted_encode_launches(sz, steps, 2, True, eval_batches + len(qa_forwards)),
                        tag, device)
        check(weighting == hasattr(trainer.model, "mtl_log_vars"), f"{tag}: mtl_log_vars")
        batch = _device_batch(config, trainer.tokenizer, qa_train, device)
        trainer.model.train()
        # the span bias shifts every start (end) logit alike: the cross entropy's gradient is zero in exact arithmetic
        res.update(_kernels_vs_plain_step(trainer.model, config, batch, dict(config, loss="MSETeacherPointwise"), tag,
                                          exact_zero={"qa_span_layer.bias": "qa_span_layer.kernel"}))
        ms = _time_ms(lambda: trainer.train_step(batch), device, sz["reps"])
        res.update(step_ms=ms, device_triples_per_s=batch_size / ms * 1e3, qa_forwards=len(qa_forwards))
        res.update(_overfit(qsz, trainer, config, batch, tag, lr=3e-4, key="qa_span_loss"))
        if weighting:
            check(os.path.isfile(os.path.join(folder, "last-qa-output.tsv")), f"{tag}: no last-qa-output.tsv")
            with open(os.path.join(folder, "validation-metrics-cont.csv")) as f:
                row = list(csv.DictReader(f))[-1]
            res.update(qa_em=float(row["QA/ExactMatch_TopRanked"]), qa_f1=float(row["QA/F1_TopRanked"]),
                       mtl_log_vars=[float(v) for v in trainer.model.mtl_log_vars.detach().cpu()])
        print(f"[zoo] {tag}: {steps} steps of {batch_size}, loss {res['loss_first']:.4f} -> {res['loss_last']:.4f}, "
              f"{res['device_triples_per_s']:.1f} triples/s device-only ({ms:.2f} ms a step); {len(qa_forwards)} QA "
              f"answer forwards" + (f"; QA EM {res['qa_em']:.4f} F1 {res['qa_f1']:.4f}, mtl_log_vars "
                                     f"{res['mtl_log_vars']}" if weighting else ""))
        result["weighted" if weighting else "lambda"] = res
        _free(trainer, device)
    return result


def phase_export(sz, device, root, trainer, classic):
    """Phase 12 (e): (c)'s trained BERT_DOT encoder through
    utils/hf_export.py, re-read through models/hf_import.py (every tensor
    bit for bit); utils/ensemble.py fusing (a)'s PACRR and DRMM run files
    (RRF)."""
    import torch

    from matchmaker_tpu_torch.evaluation import save_sorted_results
    from matchmaker_tpu_torch.metrics import load_ranking
    from matchmaker_tpu_torch.models.hf_import import load_hf_encoder
    from matchmaker_tpu_torch.utils.ensemble import fuse_runs
    from matchmaker_tpu_torch.utils.hf_export import export_to_huggingface

    out = os.path.join(root, "hf_export")
    t0 = time.perf_counter()
    export_to_huggingface(trainer.model, trainer.model.encoder_cfg, out, model_type="distilbert")
    export_s = time.perf_counter() - t0
    cfg, enc = load_hf_encoder(out)
    mine = {k: v.detach().cpu() for k, v in trainer.model.encoder.state_dict().items()}
    check(set(enc) == set(mine) and all(torch.equal(enc[k], mine[k]) for k in mine),
          "the exported checkpoint does not re-read as the trained encoder")
    check((cfg.hidden_size, cfg.num_layers) == (sz["hid"], sz["n_layers"]), f"exported config {cfg}")
    runs = [classic["pacrr"]["run_file"], classic["drmm"]["run_file"]]
    fused = fuse_runs(runs, "rrf")
    fused_path = os.path.join(root, "fused-output.txt")
    save_sorted_results(fused, fused_path)
    queries = [set(load_ranking(p)) for p in runs]
    check(set(load_ranking(fused_path)) == queries[0] | queries[1], "the fused run lost a query")
    n_bytes = sum(os.path.getsize(os.path.join(out, f)) for f in os.listdir(out))
    print(f"[zoo] (e) the listwise run's encoder exported ({n_bytes / 1e6:.1f} MB, {export_s:.2f} s) and re-read bit "
          f"for bit ({len(mine)} tensors); PACRR + DRMM fused by RRF over {len(fused)} queries")
    return {"export_mb": n_bytes / 1e6, "export_s": export_s, "tensors": len(mine), "fused_queries": len(fused)}


def phase_zoo(sz, device, root, paths):
    """Phase 12, in phase 10's directory (its corpus, vocabulary and
    embedding file): (a) the classic models, (b) the contextual embedders,
    (c) listwise BERT_DOT, (d) BERT_CAT's QA multi-task training, (e) the
    export and the run fusion."""
    result = {"launches": {}}
    t0 = time.perf_counter()
    with embedding_file_read_once():
        result["classic"] = phase_classic(sz, device, paths)
    result["classic_s"] = time.perf_counter() - t0
    ckpt = _zoo_checkpoint(sz, root)
    parts = {}
    t0 = time.perf_counter()
    parts["contextual"] = phase_contextual(sz, device, paths, ckpt)
    result["contextual_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    parts["listwise"], trainer = phase_listwise(sz, device, paths, ckpt)
    result["listwise_s"] = time.perf_counter() - t0
    result["export"] = phase_export(sz, device, root, trainer, result["classic"])
    _free(trainer, device)
    t0 = time.perf_counter()
    parts["qa"] = phase_qa(sz, device, paths, ckpt)
    result["qa_s"] = time.perf_counter() - t0
    for name, part in parts.items():
        for k, v in part.pop("launches").items():
            result["launches"][k] = result["launches"].get(k, 0) + v
        result[name] = part
    print(f"[zoo] launches in phase 12's runs: {result['launches']}")
    return result


# ---- phase 3, the attention cores at head widths 16 and 32 -------------------

# cross-encoder/ms-marco-MiniLM-L-6-v2's published config.json (typed in,
# nothing fetched): BERT layout, 6 layers, hidden 384, 12 heads of 32, FF
# 1,536, WordPiece vocabulary 30,522, 2 token types
MINILM = dict(vocab=30522, hid=384, n_layers=6, heads=12, ff=1536, type_vocab=2)
# huawei-noah/TinyBERT_General_4L_312D's config.json: 4 layers, hidden 312, 12
# heads of 26, FF 1,200 (phase 13 (e))
TINYBERT = dict(vocab=30522, hid=312, n_layers=4, heads=12, ff=1200, type_vocab=2)
# bert-large-uncased's config.json: 24 layers, hidden 1,024, 16 heads of 64,
# FF 4,096, 512 positions, 2 token types, LayerNorm eps 1e-12 (phase 13 (f))
BERT_LARGE = dict(vocab=30522, hid=1024, n_layers=24, heads=16, ff=4096, type_vocab=2)
# phase 13 (f)'s widths the card took last, (hidden, heads, FF) at
# ``width_layers`` layers: 8 heads of 128 at 1,024; 12 of 128 at 1,536 (the
# LayerNorm backward past 1,024); 8 of 80 padded to 128 at 640; hidden 100 in
# 4 heads of 25 with FF 400 and hidden 32 in 4 heads of 8 with FF 36 (widths
# that are not a multiple of 8)
WIDTH_GEOMETRIES = [(1024, 8, 4096), (1536, 12, 6144), (640, 8, 2560), (100, 4, 400), (32, 4, 36)]
# (hidden, heads, FF) of the attention cores' widths beside the 64-wide ones:
# MiniLM's 12 heads of 32 and 24 of 16 at hidden 384 (instanced widths), then
# heads the cores run zero-padded to the next instance: TinyBERT's 12 of 26,
# 16 of 24 and 8 of 48 at hidden 384
HEAD_WIDTH_CASES = [(384, 12, 1536), (384, 24, 1536), (312, 12, 1200), (384, 16, 1536), (384, 8, 1536)]
# every entry of the kernels line beside the headline ones: (entry, wrapper
# counter, phase 13 run whose launches it takes or None): the head widths'
# K1, K13, K10, K12; K9 and K11 at TinyBERT's hidden 312, K11 and K12 at 64
# (the LayerNorm backward at widths that are not a multiple of 128)
HEAD_WIDTH_KERNELS = (
    [(f"{name}@hd{hid // heads}", name, {32: "minilm", 26: "tinybert"}.get(hid // heads))
     for hid, heads, _ in HEAD_WIDTH_CASES
     for name in ("fused_attention_block", "fused_mha", "fused_attention_int8_block", "fused_attention_block_bwd")]
    + [("fused_mlp_int8_block@hid312", "fused_mlp_int8_block", "tinybert"),
       ("fused_mlp_block_bwd@hid312", "fused_mlp_block_bwd", "tinybert"),
       ("fused_mlp_block_bwd@hid64", "fused_mlp_block_bwd", None),
       ("fused_attention_block_bwd@hid64", "fused_attention_block_bwd", None)])
# the head-width entries off every path: K13 (no caller), K10 at 26 (TinyBERT
# serves int8_mlp: a bf16 attention half)
_OFF_PATH = ("fused_mha", "fused_attention_int8_block")


def _unpadded_attention_grads(grads, heads, d, width):
    """K12's gradients of zero-padded heads (width > d) cut back to the
    real columns (the padded ones checked zero)."""
    import torch

    dx, dwqkv, dbqkv, dwo, dbo, dg, dbe = grads
    real = (torch.arange(3 * heads * width, device=dwqkv.device) % width) < d
    check(not dwqkv[:, ~real].any() and not dbqkv[~real].any() and not dwo[~real[:heads * width]].any(),
          f"K12 at heads of {d} padded to {width}: a padded column's gradient is not zero")
    return dx, dwqkv[:, real], dbqkv[real], dwo[real[:heads * width]], dbo, dg, dbe


def _bwd_width_entry(out, key, kernel, named, plain, inputs, ops, sz, device, b, l, scale_of=None, headline=True,
                     device_reps=100, timed=True):
    """One backward kernel against its plain version into ``out[key]`` (a
    timing more where the entry exists and ``timed``): ``named`` turns
    ``kernel``'s result into the gradients by name (cut back to the real
    columns where the heads were padded: outside the timing), ``plain``
    returns them by name."""
    import torch

    entry = out.setdefault(key, {"max_abs_err": 0.0, "library_ms": None})
    got, want = named(kernel()), plain()
    check(all(bool(torch.isfinite(t).all()) for t in got.values()), f"{key} gradients")
    check(all(got[k].shape == want[k].shape for k in want), f"{key}: a gradient's shape is not its input's")
    err = grads_close(got, want, scale_of)
    print(f"[kernels] {key} B={b} L={l}: {len(got)} gradients within cosine 0.999, max |d| <= 2e-2 max |plain| "
          f"(largest |d| {err:.4g})")
    entry["max_abs_err"] = max(entry["max_abs_err"], err)
    if not timed:
        return
    _record(entry, [b, l, inputs[0].shape[-1]], kernel, plain, device, sz["bwd_reps"], headline=headline,
            bound_of=bound(nbytes(inputs, list(got.values())), **ops))
    _device_beside(entry, kernel, device, headline=headline, reps=device_reps)


def phase_head_width_kernels(sz, device):
    """K1, K13, K10 and K12 at the head widths of HEAD_WIDTH_CASES against
    their plain versions at phase 13 (d)'s shape, a BERT_CAT batch of 16 x
    230: 32 and 16 on their own instances, 26, 24 and 48 zero-padded to 32
    and 64 as the encoder pads them (the weights and codes once, before the
    timing; K13's q, k and v in the call), against the plain versions on the
    unpadded weights. The encoder halves' bar for the forwards (row cosine
    >= 0.999, max |d| <= 0.1; K10 also its mean |d|), the backward's for
    K12 (every gradient's cosine >= 0.999, max |d| <= 2e-2 max |plain|, the
    padded columns' gradients zero); each timed beside its plain version
    with its device time and its bound counted on the unpadded work, so the
    padding's cost shows; K13 beside one scaled_dot_product_attention. Then
    K9 at TinyBERT's widths (hidden 312, FF 1,200 in chunks of 300, its
    codes padded to 320) and K11 / K12 at hidden 312 and 64 (the LayerNorm
    backward past the multiples of 128)."""
    import torch

    from matchmaker_tpu_torch.ops import fused_attention as fa
    from matchmaker_tpu_torch.ops import fused_backward as fb
    from matchmaker_tpu_torch.ops import fused_int8 as fi
    from matchmaker_tpu_torch.probes import attn_inner as ai

    b, l = sz["head_width_shape"]
    out = {}
    for hid, heads, ff in HEAD_WIDTH_CASES:
        hd = hid // heads
        width = fa.kernel_head_dim("chip_smoke", hid, heads)
        group = 64 // hd if hd in (16, 32) else 2  # instanced widths: one 64-code Wo chunk; else JAX's 2
        hsz = dict(sz, hid=hid, ff=ff)
        attn, ln1, _, _ = _layer_params(hsz, device, seed=40 + hd)
        wq, wk, wv, wo, bq, bk, bv, bo = attn
        wqkv, bqkv = torch.cat([wq, wk, wv], dim=1), torch.cat([bq, bk, bv])
        pw, pb, po = fa.pad_attention_heads(wqkv, bqkv, wo, heads)  # as the encoder packs them
        x, mask, g = _half_inputs(hsz, b, l, device, 41 + hd)
        dy = torch.randn(b, l, hid, generator=g, device=device).to(torch.bfloat16)
        proj, core = _attention_ops(b, l, hid, heads)
        q8, _, q8ln, _ = _int8_layer_params(hsz, device, seed=42 + hd)
        q8_t = fi.kmajor_attention_weights(*q8)
        q8_p = fi.pad_int8_attention(*q8_t[:4], heads, group) + q8_t[4:]
        q, k, v = (torch.randn(b, l, hid, generator=g, device=device).to(torch.bfloat16) for _ in range(3))
        mha_ops = 4 * hid * l * int(mask.sum())  # QK^T and PV over the live keys
        _, a_saved = fb.attention_block_fwd(x, pw, pb, po, bo, mask, heads, *ln1, head_dim=hd)
        _, a_acc = fa.reference_attention_block(x, *attn, mask, heads, *ln1, save_acc=True)
        unpadded_saved = (a_acc, torch.empty(b, l, 3 * hid, dtype=torch.bfloat16),
                          torch.empty(b, l, hid, dtype=torch.bfloat16))  # bytes of the unpadded work
        forwards = (
            ("fused_attention_block",
             lambda: fa.fused_attention_block_qkv(x, pw, pb, po, bo, mask, heads, *ln1, head_dim=hd),
             lambda: fa.reference_attention_block(x, *attn, mask, heads, *ln1), (x, attn, mask, ln1),
             dict(bf16=proj + core), None),
            ("fused_mha", lambda: fa.fused_mha(q, k, v, mask, heads), lambda: fa.mha_reference(q, k, v, mask, heads),
             (q, k, v, mask), dict(bf16=mha_ops), lambda: ai.sdpa(q, k, v, mask, heads)),
            ("fused_attention_int8_block",
             lambda: fi.fused_attention_int8_block_qkv_kmajor(x, *q8_p, mask, heads, *q8ln, group_heads=group,
                                                              head_dim=hd),
             lambda: fi.reference_attention_int8_block(x, *q8, mask, heads, *q8ln, group_heads=group),
             (x, q8_t, mask, q8ln), dict(int8=proj, bf16=core), None))
        for name, kernel, plain, inputs, ops, library in forwards:
            _wide_forward(out, f"{name}@hd{hd}", kernel, plain, inputs, ops, sz, device, [b, l, hid, hd], True,
                          library=library, int8=name == "fused_attention_int8_block", device_reps=100)
            out[f"{name}@hd{hd}"].update(head_dim=hd, padded_to=width)

        def k12(pw=pw, pb=pb, po=po, x=x, mask=mask, heads=heads, ln1=ln1, dy=dy, a_saved=a_saved, hd=hd):
            return fb.attention_block_bwd(x, pw, pb, po, mask, heads, ln1[0], dy, a_saved, head_dim=hd)

        def named12(grads, heads=heads, hd=hd, width=width):
            return _named_attention_grads(*(_unpadded_attention_grads(grads, heads, hd, width) if width != hd
                                            else grads))

        def plain12(x=x, attn=attn, mask=mask, heads=heads, ln1=ln1, dy=dy, a_acc=a_acc):
            wq, wk, wv, wo, bq, bk, bv, _ = attn
            return dict(zip(_ATTN_GRADS, fb.reference_attention_block_bwd(x, wq, wk, wv, wo, bq, bk, bv, mask, heads,
                                                                           ln1[0], dy, a_acc)))

        _bwd_width_entry(out, f"fused_attention_block_bwd@hd{hd}", k12, named12, plain12,
                         (x, wqkv, bqkv, wo, mask, ln1[0], dy, unpadded_saved), dict(bf16=2 * proj + 5 * core // 2),
                         sz, device, b, l, _zero_attention_grads(l))
        out[f"fused_attention_block_bwd@hd{hd}"].update(head_dim=hd, padded_to=width)

    # K9 at TinyBERT's widths, its codes padded to 320 and chunks of 320
    t = TINYBERT
    tsz = dict(sz, hid=t["hid"], ff=t["ff"])
    _, mlp, _, ln2 = _int8_layer_params(tsz, device, seed=43)
    w1q, s1, b1, w2q, s2, b2 = mlp
    mlp_p = fi.pad_int8_mlp(fi.kmajor_codes(w1q), s1, b1, fi.kmajor_codes(w2q)) + (s2, b2)
    x, _, g = _half_inputs(tsz, b, l, device, 44)
    entry = out["fused_mlp_int8_block@hid312"] = {"max_abs_err": 0.0, "library_ms": None}
    kernel = lambda: fi.fused_mlp_int8_block_kmajor(x, *mlp_p, *ln2)  # noqa: E731
    plain = lambda: fi.reference_mlp_int8_block(x, *mlp, *ln2)  # noqa: E731
    got, want = kernel(), plain()
    cos, err = _rows_close(got, want)
    mean = _mean_abs(got, want)
    print(f"[kernels] fused_mlp_int8_block at TinyBERT's widths (312, FF 1,200 in chunks of 300, codes padded to "
          f"{tuple(mlp_p[0].shape)}) B={b} L={l}: min row cosine {cos:.6f}, max |d| {err:.4g}, mean |d| {mean:.4g}")
    check(cos >= 0.999 and err <= 0.1 and mean <= INT8_HALF_MEAN_ABS,
          f"fused_mlp_int8_block@hid312 vs plain: cos {cos}, max |d| {err}, mean |d| {mean}")
    entry["max_abs_err"] = err
    _record(entry, [b, l, t["hid"]], kernel, plain, device, sz["reps"], headline=True,
            bound_of=bound(nbytes((x, fi.kmajor_codes(w1q), s1, b1, fi.kmajor_codes(w2q), s2, b2, ln2), got),
                           int8=4 * b * l * t["hid"] * t["ff"]))
    _device_beside(entry, kernel, device, headline=True)

    # K11 at 312 and 64, K12 at 64 (4 heads of 16): the LayerNorm backward
    for hid, heads, ff in ((312, 12, 1200), (64, 4, 256)):
        wsz = dict(sz, hid=hid, ff=ff)
        attn, ln1, mlp, ln2 = _layer_params(wsz, device, seed=45 + hid)
        x, mask, g = _half_inputs(wsz, b, l, device, 46 + hid)
        dy = torch.randn(b, l, hid, generator=g, device=device).to(torch.bfloat16)
        w1, b1, w2, b2 = mlp
        _, m_saved = fb.mlp_block_fwd(x, *mlp, *ln2)
        _, m_acc = fa.reference_mlp_block(x, *mlp, *ln2, save_acc=True)
        _bwd_width_entry(out, f"fused_mlp_block_bwd@hid{hid}",
                         lambda x=x, w1=w1, b1=b1, w2=w2, ln2=ln2, dy=dy, s=m_saved: fb.mlp_block_bwd(
                             x, w1, b1, w2, ln2[0], dy, s), lambda r: dict(zip(_MLP_GRADS, r)),
                         lambda x=x, w1=w1, b1=b1, w2=w2, ln2=ln2, dy=dy, a=m_acc: dict(zip(
                             _MLP_GRADS, fb.reference_mlp_block_bwd(x, w1, b1, w2, ln2[0], dy, a))),
                         (x, w1, b1, w2, ln2[0], dy, m_saved), dict(bf16=_mlp_bwd_ops(b * l, hid, ff)), sz, device,
                         b, l)
        if hid == 64:
            wq, wk, wv, wo, bq, bk, bv, bo = attn
            wqkv, bqkv = torch.cat([wq, wk, wv], dim=1), torch.cat([bq, bk, bv])
            _, a_saved = fb.attention_block_fwd(x, wqkv, bqkv, wo, bo, mask, heads, *ln1)
            _, a_acc = fa.reference_attention_block(x, *attn, mask, heads, *ln1, save_acc=True)
            proj, core = _attention_ops(b, l, hid, heads)
            _bwd_width_entry(out, "fused_attention_block_bwd@hid64",
                             lambda: fb.attention_block_bwd(x, wqkv, bqkv, wo, mask, heads, ln1[0], dy, a_saved),
                             lambda r: _named_attention_grads(*r),
                             lambda: dict(zip(_ATTN_GRADS, fb.reference_attention_block_bwd(
                                 x, wq, wk, wv, wo, bq, bk, bv, mask, heads, ln1[0], dy, a_acc))),
                             (x, wqkv, bqkv, wo, mask, ln1[0], dy, a_saved), dict(bf16=2 * proj + 5 * core // 2),
                             sz, device, b, l, _zero_attention_grads(l))
    return out


def phase_int8_mlp_mix(sz, device, kern):
    """bench.py's ``encoder_int8_mlp`` mix (bf16 attention half K1, int8 MLP
    half K9) at its (B, L) = (1024, 128): a layer's two halves in turn, each
    against its plain version at the encoder halves' bar (K9 also its mean
    |d|), timed into the kernels' timings (``path: int8_mlp_mix``)."""
    import torch

    from matchmaker_tpu_torch.ops import fused_attention as fa
    from matchmaker_tpu_torch.ops import fused_int8 as fi

    b, l = sz["int8_mlp_mix_shape"]
    attn, ln1, _, _ = _layer_params(sz, device, seed=23)
    _, mlp, _, ln2 = _int8_layer_params(sz, device, seed=24)
    w1q, s1, b1, w2q, s2, b2 = mlp
    mlp_t = (fi.kmajor_codes(w1q), s1, b1, fi.kmajor_codes(w2q), s2, b2)
    x, mask, _ = _half_inputs(sz, b, l, device, 25)
    proj, core = _attention_ops(b, l, sz["hid"], sz["heads"])
    h = fa.fused_attention_block(x, *attn, mask, sz["heads"], *ln1)
    cases = (("fused_attention_block", lambda: fa.fused_attention_block(x, *attn, mask, sz["heads"], *ln1),
              lambda: fa.reference_attention_block(x, *attn, mask, sz["heads"], *ln1), x, (x, attn, mask, ln1),
              dict(bf16=proj + core)),
             ("fused_mlp_int8_block", lambda: fi.fused_mlp_int8_block_kmajor(h, *mlp_t, *ln2),
              lambda: fi.reference_mlp_int8_block(h, *mlp, *ln2), h, (h, mlp_t, ln2),
              dict(int8=4 * b * l * sz["hid"] * sz["ff"])))
    for name, kernel, plain, inp, inputs, ops in cases:
        got, want = kernel(), plain()
        cos, err = _rows_close(got, want)
        mean = _mean_abs(got, want)
        print(f"[kernels] {name} B={b} L={l} (the encoder_int8_mlp mix): min row cosine {cos:.6f}, max |d| "
              f"{err:.4g}, mean |d| {mean:.4g}")
        check(got.shape == inp.shape and bool(torch.isfinite(got.float()).all()), f"{name} output at {(b, l)}")
        check(cos >= 0.999 and err <= 0.1, f"{name} vs plain at {(b, l)}: cos {cos}, max |d| {err}")
        if name == "fused_mlp_int8_block":
            check(mean <= INT8_HALF_MEAN_ABS, f"{name} vs plain at {(b, l)}: mean |d| {mean}")
        entry = kern[name]
        entry["max_abs_err"] = max(entry["max_abs_err"], err)
        _record(entry, [b, l, sz["hid"]], kernel, plain, device, sz["reps"], headline=False,
                bound_of=bound(nbytes(inputs, got), **ops))
        _device_beside(entry, kernel, device, headline=False)
        entry["timings"][-1]["path"] = "int8_mlp_mix"
    return kern


# ---- phase 3, the widths the card took last: heads of 128, wide LayerNorm
# rows, widths that are not a multiple of 8, K14 at D 100 ----------------------

# (hidden, heads, FF): heads of 128 on their instance (8 at 1,024), the
# 64-wide instance at equal FLOPs (16 heads of 64 at 1,024: BERT-large's
# layer), heads of 80 zero-padded to 128 (8 at 640), 12 heads of 128 at
# 1,536 (the LayerNorm backward past 1,024 columns), hidden widths that are
# not a multiple of 8 (the products at the next one): 100 in 4 heads of
# 25 with FF 400, 32 in 4 heads of 8 with FF 36
WIDE_WIDTH_CASES = [(1024, 8, 4096), (1024, 16, 4096), (640, 8, 2560), (1536, 12, 6144), (100, 4, 400),
                    (32, 4, 36)]
# K14, its training form and its backward at D 100 (run at 104): (Bq, Lq,
# Bd, Ld, D), the ColBERT training shape and a rescore-size all-pairs batch
WIDE_MAXSIM_SHAPES = [(32, 30, 64, 200, 100), (128, 32, 256, 200, 100)]


def _wide_tag(hid, heads, ff):
    """The kernels line's suffix of a WIDE_WIDTH_CASES geometry."""
    d = hid // heads
    if hid % 8 or ff % 8 or hid > 1024:
        return f"hid{hid}"
    return f"hd{d}" if d != 64 else f"hd64@{hid}"


def _wide_kernels(hid, heads, ff):
    """The kernels a geometry is timed with: the attention ones for the
    heads, the LayerNorm backward's for 1,536, every encoder half for the
    widths that are not a multiple of 8."""
    if hid % 8 or ff % 8:
        return ("fused_attention_block", "fused_mlp_block", "fused_attention_int8_block", "fused_mlp_int8_block",
                "fused_attention_block_bwd", "fused_mlp_block_bwd")
    if hid > 1024:
        return ("fused_attention_block_bwd", "fused_mlp_block_bwd")
    if hid // heads == 64:
        return ("fused_attention_block", "fused_mha", "fused_attention_block_bwd")
    return ("fused_attention_block", "fused_mha", "fused_attention_int8_block", "fused_attention_block_bwd")


def _wide_forward(out, key, kernel, plain, inputs, ops, sz, device, shape, headline, library=None, int8=False,
                  device_reps=20, timed=True):
    """One forward kernel against its plain version at the encoder halves'
    bar (K9/K10 also their mean |d|) and, where ``timed``, timed with its
    plain version, its device time (over ``device_reps`` calls) and bound
    into ``out[key]`` (a timing more where the entry exists); ``library``
    beside it (CUDA events and device time) where one call computes the
    same function."""
    import torch

    entry = out.setdefault(key, {"max_abs_err": 0.0, "library_ms": None})
    got, want = kernel(), plain()
    cos, err = _rows_close(got, want)
    mean = _mean_abs(got, want)
    print(f"[kernels] {key} {shape}: min row cosine {cos:.6f}, max |d| {err:.4g}, mean |d| {mean:.4g}")
    check(got.shape == want.shape and bool(torch.isfinite(got.float()).all()), f"{key} output at {shape}")
    check(cos >= 0.999 and err <= 0.1, f"{key} vs plain at {shape}: cos {cos}, max |d| {err}")
    if int8:
        check(mean <= INT8_HALF_MEAN_ABS, f"{key} vs plain at {shape}: mean |d| {mean}")
    entry["max_abs_err"] = max(entry["max_abs_err"], err)
    if not timed:
        return
    _record(entry, shape, kernel, plain, device, sz["reps"], headline, bound_of=bound(nbytes(inputs, got), **ops))
    _device_beside(entry, kernel, device, headline, reps=device_reps)
    if library is not None and device.type == "cuda":
        timing = entry["timings"][-1]
        lib = timing["library_ms"] = _time_ms(library, device, sz["reps"])
        lib_dev = timing["library_device_ms"] = _device_ms(library, device, device_reps)
        print(f"[kernels]   library scaled_dot_product_attention {lib:.4f} ms, device {_fmt(lib_dev)}")
        if headline:
            entry.update(library_ms=lib, library_device_ms=lib_dev)


def phase_wide_width_kernels(sz, device):
    """The widths of WIDE_WIDTH_CASES at each (B, L) of
    ``wide_width_shapes`` (the first the headline): K1, K13 (beside one
    scaled_dot_product_attention), K10 and K12 at heads of 128 and of 80
    (padded to 128 as the encoder pads them, the weights and codes once
    before the timing), and at 16 heads of 64 at hidden 1,024 (the same
    FLOPs on the 64-wide instance); K12 and K11 at hidden 1,536 (the
    LayerNorm backward past 1,024 columns); every encoder half (K1, K2, K9,
    K10, K11, K12) at hidden 100 and 32; then K14, its training form and
    its backward at D 100. Each against its plain version on the unpadded
    weights: the forwards at the encoder halves' bar (row cosine >= 0.999,
    max |d| <= 0.1; K9/K10 also mean |d| <= 5e-5), the backwards at the
    backward's (every gradient's cosine >= 0.999, max |d| <= 2e-2 max
    |plain|, padded heads' columns zero), K14's at rtol = atol = 1e-4;
    timed beside the plain version with the device time and the bound on
    the unpadded work."""
    import torch

    from matchmaker_tpu_torch.ops import fused_attention as fa
    from matchmaker_tpu_torch.ops import fused_backward as fb
    from matchmaker_tpu_torch.ops import fused_int8 as fi
    from matchmaker_tpu_torch.ops import maxsim as ms
    from matchmaker_tpu_torch.probes import attn_inner as ai

    out = {}
    for i, (b, l) in enumerate(sz["wide_width_shapes"]):
        headline = i == 0
        for hid, heads, ff in WIDE_WIDTH_CASES:
            tag, hd = _wide_tag(hid, heads, ff), hid // heads
            kernels = _wide_kernels(hid, heads, ff)
            width = fa.kernel_head_dim("chip_smoke", hid, heads)
            hsz = dict(sz, hid=hid, ff=ff)
            seed = 60 + hid + heads
            attn, ln1, mlp, ln2 = _layer_params(hsz, device, seed=seed)
            wq, wk, wv, wo, bq, bk, bv, bo = attn
            wqkv, bqkv = torch.cat([wq, wk, wv], dim=1), torch.cat([bq, bk, bv])
            pw, pb, po = fa.pad_attention_heads(wqkv, bqkv, wo, heads)  # as the encoder packs them
            x, mask, g = _half_inputs(hsz, b, l, device, seed + 1)
            dy = torch.randn(b, l, hid, generator=g, device=device).to(torch.bfloat16)
            proj, core = _attention_ops(b, l, hid, heads)
            shape = [b, l, hid, hd]
            if "fused_attention_block" in kernels:
                _wide_forward(out, f"fused_attention_block@{tag}",
                              lambda: fa.fused_attention_block_qkv(x, pw, pb, po, bo, mask, heads, *ln1, head_dim=hd),
                              lambda: fa.reference_attention_block(x, *attn, mask, heads, *ln1), (x, attn, mask, ln1),
                              dict(bf16=proj + core), sz, device, shape, headline)
            if "fused_mlp_block" in kernels:
                _wide_forward(out, f"fused_mlp_block@{tag}", lambda: fa.fused_mlp_block(x, *mlp, *ln2),
                              lambda: fa.reference_mlp_block(x, *mlp, *ln2), (x, mlp, ln2),
                              dict(bf16=4 * b * l * hid * ff), sz, device, shape, headline)
            if "fused_mha" in kernels:
                q, k, v = (torch.randn(b, l, hid, generator=g, device=device).to(torch.bfloat16) for _ in range(3))
                _wide_forward(out, f"fused_mha@{tag}", lambda: fa.fused_mha(q, k, v, mask, heads),
                              lambda: fa.mha_reference(q, k, v, mask, heads), (q, k, v, mask),
                              dict(bf16=4 * hid * l * int(mask.sum())), sz, device, shape, headline,
                              library=lambda: ai.sdpa(q, k, v, mask, heads))
            if "fused_attention_int8_block" in kernels:
                q8, m8, q8ln, q8ln2 = _int8_layer_params(hsz, device, seed=seed + 2)
                q8_t = fi.kmajor_attention_weights(*q8)
                q8_p = fi.pad_int8_attention(*q8_t[:4], heads, 2) + q8_t[4:]
                _wide_forward(out, f"fused_attention_int8_block@{tag}",
                              lambda: fi.fused_attention_int8_block_qkv_kmajor(x, *q8_p, mask, heads, *q8ln,
                                                                               head_dim=hd),
                              lambda: fi.reference_attention_int8_block(x, *q8, mask, heads, *q8ln),
                              (x, q8_t, mask, q8ln), dict(int8=proj, bf16=core), sz, device, shape, headline,
                              int8=True)
            if "fused_mlp_int8_block" in kernels:
                w1q, s1, b1, w2q, s2, b2 = m8
                m8_p = fi.pad_int8_mlp(fi.kmajor_codes(w1q), s1, b1, fi.kmajor_codes(w2q)) + (s2, b2)
                _wide_forward(out, f"fused_mlp_int8_block@{tag}",
                              lambda: fi.fused_mlp_int8_block_kmajor(x, *m8_p, *q8ln2),
                              lambda: fi.reference_mlp_int8_block(x, *m8, *q8ln2), (x, m8, q8ln2),
                              dict(int8=4 * b * l * hid * ff), sz, device, shape, headline, int8=True)
            if "fused_attention_block_bwd" in kernels:
                _, a_saved = fb.attention_block_fwd(x, pw, pb, po, bo, mask, heads, *ln1, head_dim=hd)
                _, a_acc = fa.reference_attention_block(x, *attn, mask, heads, *ln1, save_acc=True)
                unpadded_saved = (a_acc, torch.empty(b, l, 3 * hid, dtype=torch.bfloat16),
                                  torch.empty(b, l, hid, dtype=torch.bfloat16))  # bytes of the unpadded work

                def named12(grads, heads=heads, hd=hd, width=width):
                    return _named_attention_grads(*(_unpadded_attention_grads(grads, heads, hd, width)
                                                    if width != hd else grads))

                _bwd_width_entry(out, f"fused_attention_block_bwd@{tag}",
                                 lambda: fb.attention_block_bwd(x, pw, pb, po, mask, heads, ln1[0], dy, a_saved,
                                                                head_dim=hd), named12,
                                 lambda: dict(zip(_ATTN_GRADS, fb.reference_attention_block_bwd(
                                     x, wq, wk, wv, wo, bq, bk, bv, mask, heads, ln1[0], dy, a_acc))),
                                 (x, wqkv, bqkv, wo, mask, ln1[0], dy, unpadded_saved),
                                 dict(bf16=2 * proj + 5 * core // 2), sz, device, b, l, _zero_attention_grads(l),
                                 headline=headline, device_reps=20)
                del a_saved, a_acc
            if "fused_mlp_block_bwd" in kernels:
                w1, b1, w2, b2 = mlp
                _, m_saved = fb.mlp_block_fwd(x, *mlp, *ln2)
                _, m_acc = fa.reference_mlp_block(x, *mlp, *ln2, save_acc=True)
                _bwd_width_entry(out, f"fused_mlp_block_bwd@{tag}",
                                 lambda: fb.mlp_block_bwd(x, w1, b1, w2, ln2[0], dy, m_saved),
                                 lambda r: dict(zip(_MLP_GRADS, r)),
                                 lambda: dict(zip(_MLP_GRADS, fb.reference_mlp_block_bwd(x, w1, b1, w2, ln2[0], dy,
                                                                                         m_acc))),
                                 (x, w1, b1, w2, ln2[0], dy, m_acc), dict(bf16=_mlp_bwd_ops(b * l, hid, ff)), sz,
                                 device, b, l, headline=headline, device_reps=20)
                del m_saved, m_acc
            for key in [k for k in out if k.endswith(f"@{tag}")]:
                out[key].update(hidden=hid, heads=heads, ff=ff, head_dim=hd, padded_to=width,
                                hidden_padded_to=fa.card_width(hid))
        if device.type == "cuda":
            torch.cuda.empty_cache()

    # K14, the training form and the backward at D 100
    for name in ("maxsim_all_pairs", "maxsim_all_pairs_argmax", "maxsim_all_pairs_bwd"):
        out[f"{name}@d100"] = {"max_abs_err": 0.0, "library_ms": None, "dim": 100, "padded_to": 104}
    for i, (bq, lq, bd, ld, dim) in enumerate(WIDE_MAXSIM_SHAPES):
        shape, headline = [bq, lq, bd, ld, dim], i == 0
        q, d, qm, dm = _maxsim_inputs(bq, lq, bd, ld, dim, False, device, 700 + i)
        gr = torch.randn(bq, bd, generator=torch.Generator(device=device).manual_seed(71 + i), device=device)
        fill = -1000.0
        _k14_check(out["maxsim_all_pairs@d100"], ms.maxsim_all_pairs(q, d, qm, dm, fill=fill),
                   ms.reference_maxsim_all_pairs(q, d, qm, dm, fill), shape, fill)
        got, idx = ms.maxsim_all_pairs_argmax(q, d, qm, dm, fill)
        want, want_idx, top1, top2 = ms.reference_maxsim_argmax(q, d, qm, dm, fill, with_top2=True)
        _k14_check(out["maxsim_all_pairs_argmax@d100"], got, want, shape, fill)
        agree = idx == want_idx
        check(float(agree.float().mean()) >= 0.9999 and bool(((top1 - top2).abs() <= 1e-5 * top1.abs())[~agree].all()),
              f"K14's training form at {shape}: saved tokens off a near tie")
        dq, dd = ms.maxsim_all_pairs_bwd(q, d, qm, dm, idx, gr)
        rq, rd = ms.reference_maxsim_bwd(q, d, qm, dm, idx, gr)
        check(dq.shape == q.shape and dd.shape == d.shape, f"the MaxSim backward's shapes at {shape}")
        err = max(float((dq - rq).abs().max()), float((dd - rd).abs().max()))
        check(bool(((dq - rq).abs() <= 1e-4 + 1e-4 * rq.abs()).all() and ((dd - rd).abs() <= 1e-4 + 1e-4 * rd.abs()).all()),
              f"the MaxSim backward at {shape}: max |d| {err}")
        out["maxsim_all_pairs_bwd@d100"]["max_abs_err"] = max(out["maxsim_all_pairs_bwd@d100"]["max_abs_err"], err)
        print(f"[kernels] maxsim training form and backward {shape}: tokens agree on "
              f"{float(agree.float().mean()):.6f}, dq / dd vs reference_maxsim_bwd max |d| {err:.4g}")
        live = 2 * dim * int((qm > 0).sum()) * int((dm > 0).sum())
        used = int(((gr[:, None, :] * qm[:, :, None] != 0) & (idx >= 0)).sum())
        for name, kernel, plain, bound_of in (
                ("maxsim_all_pairs", lambda: ms.maxsim_all_pairs(q, d, qm, dm, fill=fill),
                 lambda: ms.reference_maxsim_all_pairs(q, d, qm, dm, fill), bound(nbytes(q, d, qm, dm, got),
                                                                                   tf32=3 * live)),
                ("maxsim_all_pairs_argmax", lambda: ms.maxsim_all_pairs_argmax(q, d, qm, dm, fill),
                 lambda: ms.reference_maxsim_argmax(q, d, qm, dm, fill), bound(nbytes(q, d, qm, dm, got, idx),
                                                                              tf32=3 * live)),
                ("maxsim_all_pairs_bwd", lambda: ms.maxsim_all_pairs_bwd(q, d, qm, dm, idx, gr),
                 lambda: ms.reference_maxsim_bwd(q, d, qm, dm, idx, gr),
                 bound(nbytes(q, d, qm, dm, idx, gr, dq, dd), f32=4 * dim * used))):
            entry = out[f"{name}@d100"]
            _record(entry, shape, kernel, plain, device, sz["reps"], headline, bound_of=bound_of)
            _device_beside(entry, kernel, device, headline, reps=20)
    return out


WIDE_TAGS = {_wide_tag(*c) for c in WIDE_WIDTH_CASES} | {"d100"}


def wide_kernel_entries(f, kern, device):
    """The kernels line's entries of phase 3's new widths: on phase 13
    (f)'s paths (``f``, its result) where its runs launch them (BERT-large
    for the 64-wide instance at 1,024, each WIDTH_GEOMETRIES run for its own
    width: K1 and K9 in the encode, K1, K2, K12 and K11 in the steps); K13,
    K10 and K14 at D 100 on none."""
    sources = {k[0]: (k[1], k[2]) for k in KERNELS}
    runs = {"hd64@1024": ("bert_large", f["launches"]),
            **{_wide_tag(h, n, ff): (f"width_{h}x{n}", f["widths"][f"{h}x{n}"]["launches_all"])
               for h, n, ff in WIDTH_GEOMETRIES}}
    entries = []
    for key in sorted(k for k in kern if k.split("@", 1)[-1] in WIDE_TAGS):
        name, tag = key.split("@", 1)
        run, counts = runs.get(tag, (None, {}))
        on_path = run is not None and name not in _OFF_PATH and not name.startswith("maxsim")
        launches = counts.get(name, 0) if on_path else 0
        if on_path and device.type == "cuda":
            check(launches > 0, f"phase 13 (f)'s {run} run launched no {name} kernel ({key})")
        e = kern[key]
        entries.append(
            {"name": key, "route": "cuda", "source": sources[name][0], "replaces": sources[name][1],
             **{k: e[k] for k in ("hidden", "heads", "ff", "head_dim", "padded_to", "hidden_padded_to", "dim")
                if k in e}, "path": run if on_path else None, "launches": launches,
             "max_abs_err": e["max_abs_err"], "ms": e["ms"], "plain_ms": e["plain_ms"], "bound_ms": e["bound_ms"],
             "bound_by": e["bound_by"], "library_ms": e.get("library_ms"), "timed_shape": e["timed_shape"],
             "device_ms": e.get("device_ms"), "x_bound": e.get("x_bound"),
             "library_device_ms": e.get("library_device_ms")})
    return entries


def wide_width_summary(kern):
    """The 128-wide instances' device ms beside the 64-wide instance's at
    the same FLOPs (8 heads of 128 and 16 of 64 at hidden 1,024), and K13
    at 128 beside scaled_dot_product_attention, at each timed shape."""
    rows = []
    for name in ("fused_attention_block", "fused_mha", "fused_attention_block_bwd"):
        wide, narrow = kern.get(f"{name}@hd128"), kern.get(f"{name}@hd64@1024")
        if not wide or not narrow:
            continue
        for tw, tn in zip(wide["timings"], narrow["timings"]):
            row = {"kernel": name, "shape": tw["shape"][:3], "hd128_device_ms": tw.get("device_ms"),
                   "hd64_device_ms": tn.get("device_ms"), "hd128_ms": tw["ms"], "hd64_ms": tn["ms"]}
            if name == "fused_mha":
                row["library_ms"] = tw.get("library_ms")
            rows.append(row)
            print(f"[kernels] {name} at {row['shape']}: 8 heads of 128 device {_fmt(row['hd128_device_ms'])} vs 16 "
                  f"heads of 64 {_fmt(row['hd64_device_ms'])} (the same FLOPs)"
                  + (f"; scaled_dot_product_attention at 128 {row['library_ms']:.4f} ms (events)"
                     if row.get("library_ms") is not None else ""))
    return rows


# ---- phase 3: sequences past 512 ---------------------------------------------

# (B, L) of the attention kernels past 512 keys: checked at heads of 64 and
# of 128 (LONG_HEADS) and timed at heads of 64 at ``long_timed_shapes``
LONG_CHECK_SHAPES = [(3, 513), (3, 1024), (3, 2048)]
LONG_HEADS = [(768, 12, 3072), (1024, 8, 4096)]
# K14 past 512 query rows (Bq, Lq, Bd, Ld, D; the first timed); the
# gathered form's queries (B, Lq, C, D, slots); the training form and its
# backward past 1,024 doc tokens (Bq, Lq, Bd, Ld, D, fill, live dots below
# -1000, exact ties; the first the headline)
LONG_MAXSIM_SHAPES = [(3, 1024, 64, 200, 128), (3, 513, 9, 77, 768)]
LONG_GATHERED = [(8, 1024, 64, 128, 128), (2, 513, 9, 768, 77)]
LONG_MAXSIM_TRAIN = [(4, 600, 8, 2000, 128, -1000.0, False, True), (8, 30, 16, 1025, 128, -1000.0, False, True)]


def _long_mask(b, l, device, seed):
    """Example 0 live up to a key past key 512 (the tiles after its last
    skipped), example 1 without a live key (every tile runs), example 2
    with random holes, the rest live."""
    import torch

    g = torch.Generator(device=device).manual_seed(seed)
    mask = torch.ones(b, l, device=device)
    mask[0, 512 + (l - 512) // 2 + 1:] = 0.0
    if b > 1:
        mask[1] = 0.0
    if b > 2:
        mask[2] = (torch.rand(l, generator=g, device=device) > 0.3).float()
        mask[2, 0] = 1.0
    return mask


def _needed_core_ops(mask, hid):
    """QK^T and P.V operations of an attention core over the keys its data
    needs: every query row against each example's keys up to its last with
    m = 1, or against all L where none has m = 1 (the softmax then spreads
    over every key)."""
    import torch

    l = mask.shape[1]
    last = ((mask == 1) * torch.arange(1, l + 1, device=mask.device)).amax(dim=1)
    return 4 * hid * l * int(torch.where(last > 0, last, l).sum())


def _long_attention_case(out, sz, b, l, device, seed, timed, headline):
    """K1, K10, K13 and K12 at (b, l) with _long_mask's masks against their
    plain versions (the bars of phase_wide_width_kernels) into the entries
    ``<kernel>@long``; where ``timed`` also timed beside the plain version,
    by device time and against the bound of the keys the masks need
    (K13 beside scaled_dot_product_attention)."""
    import torch

    from matchmaker_tpu_torch.ops import fused_attention as fa
    from matchmaker_tpu_torch.ops import fused_backward as fb
    from matchmaker_tpu_torch.ops import fused_int8 as fi
    from matchmaker_tpu_torch.probes import attn_inner as ai

    hid, heads = sz["hid"], sz["heads"]
    hd = hid // heads
    attn, ln1, _, _ = _layer_params(sz, device, seed=seed)
    wq, wk, wv, wo, bq, bk, bv, bo = attn
    wqkv, bqkv = torch.cat([wq, wk, wv], dim=1), torch.cat([bq, bk, bv])
    pw, pb, po = fa.pad_attention_heads(wqkv, bqkv, wo, heads)
    x, _, g = _half_inputs(sz, b, l, device, seed + 1)
    mask = _long_mask(b, l, device, seed + 2)
    dy = torch.randn(b, l, hid, generator=g, device=device).to(torch.bfloat16)
    q, k, v = (torch.randn(b, l, hid, generator=g, device=device).to(torch.bfloat16) for _ in range(3))
    proj, _ = _attention_ops(b, l, hid, heads)
    core = _needed_core_ops(mask, hid)
    shape = [b, l, hid, hd]
    kw = dict(timed=timed, device_reps=10)
    _wide_forward(out, "fused_attention_block@long",
                  lambda: fa.fused_attention_block_qkv(x, pw, pb, po, bo, mask, heads, *ln1, head_dim=hd),
                  lambda: fa.reference_attention_block(x, *attn, mask, heads, *ln1), (x, attn, mask, ln1),
                  dict(bf16=proj + core), sz, device, shape, headline, **kw)
    _wide_forward(out, "fused_mha@long", lambda: fa.fused_mha(q, k, v, mask, heads),
                  lambda: fa.mha_reference(q, k, v, mask, heads), (q, k, v, mask), dict(bf16=core), sz, device, shape,
                  headline, library=lambda: ai.sdpa(q, k, v, mask, heads), **kw)
    q8, _, q8ln, _ = _int8_layer_params(sz, device, seed=seed + 3)
    q8_t = fi.kmajor_attention_weights(*q8)
    q8_p = fi.pad_int8_attention(*q8_t[:4], heads, 2) + q8_t[4:]
    _wide_forward(out, "fused_attention_int8_block@long",
                  lambda: fi.fused_attention_int8_block_qkv_kmajor(x, *q8_p, mask, heads, *q8ln, head_dim=hd),
                  lambda: fi.reference_attention_int8_block(x, *q8, mask, heads, *q8ln), (x, q8_t, mask, q8ln),
                  dict(int8=proj, bf16=core), sz, device, shape, headline, int8=True, **kw)
    _, a_saved = fb.attention_block_fwd(x, pw, pb, po, bo, mask, heads, *ln1, head_dim=hd)
    _, a_acc = fa.reference_attention_block(x, *attn, mask, heads, *ln1, save_acc=True)
    _bwd_width_entry(out, "fused_attention_block_bwd@long",
                     lambda: fb.attention_block_bwd(x, pw, pb, po, mask, heads, ln1[0], dy, a_saved, head_dim=hd),
                     lambda grads: _named_attention_grads(*grads),
                     lambda: dict(zip(_ATTN_GRADS, fb.reference_attention_block_bwd(
                         x, wq, wk, wv, wo, bq, bk, bv, mask, heads, ln1[0], dy, a_acc))),
                     (x, wqkv, bqkv, wo, mask, ln1[0], dy, a_saved), dict(bf16=2 * proj + 5 * core // 2), sz,
                     device, b, l, _zero_attention_grads(l), headline=headline, **kw)
    del a_saved, a_acc
    if device.type == "cuda":
        torch.cuda.empty_cache()


def phase_long_sequence_kernels(sz, device):
    """Sequences past 512 (the attention cores' mask row in 512-key windows,
    K14's row sums in passes of 512, the MaxSim backward's tie classes
    sized by Ld): K1, K10, K13 and K12 at LONG_CHECK_SHAPES, heads of 64
    and of 128, and timed at ``long_timed_shapes`` (heads of 64; L 8,192
    at B 1), each with _long_mask's masks; K14 at Lq 513 and 1,024, all
    pairs (LONG_MAXSIM_SHAPES, the first timed) and gathered
    (LONG_GATHERED); the training form and the backward at
    LONG_MAXSIM_TRAIN (_maxsim_training_shape's gates and timings). The
    bars are phase 3's: the encoder halves' (K10 also its mean |d|), the
    backward's, K14's rtol = atol = 1e-4."""
    import torch

    from matchmaker_tpu_torch.ops import maxsim as ms

    out = {}
    for hid, heads, ff in LONG_HEADS:
        hsz = dict(sz, hid=hid, heads=heads, ff=ff)
        cases = [(shape, False) for shape in LONG_CHECK_SHAPES]
        if (hid, heads, ff) == LONG_HEADS[0]:
            cases += [(tuple(shape), True) for shape in sz["long_timed_shapes"]]
        for (b, l), timed in cases:
            _long_attention_case(out, hsz, b, l, device, 80 + l + hid, timed,
                                 timed and (b, l) == tuple(sz["long_timed_shapes"][0]))
    entry = out["maxsim_all_pairs@long"] = {"max_abs_err": 0.0, "library_ms": None}
    for i, (bq, lq, bd, ld, dim) in enumerate(LONG_MAXSIM_SHAPES):
        shape = [bq, lq, bd, ld, dim]
        q, d, qm, dm = _maxsim_inputs(bq, lq, bd, ld, dim, False, device, 950 + i)
        for fill in (-1000.0, float("-inf")):
            got = ms.maxsim_all_pairs(q, d, qm, dm, fill=fill)
            _k14_check(entry, got, ms.reference_maxsim_all_pairs(q, d, qm, dm, fill), shape, fill)
            check(torch.equal(got, ms.maxsim_all_pairs(q, d, qm, dm, fill=fill)), f"K14's reruns differ at {shape}")
        if i == 0:
            live = 2 * dim * int((qm > 0).sum()) * int((dm > 0).sum())
            _record(entry, shape, lambda a=(q, d, qm, dm): ms.maxsim_all_pairs(*a),
                    lambda a=(q, d, qm, dm): ms.reference_maxsim_all_pairs(*a), device, sz["reps"], True,
                    bound_of=bound(nbytes(q, d, qm, dm, got), tf32=3 * live))
            _device_beside(entry, lambda a=(q, d, qm, dm): ms.maxsim_all_pairs(*a), device, True, reps=20)
    for i, (b, lq, c, dim, pad) in enumerate(LONG_GATHERED):
        g = torch.Generator(device=device).manual_seed(960 + i)
        counts = torch.randint(0, pad + 1, (50,), generator=g, device=device)
        starts = torch.cumsum(counts, 0) - counts
        tokens = (torch.randn(int(counts.sum()), dim, generator=g, device=device) * 2).half()
        pick = torch.randint(0, 50, (b, c), generator=g, device=device)
        q = torch.randn(b, lq, dim, generator=g, device=device) * 2
        qm = (torch.rand(b, lq, generator=g, device=device) > 0.2).float()
        qm[:, 0] = 1.0
        first, count = starts[pick].cpu(), counts[pick].int().cpu()
        got = ms.maxsim_gathered(q, qm, tokens, first, count, pad, fill=float("-inf"))
        _k14_check(entry, got, ms.reference_maxsim_gathered(q, qm, tokens, first, count, pad, float("-inf")),
                   [b, lq, c, dim, pad], float("-inf"))
    fwd = out["maxsim_all_pairs_argmax@long"] = {"max_abs_err": 0.0, "library_ms": None}
    bwd = out["maxsim_all_pairs_bwd@long"] = {"max_abs_err": 0.0, "library_ms": None}
    fwd["token_agreement"] = [_maxsim_training_shape(fwd, bwd, case, 970 + i, sz, device, i == 0)
                              for i, case in enumerate(LONG_MAXSIM_TRAIN)]
    return out


def long_kernel_entries(long_docs, kern, device):
    """The kernels line's entries of phase 3's sequences past 512, their
    launches those of phase 15's runs (``long_docs``, its result): K1 in
    every run, K10 in the encoder_int8 batch, K12 in both training runs,
    the training form and the backward in ColBERT's; K13 and K14 on no
    path there."""
    sources = {k[0]: (k[1], k[2]) for k in KERNELS}
    entries = []
    for key in sorted(k for k in kern if k.endswith("@long")):
        name = key.split("@", 1)[0]
        launches = long_docs["launches"].get(name, 0)
        on_path = name not in ("fused_mha", "maxsim_all_pairs")
        if on_path and device.type == "cuda":
            check(launches > 0, f"phase 15's runs launched no {name} kernel ({key})")
        e = kern[key]
        entries.append(
            {"name": key, "route": "cuda", "source": sources[name][0], "replaces": sources[name][1],
             "path": "long_docs" if on_path else None, "launches": launches if on_path else 0,
             "max_abs_err": e["max_abs_err"], "ms": e["ms"], "plain_ms": e["plain_ms"], "bound_ms": e["bound_ms"],
             "bound_by": e["bound_by"], "library_ms": e.get("library_ms"), "timed_shape": e["timed_shape"],
             "device_ms": e.get("device_ms"), "x_bound": e.get("x_bound"),
             "library_device_ms": e.get("library_device_ms")})
    return entries


# ---- phase 13: JAX run folders, accumulation, hub teachers, the fused check ----

# configs/huggingface_modelhub/sebastian-hofstaetter/colbert-distilbert-margin_mse-T2-msmarco.yaml, key for key
# (the card has no PyYAML; tests/test_torch_jax_runs.py holds this dict to the file)
HUB_TEACHER = "sebastian-hofstaetter/colbert-distilbert-margin_mse-T2-msmarco"
HUB_TEACHER_STUB = {"model": "colbert", "model_input_type": "independent", "token_embedder_type": "huggingface_bpe",
                    "bert_pretrained_model": HUB_TEACHER, "colbert_compression_dim": 768,
                    "query_augment_mask_number": 8, "use_fp16": True, "train_embedding": True,
                    "max_doc_length": 200, "max_query_length": 30, "min_doc_length": -1, "min_query_length": -1,
                    "random_seed": 208973249}
# phase 13 (c): cli/effectiveness_check.py's own config on the 4 x 256 mini
# encoder (4 heads of 64) through the fused halves, bf16 (the kernels' type);
# its learning rate and epochs (1e-3, phase 8's 6) as the CPU run of the
# plain versions set them (PERF.md, PR 19)
EFFECTIVENESS_FUSED = {"bert_pretrained_model": "mini", "encoder_fused_attention": True, "use_fp16": True}


def predicted_accumulation_launches(sz):
    """K1/K2 and K11/K12 once per layer and encode of each micro-step (two
    encodes: the queries, the packed documents); nothing else runs."""
    n = sz["accum_steps"] * sz["n_layers"] * 2
    return {"fused_attention_block": n, "fused_mlp_block": n, "fused_attention_block_bwd": n,
            "fused_mlp_block_bwd": n}


def predicted_hub_teacher_launches(sz):
    """The student's two encodes a step (forward and backward) and the
    ColBERT teacher's two (forward) per layer; K14's all-pairs form once a
    step (the teacher's in-batch matrix); nothing of K14's training form."""
    steps, layers = sz["hub_steps"], sz["n_layers"]
    return {"fused_attention_block": 4 * steps * layers, "fused_mlp_block": 4 * steps * layers,
            "fused_attention_block_bwd": 2 * steps * layers, "fused_mlp_block_bwd": 2 * steps * layers,
            "maxsim_all_pairs": steps, "maxsim_all_pairs_argmax": 0, "maxsim_all_pairs_bwd": 0}


def _run_files(folder):
    out = {}
    for name, _, _ in QUERY_SETS:
        with open(os.path.join(folder, f"{name}-output.txt"), "rb") as f:
            out[name] = f.read()
    return out


def _update_cosines(start, end_a, end_b, tag, what):
    """Per parameter, the cosine between two updates from ``start`` (the
    key biases, zero in exact arithmetic: their noise against the query
    bias's largest update, bar 2e-2)."""
    import torch

    worst, noise = (None, 2.0), 0.0
    for name, p0 in start.items():
        da, db = (end_a[name] - p0).float().reshape(-1), (end_b[name] - p0).float().reshape(-1)
        if name.endswith("attention.key.bias"):
            ref = float((end_b[name.replace("key.bias", "query.bias")] - start[name.replace("key.bias", "query.bias")])
                        .abs().max())
            noise = max(noise, float((da - db).abs().max()) / ref)
            continue
        cos = float(torch.nn.functional.cosine_similarity(da, db, dim=0))
        if cos < worst[1]:
            worst = (name, cos)
    print(f"[{tag}] {what}: worst cosine {worst[1]:.6f} at "
          f"{worst[0]}; key-bias noise {noise:.4g} of the query bias's update")
    check(worst[1] >= 0.99, f"{tag}: update cosine {worst[1]} at {worst[0]}")
    check(noise <= 2e-2, f"{tag}: key-bias update noise {noise}")
    return {"update_cos": worst[1], "update_cos_at": worst[0], "key_bias_noise": noise}


def phase_jax_run(sz, device, root):
    """Phase 13 (a), in phase 4's directory: a seeded DistilBERT-width
    BERT_DOT written as a JAX run folder (``best-model.flax`` alone, by
    ``state_dict_to_flax`` + ``write_flax``) and as a port run
    (``best-model.npz``); cli.dense_retrieval serves both over phase 4's
    collection (run files and encoded rows equal bit for bit); cli.train
    warm-starts from the ``.flax`` with ``gradient_accumulation_steps: 4``
    at batch 8 for ``accum_steps`` micro-steps, a constant learning rate
    without warmup (a warmup's first update has lr 0) (launches against the
    prediction, a finite loss every step, the parameters unchanged bit for
    bit after micro-steps 1-3 and moved after the 4th); then one
    accumulated update of 4 x 8 triples against one step over the 32 from
    the same weights under Margin-MSE without in-batch negatives."""
    import torch

    from matchmaker_tpu_torch.cli.dense_retrieval import run
    from matchmaker_tpu_torch.data.tokenization import build_tokenizer
    from matchmaker_tpu_torch.losses import get_loss
    from matchmaker_tpu_torch.models import get_model, init_params
    from matchmaker_tpu_torch.ops import _build
    from matchmaker_tpu_torch.retrieval.encode import load_encoded
    from matchmaker_tpu_torch.training import checkpoints as ckpt
    from matchmaker_tpu_torch.training.optim import build_optimizer
    from matchmaker_tpu_torch.training.train_step import make_train_step

    result = {}
    config = _main_config(root, sz, device)
    model = get_model(config, build_tokenizer(config))
    init_params(model, config, torch.Generator().manual_seed(31))
    jax_dir, npz_dir = os.path.join(root, "jax_run"), os.path.join(root, "npz_run")
    os.makedirs(jax_dir)
    os.makedirs(npz_dir)
    t0 = time.perf_counter()
    ckpt.write_flax(os.path.join(jax_dir, ckpt.BEST_MODEL_FLAX), ckpt.state_dict_to_flax(model))
    result["write_flax_s"] = time.perf_counter() - t0
    ckpt.save_params(os.path.join(npz_dir, ckpt.BEST_MODEL), model)
    t0 = time.perf_counter()
    back = ckpt.load_state(jax_dir)
    result["read_flax_s"] = time.perf_counter() - t0
    start = model.state_dict()
    check(back.keys() == start.keys() and all(torch.equal(back[k], start[k]) for k in start),
          "the .flax run folder does not load the weights written")
    served = {}
    for tag, folder in (("flax", jax_dir), ("npz", npz_dir)):
        out = os.path.join(root, f"served_{tag}")
        os.makedirs(out)
        fresh_perf_monitor()
        _build.reset_launches()
        check(run("encode+index+search", dict(config, trained_model=folder), out) == 0, f"serving the {tag} run")
        served[tag] = (_run_files(out), load_encoded(os.path.join(out, "encoded")), dict(_build.LAUNCHES))
    (files_f, (vec_f, ids_f), launches), (files_n, (vec_n, ids_n), _) = served["flax"], served["npz"]
    check(files_f == files_n, "the run files from the .flax and the .npz differ")
    check(np.array_equal(vec_f, vec_n) and np.array_equal(ids_f, ids_n), "the encoded rows differ")
    for name in SERVING:
        check(launches[name] > 0 or device.type != "cuda", f"serving the JAX run launched no {name} kernel")
    result["serve_launches"] = launches
    print(f"[jax_run] (a) a JAX run folder ({os.path.getsize(os.path.join(jax_dir, ckpt.BEST_MODEL_FLAX)) / 1e6:.1f} "
          f"MB best-model.flax, written in {result['write_flax_s']:.2f} s, read in {result['read_flax_s']:.2f} s) "
          f"served over {sz['passages']} passages: run files and encoded rows equal the .npz run's bit for bit; "
          f"launches {({k: v for k, v in launches.items() if v})}")
    del model

    # warm start from the .flax with gradient accumulation
    os.makedirs(os.path.join(root, "accum"))
    paths = _write_train_data(os.path.join(root, "accum"), dict(sz, train_batches=sz["accum_steps"]))
    tcfg = dict(_train_config(paths, sz, device), batch_size_train=sz["accum_batch"],
                gradient_accumulation_steps=sz["accum_k"], max_training_batches=sz["accum_steps"],
                warmstart_model_path=jax_dir, validate_every_n_batches=-1, validation_cont=None, test=None,
                run_dense_retrieval_eval=False, lr_schedule="constant", optimizer_warmup_steps=0)
    seen = {"unchanged": [], "moved": None}

    def watch(trainer):
        inner = trainer.train_step
        weights = {n: p.detach().clone() for n, p in trainer.model.named_parameters()}

        def step(batch):
            stats = inner(batch)
            i = len(seen["unchanged"]) + (seen["moved"] is not None) + 1
            same = all(torch.equal(p, weights[n]) for n, p in trainer.model.named_parameters())
            if i < sz["accum_k"]:
                seen["unchanged"].append(same)
            elif i == sz["accum_k"]:
                seen["moved"] = not same
            return stats

        trainer.train_step = step

    rsz = dict(sz, train_batch=sz["accum_batch"])
    trainer, res = _train_through_trainer(rsz, device, tcfg, os.path.join(root, "accum_run"), sz["accum_steps"],
                                          "jax_run", before=watch)
    _check_launches(res["launches"], predicted_accumulation_launches(sz), "the accumulation run", device)
    check(seen["unchanged"] == [True] * (sz["accum_k"] - 1) and seen["moved"],
          f"the parameters after micro-steps 1-{sz['accum_k']}: unchanged {seen['unchanged']}, moved "
          f"{seen['moved']}")
    check(trainer.optimizer.count == sz["accum_steps"] // sz["accum_k"] and trainer.global_step == sz["accum_steps"],
          f"{trainer.global_step} micro-steps, {trainer.optimizer.count} updates")
    print(f"[jax_run] (a) cli.train warm-started from the .flax, k = {sz['accum_k']} at batch {sz['accum_batch']}: "
          f"{sz['accum_steps']} micro-steps, {trainer.optimizer.count} updates, loss {res['loss_first']:.4f} -> "
          f"{res['loss_last']:.4f}; parameters unchanged after micro-steps 1-{sz['accum_k'] - 1}, moved after "
          f"the {sz['accum_k']}th; {res['cli_triples_per_s']:.1f} triples/s through the Trainer")
    result["train"] = res

    # one accumulated update against one big step, from the warm-start weights:
    # Margin-MSE alone (each micro-batch's loss a mean over its triples, so the
    # mean of the four gradients is the big batch's); lr 1 and Adam's eps 1
    # make the first update g / (|g| + 1), proportional to the gradient
    cmp_cfg = dict(tcfg, in_batch_negatives=False, lr_schedule="constant", optimizer_warmup_steps=0,
                   param_group0_learning_rate=1.0, param_group1_learning_rate=1.0,
                   embedding_optimizer_learning_rate=1.0, adam_eps=1.0, weight_decay=0.0)
    big = _device_batch(dict(cmp_cfg, batch_size_train=sz["accum_k"] * sz["accum_batch"]), trainer.tokenizer,
                        paths["train"], device)
    model = trainer.model
    ends = {}
    for k in (sz["accum_k"], 1):
        model.load_state_dict(ckpt.load_state(jax_dir))
        w0 = {n: t.detach().clone() for n, t in model.state_dict().items()}
        step = make_train_step(model, get_loss(cmp_cfg), build_optimizer(dict(cmp_cfg, gradient_accumulation_steps=k),
                                                                         model), cmp_cfg)
        if k > 1:
            n = sz["accum_batch"]
            for i in range(k):
                step({key: t[i * n:(i + 1) * n] for key, t in big.items()})
        else:
            step(big)
        ends[k] = {n: t.detach().clone() for n, t in model.state_dict().items()}
    result["accumulated_vs_big"] = _update_cosines(
        w0, ends[sz["accum_k"]], ends[1], "jax_run",
        f"accumulated update ({sz['accum_k']} x {sz['accum_batch']} triples) vs one step over the "
        f"{sz['accum_k'] * sz['accum_batch']}")
    result["launches"] = res["launches"]
    _free(trainer, device)
    return result


def phase_hub_teacher(sz, device, root):
    """Phase 13 (b): a hub teacher from a seeded DistilBERT checkpoint
    (random weights) in a temporary ``HF_HUB_CACHE``, the hub stub's keys
    handed in as ``teacher_config`` with the fused layers on, teaching a
    BERT_DOT student with in-batch scoring for ``hub_steps`` steps: the
    teacher's encoder tensors equal the checkpoint's bit for bit, its
    launches (K14's all-pairs form once a step) against the prediction."""
    import torch

    from matchmaker_tpu_torch.distillation.dynamic_teacher import load_teacher
    from matchmaker_tpu_torch.models import hf_import
    from matchmaker_tpu_torch.models.encoder import EncoderConfig

    cache = os.path.join(root, "hf_cache")
    snapshot = os.path.join(cache, "models--" + HUB_TEACHER.replace("/", "--"), "snapshots", "0" * 40)
    t0 = time.perf_counter()
    hf_config, sd = hf_import.seeded_distilbert_checkpoint(EncoderConfig.distilbert(), seed=33)
    hf_import.save_hf_checkpoint(snapshot, hf_config, sd, True)
    write_s = time.perf_counter() - t0
    teacher_config = dict(HUB_TEACHER_STUB, encoder_fused_attention=True, device=str(device))
    saved_env = {k: os.environ.get(k) for k in ("HF_HUB_CACHE", "HF_HUB_OFFLINE")}
    os.environ.update(HF_HUB_CACHE=cache, HF_HUB_OFFLINE="1")
    try:
        teacher, _, _ = load_teacher(HUB_TEACHER, config=teacher_config, device=str(device))
        _, enc = hf_import.load_hf_encoder(snapshot)
        state = teacher.encoder.state_dict()
        check(state.keys() == enc.keys() and all(torch.equal(state[k].cpu(), enc[k]) for k in enc),
              "the hub teacher's encoder is not the checkpoint's")
        del teacher
        os.makedirs(os.path.join(root, "hub"))
        paths = _write_train_data(os.path.join(root, "hub"), dict(sz, train_batches=sz["hub_steps"]))
        config = dict(_train_config(paths, sz, device), dynamic_teacher=True, dynamic_teacher_path=HUB_TEACHER,
                      dynamic_teacher_in_batch_scoring=True, in_batch_neg_loss="KLDivTeacherList",
                      max_training_batches=sz["hub_steps"], validate_every_n_batches=-1, validation_cont=None,
                      test=None, run_dense_retrieval_eval=False)
        trainer, res = _train_through_trainer(sz, device, config, os.path.join(root, "hub_run"), sz["hub_steps"],
                                              "hub_teacher", teacher_config=teacher_config)
    finally:
        for k, v in saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    _check_launches(res["launches"], predicted_hub_teacher_launches(sz), "the hub teacher's run", device)
    print(f"[hub_teacher] (b) {HUB_TEACHER} from a seeded checkpoint in a temporary cache (written in "
          f"{write_s:.1f} s): encoder equal to the checkpoint's; BERT_DOT student {sz['hub_steps']} steps, loss "
          f"{res['loss_first']:.4f} -> {res['loss_last']:.4f}, {res['cli_triples_per_s']:.1f} triples/s through "
          f"the Trainer (teacher included)")
    _free(trainer, device)
    return dict(res, checkpoint_write_s=write_s)


def phase_fused_effectiveness(sz, device, root):
    """Phase 13 (c): phase 8's effectiveness check on the same planted
    corpus and seed with the mini encoder through the fused halves (K1/K2
    forward, K11/K12 backward), gated at the same floor, MRR@10 >= 0.5."""
    from matchmaker_tpu_torch.cli.effectiveness_check import run_check
    from matchmaker_tpu_torch.ops import _build

    fresh_perf_monitor()
    _build.reset_launches()
    t0 = time.perf_counter()
    out = run_check(os.path.join(root, "eff_fused"), device=str(device), overrides=EFFECTIVENESS_FUSED,
                    **sz["effectiveness_args"])
    launches = dict(_build.LAUNCHES)
    result = dict(out, wall_s=time.perf_counter() - t0, launches=launches)
    print(f"[fused_check] (c) effectiveness check {sz['effectiveness_args']} on {EFFECTIVENESS_FUSED}: MRR@10 "
          f"{out['MRR@10']:.4f}, Recall@100 {out['Recall@100']:.4f} in {result['wall_s']:.1f} s; launches "
          f"{({k: v for k, v in launches.items() if v})}")
    if device.type == "cuda":
        for name in ("fused_attention_block", "fused_mlp_block", "fused_attention_block_bwd", "fused_mlp_block_bwd"):
            check(launches[name] > 0, f"the fused effectiveness check launched no {name} kernel")
    check(out["MRR@10"] >= 0.5, f"the fused effectiveness check's MRR@10 {out['MRR@10']} below 0.5")
    return result


@contextlib.contextmanager
def plain_int8_blocks():
    """Route the encoder's int8 halves (K-major codes, Q/K/V packed) to
    their plain versions on the same device."""
    import matchmaker_tpu_torch.models.encoder as enc
    from matchmaker_tpu_torch.ops import fused_int8 as fi

    def attention(x, wqkv_t, sqkv, bqkv, wo_t, so, bo, mask, n_heads, *ln, **kw):  # codes padded or not
        (wq, wk, wv), (sq, sk, sv), (bq, bk, bv) = (t.chunk(3) for t in (wqkv_t, sqkv, bqkv))
        return fi.reference_attention_int8_block(x, wq.t(), sq, wk.t(), sk, wv.t(), sv, wo_t.t(), so, bq, bk, bv,
                                                 bo, mask, n_heads, *ln, **kw)

    def mlp(x, w1_t, s1, b1, w2_t, s2, b2, *ln, **kw):
        return fi.reference_mlp_int8_block(x, w1_t.t(), s1, b1, w2_t.t(), s2, b2, *ln, **kw)

    names = ("fused_attention_int8_block_qkv_kmajor", "fused_mlp_int8_block_kmajor")
    saved = {n: getattr(enc, n) for n in names}
    enc.fused_attention_int8_block_qkv_kmajor, enc.fused_mlp_int8_block_kmajor = attention, mlp
    try:
        yield
    finally:
        for n, fn in saved.items():
            setattr(enc, n, fn)


def _minilm_checkpoint(root):
    """A seeded encoder at MiniLM-L6's published widths, written as a BERT
    checkpoint folder (utils/hf_export.py), for ``bert_pretrained_model``."""
    import torch

    from matchmaker_tpu_torch.models.encoder import EncoderConfig, TransformerEncoderLM
    from matchmaker_tpu_torch.models.weights import init_parameters
    from matchmaker_tpu_torch.utils.hf_export import export_to_huggingface

    m = MINILM
    cfg = EncoderConfig(vocab_size=m["vocab"], hidden_size=m["hid"], num_layers=m["n_layers"], num_heads=m["heads"],
                        intermediate_size=m["ff"], max_position_embeddings=512, type_vocab_size=m["type_vocab"])
    enc = TransformerEncoderLM(cfg)
    init_parameters(enc, torch.Generator().manual_seed(35))
    return export_to_huggingface({f"encoder.{k}": v for k, v in enc.state_dict().items()}, cfg,
                                 os.path.join(root, "minilm"), "bert")


def phase_minilm(sz, device, root):
    """Phase 13 (d): BERT_CAT at MiniLM-L6's widths (12 heads of 32) through
    the fused halves at batch 16 x 230: one eval batch against the plain
    versions, ``minilm_steps`` training steps through the Trainer
    (launches against the prediction), every gradient's cosine >= 0.99
    under a pointwise loss, and the int8 forward (K10 + K9) on one eval
    batch against its plain versions, all at the encoder halves' bar."""
    import torch

    from matchmaker_tpu_torch.data.loaders import reranking_inference_loader
    from matchmaker_tpu_torch.models import get_model
    from matchmaker_tpu_torch.ops import _build

    msz = dict(sz, hid=MINILM["hid"], heads=MINILM["heads"], ff=MINILM["ff"], n_layers=MINILM["n_layers"])
    paths = _rerank_data(root, sz)
    ckpt = _minilm_checkpoint(root)
    steps = sz["minilm_steps"]
    config = _rerank_config(paths, sz, device, "bert_cat", ckpt, steps)
    rsz = dict(msz, train_batch=sz["rerank_batch"])
    trainer, res = _train_through_trainer(rsz, device, config, os.path.join(root, "minilm_run"), steps, "minilm")
    _check_launches(res["launches"], predicted_rerank_launches(msz, "bert_cat", steps,
                                                               steps // config["validate_every_n_batches"]),
                    "MiniLM BERT_CAT", device)
    check(trainer.model.encoder.cfg.num_heads == MINILM["heads"] and trainer.model.encoder.cfg.hidden_size == 384,
          "the BERT_CAT encoder is not at MiniLM's widths")
    res.update(_eval_batch_vs_plain(trainer, paths["val"], device, "minilm bert_cat"))
    batch = _device_batch(config, trainer.tokenizer, paths["train_tsv"], device)
    res.update(_kernels_vs_plain_step(trainer.model, config, batch, dict(config, loss="MSETeacherPointwise"),
                                      "minilm"))
    # the int8 halves on one eval batch, the trained weights quantized
    i8 = get_model(dict(config, encoder_int8=True), trainer.tokenizer).to(device)
    i8.load_state_dict(trainer.model.state_dict())
    eval_batch, _, _ = next(iter(reranking_inference_loader(config, trainer.tokenizer, paths["val"])))
    eval_batch = {k: torch.from_numpy(v).to(device) for k, v in eval_batch.items()}
    valid = eval_batch["valid"] > 0
    _build.reset_launches()
    with torch.inference_mode():
        i8.eval()
        got = i8(eval_batch)["score"].float()[valid]
        int8_launches = dict(_build.LAUNCHES)
        with plain_int8_blocks():
            want = i8(eval_batch)["score"].float()[valid]
    cos = float(torch.nn.functional.cosine_similarity(got, want, dim=0))
    err = float((got - want).abs().max())
    print(f"[minilm] int8 forward (K10 + K9) on one eval batch ({int(valid.sum())} pairs), kernels vs plain: cosine "
          f"{cos:.6f}, max |d| {err:.4g}; launches {({k: v for k, v in int8_launches.items() if v})}")
    check(cos >= 0.999 and err <= 0.1, f"MiniLM int8 scores, kernels vs plain: cosine {cos}, max |d| {err}")
    if device.type == "cuda":
        for name in ("fused_attention_int8_block", "fused_mlp_int8_block"):
            check(int8_launches[name] == MINILM["n_layers"], f"the int8 forward launched {int8_launches[name]} {name}")
    res.update(int8_eval_cos=cos, int8_eval_max_abs=err, int8_launches=int8_launches)
    print(f"[minilm] (d) BERT_CAT at MiniLM-L6's widths, {steps} steps: loss {res['loss_first']:.4f} -> "
          f"{res['loss_last']:.4f}, {res['cli_triples_per_s']:.1f} triples/s through the Trainer")
    _free(trainer, device)
    return res


def _seeded_checkpoint(root, name, dims, seed):
    """A seeded BERT encoder at ``dims``' widths (vocab, hid, n_layers,
    heads, ff, type_vocab: random weights, no checkpoint is in the
    repository) written as a Hugging Face checkpoint folder by the port's
    export, as :func:`_minilm_checkpoint` writes MiniLM's."""
    import torch

    from matchmaker_tpu_torch.models.encoder import EncoderConfig, TransformerEncoderLM
    from matchmaker_tpu_torch.models.weights import init_parameters
    from matchmaker_tpu_torch.utils.hf_export import export_to_huggingface

    t = dims
    cfg = EncoderConfig(vocab_size=t["vocab"], hidden_size=t["hid"], num_layers=t["n_layers"], num_heads=t["heads"],
                        intermediate_size=t["ff"], max_position_embeddings=512, type_vocab_size=t["type_vocab"])
    enc = TransformerEncoderLM(cfg)
    init_parameters(enc, torch.Generator().manual_seed(seed))
    return export_to_huggingface({f"encoder.{k}": v for k, v in enc.state_dict().items()}, cfg,
                                 os.path.join(root, name), "bert")


def _tinybert_checkpoint(root):
    """TinyBERT-General-4L-312D's widths, seeded (phase 13 (e))."""
    return _seeded_checkpoint(root, "tinybert", TINYBERT, 36)


def _layers_vs_plain(model, ids, mask, tag):
    """Each layer of the document tower on the same input through the
    kernels and through the plain versions (its input the kernels' output
    of the layer before): the encoder halves' bar, row cosine >= 0.999 and
    max |d| <= 0.1, at every layer. Returns the worst (cosine, max |d|)."""
    import torch

    enc = model.tower("doc")
    worst_cos, worst_err = 1.0, 0.0
    with torch.inference_mode():
        x = enc.embed(ids).to(enc.compute_dtype)
        for i in range(enc.cfg.num_layers):
            layer = getattr(enc, f"layer_{i}")
            got = layer(x, mask)
            with plain_encoder_blocks(), plain_int8_blocks():
                want = layer(x, mask)
            cos, err = _rows_close(got, want)
            check(cos >= 0.999 and err <= 0.1, f"{tag} layer {i}, kernels vs plain on the same input: cosine {cos}, "
                  f"max |d| {err}")
            worst_cos, worst_err = min(worst_cos, cos), max(worst_err, err)
            x = got
    return worst_cos, worst_err


def _encode_batch_vs_plain(sz, device, config, tag, what, per_layer=False):
    """One batch of the collection encoded by the model ``config`` builds
    (its checkpoint's weights), through the kernels and through the plain
    versions: the encoder halves' bar (row cosine >= 0.999, max |d| <=
    0.1). ``per_layer``: the max |d| bar taken by each layer on the same
    input (:func:`_layers_vs_plain`), the whole stack's max |d| reported
    and its cosine gated: over 24 layers the int8 halves' single-code and
    single-ulp differences add up past the bar of one half (BERT-large: each
    layer within 0.047, the stack 0.1016: PERF.md §6). Returns
    (cosine, max |d|) of the stack, and the per-layer worst where taken."""
    import torch

    from matchmaker_tpu_torch.data.loaders import single_sequence_loader
    from matchmaker_tpu_torch.data.tokenization import build_tokenizer
    from matchmaker_tpu_torch.models import get_model, init_params

    tokenizer = build_tokenizer(config)
    model = get_model(config, tokenizer)
    init_params(model, config, torch.Generator().manual_seed(37))
    model = model.to(device).eval()
    got, _ = _encode_file(model, config, tokenizer, config["collection_tsv"], "doc", sz["batch"], device,
                          limit=sz["batch"])
    with plain_encoder_blocks(), plain_int8_blocks():
        plain, _ = _encode_file(model, config, tokenizer, config["collection_tsv"], "doc", sz["batch"], device,
                                limit=sz["batch"])
    cos, err = _rows_close(got, plain)
    result = {"encode_cos": cos, "encode_max_abs": err}
    layers = ""
    if per_layer:
        b, _ = next(iter(single_sequence_loader(dict(config, batch_size_inference=sz["batch"]), tokenizer,
                                                config["collection_tsv"], "doc")))
        lcos, lerr = _layers_vs_plain(model, torch.from_numpy(b["seq_ids"]).to(device),
                                      torch.from_numpy(b["seq_mask"]).to(device), tag)
        result.update(layer_cos=lcos, layer_max_abs=lerr)
        layers = f"; each layer on the same input: worst cosine {lcos:.6f}, max |d| {lerr:.4g}"
    print(f"[{tag}] one batch of {got.shape[0]} passages encoded with {what}, kernels vs plain: min row cosine "
          f"{cos:.6f}, max |d| {err:.4g}{layers}")
    check(got.shape[-1] == model.tower("doc").cfg.hidden_size and bool(torch.isfinite(got).all()),
          f"{tag} encode rows")
    check(cos >= 0.999 and (per_layer or err <= 0.1), f"{tag} encode, kernels vs plain: cosine {cos}, max |d| {err}")
    del model
    return result


def _serve_checkpoint(sz, device, root, ckpt, dims, tag, per_layer=False):
    """cli.dense_retrieval over phase 4's collection with the checkpoint at
    ``ckpt`` and ``encoder_int8_mlp`` (bench.py's encoder: K1 and K9; the
    search K3, K6, K4): launches against the prediction, the encoded rows
    finite, one batch's encode with the kernels against the plain versions
    at the encoder halves' bar (``per_layer``: see _encode_batch_vs_plain)."""
    import torch

    from matchmaker_tpu_torch.cli.dense_retrieval import run
    from matchmaker_tpu_torch.ops import _build
    from matchmaker_tpu_torch.retrieval.encode import load_encoded

    tsz = dict(sz, hid=dims["hid"], heads=dims["heads"], ff=dims["ff"], n_layers=dims["n_layers"])
    result = {}
    config = dict(_main_config(root, sz, device), bert_pretrained_model=ckpt, encoder_int8_mlp=True)
    out = os.path.join(root, f"served_{tag}")
    os.makedirs(out)
    fresh_perf_monitor()
    _build.reset_launches()
    t0 = time.perf_counter()
    check(run("encode+index+search", dict(config), out) == 0, f"serving {tag} with encoder_int8_mlp")
    if device.type == "cuda":
        torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    want = predicted_int8_serving_launches(tsz)
    _check_launches(launches, {"fused_attention_block": want, "fused_mlp_int8_block": want, "fused_mlp_block": 0,
                               "fused_attention_int8_block": 0}, f"{tag} int8_mlp serving", device)
    for name in ("binmax_candidates", "unpack_candidates"):
        check(launches[name] > 0 or device.type != "cuda", f"{tag} serving launched no {name} kernel")
    vectors, _ = load_encoded(os.path.join(out, "encoded"))
    check(vectors.shape == (sz["passages"], dims["hid"]) and bool(np.isfinite(vectors).all()), f"{tag}'s rows")
    with open(os.path.join(out, "efficiency-metrics.json")) as f:
        blocks = json.load(f)[-1]["blocks"]
    result.update(serve_launches=launches, serve_wall_s=time.perf_counter() - t0,
                  encode_psg_per_s=blocks["encode"]["items_per_second"],
                  search_qps=blocks["search_total"]["items_per_second"])
    result.update(_encode_batch_vs_plain(sz, device, config, tag, "encoder_int8_mlp", per_layer))
    print(f"[{tag}] cli.dense_retrieval over {sz['passages']} passages: {result['encode_psg_per_s']:.1f} "
          f"psg/s, {result['search_qps']:.1f} QPS; launches {({k: v for k, v in launches.items() if v})}")
    return result


def _train_checkpoint(sz, device, root, ckpt, dims, tag, steps, speed=False, grad_rows=None, against_f32=False):
    """``steps`` BERT_DOT Trainer steps (Margin-MSE, in-batch negatives,
    batch ``train_batch``, query / doc ``train_query_len`` /
    ``train_doc_len``) from the checkpoint at ``ckpt`` with the fused
    halves (K1, K2, K12, K11) against the prediction, and one step's loss
    and gradients against the plain versions'; ``speed``: also the step's
    device-only triples/s; ``against_f32``: the step held to an f32 twin
    (:func:`_step_vs_f32`, its gradients on the first ``grad_rows``
    triples) in place of kernels vs plain bf16."""
    os.makedirs(os.path.join(root, f"{tag}_train"))
    paths = _write_train_data(os.path.join(root, f"{tag}_train"), dict(sz, train_batches=steps))
    tcfg = dict(_train_config(paths, sz, device), bert_pretrained_model=ckpt, max_training_batches=steps,
                validate_every_n_batches=-1, validation_cont=None, test=None, run_dense_retrieval_eval=False)
    trainer, res = _train_through_trainer(sz, device, tcfg, os.path.join(root, f"{tag}_run"), steps, tag)
    n = steps * dims["n_layers"] * 2
    _check_launches(res["launches"], {"fused_attention_block": n, "fused_mlp_block": n,
                                      "fused_attention_block_bwd": n, "fused_mlp_block_bwd": n},
                    f"{tag} BERT_DOT training", device)
    cfg = trainer.model.encoder.cfg
    check((cfg.hidden_size, cfg.num_heads, cfg.intermediate_size, cfg.num_layers)
          == (dims["hid"], dims["heads"], dims["ff"], dims["n_layers"]), f"the {tag} encoder is not at its widths")
    batch = _device_batch(tcfg, trainer.tokenizer, paths["train"], device)
    if speed:
        res.update(_step_speed(sz, device, trainer, batch, tag))
        res.pop("profile", None)
    smooth = dict(tcfg, in_batch_negatives=False)
    if against_f32:
        res.update(_step_vs_f32(trainer.model, tcfg, batch, smooth, tag, grad_rows))
    else:
        res.update(_kernels_vs_plain_step(trainer.model, tcfg, batch, smooth, tag))
    print(f"[{tag}] BERT_DOT, {steps} steps: loss {res['loss_first']:.4f} -> {res['loss_last']:.4f}, "
          f"{res['cli_triples_per_s']:.1f} triples/s through the Trainer"
          + (f", {res['device_triples_per_s']:.1f} device-only ({res['step_ms']:.2f} ms a step)" if speed else ""))
    _free(trainer, device)
    return res


def phase_tinybert(sz, device, root):
    """Phase 13 (e), in phase 4's directory: BERT_DOT at
    TinyBERT-General-4L-312D's widths (hidden 312, 12 heads of 26 padded to
    32, FF 1,200), a seeded checkpoint, served through cli.dense_retrieval
    with ``encoder_int8_mlp`` (K1 at heads of 26, K9 with its codes padded
    to 320 and FF chunks of 320; :func:`_serve_checkpoint`), then
    ``tinybert_steps`` Trainer steps with the fused halves (K1, K2, K12,
    K11 at 312: the LayerNorm backward past the multiples of 128;
    :func:`_train_checkpoint`)."""
    ckpt = _tinybert_checkpoint(root)
    result = _serve_checkpoint(sz, device, root, ckpt, TINYBERT, "tinybert")
    result["train"] = _train_checkpoint(sz, device, root, ckpt, TINYBERT, "tinybert", sz["tinybert_steps"])
    result["launches"] = result["train"]["launches"]
    return result


def phase_bert_large(sz, device, root):
    """Phase 13 (f), in phase 4's directory: BERT-large (bert-large-uncased's
    widths: 24 layers, hidden 1,024 in 16 heads of 64, FF 4,096) from a
    seeded checkpoint written by the port's export, served through
    cli.dense_retrieval with ``encoder_int8_mlp`` (K1, K9, K3, K4, K6) and
    trained ``bert_large_steps`` Trainer steps of BERT_DOT under
    Margin-MSE (K1, K2, K12, K11; the LayerNorm backward at 1,024), its
    encode psg/s and device-only triples/s printed. Then the widths the card
    took last, 4 layers each at full width (WIDTH_GEOMETRIES), each a
    checkpoint, one encode batch with ``encoder_int8_mlp`` and
    ``width_steps`` Trainer steps. The encodes at the encoder halves' bar
    (BERT-large's each layer on the same input, its stack's cosine), every
    step held to its f32 twin (:func:`_step_vs_f32`): kernels against plain
    bf16 reached a 1.07 % loss gap and a 0.985 gradient cosine at 8 heads of
    128 in 4 layers and noise against noise at BERT-large's depth."""
    t0 = time.perf_counter()
    ckpt = _seeded_checkpoint(root, "bert_large", BERT_LARGE, 38)
    result = {"checkpoint_s": time.perf_counter() - t0}
    result.update(_serve_checkpoint(sz, device, root, ckpt, BERT_LARGE, "bert_large", per_layer=True))
    result["train"] = _train_checkpoint(sz, device, root, ckpt, BERT_LARGE, "bert_large", sz["bert_large_steps"],
                                        speed=True, grad_rows=sz["bert_large_grad_rows"], against_f32=True)
    shutil.rmtree(ckpt, ignore_errors=True)
    result["launches"] = {k: result["serve_launches"].get(k, 0) + result["train"]["launches"].get(k, 0)
                          for k in result["train"]["launches"]}
    print(f"[bert_large] (f) BERT-large: encode {result['encode_psg_per_s']:.1f} psg/s through cli.dense_retrieval "
          f"(encoder_int8_mlp), BERT_DOT training {result['train']['device_triples_per_s']:.1f} triples/s "
          f"device-only ({result['train']['cli_triples_per_s']:.1f} through the Trainer)")
    result["widths"] = {}
    for hid, heads, ff in WIDTH_GEOMETRIES:
        t0 = time.perf_counter()
        tag = f"width_{hid}x{heads}"
        dims = dict(BERT_LARGE, hid=hid, heads=heads, ff=ff, n_layers=sz["width_layers"])
        ckpt = _seeded_checkpoint(root, tag, dims, 39 + hid)
        config = dict(_main_config(root, sz, device), bert_pretrained_model=ckpt, encoder_int8_mlp=True)
        from matchmaker_tpu_torch.ops import _build

        _build.reset_launches()
        enc = _encode_batch_vs_plain(sz, device, config, tag, "encoder_int8_mlp")
        encode_launches = dict(_build.LAUNCHES)
        cos = enc["encode_cos"]
        res = _train_checkpoint(sz, device, root, ckpt, dims, tag, sz["width_steps"], against_f32=True)
        res.update(enc, encode_launches=encode_launches,
                   launches_all={k: encode_launches.get(k, 0) + v for k, v in res["launches"].items()},
                   seconds=time.perf_counter() - t0, hidden=hid, heads=heads, ff=ff)
        for name in ("fused_attention_block", "fused_mlp_int8_block"):
            check(encode_launches[name] > 0 or device.type != "cuda", f"{tag}: the encode launched no {name}")
        result["widths"][f"{hid}x{heads}"] = res
        print(f"[widths] (f) hidden {hid}, {heads} heads of {hid // heads}, FF {ff}, {dims['n_layers']} layers: encode "
              f"batch cosine {cos:.6f}, {sz['width_steps']} steps; against the f32 twin: scores {res['f32_score_err']:.3g} "
              f"(plain bf16 {res['plain_f32_score_err']:.3g}), gradients within {res['f32_grad_error_ratio']:.3g}x the "
              f"plain bf16 version's error; kernels vs plain bf16: loss gap {res['plain_loss_gap']:.3g}, worst "
              f"gradient cosine {res['plain_grad_cos']:.6f} ({res['seconds']:.1f} s)")
        shutil.rmtree(ckpt, ignore_errors=True)
    return result


def phase_jax_runs(sz, device, root):
    """Phase 13: (a), (e) and (f) in phase 4's directory, (b), (c) and (d)
    in their own; ``launches``: those of every run the parts drive (the
    .flax serving run, the accumulation run, the hub teacher's, the
    check's, MiniLM's training run and its int8 forward, TinyBERT's and
    BERT-large's serving and training runs, the new widths' encodes and
    steps)."""
    result = {"jax_run": phase_jax_run(sz, device, root)}
    with tempfile.TemporaryDirectory() as sub:
        result["hub_teacher"] = phase_hub_teacher(sz, device, sub)
    with tempfile.TemporaryDirectory() as sub:
        result["fused_check"] = phase_fused_effectiveness(sz, device, sub)
    with tempfile.TemporaryDirectory() as sub:
        result["minilm"] = phase_minilm(sz, device, sub)
    t0 = time.perf_counter()
    result["tinybert"] = phase_tinybert(sz, device, root)
    result["tinybert"]["seconds"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    result["bert_large"] = phase_bert_large(sz, device, root)
    result["bert_large"]["seconds"] = time.perf_counter() - t0
    print(f"[jax_runs] phase 13 (f) took {result['bert_large']['seconds']:.1f} s")
    launches = {}
    for runs in (result["jax_run"]["serve_launches"], result["jax_run"]["launches"], result["hub_teacher"]["launches"],
                 result["fused_check"]["launches"], result["minilm"]["launches"], result["minilm"]["int8_launches"],
                 result["tinybert"]["serve_launches"], result["tinybert"]["launches"], result["bert_large"]["launches"],
                 *(w["launches_all"] for w in result["bert_large"]["widths"].values())):
        for k, v in runs.items():
            launches[k] = launches.get(k, 0) + v
    result["launches"] = launches
    return result


# ---- phase 15: 2,000-token documents through BERT_DOT and ColBERT ---------------

def _long_checkpoint(root, sz):
    """A seeded checkpoint at DistilBERT's widths with ``long_positions``
    (2,048) positions (models/hf_import.py: seeded_distilbert_checkpoint,
    save_hf_checkpoint), the encoder that takes 2,000-token documents
    whole."""
    from matchmaker_tpu_torch.models.encoder import EncoderConfig
    from matchmaker_tpu_torch.models.hf_import import save_hf_checkpoint, seeded_distilbert_checkpoint

    cfg = EncoderConfig(vocab_size=sz["vocab"], hidden_size=sz["hid"], num_layers=sz["n_layers"],
                        num_heads=sz["heads"], intermediate_size=sz["ff"],
                        max_position_embeddings=sz["long_positions"], type_vocab_size=0)
    config, state = seeded_distilbert_checkpoint(cfg, seed=41)
    path = os.path.join(root, "long_distilbert")
    save_hf_checkpoint(path, config, state, safetensors=True)
    return path


def _write_long_data(root, sz, seed=15):
    """``long_passages`` synthetic passages, every other one long enough to
    fill ``long_doc_len`` hash-tokenizer tokens (one a word), the others
    shorter (the masks' tails), queries of 3-6 of a target passage's words
    with their qrels, and ``long_steps`` x ``long_batch`` training triples
    of such passages with teacher scores."""
    rng = np.random.default_rng(seed)
    words = np.array([f"t{i}" for i in range(20_000)])
    n, full = sz["long_passages"], sz["long_doc_len"]
    lens = np.where(np.arange(n) % 2 == 0, rng.integers(full, full + 400, size=n),
                    rng.integers(full // 10, full - 100, size=n))
    passages = [" ".join(words[rng.integers(0, len(words), size=int(k))]) for k in lens]
    paths = {k: os.path.join(root, f) for k, f in (("collection", "collection.tsv"), ("queries", "queries.tsv"),
                                                    ("qrels", "qrels.txt"), ("train", "train.tsv"))}
    with open(paths["collection"], "w") as f:
        f.writelines(f"{i}\t{p}\n" for i, p in enumerate(passages))
    targets = rng.choice(n, size=sz["long_queries"], replace=False)
    with open(paths["queries"], "w") as fq, open(paths["qrels"], "w") as fr:
        for qi, t in enumerate(targets):
            fq.write(f"{qi}\t{' '.join(rng.choice(passages[t].split(), size=int(rng.integers(3, 7))))}\n")
            fr.write(f"{qi} 0 {t} 1\n")
    with open(paths["train"], "w") as f:
        for _ in range(sz["long_steps"] * sz["long_batch"]):
            pos, neg = rng.integers(0, n, size=2)
            query = " ".join(rng.choice(passages[pos].split(), size=int(rng.integers(3, 12))))
            f.write(f"{rng.uniform(5, 10):.3f}\t{rng.uniform(0, 5):.3f}\t{query}\t{passages[pos]}\t{passages[neg]}\n")
    return paths


def _long_serve(sz, device, root, config, tag, want):
    """cli.dense_retrieval encode+index+search over the long collection with
    ``config``: launches against ``want``, every query's 100 hits, recall@100
    of the run against an exact search of the rows it encoded (the queries
    encoded by the same model) at phase 4's floor, psg/s and QPS from the
    CLI's efficiency metrics; the model, for further checks."""
    import torch

    from matchmaker_tpu_torch.cli.dense_retrieval import run
    from matchmaker_tpu_torch.data.tokenization import build_tokenizer
    from matchmaker_tpu_torch.models import get_model, init_params
    from matchmaker_tpu_torch.ops import _build
    from matchmaker_tpu_torch.retrieval.encode import load_encoded

    out = os.path.join(root, f"served_{tag}")
    os.makedirs(out)
    fresh_perf_monitor()
    _build.reset_launches()
    t0 = time.perf_counter()
    check(run("encode+index+search", dict(config), out) == 0, f"{tag}: cli.dense_retrieval returned non-zero")
    if device.type == "cuda":
        torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    _check_launches(launches, want, f"{tag} serving", device)
    with open(os.path.join(out, "efficiency-metrics.json")) as f:
        blocks = json.load(f)[-1]["blocks"]
    result = {"launches": launches, "wall_s": time.perf_counter() - t0,
              "encode_psg_per_s": blocks["encode"]["items_per_second"],
              "search_qps": blocks["search_total"]["items_per_second"]}
    ranking = {}
    with open(os.path.join(out, "dev-output.txt")) as f:
        for line in f:
            qid, did, _, _ = line.split()
            ranking.setdefault(qid, []).append(did)
    k = sz["top_n"]
    check(len(ranking) == sz["long_queries"] and all(len(v) == k for v in ranking.values()),
          f"{tag}: every query must have {k} hits")
    tokenizer = build_tokenizer(config)
    model = get_model(config, tokenizer)
    init_params(model, config, torch.Generator().manual_seed(config["random_seed"]))
    model.to(device).eval()
    check(model.tower("doc").cfg.max_position_embeddings == sz["long_positions"], f"{tag}: the encoder's positions")
    q_vecs, qids = _encode_file(model, config, tokenizer, config["query_sets"]["dev"]["queries_tsv"], "query", 32,
                                device)
    vectors, row_ids = load_encoded(os.path.join(out, "encoded"))
    check(vectors.shape == (sz["long_passages"], sz["hid"]) and bool(np.isfinite(vectors).all()), f"{tag}'s rows")
    rows = torch.from_numpy(vectors).to(device).to(torch.bfloat16).float()
    with torch.inference_mode():
        top = torch.topk(q_vecs.to(torch.bfloat16).float() @ rows.T, k, dim=1).indices.cpu().tolist()
    recall = float(np.mean([len({str(row_ids[i]) for i in idx} & set(ranking[q])) / k for q, idx in zip(qids, top)]))
    result[f"recall@{k}"] = recall
    print(f"[long_docs] {tag}: {result['encode_psg_per_s']:.1f} psg/s, {result['search_qps']:.1f} QPS through "
          f"cli.dense_retrieval ({sz['long_passages']} passages of up to {sz['long_doc_len']} tokens); recall@{k} "
          f"vs the exact search of its encoded rows {recall:.4f}; launches {({n: v for n, v in launches.items() if v})}")
    check(recall >= QUERY_SETS[0][2], f"{tag}: recall@{k} {recall} < {QUERY_SETS[0][2]}")
    return result, model, tokenizer


def _long_batch_vs_plain(model, config, tokenizer, sz, device, tag):
    """The first ``long_plain_docs`` passages (long and short ones) encoded
    through the kernels and through the plain versions: the encoder halves'
    bar (row cosine >= 0.999, max |d| <= 0.1)."""
    n = sz["long_plain_docs"]
    got, _ = _encode_file(model, config, tokenizer, config["collection_tsv"], "doc", n, device, limit=n)
    with plain_encoder_blocks(), plain_int8_blocks():
        want, _ = _encode_file(model, config, tokenizer, config["collection_tsv"], "doc", n, device, limit=n)
    cos, err = _rows_close(got, want)
    print(f"[long_docs] {tag}: {n} passages of up to {sz['long_doc_len']} tokens, kernels vs plain: min row cosine "
          f"{cos:.6f}, max |d| {err:.4g}")
    check(cos >= 0.999 and err <= 0.1, f"{tag} encode, kernels vs plain: cosine {cos}, max |d| {err}")
    return {"encode_cos": cos, "encode_max_abs": err}


def _long_train(sz, device, root, config, tag, want, smooth):
    """``long_steps`` Trainer steps of ``config`` at batch ``long_batch``:
    launches against ``want``, a finite loss every step, device-only
    triples/s, and one step held to an f32 twin of the model
    (:func:`_step_vs_f32`: the batch's scores and, under ``smooth``'s loss,
    every gradient on its first ``long_grad_rows`` triples, the plain
    versions' (B, 12, L, L) f32 intermediates of the whole batch taking
    about 6 GB a layer, each within twice the plain bf16 version's error
    from f32 plus 1e-3). Kernels against plain bf16 is noise against noise
    at 2,000 tokens (PERF.md §6: bias-gradient cosines of 0.64 between two
    bf16 runs), so it is reported, not gated."""
    lsz = dict(sz, train_batch=sz["long_batch"])
    trainer, res = _train_through_trainer(lsz, device, config, os.path.join(root, f"{tag}_run"), sz["long_steps"], tag)
    _check_launches(res["launches"], want, tag, device)
    batch = _device_batch(config, trainer.tokenizer, config["train_tsv"], device)
    check(batch["doc_pos_ids"].shape[-1] == sz["long_doc_len"] and int(batch["doc_pos_mask"].sum(dim=1).max())
          == sz["long_doc_len"], f"{tag}: the documents are not {sz['long_doc_len']} tokens")
    res.update(_step_speed(lsz, device, trainer, batch, tag, profile=False))
    res.update(_step_vs_f32(trainer.model, config, batch, smooth, tag, sz["long_grad_rows"]))
    print(f"[long_docs] {tag}: {sz['long_steps']} steps, loss {res['loss_first']:.4f} -> {res['loss_last']:.4f}, "
          f"{res['device_triples_per_s']:.1f} triples/s device-only ({res['step_ms']:.2f} ms a step), "
          f"{res['cli_triples_per_s']:.1f} through the Trainer")
    _free(trainer, device)
    return res


def phase_long_documents(sz, device, root):
    """Phase 15: 2,000-token documents whole through the encoder, DistilBERT
    widths (6 x 768, 12 heads of 64, FF 3,072) from a seeded checkpoint of
    2,048 positions, queries of 30 tokens, ``max_doc_length`` 2,000: (a)
    BERT_DOT served through cli.dense_retrieval over ``long_passages``
    passages with the bf16 halves (K1, K2) and with ``encoder_int8_mlp``
    (K1, K9), each run's recall@100 gated against an exact search of its
    encoded rows, one batch of each against the plain versions, and one
    encode batch with ``encoder_int8`` (K10, K9); (b) ``long_steps``
    BERT_DOT Trainer steps at batch ``long_batch`` under Margin-MSE +
    in-batch negatives (K1, K2, K12, K11); (c) as many ColBERT steps,
    compression 128 (the MaxSim training form and backward at Ld 2,000).
    Launches against the prediction in every run."""
    import torch

    from matchmaker_tpu_torch.models import get_model, init_params
    from matchmaker_tpu_torch.ops import _build

    t0 = time.perf_counter()
    long_root = os.path.join(root, "long_docs")
    os.makedirs(long_root)
    ckpt = _long_checkpoint(long_root, sz)
    paths = _write_long_data(long_root, sz)
    result = {"setup_s": time.perf_counter() - t0}
    n = sz["long_doc_len"]
    base = dict(_main_config(long_root, sz, device), bert_pretrained_model=ckpt, max_doc_length=n,
                collection_batch_size=sz["long_encode_batch"],
                query_sets={"dev": {"queries_tsv": paths["queries"], "qrels": paths["qrels"], "top_n": sz["top_n"],
                                    "binarization_point": 1}})
    layers = sz["n_layers"]
    encodes = layers * (-(-sz["long_passages"] // sz["long_encode_batch"]) + -(-sz["long_queries"] // 32))
    serve = {}
    serve["bf16"], model, tokenizer = _long_serve(
        sz, device, long_root, base, "bf16", {"fused_attention_block": encodes, "fused_mlp_block": encodes,
                                              "fused_mlp_int8_block": 0, "fused_attention_int8_block": 0})
    serve["bf16"].update(_long_batch_vs_plain(model, base, tokenizer, sz, device, "bf16"))
    del model
    int8_mlp = dict(base, encoder_int8_mlp=True)
    serve["int8_mlp"], model, tokenizer = _long_serve(
        sz, device, long_root, int8_mlp, "int8_mlp", {"fused_attention_block": encodes, "fused_mlp_int8_block": encodes,
                                                      "fused_mlp_block": 0, "fused_attention_int8_block": 0})
    serve["int8_mlp"].update(_long_batch_vs_plain(model, int8_mlp, tokenizer, sz, device, "int8_mlp"))
    del model
    int8 = dict(base, encoder_int8=True)
    model = get_model(int8, tokenizer)
    init_params(model, int8, torch.Generator().manual_seed(int8["random_seed"]))
    model.to(device).eval()
    _build.reset_launches()
    serve["int8"] = _long_batch_vs_plain(model, int8, tokenizer, sz, device, "encoder_int8")
    serve["int8"]["launches"] = dict(_build.LAUNCHES)
    _check_launches(serve["int8"]["launches"], {"fused_attention_int8_block": layers, "fused_mlp_int8_block": layers,
                                                 "fused_attention_block": 0, "fused_mlp_block": 0}, "encoder_int8", device)
    del model
    result["serve"] = serve

    train = dict(_train_config(dict(paths, val=None, val_qrels=None), sz, device), bert_pretrained_model=ckpt,
                 batch_size_train=sz["long_batch"], max_doc_length=n, max_training_batches=sz["long_steps"],
                 validate_every_n_batches=-1, validation_cont=None, test=None, run_dense_retrieval_eval=False)
    steps = sz["long_steps"] * layers * 2
    halves = {"fused_attention_block": steps, "fused_mlp_block": steps, "fused_attention_block_bwd": steps,
              "fused_mlp_block_bwd": steps}
    result["bert_dot"] = _long_train(sz, device, long_root, train, "long_bert_dot", halves,
                                     dict(train, in_batch_negatives=False))
    colbert = dict(train, model="colbert", colbert_compression_dim=128, query_augment_mask_number=8,
                   in_batch_neg_loss="margin-mse")
    result["colbert"] = _long_train(
        sz, device, long_root, colbert, "long_colbert",
        dict(halves, maxsim_all_pairs_argmax=sz["long_steps"], maxsim_all_pairs_bwd=sz["long_steps"], maxsim_all_pairs=0),
        dict(colbert, in_batch_neg_loss="KLDivTeacherList"))
    launches = {}
    for runs in (serve["bf16"]["launches"], serve["int8_mlp"]["launches"], serve["int8"]["launches"],
                 result["bert_dot"]["launches"], result["colbert"]["launches"]):
        for k, v in runs.items():
            launches[k] = launches.get(k, 0) + v
    result["launches"] = launches
    result["seconds"] = time.perf_counter() - t0
    shutil.rmtree(long_root, ignore_errors=True)
    print(f"[long_docs] phase 15 took {result['seconds']:.1f} s (set-up {result['setup_s']:.1f} s)")
    return result


# ---- phase 11: the index layer through the CLI and at 1M rows ------------------

# (a) the CLI's other index kinds over phase 4's collection; the files each saves
CLI_INDEX_KINDS = {
    "ivf": ({"faiss_index_type": "ivf", "faiss_ivf_list_count": 64, "faiss_ivf_nprobe": 8}, ("ivf_index.npz",)),
    "tree_ah": ({"faiss_index_type": "scann", "scann_backend": "tree_ah"}, ("ivf_index.npz", "scann_ah.npz")),
    "hnsw": ({"faiss_index_type": "hnsw", "faiss_hnsw_graph_neighbors": 16, "hnsw_ef_construction": 80,
              "hnsw_ef_search": 128}, ("hnsw_graph.bin", "hnsw_ids.npy")),
    "streaming": ({"faiss_index_type": "streaming"}, ("streaming_meta.json",)),
}
# |d score| within this share of the score: a near-tie, which sums in another order may swap
NEAR_TIE_REL = 1e-6


def predicted_index_cli_launches(sz, encode):
    """K1 and K2 once per layer and encode batch: the collection's batches
    (when the run encodes) and the query set's batches of 32; no other
    kernel (none of these indexes runs a binmax scan)."""
    batches = (-(-sz["passages"] // sz["batch"]) if encode else 0) + -(-sz["queries"] // 32)
    return {"fused_attention_block": sz["n_layers"] * batches, "fused_mlp_block": sz["n_layers"] * batches}


def _read_run(path):
    ids, scores = {}, {}
    with open(path) as f:
        for line in f:
            qid, did, _, score = line.split()
            ids.setdefault(qid, []).append(did)
            scores.setdefault(qid, []).append(float(score))
    return ids, scores


def _misses_past_ties(got_ids, want_ids, want_scores, rel=NEAR_TIE_REL):
    """Hits of the reference a search missed whose score clears the
    reference's last kept score by more than ``rel`` of the query's largest
    |score| (a near-tie at the edge may be traded: f32 sums in another order
    differ by about that much of the terms, not of the sum), summed over the
    queries."""
    misses = 0
    for g, w, s in zip(got_ids, want_ids, want_scores):
        edge, scale = s[-1], max(abs(v) for v in s if np.isfinite(v))
        got = set(g)
        misses += sum(1 for x, v in zip(w, s) if x not in got and v - edge > rel * scale)
    return misses


def _exact_topk(q, rows, k):
    """Exact top-k (f32 sums, ties to the lower row) → host (scores, rows)."""
    import torch

    from matchmaker_tpu_torch.ops import matmul_f32, topk_lowest_first

    with torch.inference_mode():
        v, i = topk_lowest_first(matmul_f32(q, rows.T), k)
    return v.cpu().numpy(), i.cpu().numpy()


def phase_index_cli(sz, device, root):
    """Phase 11 (a): ``run("encode+index+search")`` for the first index
    kind and ``run("index+search")`` on a copy of its encoded blocks for
    the others (the collection encoded once), each then ``run("search")``
    from the saved index."""
    import torch

    from matchmaker_tpu_torch.cli.dense_retrieval import run
    from matchmaker_tpu_torch.data.tokenization import build_tokenizer
    from matchmaker_tpu_torch.models import get_model, init_params
    from matchmaker_tpu_torch.ops import _build
    from matchmaker_tpu_torch.retrieval.encode import load_encoded

    _write_collection(root, sz)
    base = _main_config(root, sz, device)
    base["query_sets"] = {"dev": base["query_sets"]["dev"]}
    k = sz["top_n"]
    result, total = {}, {}
    vectors = None
    for i, (kind, (extra, files)) in enumerate(CLI_INDEX_KINDS.items()):
        config = dict(base, **extra)
        folder = os.path.join(root, f"run_{kind}")
        if i:
            shutil.copytree(os.path.join(root, f"run_{next(iter(CLI_INDEX_KINDS))}", "encoded"),
                            os.path.join(folder, "encoded"))
        else:
            os.makedirs(folder)
        rec = {}
        for mode in ("index+search" if i else "encode+index+search", "search"):
            fresh_perf_monitor()
            _build.reset_launches()
            t0 = time.perf_counter()
            check(run(mode, dict(config), folder) == 0, f"{kind}: run({mode}) returned non-zero")
            if device.type == "cuda":
                torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = dict(_build.LAUNCHES)
            for name, n in launches.items():
                total[name] = total.get(name, 0) + n
            want = predicted_index_cli_launches(sz, "encode" in mode)
            _check_launches(launches, want, f"{kind} {mode}", device)
            if device.type == "cuda":
                check(not any(n for name, n in launches.items() if name not in want), f"{kind}: {launches}")
            with open(os.path.join(folder, "efficiency-metrics.json")) as f:
                blocks = json.load(f)[-1]["blocks"]
            ranking = _read_run(os.path.join(folder, "dev-output.txt"))
            check(len(ranking[0]) == sz["queries"] and all(len(v) == k for v in ranking[0].values()),
                  f"{kind} {mode}: every query must have {k} hits")
            rec["run" if mode != "search" else mode] = {
                "mode": mode, "wall_s": wall, "launches": {n: launches[n] for n in want},
                "search_qps": blocks["search_total"]["items_per_second"],
                "indexing_s": blocks["indexing"]["total_seconds"] if "indexing" in blocks else None}
            if mode != "search":
                first = ranking
                os.remove(os.path.join(folder, "dev-output.txt"))
        for rel in ("encoded/encode_meta.json", "dev-metrics.csv") + tuple(f"index/{f}" for f in files):
            check(os.path.isfile(os.path.join(folder, rel)), f"{kind}: missing {rel}")
        check(ranking[0] == first[0], f"{kind}: the search from the saved index ranks otherwise")
        if vectors is None:
            vectors, row_ids = load_encoded(os.path.join(folder, "encoded"))
        rec["ranking"] = first
        result[kind] = rec

    # the exact f32 top-k over the stored rows, the queries encoded as the CLI encodes them
    tokenizer = build_tokenizer(base)
    model = get_model(base, tokenizer)
    init_params(model, base, torch.Generator().manual_seed(base["random_seed"]))
    model.to(device).eval()
    q_vecs, qids = _encode_file(model, base, tokenizer, os.path.join(root, "queries.tsv"), "query", 32, device)
    ex_v, ex_i = _exact_topk(q_vecs.float(), torch.from_numpy(vectors).to(device).float(), k)
    exact_ids = [[str(row_ids[i]) for i in row] for row in ex_i]
    for kind, rec in result.items():
        ids, scores = rec.pop("ranking")
        got = [ids[q] for q in qids]
        rec["recall@%d" % k] = float(np.mean([len(set(g) & set(w)) / k for g, w in zip(got, exact_ids)]))
        rec["misses_past_ties"] = _misses_past_ties(got, exact_ids, ex_v.tolist())
        print(f"[index-cli] {kind}: recall@{k} vs the exact f32 search of the stored rows {rec['recall@%d' % k]:.4f}"
              f" ({rec['misses_past_ties']} misses past near-ties); indexing {rec['run']['indexing_s']:.3f} s,"
              f" search {rec['run']['search_qps']:.1f} QPS in the CLI, {rec['search']['search_qps']:.1f}"
              f" QPS from the saved index; K1/K2 launches {rec['run']['launches']['fused_attention_block']}"
              f" + {rec['search']['launches']['fused_attention_block']} (as predicted)")
        if kind == "streaming":
            check(rec["misses_past_ties"] == 0, f"streaming: {rec['misses_past_ties']} misses against the exact search")
            # rank by rank, the run file's scores are the exact ones (near-ties may trade places)
            rel = max(float(np.abs(np.asarray(scores[q]) - ex_v[qi]).max() / np.abs(ex_v[qi]).max())
                      for qi, q in enumerate(qids))
            check(rel <= 1e-5, f"streaming: scores {rel} of the largest off the exact ones")
            rec["scores_max_rel"] = rel
            rec["queries_ranked_identically"] = sum(g == w for g, w in zip(got, exact_ids))
    result["launches"] = total
    return result


def _device_bytes(index):
    import torch

    state = index._device_vectors
    return int(sum(t.numel() * t.element_size() for t in (state if isinstance(state, tuple) else (state,))
                   if isinstance(t, torch.Tensor)))


def _on_cpu(index, config, cls):
    """A port index on the CPU with the card index's state, handed over in
    memory: IVF / tree-AH the arrays ``save`` writes (compressing ~1.5 GB
    into the JAX format's .npz would take most of the phase; phase 11 (a)
    saves and loads at 16,384 rows), FlatIndex its device tensors (its
    quantization on the host again would take ~10 s)."""
    import torch

    cpu = cls(config, "cpu")
    for name in ("_centroids", "_sorted_vectors", "_sorted_rows", "_offsets", "_ids", "n_clusters_eff", "_codes",
                 "_scales", "_leaf_of_row", "_vectors", "_row_count"):
        if hasattr(index, name):
            setattr(cpu, name, getattr(index, name))
    if hasattr(index, "_device_vectors"):
        state = index._device_vectors
        cpu._device_vectors = (tuple(t.cpu() if isinstance(t, torch.Tensor) else t for t in state)
                               if isinstance(state, tuple) else state.cpu())
    return cpu


def _write_blocks(folder, vectors, block_rows):
    """vectors as the encode folder holds them: float16 blocks, one sequence a row."""
    from matchmaker_tpu_torch.retrieval.encode import BlockWriter

    writer = BlockWriter(folder, vectors.shape[1], block_rows)
    spans = [writer.append(vectors[i:i + block_rows]) for i in range(0, len(vectors), block_rows)]
    writer.flush()
    ids = np.arange(len(vectors))
    starts = np.concatenate([np.arange(s, e) for _, s, e in spans])
    blocks = np.repeat([b for b, _, _ in spans], [e - s for _, s, e in spans])
    np.savez_compressed(os.path.join(folder, "doc_infos.npz"), ids=ids,
                        spans=np.stack([blocks, starts, starts + 1], axis=1).astype(np.int64))
    with open(os.path.join(folder, "encode_meta.json"), "w") as f:
        json.dump({"dim": vectors.shape[1], "dtype": "float16", "blocks": writer.block_num,
                   "sequences": len(vectors)}, f)
    return sum(os.path.getsize(os.path.join(folder, f"token_reps_{i}.npy")) for i in range(writer.block_num))


def phase_index_scale(sz, device, root):
    """Phase 11 (b) and (c): each route at phase 5's clustered rows, and the
    card's results against a port index on the CPU with the same state."""
    import torch

    from matchmaker_tpu_torch.ops import _build
    from matchmaker_tpu_torch.retrieval.hnsw import HNSWIndex
    from matchmaker_tpu_torch.retrieval.indexes import FlatIndex, IVFIndex, StreamingFlatIndex
    from matchmaker_tpu_torch.retrieval.scann_tree_ah import ScaNNTreeAHIndex

    n, k = sz["scale_rows"], sz["scale_k"]
    rows, q = _clustered(n, sz["hid"], sz["scale_clusters"], device, seed=9, n_queries=256)
    # the references: exact f32 over the rows, over the float16-stored rows,
    # and over the bf16-rounded float16 rows with bf16 queries (the float16 scan's operands)
    refs = {"f32": _exact_topk(q, rows, k), "stored": _exact_topk(q, rows.half().float(), k),
            "bf16": _exact_topk(q.bfloat16().float(), rows.half().bfloat16().float(), k)}
    vectors, queries = rows.cpu().numpy(), q.cpu().numpy()
    del rows, q
    ids = np.arange(n)
    stream_dir = os.path.join(root, "stream_blocks")
    routes = {
        "ivf": (IVFIndex, {"faiss_ivf_list_count": sz["scale_ivf_lists"], "faiss_ivf_nprobe": sz["scale_ivf_nprobe"]},
                "f32"),
        "tree_ah": (ScaNNTreeAHIndex, {"scann_num_leaves": sz["scale_ah_leaves"], "scann_leaves_to_search":
                                       sz["scale_ah_search"], "scann_reorder_mult": 1}, "f32"),
        "float16_scan": (FlatIndex, {"mips_quantization": "float16", "mips_kernel": "scan"}, "bf16"),
        "int8_twostage": (FlatIndex, {"mips_quantization": "int8", "mips_kernel": "scan", "mips_twostage": True,
                                      "mips_oversample": 4, "mips_rescore_dtype": "float16"}, "f32"),
        "streaming": (StreamingFlatIndex, {}, "stored"),
    }
    result = {}
    for name, (cls, extra, ref) in routes.items():
        config = {"token_dtype": "float16", **extra}
        _build.reset_launches()
        t0 = time.perf_counter()
        index = cls(config, device)
        if cls is StreamingFlatIndex:
            nbytes = _write_blocks(stream_dir, vectors, sz["stream_block_rows"])
            index.index_from_folder(stream_dir)
        else:
            index.prepare(vectors.shape[1])
            index.index(ids, vectors)
            if cls is FlatIndex:
                index._ensure_device()
                nbytes = _device_bytes(index)
            else:
                index._device_state("centroids", "offsets", *(("codes", "scales", "leaf", "stored")
                                                              if cls is ScaNNTreeAHIndex else ("corpus",)))
                nbytes = index.storage_bytes()
        if device.type == "cuda":
            torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        scores, got = index.search(queries, k)  # warm
        reps = 3
        t0 = time.perf_counter()
        for _ in range(reps):
            scores, got = index.search(queries, k)
        qps = len(queries) * reps / (time.perf_counter() - t0)
        check(not any(_build.LAUNCHES.values()), f"{name}: a kernel was launched: {_build.LAUNCHES}")
        ref_v, ref_i = refs[ref]
        got = got.astype(np.int64)
        recall = _overlap(got, ref_i)
        rec = {"build_s": build_s, "index_bytes": nbytes, "qps": qps, "reference": ref, f"recall@{k}": recall,
               f"recall@{k}_f32": _overlap(got, refs["f32"][1]),
               "misses_past_ties": _misses_past_ties(got.tolist(), ref_i.tolist(), ref_v.tolist())}
        # (c) the same state in a port index on the CPU, 8 queries
        m = sz["index_cpu_queries"]
        if cls is StreamingFlatIndex:
            cpu = StreamingFlatIndex(config, "cpu")
            cpu.index_from_folder(stream_dir)
        else:
            cpu = _on_cpu(index, config, cls)
        t0 = time.perf_counter()
        cpu_scores, cpu_got = cpu.search(queries[:m], k)
        rec["cpu_s"] = time.perf_counter() - t0
        # relative to each query's largest |score| (f32 sums in another order differ by that much of the terms)
        rel = np.abs(scores[:m] - cpu_scores) / np.abs(cpu_scores).max(axis=1, keepdims=True)
        rec["cpu_max_rel"] = float(rel.max())
        rec["cpu_misses_past_ties"] = _misses_past_ties(got[:m].tolist(), cpu_got.astype(np.int64).tolist(),
                                                        cpu_scores.tolist(), rel=1e-3)
        check(rec["cpu_max_rel"] <= 1e-3 and rec["cpu_misses_past_ties"] == 0,
              f"{name}: card vs CPU max rel {rec['cpu_max_rel']}, misses {rec['cpu_misses_past_ties']}")
        print(f"[index-scale] {name}: {n} x {sz['hid']}, Q={len(queries)}, k={k}: build {build_s:.2f} s, "
              f"{nbytes / 1e9:.3f} GB, {qps:.1f} QPS (search, host clock), recall@{k} {recall:.4f} vs exact "
              f"({ref}; {rec['misses_past_ties']} misses past near-ties), {rec[f'recall@{k}_f32']:.4f} vs exact f32; "
              f"card vs CPU on {m} queries: max rel {rec['cpu_max_rel']:.3g}, misses {rec['cpu_misses_past_ties']}")
        if name == "float16_scan":
            check(rec["misses_past_ties"] == 0, f"float16 scan: {rec['misses_past_ties']} misses past near-ties")
        if name == "int8_twostage":
            check(recall >= 0.99, f"int8 two-stage: recall@{k} {recall} < 0.99")
        if name == "streaming":
            check(rec["misses_past_ties"] == 0, f"streaming: {rec['misses_past_ties']} misses past near-ties")
            rec["identical_places"] = float(np.mean(got == ref_i))
        result[name] = rec
        del index, cpu
    del vectors

    # HNSW on the host at hnsw_rows
    rows, q = _clustered(sz["hnsw_rows"], sz["hid"], sz["scale_clusters"], device, seed=10, n_queries=256)
    ref_v, ref_i = _exact_topk(q, rows, k)
    vectors, queries = rows.cpu().numpy(), q.cpu().numpy()
    del rows, q
    index = HNSWIndex({"faiss_hnsw_graph_neighbors": 16, "hnsw_ef_construction": 80, "hnsw_ef_search": 128}, device)
    t0 = time.perf_counter()
    index.index(np.arange(len(vectors)), vectors)
    build_s = time.perf_counter() - t0
    index.save(os.path.join(root, "hnsw"))
    index.search(queries, k)
    t0 = time.perf_counter()
    _, got = index.search(queries, k)
    qps = len(queries) / (time.perf_counter() - t0)
    recall = _overlap(got.astype(np.int64), ref_i)
    nbytes = sum(os.path.getsize(os.path.join(root, "hnsw", f)) for f in os.listdir(os.path.join(root, "hnsw")))
    result["hnsw"] = {"rows": len(vectors), "build_s": build_s, "adds_per_s": len(vectors) / build_s,
                      "index_bytes": nbytes, "qps": qps, f"recall@{k}": recall, "reference": "f32",
                      "ef_search_used": max(128, k)}
    print(f"[index-scale] hnsw (host, M 16, efC 80, efSearch max(128, k)): {len(vectors)} x {sz['hid']}: build "
          f"{build_s:.2f} s ({len(vectors) / build_s:.1f} adds/s), {nbytes / 1e9:.3f} GB, {qps:.1f} QPS, "
          f"recall@{k} {recall:.4f} vs exact f32")
    return result


def phase_indexes(sz, device, root):
    """Phase 11: (a) the CLI's index kinds, (b) the routes at 1M rows, (c)
    the card against the CPU."""
    t0 = time.perf_counter()
    result = {"cli": phase_index_cli(sz, device, root)}
    result["cli_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    result["scale"] = phase_index_scale(sz, device, root)
    result["scale_s"] = time.perf_counter() - t0
    result["launches"] = result["cli"]["launches"]
    print(f"[indexes] phase 11: the CLI runs {result['cli_s']:.1f} s, the 1M-row routes {result['scale_s']:.1f} s")
    return result


# ---- phase 7: the probes' own path ---------------------------------------------

# the probe that launches each probe kernel
PROBE_OF = {"attn_inner": "attn_inner", "int8_matmul": "int8_matmul", "mlp_rows2d": "mlp_rows",
            "mlp_rowsblk": "mlp_rows"}


def phase_probes(sz, device):
    """Each probe as a user runs it, ``python -m
    matchmaker_tpu_torch.probes.<name>`` (its main()), at the JAX probes'
    shapes: the launch counts set to 0 just before each probe and read just
    after, every kernel of that probe launched; its JSON line kept in the
    report."""
    import importlib
    import io

    import torch

    from matchmaker_tpu_torch.ops import _build

    result = {"launches": {}, "results": {}}
    for name, args in sz["probe_args"].items():
        probe = importlib.import_module(f"matchmaker_tpu_torch.probes.{name}")
        _build.reset_launches()
        printed = io.StringIO()
        with contextlib.redirect_stdout(printed):
            line = probe.main(args + ["--device", device.type])
        if device.type == "cuda":
            torch.cuda.synchronize()
        launches = dict(_build.LAUNCHES)
        check(json.loads(printed.getvalue().strip().splitlines()[-1]) == line, f"probe {name}: its JSON line")
        for kernel, owner in PROBE_OF.items():
            if owner == name:
                check(launches[kernel] > 0 or device.type != "cuda", f"probe {name} launched no {kernel} kernel")
                result["launches"][kernel] = launches[kernel]
        others = {k: v for k, v in launches.items() if v and PROBE_OF.get(k) != name}
        result["results"][name] = line
        print(f"[probes] {name}: launches {({k: launches[k] for k, o in PROBE_OF.items() if o == name})}, "
              f"other kernels {others}")
    res = result["results"]
    print(f"[probes] attn_inner ms: " + ", ".join(f"{k} {v['ms']:.4f}" for k, v in res["attn_inner"].items()
                                                  if isinstance(v, dict) and "ms" in v))
    print(f"[probes] int8_matmul ms: {res['int8_matmul']['ms']}, int8_vs_bf16 {res['int8_matmul']['int8_vs_bf16']:.3f},"
          f" chain_vs_bf16 {res['int8_matmul']['chain_vs_bf16']:.3f}")
    for shape in res["mlp_rows"]["shapes"]:
        print(f"[probes] mlp_rows {shape['shape']} ms: " + ", ".join(
            f"{key} {shape[key]['ms']:.4f}" for key in ("prod_3d", "rows2d", "rowsblk_1024", "rowsblk_2048", "chain")))
    return result


# ---- phase 14: more than one device ----------------------------------------

# (a)'s routes: name, FlatIndex config, the scan kernel a shard launches. The
# three binmax int8 routes share one index's storage (the same codes and bin
# scales): a route is the index's search flags.
MULTI_ROUTES = (
    ("bf16", {"mips_quantization": "float16", "mips_kernel": "binmax"}, "binmax_candidates"),
    ("int8", {"mips_quantization": "int8", "mips_kernel": "binmax"}, "binmax_candidates_int8"),
    ("mixed", {"mips_quantization": "int8", "mips_kernel": "binmax", "mips_int8_queries": "float"},
     "binmax_candidates_int8f"),
    ("rescore", {"mips_quantization": "int8", "mips_kernel": "binmax", "mips_twostage": True},
     "binmax_candidates_int8"),
    ("float16_scan", {"mips_quantization": "float16", "mips_kernel": "scan"}, None),
)
# phase 5's and 5b's recall floors against the exact search (the default int8 route's: reported)
MULTI_RECALL_FLOORS = {"bf16": 0.95, "mixed": 0.95, "rescore": 0.95}


def _stored(index):
    return index._device_vectors[0] if isinstance(index._device_vectors, tuple) else index._device_vectors


def predicted_sharded_launches(index, k, scan):
    """One sharded binmax search call: a scan (``scan``) and an unpack (K6)
    a shard, and level 2 (K4) a shard when the gate, read on the fullest
    shard's real rows, picks it (the rescore route's scan fetches
    oversample·k at per_bin >= 4); none for the float16 scan."""
    from matchmaker_tpu_torch.ops import mips_binmax as mb

    if scan is None:
        return {}
    rows, per_bin, fetch = _stored(index).rows, index._per_bin(k), k
    if index.twostage and index.int8_queries != "float":
        per_bin = max(per_bin, 4)
        fetch = min(k * index.oversample, rows, max(rows // mb.BIN_WIDTH * per_bin, k))
    level2 = min(rows, index._row_count) // mb.BIN_WIDTH * per_bin >= 16 * fetch
    n = index.n_shards
    return {scan: n, "level2_reduce": n if level2 else 0, "unpack_candidates": n}


def _sharded_agreement(s_vals, s_ids, u_vals, u_ids, rel=NEAR_TIE_REL):
    """A sharded search (S) against the same route unsharded (U) on the same
    rows. Each shard's candidate pool holds U's (the same 128-row bins; the
    level-2 gate, read on a shard's rows, keeps at least as many), and a
    row scores the same in both, so: an id in both has one score, S is at
    least U rank by rank, and an id of U missing from S scores no more than
    S's last; all within ``rel`` of the query's largest |score|. Scores are
    compared with their low 14 mantissa bits cleared (a monotone map): a
    search through level 2 returns them so (its lanes' bits), one without
    with 7 cleared. → the hits of one search the other has not (summed
    over the queries), and the violations of each rule."""
    out = {"hits_not_unsharded": 0, "score_mismatches": 0, "rank_below": 0, "unexplained_misses": 0}
    lanes = ~np.int32((1 << 14) - 1)
    s_vals, u_vals = ((np.asarray(v, np.float32).view(np.int32) & lanes).view(np.float32) for v in (s_vals, u_vals))
    for sv, si, uv, ui in zip(s_vals, s_ids, u_vals, u_ids):
        tol = rel * float(np.abs(uv[np.isfinite(uv)]).max())
        out["hits_not_unsharded"] += len(set(si.tolist()) - set(ui.tolist()))
        s_of = dict(zip(si.tolist(), sv.tolist()))
        for x, v in zip(ui.tolist(), uv.tolist()):
            if x in s_of:
                out["score_mismatches"] += abs(s_of[x] - v) > tol
            elif v > sv[-1] + tol:
                out["unexplained_misses"] += 1
        out["rank_below"] += int((sv < uv - tol).sum())
    return out


def _qps(index, queries, k, reps=3):
    """Queries a second over ``reps`` searches (host clock), after the
    caller's first search."""
    t0 = time.perf_counter()
    for _ in range(reps):
        index.search_rows(queries, k)
    return len(queries) * reps / (time.perf_counter() - t0)


def _shard_scan_check(index, route, q, k, device):
    """Shard 1's scan (its row view) against its plain version on the card:
    K7 bit for bit, K3 and K8 by identical candidates (>= 0.999) and their
    values."""
    import torch

    from matchmaker_tpu_torch.ops import mips_binmax as mb
    from matchmaker_tpu_torch.ops.mips_quant import quantize_queries

    shard, tile, per_bin = _stored(index).parts[1], 2048, index._per_bin(k)
    rows = shard.shape[0]
    if route == "bf16":
        qb = q.to(torch.bfloat16)
        got, want = mb._scan_cuda(qb, shard, rows, per_bin, tile), mb._scan_plain(qb, shard, rows, per_bin, tile)
    else:
        scales = index._device_vectors[1].parts[1]
        if route == "mixed":
            qb = q.to(torch.bfloat16)
            got = mb._scan_int8f_cuda(qb, shard, scales, rows, per_bin, tile)
            want = mb._scan_int8f_plain(qb, shard, scales, rows, per_bin, tile)
        else:
            q8, qs = quantize_queries(q)
            got = mb._scan_int8_cuda(q8, shard, scales, qs, rows, per_bin, tile)
            want = mb._scan_int8_plain(q8, shard, scales, qs, rows, per_bin, tile)
            return {"bit_identical": bool(torch.equal(got.view(torch.int32), want.view(torch.int32)))}
    pos = torch.arange(got.shape[1], device=device).expand_as(got).contiguous()
    gv, gi = mb._unpack_plain(got, pos, tile, per_bin)
    wv, wi = mb._unpack_plain(want, pos, tile, per_bin)
    same = gi == wi
    return {"identical": float(same.float().mean()),
            "max_abs_err": float((gv - wv).abs()[same & torch.isfinite(wv)].max())}


def phase_sharded_flat(sz, device):
    """Phase 14 (a): FlatIndex's binmax and float16-scan routes over a mesh
    of ``multi_shards`` cuda:0 entries (four shards of 262,144 rows, K3/K7's
    headline shape) against the same route unsharded on phase 5's rows."""
    import torch

    from matchmaker_tpu_torch.ops import _build
    from matchmaker_tpu_torch.parallel.mesh import make_mesh
    from matchmaker_tpu_torch.retrieval.indexes import FlatIndex

    n, k = sz["scale_rows"], sz["scale_k"]
    rows, q = _clustered(n, sz["hid"], sz["scale_clusters"], device, seed=9, n_queries=256)
    _, exact = _exact_topk(q.bfloat16().float(), rows.bfloat16().float(), k)
    vectors, queries = rows.cpu().numpy(), q.cpu().numpy()
    del rows
    mesh = make_mesh(devices=[device] * sz["multi_shards"])
    result, pair = {"launches": {}}, []
    for name, extra, scan in MULTI_ROUTES:
        config = {"token_dtype": "float16", **extra}
        if name in ("bf16", "int8", "float16_scan"):  # a new storage (the int8 routes share one)
            del pair
            if device.type == "cuda":
                torch.cuda.empty_cache()
            pair = []
            t0 = time.perf_counter()
            for m in (None, mesh):
                index = FlatIndex(config, device, m)
                index.index(np.arange(n), vectors)
                index._ensure_device()
                pair.append(index)
            if device.type == "cuda":
                torch.cuda.synchronize()
            build_s = time.perf_counter() - t0
        one, four = pair
        for index in pair:  # the search flags of this route
            index.int8_queries = extra.get("mips_int8_queries", "int8")
            index.twostage = extra.get("mips_twostage", False)
        u_vals, u_ids = one.search_rows(queries, k)
        _build.reset_launches()
        s_vals, s_ids = four.search_rows(queries, k)
        launches = {c: v for c, v in _build.LAUNCHES.items() if v}
        want = predicted_sharded_launches(four, k, scan) if device.type == "cuda" else {}
        check(launches == {c: v for c, v in want.items() if v},
              f"phase 14 {name}: launches {launches}, predicted {want}")
        agree = _sharded_agreement(s_vals, s_ids, u_vals, u_ids)
        check(agree["score_mismatches"] == agree["rank_below"] == agree["unexplained_misses"] == 0,
              f"phase 14 {name}: the sharded search against the unsharded one: {agree}")
        rec = {"launches": launches, "build_s_both": build_s, **agree,
               "recall": _overlap(four.row_ids[s_ids], exact), "recall_unsharded": _overlap(one.row_ids[u_ids], exact),
               "qps_four_shards_one_card": _qps(four, queries, k), "qps_unsharded": _qps(one, queries, k)}
        if scan is None:
            rec["misses_past_ties"] = _misses_past_ties(s_ids.tolist(), u_ids.tolist(), u_vals.tolist())
            check(rec["misses_past_ties"] == 0, f"phase 14 {name}: {rec['misses_past_ties']} misses past ties")
        elif device.type == "cuda":  # a kernel against its plain version
            rec["shard_scan_vs_plain"] = _shard_scan_check(four, name, torch.from_numpy(queries).to(device), k, device)
            sv = rec["shard_scan_vs_plain"]
            check(sv.get("bit_identical", sv.get("identical", 0) >= 0.999),
                  f"phase 14 {name}: shard 1's scan against its plain version: {sv}")
        if name in MULTI_RECALL_FLOORS:
            check(rec["recall"] >= MULTI_RECALL_FLOORS[name], f"phase 14 {name}: recall@{k} {rec['recall']}")
        for c, v in launches.items():
            result["launches"][c] = result["launches"].get(c, 0) + v
        print(f"[multi] (a) {name}: {sz['multi_shards']} shards of {_stored(four).rows} rows on one card, Q 256, "
              f"k {k}: launches {launches}; {agree['hits_not_unsharded']} hits the unsharded search has not "
              f"(none unexplained); recall@{k} {rec['recall']:.4f} (unsharded {rec['recall_unsharded']:.4f}); "
              f"{rec['qps_four_shards_one_card']:.1f} QPS as {sz['multi_shards']} shards on one card (not a "
              f"multi-card rate), {rec['qps_unsharded']:.1f} unsharded")
        result[name] = rec
        del one, four
    del pair
    if device.type == "cuda":
        torch.cuda.empty_cache()
    result["vectors"], result["queries"] = vectors, queries
    return result


def phase_sharded_ivf(sz, device, vectors, queries):
    """Phase 14 (b): IVF (2,048 lists, 64 probed) and tree-AH over the same
    mesh, both on the unsharded IVF's state, against its search: recall
    against it >= 0.99, every returned score the row's exact score (f32
    products of the stored rows) within 1e-3 of the query's largest."""
    import torch

    from matchmaker_tpu_torch.ops import _build, matmul_f32
    from matchmaker_tpu_torch.parallel.mesh import make_mesh
    from matchmaker_tpu_torch.retrieval.indexes import IVFIndex
    from matchmaker_tpu_torch.retrieval.scann_tree_ah import ScaNNTreeAHIndex

    k, n = sz["scale_k"], len(vectors)
    mesh = make_mesh(devices=[device] * sz["multi_shards"])
    # k-means on the 131,072-row floor of the training sample (phase 11 trains on 256 rows a list): the
    # comparison holds the sharded search to the unsharded one on whatever state they share
    config = {"token_dtype": "float16", "faiss_ivf_list_count": sz["scale_ivf_lists"],
              "faiss_ivf_nprobe": sz["scale_ivf_nprobe"], "ivf_train_points_per_centroid": 64}
    t0 = time.perf_counter()
    one = IVFIndex(config, device)
    one.index(np.arange(n), vectors)
    build_s = time.perf_counter() - t0
    sharded = {"ivf": IVFIndex(config, device, mesh),
               "tree_ah": ScaNNTreeAHIndex({"token_dtype": "float16", "scann_leaves_to_search": sz["scale_ivf_nprobe"]},
                                           device, mesh)}
    u_vals, u_ids = one.search(queries, k)
    result = {"ivf_build_s": build_s, "qps_unsharded": _qps(one, queries, k, reps=1)}
    stored = torch.from_numpy(np.asarray(vectors, np.float16)).to(device)
    qd = torch.from_numpy(queries).to(device)
    for name, index in sharded.items():
        for attr in ("_centroids", "_sorted_vectors", "_sorted_rows", "_offsets", "_ids", "n_clusters_eff"):
            setattr(index, attr, getattr(one, attr))  # the same state
        _build.reset_launches()
        s_vals, s_ids = index.search(queries, k)
        check(not any(_build.LAUNCHES.values()), f"phase 14 (b) {name}: a kernel was launched")
        with torch.inference_mode():
            ids = torch.from_numpy(np.where(s_ids >= 0, s_ids, 0).astype(np.int64)).to(device)
            exact = matmul_f32(stored[ids], qd[:, :, None])[..., 0].cpu().numpy()
        scale = np.abs(exact).max(axis=1, keepdims=True)
        rel = float((np.abs(s_vals - exact) / scale)[s_ids >= 0].max())
        rec = {"recall_vs_unsharded": _overlap(s_ids, u_ids), "max_rel_vs_exact": rel,
               "qps_four_shards_one_card": _qps(index, queries, k, reps=1) if name == "ivf" else None}
        print(f"[multi] (b) {name} over {sz['multi_shards']} shards ({sz['scale_ivf_lists']} lists, "
              f"{sz['scale_ivf_nprobe']} probed): recall@{k} vs the unsharded IVF {rec['recall_vs_unsharded']:.4f}, "
              f"scores vs exact max rel {rel:.3g}; " + (f"{rec['qps_four_shards_one_card']:.1f} QPS as four shards "
              "on one card" if name == "ivf" else "the IVF search's rate") +
              f", unsharded {result['qps_unsharded']:.1f}")
        check(rec["recall_vs_unsharded"] >= 0.99 and rel <= 1e-3, f"phase 14 (b) {name}: {rec}")
        result[name] = rec
    return result


def _mp_configs(paths, sz, device):
    """Phase 6's BERT_DOT configuration at phase 14's batch and steps,
    without validation or dense retrieval, a constant learning rate; and
    the one-step comparison's (phase 13's: lr 1 and Adam's eps 1 make the
    first update g / (|g| + 1), near proportional to the gradient)."""
    run = dict(_train_config(paths, sz, device), batch_size_train=sz["mp_batch"], max_training_batches=sz["mp_steps"],
               validation_cont=None, test=None, run_dense_retrieval_eval=False, validate_every_n_batches=-1,
               lr_schedule="constant", optimizer_warmup_steps=0)
    step = dict(run, param_group0_learning_rate=1.0, param_group1_learning_rate=1.0,
                embedding_optimizer_learning_rate=1.0, adam_eps=1.0, weight_decay=0.0)
    return run, step


def two_process_worker(spec_path: str) -> int:
    """One rank of phase 14 (c) (``python3 chip_smoke.py --two-process-worker
    spec.json``): one step of the comparison's configuration on this rank's
    half of the first global batch, then, from the same start,
    ``mp_steps`` steps through the Trainer; rank 0 writes the step's
    parameters, every rank its counts."""
    import torch

    from matchmaker_tpu_torch.ops import _build
    from matchmaker_tpu_torch.parallel import multihost
    from matchmaker_tpu_torch.training.optim import build_optimizer
    from matchmaker_tpu_torch.training.train_step import make_train_step
    from matchmaker_tpu_torch.training.trainer import Trainer

    with open(spec_path) as f:
        spec = json.load(f)
    config, step_config = spec["config"], spec["step_config"]
    multihost.maybe_initialize_distributed(config)
    rank = multihost.process_index()
    on_card = torch.device(config["device"]).type == "cuda"
    out = {"rank": rank, "backend": multihost.backend(), "device": str(multihost.rank_device()) if on_card else "cpu",
           "visible_cards": torch.cuda.device_count()}
    folder = os.path.join(spec["root"], "mp_run")
    multihost.on_primary(lambda: os.makedirs(folder, exist_ok=True))
    trainer = Trainer(config, folder)
    start = {k: v.detach().clone() for k, v in trainer.model.state_dict().items()}
    first = next(iter(trainer._epoch_batches(None, None)))
    # one step on this rank's half of the first global batch, and one from the
    # same start on the padded global batch (rows from mp_valid on: zeros, valid 0)
    local = first["valid"].shape[0]
    for tag, batch in (("", first), ("_padded", _padded_rows(first, spec["mp_valid"] - rank * local))):
        trainer.model.load_state_dict(start)
        step = make_train_step(trainer.model, trainer.losses, build_optimizer(step_config, trainer.model),
                               step_config)
        stats = step(batch)
        if rank == 0:
            torch.save({"params": {k: v.detach().float().cpu() for k, v in trainer.model.state_dict().items()},
                        "loss": float(stats["loss"])}, os.path.join(spec["root"], f"mp_step{tag}.pt"))
    trainer.model.load_state_dict(start)
    _build.reset_launches()
    t0 = time.perf_counter()
    trainer.train()
    if on_card:
        torch.cuda.synchronize()
    out.update(wall_s=time.perf_counter() - t0, steps=trainer.global_step, launches=dict(_build.LAUNCHES))
    with open(os.path.join(folder, f"efficiency-metrics-p{rank}.json")) as f:
        out["train_s"] = json.load(f)[-1]["blocks"]["train"]["total_seconds"]
    with open(os.path.join(spec["root"], f"mp_out_{rank}.json"), "w") as f:
        json.dump(out, f)
    multihost.barrier()
    multihost.shutdown()
    return 0


def _padded_rows(batch, first):
    """``batch`` with its rows from ``first`` on as the loader pads the last
    batch of a file (data/batching.py): zeros, ``valid`` 0."""
    out = {}
    for key, t in batch.items():
        t = t.clone()
        t[max(first, 0):] = 0
        out[key] = t
    return out


def _launch_two(root, config, step_config, cards, timeout=600, mp_valid=0):
    """Both ranks of phase 14 (c) on ``cards`` (CUDA_VISIBLE_DEVICES); every
    process ends before this returns. → their outputs."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    spec = os.path.join(root, "mp_spec.json")
    with open(spec, "w") as f:
        json.dump({"root": root, "config": config, "step_config": step_config, "mp_valid": mp_valid}, f)
    procs = []
    for rank in range(2):
        env = dict(os.environ, MATCHMAKER_COORDINATOR=f"127.0.0.1:{port}", MATCHMAKER_NUM_PROCESSES="2",
                   MATCHMAKER_PROCESS_ID=str(rank), CUDA_VISIBLE_DEVICES=cards)
        procs.append(subprocess.Popen([sys.executable, os.path.join(ROOT, "chip_smoke.py"), "--two-process-worker",
                                       spec], env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rank, (p, text) in enumerate(zip(procs, outs)):
        check(p.returncode == 0, f"phase 14 (c) rank {rank} exited {p.returncode}:\n{text[-3000:]}")
    results = []
    for rank in range(2):
        with open(os.path.join(root, f"mp_out_{rank}.json")) as f:
            results.append(json.load(f))
    return results, outs


def phase_two_processes(sz, device, root):
    """Phase 14 (c): two processes on the one card over gloo (the backend
    rule: NCCL refuses two ranks on one card), BERT_DOT at DistilBERT width,
    a global batch of ``mp_batch`` (half a process), query 30, doc 200,
    Margin-MSE + in-batch negatives: one step against the one-process step
    on the same global batch, and one on the padded last batch of a file
    (``mp_valid`` valid rows: process 0 holds half the batch's, process 1
    the rest; JAX's one mean over the global batch's valid rows, whatever
    each process holds), ``mp_steps`` steps through the Trainer in each
    process (K1/K2/K11/K12 counted in each), the primary alone writing the
    run folder; on a machine with two cards or more, the same over nccl."""
    import torch

    from matchmaker_tpu_torch.training.optim import build_optimizer
    from matchmaker_tpu_torch.training.train_step import make_train_step
    from matchmaker_tpu_torch.training.trainer import Trainer

    paths = _write_train_data(root, dict(sz, train_batches=sz["mp_steps"] + 1, train_batch=sz["mp_batch"]))
    config, step_config = _mp_configs(paths, sz, device)
    fresh_perf_monitor()
    os.makedirs(os.path.join(root, "one_step"))
    one = Trainer(step_config, os.path.join(root, "one_step"))
    start_dev = {k: v.detach().clone() for k, v in one.model.state_dict().items()}
    start = {k: v.float().cpu().clone() for k, v in start_dev.items()}
    first = next(iter(one._epoch_batches(None, None)))
    after_one, loss_one = {}, {}
    for tag, batch in (("", first), ("_padded", _padded_rows(first, sz["mp_valid"]))):
        one.model.load_state_dict(start_dev)
        step = make_train_step(one.model, one.losses, build_optimizer(step_config, one.model), step_config)
        loss_one[tag] = float(step(batch)["loss"])
        after_one[tag] = {k: v.detach().float().cpu().clone() for k, v in one.model.state_dict().items()}
    del one
    if device.type == "cuda":
        torch.cuda.empty_cache()
    visible = os.environ.get("CUDA_VISIBLE_DEVICES")
    cards = visible.split(",") if visible else [str(i) for i in range(torch.cuda.device_count())]
    result = {}
    for tag, use in (("gloo_one_card", cards[:1]), ("nccl_two_cards", cards[:2])):
        if tag == "nccl_two_cards" and len(cards) < 2:
            result[tag] = "skipped: one card"
            print("[multi] (c) nccl on two cards: skipped: one card")
            continue
        run_root = os.path.join(root, tag)
        os.makedirs(run_root)
        t0 = time.perf_counter()
        ranks, outs = _launch_two(run_root, config, step_config, ",".join(use), mp_valid=sz["mp_valid"])
        wall = time.perf_counter() - t0
        steps = {}
        for which in ("", "_padded"):
            mp_step = torch.load(os.path.join(run_root, f"mp_step{which}.pt"), weights_only=True)
            gap = abs(mp_step["loss"] - loss_one[which]) / abs(loss_one[which])
            what = "padded two-process step" if which else "two-process step"
            steps[which] = (mp_step["loss"], gap, _update_cosines(start, mp_step["params"], after_one[which], "multi",
                                                                  f"{tag}: {what} vs one-process"))
            check(gap <= 1e-2, f"phase 14 (c) {tag}: {what}'s loss {mp_step['loss']} vs one process "
                               f"{loss_one[which]}")
        (mp_loss, loss_gap, cos), (pad_loss, pad_gap, pad_cos) = steps[""], steps["_padded"]
        want = 2 * sz["mp_steps"] * sz["n_layers"] if device.type == "cuda" else 0
        for r in ranks:
            got = {c: r["launches"][c] for c in ("fused_attention_block", "fused_mlp_block",
                                                 "fused_attention_block_bwd", "fused_mlp_block_bwd")}
            check(r["steps"] == sz["mp_steps"] and set(got.values()) == {want},
                  f"phase 14 (c) {tag} rank {r['rank']}: {r['steps']} steps, launches {got}, predicted {want} each")
        files = sorted(os.listdir(os.path.join(run_root, "mp_run")))
        check(files == ["best-model.npz", "efficiency-metrics-p0.json", "efficiency-metrics-p1.json"],
              f"phase 14 (c) {tag}: run folder {files}")
        rate = sz["mp_steps"] * sz["mp_batch"] / max(r["train_s"] for r in ranks)
        backends = [r["backend"] for r in ranks]
        check(backends == (["gloo", "gloo"] if tag.startswith("gloo") else ["nccl", "nccl"]),
              f"phase 14 (c) {tag}: backends {backends}")
        result[tag] = {"backends": backends, "devices": [r["device"] for r in ranks], "loss_one_process": loss_one[""],
                       "loss_two_processes": mp_loss, "loss_rel_gap": loss_gap, **cos,
                       "padded": {"valid_rows": sz["mp_valid"], "loss_one_process": loss_one["_padded"],
                                  "loss_two_processes": pad_loss, "loss_rel_gap": pad_gap, **pad_cos},
                       "launches_rank0": ranks[0]["launches"], "launches_rank1": ranks[1]["launches"],
                       "triples_per_s_host_paced": rate, "wall_s": wall, "run_files": files}
        print(f"[multi] (c) {tag}: backends {backends} on {result[tag]['devices']}; one step vs one process: loss "
              f"gap {loss_gap:.3g}, worst update cosine {cos['update_cos']:.6f}; on the padded batch ({sz['mp_valid']} "
              f"valid rows of {sz['mp_batch']}) loss gap {pad_gap:.3g}, worst update cosine "
              f"{pad_cos['update_cos']:.6f}; {sz['mp_steps']} steps, "
              f"K1/K2/K11/K12 {want} each in each process; {rate:.1f} triples/s (host-paced; "
              f"{'two ranks on one card' if tag.startswith('gloo') else 'two cards'}); run folder {files}")
    return result


def phase_multi_device(sz, device, root):
    """Phase 14: (a) the sharded FlatIndex routes, (b) the sharded IVF and
    tree-AH, (c) two processes."""
    t0 = time.perf_counter()
    flat = phase_sharded_flat(sz, device)
    vectors, queries = flat.pop("vectors"), flat.pop("queries")
    t1 = time.perf_counter()
    ivf = phase_sharded_ivf(sz, device, vectors, queries)
    del vectors
    t2 = time.perf_counter()
    procs = phase_two_processes(sz, device, root)
    t3 = time.perf_counter()
    print(f"[multi] (a) {t1 - t0:.1f} s, (b) {t2 - t1:.1f} s, (c) {t3 - t2:.1f} s")
    launches = dict(flat["launches"])
    for c, v in procs["gloo_one_card"]["launches_rank0"].items():
        launches[c] = launches.get(c, 0) + v
    return {"flat": flat, "ivf": ivf, "processes": procs, "launches": launches, "seconds": time.perf_counter() - t0,
            "part_seconds": {"a": t1 - t0, "b": t2 - t1, "c": t3 - t2}}


SERVING = ("fused_attention_block", "fused_mlp_block", "binmax_candidates", "level2_reduce", "unpack_candidates")
SERVING_INT8 = ("fused_attention_int8_block", "fused_mlp_int8_block", "binmax_candidates_int8f",
                "binmax_candidates_int8")

KERNELS = [  # name, source, TPU kernel it replaces, TPU kernels folded into it
    ("fused_attention_block", "matchmaker_tpu_torch/csrc/encoder_kernels.cu",
     "matchmaker_tpu/ops/fused_attention.py:186", None),
    ("fused_mlp_block", "matchmaker_tpu_torch/csrc/encoder_kernels.cu",
     "matchmaker_tpu/ops/fused_attention.py:386", None),
    ("binmax_candidates", "matchmaker_tpu_torch/csrc/binmax_kernels.cu",
     "matchmaker_tpu/ops/mips_binmax.py:247", "matchmaker_tpu/ops/mips_binmax.py:317 (K5 transpose, in the store)"),
    ("level2_reduce", "matchmaker_tpu_torch/csrc/binmax_kernels.cu",
     "matchmaker_tpu/ops/mips_binmax.py:327", None),
    ("unpack_candidates", "matchmaker_tpu_torch/csrc/binmax_kernels.cu",
     "matchmaker_tpu/ops/mips_binmax.py:139", None),
    ("fused_mlp_block_bwd", "matchmaker_tpu_torch/csrc/encoder_backward_kernels.cu",
     "matchmaker_tpu/ops/fused_backward.py:124", None),
    ("fused_attention_block_bwd", "matchmaker_tpu_torch/csrc/encoder_backward_kernels.cu",
     "matchmaker_tpu/ops/fused_backward.py:290", None),
    ("fused_mlp_int8_block", "matchmaker_tpu_torch/csrc/encoder_int8_kernels.cu",
     "matchmaker_tpu/ops/fused_int8.py:72", None),
    ("fused_attention_int8_block", "matchmaker_tpu_torch/csrc/encoder_int8_kernels.cu",
     "matchmaker_tpu/ops/fused_int8.py:163", None),
    ("binmax_candidates_int8f", "matchmaker_tpu_torch/csrc/binmax_kernels.cu",
     "matchmaker_tpu/ops/mips_binmax.py:288", None),
    ("binmax_candidates_int8", "matchmaker_tpu_torch/csrc/binmax_kernels.cu",
     "matchmaker_tpu/ops/mips_binmax.py:259", None),
    ("maxsim_all_pairs", "matchmaker_tpu_torch/csrc/maxsim_kernels.cu",
     "matchmaker_tpu/ops/pallas_kernels.py:62", None),
    ("maxsim_all_pairs_argmax", "matchmaker_tpu_torch/csrc/maxsim_train_kernels.cu",
     "matchmaker_tpu/ops/pallas_kernels.py:62",
     "matchmaker_tpu/ops/maxsim.py:34 (the jnp all-pairs MaxSim JAX trains through: K14's all-pairs form that also "
     "saves each max's doc token; no pallas_call of its own)"),
    ("maxsim_all_pairs_bwd", "matchmaker_tpu_torch/csrc/maxsim_train_kernels.cu", "matchmaker_tpu/ops/maxsim.py:34",
     "the gradient JAX takes by autodiff of the jnp all-pairs MaxSim (matchmaker_tpu/training/train_step.py:212-221);"
     " no pallas_call"),
    ("fused_mha", "matchmaker_tpu_torch/csrc/encoder_kernels.cu",
     "matchmaker_tpu/ops/fused_attention.py:49", None),
    ("attn_inner", "matchmaker_tpu_torch/csrc/probe_attn_inner.cu", "benchmarks/attn_inner_probe.py:56",
     "benchmarks/attn_inner_probe.py:75,90,109 (k_unrolled, k_allheads, k_blockdiag: the same function)"),
    ("int8_matmul", "matchmaker_tpu_torch/csrc/probe_int8_matmul.cu", "benchmarks/int8_matmul_probe.py:97", None),
    ("mlp_rows2d", "matchmaker_tpu_torch/csrc/probe_mlp_rows.cu", "benchmarks/mlp_rows_probe.py:43", None),
    ("mlp_rowsblk", "matchmaker_tpu_torch/csrc/probe_mlp_rows.cu", "benchmarks/mlp_rows_probe.py:101", None),
]


# other times and agreements measured beside a kernel, carried into its entry
# the design of the kernels redesigned for Hopper since their first port
DESIGN = {
    "fused_attention_block": "QKV and Wo on the persistent wgmma/TMA GEMM (wgmma_gemm.cuh, bias and bias + residual "
                             "epilogues, weights read MN-major where they lie); attention core on mma.sync with each "
                             "64-key tile's scores in registers, two passes, f32 p as a bf16 hi + lo pair, key tiles "
                             "past the last unmasked key skipped; LayerNorm",
    "fused_mlp_block": "W1 and W2 on the persistent wgmma/TMA GEMM (wgmma_gemm.cuh, bias + gelu poly and bias + "
                       "residual epilogues, weights read MN-major where they lie); LayerNorm",
    "fused_mha": "K1's register-resident mma.sync attention core, the normalised p rounded to bf16",
    "fused_attention_int8_block": "s8 wgmma/TMA products (encoder_int8_kernels.cu); K1's register-resident "
                                  "attention core with an f32 output, p as three bf16 terms",
    "binmax_candidates": "persistent warp-specialised scan (binmax_kernels.cu scan_kernel): TMA ring of queries "
                         "(wgmma A, 128 or 256 a unit) and one 128-row bin (B), m64n128k16 bf16 -> f32, each bin's "
                         "top per_bin selected in registers by the quad of lanes holding a query row, merged with "
                         "two xor shuffles, stored packed into the (Q, C) layout",
    "binmax_candidates_int8": "the same scan with m64n128k32 s8 -> s32 products, f32(raw) * bin scale * query "
                              "scale before the selection; bit-identical to its plain version",
    "binmax_candidates_int8f": "the same scan (SCAN_MIXED): the bin's int8 codes by TMA into a staging area, turned "
                               "into the 128-byte-swizzled bf16 B operand by the producer warpgroup's three idle warps "
                               "(exact), m64n128k16 bf16 -> f32 products, f32 sum * bin scale before the selection",
    "attn_inner": "one warpgroup a (head, example), two CTAs an SM: Q tiles, K and V by TMA through 3-D maps "
                  "(rows past L zero on loads, clipped on stores), read once; S = Q.K^T by wgmma m64n64k16 with the "
                  "whole row (<= 256 keys) in registers, softmax in registers over the quad of lanes, p as register-A "
                  "bf16 fragments (hi + lo for f32_p) into wgmma m64n64k16 against V MN-major; past 256 keys two "
                  "halves (max and sum, then S again); the output tile through shared memory by TMA store",
    "int8_matmul": "persistent s8 wgmma/TMA GEMM: a producer warp keeps a 5-stage ring of both K-major operands "
                   "and runs into the next tile; two consumer warpgroups of m64n128k32; the int32 tile through a "
                   "swizzled shared-memory buffer a warpgroup to TMA stores that run under the next tile's mainloop",
    "mlp_rows2d": "a cluster of 4 CTAs a 128-row tile, each owning 192 output columns: per round of 256 FF "
                  "columns each CTA computes a 64-column chunk of h = gelu(x.W1 + b1) by wgmma m64n64k16 (x "
                  "multicast by TMA to the four CTAs), rounds it to bf16 and copies it into its peers' shared "
                  "memory (cp.async.bulk, double-buffered), then every CTA adds h.W2 for its columns by wgmma "
                  "m64n192k16; the LayerNorm's row sums and centred squares exchanged over distributed shared "
                  "memory and added in CTA order; y out by TMA store; neither h nor the pre-LN sums reach device "
                  "memory",
    "maxsim_all_pairs_argmax": "persistent, one CTA an SM over the (128-row query tile, doc) items: two consumer "
                               "warpgroups run split-TF32 wgmma m64nNk8 (N 64/104/128 tokens a chunk) with the "
                               "tile's hi and lo resident in shared memory (streamed beside each doc slab past D "
                               "160); a producer warpgroup loads doc slabs two stages ahead, splits them once into "
                               "hi and lo, and fills a 2-4 slot ring under full / empty mbarriers; the row max and "
                               "its token in registers, across the quad by shuffles (the first of equal maxima, -1 "
                               "where the fill wins); a small second kernel sums the rows in order",
    "maxsim_all_pairs_bwd": "two launches, no float atomics: (1) a block a doc builds its classes of bit-equal rows "
                            "once (lane-parallel hashes, a full compare where they agree) while warps compute dq, a "
                            "query row each, gathering 16 doc rows at a time and summing over the docs in order; "
                            "(2) dd, a block a (doc, range of <= 40 rows, 128 columns): the (b, l) whose token's "
                            "class lead lies in its range listed in order by a block scan, four column groups "
                            "summing a quarter of each list chunk apart, the groups added in order and each "
                            "class's members given the lead's sum over its size",
    "maxsim_all_pairs": "split-TF32 mma.sync m16n8k8 (hi + lo of each f32 operand, three products; two for float16 "
                        "tokens), whole queries packed in row tiles of Lq rounded to 16, token chunks of 64 through a "
                        "3-stage cp.async ring, the max in registers, across the quad by shuffles and across warps in "
                        "shared memory; one launch serves a query batch's gathered candidate spans or all pairs",
}
DESIGN["mlp_rowsblk"] = DESIGN["mlp_rows2d"]  # one kernel behind both wrappers

BESIDE = ("headline", "fused_mha_ms", "fused_mha_device_ms", "x_bound", "chain_ms", "fused_mlp_block_ms",
          "chain_device_ms", "fused_mlp_block_device_ms",
          "device_ms", "host_ms", "library_device_ms", "library_call", "floor_device_ms",
          "f32_p_vs_f32_plain_mean_abs", "batched_vs_f32_plain_mean_abs", "parts", "parts_total_ms",
          "library_chain_ms", "product_library_ms", "product_library_call", "colbert_shape_identical")


def run_phases(sz, device, card: str) -> dict:
    import torch

    from matchmaker_tpu_torch.ops import _build

    report = {"card": card, "clock": []}
    start = time.perf_counter()

    def mark(label):  # seconds from the start of the phases at the end of each
        report["clock"].append([label, round(time.perf_counter() - start, 1)])

    if device.type == "cuda":
        t0 = time.perf_counter()
        _build.library()
        report["build_s"] = time.perf_counter() - t0
        print(f"[build] kernels built and loaded in {report['build_s']:.1f} s ({_build.library_path().name})")
    kern = phase_encoder_kernels(sz, device)
    kern.update(phase_backward_kernels(sz, device))
    report["backward_parts"] = phase_backward_parts(sz, device)
    kern.update(phase_binmax_kernels(sz, device))
    kern.update(phase_int8_encoder_kernels(sz, device))
    kern.update(phase_int8_binmax_kernels(sz, device))
    kern.update(phase_maxsim_kernel(sz, device))
    kern.update(phase_maxsim_training(sz, device))
    kern.update(phase_mha_kernel(sz, device))
    phase_rerank_kernels(sz, device, kern)
    phase_rerank_kernels(sz, device, kern, sz["train_shapes"], "train")
    phase_int8_mlp_mix(sz, device, kern)
    kern.update(phase_head_width_kernels(sz, device))
    t0 = time.perf_counter()
    kern.update(phase_wide_width_kernels(sz, device))
    report["wide_widths"] = wide_width_summary(kern)
    report["wide_width_kernels_s"] = time.perf_counter() - t0
    print(f"[kernels] phase 3's new widths took {report['wide_width_kernels_s']:.1f} s")
    t0 = time.perf_counter()
    kern.update(phase_long_sequence_kernels(sz, device))
    report["long_sequence_kernels_s"] = time.perf_counter() - t0
    print(f"[kernels] phase 3's sequences past 512 took {report['long_sequence_kernels_s']:.1f} s")
    t0 = time.perf_counter()
    kern.update(phase_probe_kernels(sz, device))
    report["probe_kernels_s"] = time.perf_counter() - t0
    mark("3: kernels against their plain versions")
    with tempfile.TemporaryDirectory() as root:
        report["main"] = phase_main_path(sz, device, root)
        mark("4: the main path")
        report["main_int8"] = phase_main_path_int8(sz, device, root, os.path.join(root, "run"))
        mark("4b: int8 serving")
        report["colbert"] = phase_colbert(sz, device, root)
        mark("4c: ColBERT serving")
        t0 = time.perf_counter()
        report["jax_runs"] = phase_jax_runs(sz, device, root)
        report["jax_runs_s"] = time.perf_counter() - t0
        mark("13: JAX runs, MiniLM, TinyBERT, BERT-large and the new widths")
    print(f"[jax_runs] phase 13 took {report['jax_runs_s']:.1f} s")
    with tempfile.TemporaryDirectory() as root:
        report["long_docs"] = phase_long_documents(sz, device, root)
    mark("15: 2,000-token documents")
    report["scale"] = phase_scale(sz, device)
    report["scale_int8"] = phase_scale_int8(sz, device)
    mark("5, 5b: 1M-row searches")
    with tempfile.TemporaryDirectory() as root:
        report["train"] = phase_train(sz, device, root)
    mark("6: training")
    with tempfile.TemporaryDirectory() as root:
        report["train_colbert"] = phase_train_colbert(sz, device, root)
    mark("6b: ColBERT training")
    t0 = time.perf_counter()
    report["probes"] = phase_probes(sz, device)
    report["probes_s"] = time.perf_counter() - t0
    mark("7: the probes")
    print(f"[probes] the probes' kernels against their plain versions took {report['probe_kernels_s']:.1f} s, "
          f"their own path {report['probes_s']:.1f} s")
    with tempfile.TemporaryDirectory() as root:
        report["recipe"] = phase_recipe(sz, device, root)
    mark("8: the TAS-B recipe")
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as root:
        report["rerank"] = phase_rerank(sz, device, root)
    report["rerank_s"] = time.perf_counter() - t0
    mark("9: re-rankers")
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as root:
        report["pooling"] = phase_kernel_pooling(sz, device, root)
        report["pooling_s"] = time.perf_counter() - t0
        mark("10: kernel pooling and IDCM")
        t0 = time.perf_counter()
        report["zoo"] = phase_zoo(sz, device, root, report["pooling"].pop("paths"))
        report["zoo_s"] = time.perf_counter() - t0
        mark("12: the model zoo")
    print(f"[zoo] phase 12 took {report['zoo_s']:.1f} s")
    t0 = time.perf_counter()
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as root:  # the streaming blocks on disk
        report["indexes"] = phase_indexes(sz, device, root)
    report["indexes_s"] = time.perf_counter() - t0
    mark("11: the index layer")
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as root:
        report["multi"] = phase_multi_device(sz, device, root)
    print(f"[multi] phase 14 took {report['multi']['seconds']:.1f} s")
    mark("14: more than one device")
    print("[clock] seconds at the end of each phase: " + ", ".join(f"{k} {v}" for k, v in report["clock"]))
    check(set(report["main"]["launches"]) == {k[0] for k in KERNELS}, "a kernel without an entry")
    report["kernels"] = []
    for name, src, rep, inc in KERNELS:
        # "launches": the run of the kernel's own path: the bf16 serving run,
        # the int8 serving run that uses it (K9/K10 and K8: the mixed run,
        # K7: the two-stage run), the ColBERT serving run (K14) or the
        # training run, or for K15-K18 their probe's run; K13 lies on no
        # path; "launches_rerank": phase 9's runs (K1, K2, K11, K12 and the
        # student's dense retrieval); "launches_phase10": phase 10's IDCM runs
        # (K1, K2, K11, K12); "launches_phase11": phase 11's CLI runs over the IVF,
        # tree-AH, HNSW and streaming indexes (K1, K2); "launches_phase12": phase 12's runs (TK over bert_vectors,
        # listwise BERT_DOT, BERT_CAT with QA heads: K1, K2, K11, K12); "launches_phase14": phase 14's sharded
        # searches (one call a route: K3, K4, K6, K7, K8) and rank 0's steps in its two-process run (K1, K2, K11,
        # K12); "launches_phase15": phase 15's runs over 2,000-token documents (K1, K2, K9, K10, K11, K12, the
        # MaxSim training form and backward); "launches_scale": the scale search of the same route (bf16 or int8;
        # training and the probes: the bf16)
        runs = {"serve": report["main"]["launches"][name], "train": report["train"]["launches"][name],
                **{f"serve_int8_{r}": report["main_int8"][r]["launches"][name] for r, _, _ in INT8_RUNS},
                "serve_colbert": report["colbert"]["launches"][name],
                "train_colbert": report["train_colbert"]["launches"][name],
                "recipe": report["recipe"]["launches"][name],
                "probes": report["probes"]["launches"].get(name, 0),
                "rerank": report["rerank"]["launches"].get(name, 0),
                "phase10": report["pooling"]["launches"].get(name, 0),
                "phase11": report["indexes"]["launches"].get(name, 0),
                "phase12": report["zoo"]["launches"].get(name, 0),
                "phase13": report["jax_runs"]["launches"].get(name, 0),
                "phase14": report["multi"]["launches"].get(name, 0),
                "phase15": report["long_docs"]["launches"].get(name, 0)}
        scale_runs = {"scale_bf16": report["scale"]["launches"][name],
                      **{f"scale_int8_{r}": report["scale_int8"][r]["launches"][name]
                         for r, _, _ in SCALE_INT8_RUNS}}
        if name in SERVING:
            path, scale_path = "serve", "scale_bf16"
        elif name == "binmax_candidates_int8":
            path, scale_path = "serve_int8_int8_twostage", "scale_int8_int8"
        elif name in SERVING_INT8:
            path, scale_path = "serve_int8_mixed", "scale_int8_mixed"
        elif name == "maxsim_all_pairs":
            path, scale_path = "serve_colbert", "scale_bf16"
        elif name in ("maxsim_all_pairs_argmax", "maxsim_all_pairs_bwd"):
            path, scale_path = "train_colbert", "scale_bf16"
        elif name == "fused_mha":
            path, scale_path = None, "scale_bf16"
        elif name in PROBE_OF:
            path, scale_path = "probes", "scale_bf16"
        else:
            path, scale_path = "train", "scale_bf16"
        report["kernels"].append(
            {"name": name, "route": "cuda", "source": src, "replaces": rep, **({"includes": inc} if inc else {}),
             **({"design": DESIGN[name]} if name in DESIGN else {}),
             "path": path, "launches": runs[path] if path else 0, **{f"launches_{r}": v for r, v in runs.items()},
             "launches_scale": scale_runs[scale_path], **{f"launches_{r}": v for r, v in scale_runs.items()},
             "max_abs_err": kern[name]["max_abs_err"], "ms": kern[name]["ms"], "plain_ms": kern[name]["plain_ms"],
             "bound_ms": kern[name]["bound_ms"], "bound_by": kern[name]["bound_by"],
             "library_ms": kern[name].get("library_ms"),
             "timed_shape": kern[name]["timed_shape"], **{k: kern[name][k] for k in BESIDE if k in kern[name]}})
    # the attention cores' other head widths and the other hidden widths:
    # at width 32 on phase 13 (d)'s path (MiniLM: K1 and K12 in its training
    # run, K10 in its int8 forward; every launch there is at width 32), at
    # width 26 and hidden 312 on phase 13 (e)'s (TinyBERT: K1 and K9 in its
    # int8_mlp serving run, K1, K12 and K11 in its training run; every
    # launch there is at hidden 312), K13, K10 at 26 and the other widths on
    # none
    j = report["jax_runs"]
    runs = {"minilm": (j["minilm"]["launches"], j["minilm"]["int8_launches"]),
            "tinybert": (j["tinybert"]["serve_launches"], j["tinybert"]["launches"])}
    sources = {k[0]: (k[1], k[2]) for k in KERNELS}
    for name, counter, run in HEAD_WIDTH_KERNELS:
        on_path = run is not None and counter not in _OFF_PATH
        launches = sum(r.get(counter, 0) for r in runs[run]) if on_path else 0
        if on_path and device.type == "cuda":
            check(launches > 0, f"phase 13's {run} run launched no {counter} kernel ({name})")
        e = kern[name]
        report["kernels"].append(
            {"name": name, "route": "cuda", "source": sources[counter][0], "replaces": sources[counter][1],
             **{k: e[k] for k in ("head_dim", "padded_to") if k in e}, "path": run if on_path else None,
             "launches": launches, "max_abs_err": e["max_abs_err"], "ms": e["ms"], "plain_ms": e["plain_ms"],
             "bound_ms": e["bound_ms"], "bound_by": e["bound_by"], "library_ms": e.get("library_ms"),
             "timed_shape": e["timed_shape"], "device_ms": e.get("device_ms"), "x_bound": e.get("x_bound")})
    report["kernels"] += wide_kernel_entries(report["jax_runs"]["bert_large"], kern, device)
    report["kernels"] += long_kernel_entries(report["long_docs"], kern, device)
    report["kernel_timings"] = {k[0]: kern[k[0]]["timings"] for k in KERNELS}
    report["kernel_timings"].update({k: kern[k]["timings"] for k in kern
                                     if k.split("@", 1)[-1] in WIDE_TAGS | {"long"}})
    if report["scale"]["level2_reduce"]:
        report["kernel_timings"]["level2_reduce"].append(dict(report["scale"]["level2_reduce"], path="scale_bf16"))
    report["torch"] = torch.__version__
    return report


def print_rerank(card, report) -> None:
    rr = report["rerank"]
    bc, te, st = rr["bert_cat"], rr["teacher"], rr["student"]
    print(f"[{card}] BERT_CAT train {bc['cli_triples_per_s']:.1f} triples/s through cli.train's Trainer (validation "
          f"included), {bc['device_triples_per_s']:.1f} triples/s device-only at batch {FULL['rerank_batch']} "
          f"({FULL['rerank_query_len']} + {FULL['rerank_doc_len']} tokens, two passes a triple); kernels vs plain: "
          f"loss gap {bc['plain_loss_gap']:.3g}, worst gradient cosine {bc['plain_grad_cos']:.6f}; overfit "
          f"{bc['overfit_first']:.4g} -> {bc['overfit_last']:.4g}")
    print(f"[{card}] teacher scoring {te['pairs_per_s']:.1f} pairs/s through score_triples ({te['timed_triples']} "
          f"triples), pairwise accuracy {te['pairwise_accuracy']:.4f}, scores vs plain cosine {te['scores_cos']:.6f} "
          f"max |d| {te['scores_max_abs']:.4g}; Margin-MSE student loss {st['loss_first']:.4f} -> "
          f"{st['loss_last']:.4f}")
    for model in RERANK_MODELS:
        r = rr[model]
        print(f"[{card}] {model}: {r['cli_triples_per_s']:.1f} triples/s through the Trainer, eval scores vs plain "
              f"cosine {r['eval_cos']:.6f} max |d| {r['eval_max_abs']:.4g}")


def print_pooling(card, report) -> None:
    pool, idcm = report["pooling"]["pooling"], report["pooling"]["idcm"]
    for name in ("tk", "knrm"):
        r = pool[name]
        print(f"[{card}] {name.upper()} train {r['cli_triples_per_s']:.1f} triples/s through cli.train's Trainer "
              f"(validation included), {r['device_triples_per_s']:.1f} triples/s device-only at batch "
              f"{FULL['pool_batch']} (query {FULL['rerank_query_len']}, doc {FULL['rerank_doc_len']}, "
              f"{FULL['pool_vocab']} x {FULL['pool_dim']} embeddings); overfit {r['overfit_first']:.4g} -> "
              f"{r['overfit_last']:.4g}")
    print(f"[{card}] kernel pooling, card vs CPU scores (worst cosine "
          f"{min(pool[n]['cpu_cos'] for n in POOLING_MODELS):.7f}, max |d| "
          f"{max(pool[n]['cpu_max_abs'] for n in POOLING_MODELS):.3g}); exact-match activation min "
          f"{min(pool[n]['exact_match_min'] for n in POOLING_MODELS):.6f}; TKL "
          f"{pool['tkl']['cli_triples_per_s']:.1f} triples/s through the Trainer")
    s1 = idcm["stage1"]
    print(f"[{card}] IDCM cascade {idcm['cascade']['pairs_per_s']:.1f} pairs/s at batch "
          f"{idcm['cascade']['eval_batch']}, full path {idcm['full']['pairs_per_s']:.1f} pairs/s at batch "
          f"{idcm['full']['eval_batch']} ({FULL['pool_long_words']}-token documents); cascade vs plain cosine "
          f"{idcm['cascade']['eval_cos']:.6f} max |d| {idcm['cascade']['eval_max_abs']:.4g}; stage 1 "
          f"{s1['device_triples_per_s']:.1f} triples/s device-only, {s1['cli_triples_per_s']:.1f} through the "
          f"Trainer, worst gradient cosine {s1['plain_grad_cos']:.6f}; stage 2 replay "
          f"{idcm['stage2']['replay']['cli_triples_per_s']:.1f} triples/s (write "
          f"{idcm['stage2']['write']['cli_triples_per_s']:.1f})")


def print_indexes(card, report) -> None:
    ix = report["indexes"]
    k, n = FULL["scale_k"], FULL["scale_rows"]
    print(f"[{card}] index kinds through the CLI ({FULL['passages']} passages, top-{FULL['top_n']}): " + ", ".join(
        f"{kind} recall {r['recall@%d' % FULL['top_n']]:.4f}, {r['run']['search_qps']:.1f} QPS"
        for kind, r in ix["cli"].items() if kind != "launches"))
    print(f"[{card}] index routes at {n} x {FULL['hid']}, Q 256, k {k}: " + ", ".join(
        f"{name} build {r['build_s']:.2f} s, {r['index_bytes'] / 1e9:.3f} GB, {r['qps']:.1f} QPS, recall@{k} "
        f"{r[f'recall@{k}']:.4f} ({r['reference']})" for name, r in ix["scale"].items()))


def print_zoo(card, report) -> None:
    zoo = report["zoo"]
    print(f"[{card}] classic models through the Trainer at batch {FULL['pool_batch']} (query {FULL['rerank_query_len']}, "
          f"doc {FULL['rerank_doc_len']}, {FULL['pool_vocab']} x {FULL['pool_dim']} embeddings), device-only "
          "triples/s: " + ", ".join(f"{n} {zoo['classic'][n]['device_triples_per_s']:.1f}" for n in ZOO_MODELS)
          + f"; DRMM histogram entries moved on the card {zoo['classic']['drmm']['histogram_moved']} of "
          f"{zoo['classic']['drmm']['histogram_entries']}")
    ctx = zoo["contextual"]
    print(f"[{card}] TK over bert_vectors: frozen {ctx['tk_vectors_frozen']['device_triples_per_s']:.1f}, trainable "
          f"{ctx['tk_vectors_trainable']['device_triples_per_s']:.1f} triples/s device-only (worst gradient cosine "
          f"{ctx['tk_vectors_trainable']['plain_grad_cos']:.6f}); KNRM over bert_embedding "
          f"{ctx['knrm_bert_embedding']['cli_triples_per_s']:.1f} triples/s through the Trainer")
    print(f"[{card}] listwise BERT_DOT ({FULL['list_queries']} lists x {FULL['list_size']}): " + ", ".join(
        f"{loss} {zoo['listwise'][loss]['device_lists_per_s']:.1f} lists/s device-only, positive first "
        f"{zoo['listwise'][loss]['positive_first_after']:.2f} after the overfit" for loss in LIST_LOSSES))
    qa = zoo["qa"]
    print(f"[{card}] BERT_CAT + QA heads: {qa['weighted']['device_triples_per_s']:.1f} (weighted) / "
          f"{qa['lambda']['device_triples_per_s']:.1f} triples/s device-only, QA EM {qa['weighted']['qa_em']:.4f} F1 "
          f"{qa['weighted']['qa_f1']:.4f}; span loss overfit {qa['weighted']['overfit_first']:.4f} -> "
          f"{qa['weighted']['overfit_last']:.4f}; phase 12 {report['zoo_s']:.1f} s")


def print_jax_runs(card, report) -> None:
    jr = report["jax_runs"]
    a, b, c, d, e = jr["jax_run"], jr["hub_teacher"], jr["fused_check"], jr["minilm"], jr["tinybert"]
    print(f"[{card}] JAX run folder: best-model.flax served bit for bit as the .npz; warm start + accumulation "
          f"(k {FULL['accum_k']}, batch {FULL['accum_batch']}) {a['train']['cli_triples_per_s']:.1f} triples/s "
          f"through the Trainer, accumulated vs big-batch update worst cosine "
          f"{a['accumulated_vs_big']['update_cos']:.6f}; hub teacher: student {b['cli_triples_per_s']:.1f} "
          f"triples/s with the ColBERT teacher; fused effectiveness check (mini) MRR@10 {c['MRR@10']:.4f}; "
          f"MiniLM BERT_CAT {d['cli_triples_per_s']:.1f} triples/s through the Trainer, eval cosine "
          f"{d['eval_cos']:.6f}, int8 eval cosine {d['int8_eval_cos']:.6f}, worst gradient cosine "
          f"{d['plain_grad_cos']:.6f}; TinyBERT-4L-312D int8_mlp encode {e['encode_psg_per_s']:.1f} psg/s (cosine "
          f"{e['encode_cos']:.6f} to plain), BERT_DOT {e['train']['cli_triples_per_s']:.1f} triples/s through the "
          f"Trainer, worst gradient cosine {e['train']['plain_grad_cos']:.6f} ({e['seconds']:.1f} s); phase 13 "
          f"{report['jax_runs_s']:.1f} s")
    f = jr["bert_large"]
    print(f"[{card}] BERT-large (24 x 1,024, 16 heads of 64, FF 4,096; a seeded checkpoint): int8_mlp encode "
          f"{f['encode_psg_per_s']:.1f} psg/s through cli.dense_retrieval (cosine {f['encode_cos']:.6f} to plain), "
          f"BERT_DOT {f['train']['device_triples_per_s']:.1f} triples/s device-only, "
          f"{f['train']['cli_triples_per_s']:.1f} through the Trainer, worst gradient cosine "
          f"{f['train']['plain_grad_cos']:.6f}; the new widths: "
          + "; ".join(f"{w['hidden']}/{w['heads']}/{w['ff']} encode cosine {w['encode_cos']:.6f}, gradient cosine "
                      f"{w['plain_grad_cos']:.6f}" for w in f["widths"].values()) + f" ({f['seconds']:.1f} s)")


def print_long_docs(card, report) -> None:
    ld, k = report["long_docs"], FULL["top_n"]
    sv, bd, cb = ld["serve"], ld["bert_dot"], ld["colbert"]
    print(f"[{card}] phase 15, {FULL['long_doc_len']}-token documents (DistilBERT widths, {FULL['long_positions']} "
          f"positions): BERT_DOT through cli.dense_retrieval bf16 {sv['bf16']['encode_psg_per_s']:.1f} psg/s "
          f"(recall@{k} {sv['bf16'][f'recall@{k}']:.4f}), int8_mlp {sv['int8_mlp']['encode_psg_per_s']:.1f} psg/s "
          f"(recall@{k} {sv['int8_mlp'][f'recall@{k}']:.4f}); BERT_DOT training "
          f"{bd['device_triples_per_s']:.1f} triples/s device-only ({bd['step_ms']:.2f} ms a step, worst gradient "
          f"cosine {bd['plain_grad_cos']:.6f}), ColBERT {cb['device_triples_per_s']:.1f} ({cb['step_ms']:.2f} ms, "
          f"{cb['plain_grad_cos']:.6f}); phase 15 {ld['seconds']:.1f} s; phase 3's sequences past 512 "
          f"{report['long_sequence_kernels_s']:.1f} s")


def print_multi(card, report) -> None:
    mu = report["multi"]
    flat, ivf, gloo = mu["flat"], mu["ivf"], mu["processes"]["gloo_one_card"]
    nccl = mu["processes"]["nccl_two_cards"]
    print(f"[{card}] phase 14: {FULL['multi_shards']} shards of {FULL['scale_rows'] // FULL['multi_shards']} rows on "
          f"one card (not a multi-card rate), QPS sharded / unsharded: " + ", ".join(
              f"{r} {flat[r]['qps_four_shards_one_card']:.1f} / {flat[r]['qps_unsharded']:.1f} (recall "
              f"{flat[r]['recall']:.4f}, {flat[r]['hits_not_unsharded']} hits not unsharded)"
              for r, _, _ in MULTI_ROUTES)
          + f"; IVF sharded recall vs unsharded {ivf['ivf']['recall_vs_unsharded']:.4f}, tree-AH "
          f"{ivf['tree_ah']['recall_vs_unsharded']:.4f}; two processes over {gloo['backends'][0]} on one card: "
          f"{gloo['triples_per_s_host_paced']:.1f} triples/s (host-paced), one step vs one process loss gap "
          f"{gloo['loss_rel_gap']:.3g}, worst update cosine {gloo['update_cos']:.6f}; nccl on two cards: "
          f"{nccl if isinstance(nccl, str) else 'backends ' + str(nccl['backends'])}; phase 14 {mu['seconds']:.1f} s")


def main() -> int:
    import torch

    if sys.argv[1:2] == ["--two-process-worker"]:
        sys.path.insert(0, ROOT)
        return two_process_worker(sys.argv[2])
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this smoke run needs an NVIDIA GPU",
              file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import matchmaker_tpu_torch  # noqa: F401  (fails outside a checkout of the repository)

    card = card_line()
    print(card)
    torch.set_float32_matmul_precision("highest")
    device = torch.device("cuda")
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    report = run_phases(FULL, device, card)
    main_, scale = report["main"], report["scale"]
    print(f"[{card}] encode {main_['encode_psg_per_s']:.1f} psg/s end to end in the CLI "
          f"(tokenization included), {main_['encode_device_psg_per_s']:.1f} psg/s device-only at "
          f"{FULL['batch']}x{FULL['doc_len']}")
    print(f"[{card}] search {main_['search_qps']:.1f} QPS in the CLI (16,384 rows, top-{FULL['top_n']} and "
          f"top-{FULL['top_n_small']} sets, query encode included); {scale['qps']:.1f} QPS FlatIndex.search_rows and "
          f"{scale['device_qps']:.1f} QPS device-only at {FULL['scale_rows']} rows, k={FULL['scale_k']}")
    train = report["train"]
    print(f"[{card}] train {train['cli_triples_per_s']:.1f} triples/s through cli.train's Trainer (validation "
          f"included), {train['device_triples_per_s']:.1f} triples/s device-only at batch {FULL['train_batch']} "
          f"(query {FULL['train_query_len']}, doc {FULL['train_doc_len']})")
    tc = report["train_colbert"]
    print(f"[{card}] ColBERT train {tc['cli_triples_per_s']:.1f} triples/s through cli.train's Trainer (validation "
          f"included), {tc['device_triples_per_s']:.1f} triples/s device-only at batch {FULL['train_batch']} "
          f"(query {FULL['train_query_len']}, doc {FULL['train_doc_len']}, compression 128); kernels vs plain: loss "
          f"gap {tc['plain_loss_gap']:.3g}, worst gradient cosine {tc['plain_grad_cos']:.6f}; overfit "
          f"{tc['overfit_first']:.4g} -> {tc['overfit_last']:.4g}")
    rc = report["recipe"]
    print(f"[{card}] TAS-B recipe ({rc['n_docs']} docs, {rc['model']}): MRR@10 {rc['MRR@10']:.4f}, Recall@100 "
          f"{rc['Recall@100']:.4f}, teacher pairwise accuracy {rc['teacher_pairwise_accuracy']:.4f}, "
          f"{rc['clusters']} clusters, stages (s) {rc['timings_s']}; effectiveness check MRR@10 "
          f"{rc['effectiveness']['MRR@10']:.4f}")
    int8, scale8 = report["main_int8"], report["scale_int8"]
    print(f"[{card}] int8 encode {int8['mixed']['encode_psg_per_s']:.1f} psg/s end to end in the CLI, "
          f"{int8['encode_device_psg_per_s']:.1f} psg/s device-only at {FULL['batch']}x{FULL['doc_len']} "
          f"(bf16 halves: {main_['encode_device_psg_per_s']:.1f}, int8 / bf16 "
          f"{int8['encode_device_psg_per_s'] / main_['encode_device_psg_per_s']:.3f}); int8 search at "
          f"{FULL['scale_rows']} rows, "
          f"k={FULL['scale_k']}: " + ", ".join(
              f"{r} recall@{FULL['scale_k']} {scale8[r]['recall']:.4f}, {scale8[r]['qps']:.1f} QPS search_rows, "
              f"{scale8[r]['device_qps']:.1f} device-only" for r, _, _ in SCALE_INT8_RUNS))
    col = report["colbert"]
    print(f"[{card}] colbert: {col['token_rows']} token rows ({col['index_device_bytes'] / 1e9:.3f} GB bf16 on the "
          f"card), encode {col['encode_psg_per_s']:.1f} psg/s and search {col['search_qps']:.1f} QPS in the CLI "
          f"(rescore included: {col['rescore_ms_per_batch']:.3f} ms a batch of {FULL['colbert_query_batch']} "
          f"queries), device-only per-token search {col['token_search_device_qps']:.1f} QPS; per-token "
          f"recall@{FULL['colbert_candidates']} {col['token_recall']:.4f}, recall@{FULL['colbert_top_n']} vs "
          f"exhaustive MaxSim {col['recall@10_vs_exhaustive']:.4f}")
    print_rerank(card, report)
    print_pooling(card, report)
    print_indexes(card, report)
    print_zoo(card, report)
    print_jax_runs(card, report)
    print_multi(card, report)
    print_long_docs(card, report)
    for k in report["kernels"]:
        device = (f" (device {k['device_ms']:.4f} ms, {k['x_bound']:.2f}x bound; library device "
                  f"{_fmt(k.get('library_device_ms'))})" if k.get("x_bound") else "")
        print(f"[{card}] {k['name']}: kernel {k['ms']:.4f} ms{device}, plain {k['plain_ms']:.4f} ms, bound "
              f"{k['bound_ms']:.4f} ms ({k['bound_by']}) at {k['timed_shape']}, max |d| {k['max_abs_err']:.3g}, "
              f"launches {k['launches']} in its path's run ({k['path']})" + (
                  f", {k['launches_rerank']} in phase 9's runs, {k['launches_phase10']} in phase 10's, "
                  f"{k['launches_phase11']} in phase 11's, {k['launches_phase12']} in phase 12's, "
                  f"{k['launches_phase13']} in phase 13's, {k['launches_phase14']} in phase 14's, "
                  f"{k['launches_phase15']} in phase 15's, "
                  f"{k['launches_scale']} in the scale search"
                  if "launches_scale" in k else f" ({k['name'].split('@', 1)[1]})"))
    with open(os.path.join(ROOT, "build", "chip_smoke.json"), "w") as f:
        json.dump(report, f, indent=1)
    print(json.dumps({"kernels": report["kernels"]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
