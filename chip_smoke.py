#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (sparse_vae_tpu_torch) on one NVIDIA
GPU:

    python3 chip_smoke.py [--k4-parent DIR]
    python3 chip_smoke.py --generic-parent DIR
    python3 chip_smoke.py --dense-parent DIR
    python3 chip_smoke.py --compare BEFORE.log AFTER.log

--generic-parent runs the kernels-generic phase (9a) alone, in another
checkout DIR (its own script, package and build) and in this one, in the
order parent, this, this, parent, and prints each shared row's times
side by side.

--dense-parent does the same for the dense causal route: `dense_phase`
at the lm-kernels shapes (Dh 64: the r4 geometry's full rows,
draft-tlm-r5's ragged rows, lm-serve's [1, 8, 512, 64]) and at
[14, 4, 3584, 128], each tree running its own kernels for the route, then
`profile_train geometry=real-prose-lm-r4 batch=14 seq=3584`, in the
order parent, this, this, parent; it prints each shape's forward and
backward times from every run and every run's r4 step.

--compare reads two of this script's logs (no card needed) and prints,
phase by phase, the seconds of each and the timing and memory numbers
of its JSON lines (`COMPARED_KEYS`), the first log's beside the second's.

Phases, each timed:
  1. device  — the card's name and power limit (nvidia-smi); exits non-zero
               without CUDA;
  2. build   — the CUDA kernels from csrc/, one nvcc process per source,
               all started together, then one link; the `ptxas info`
               lines (nvcc -Xptxas -v) give registers, spills and static
               shared memory of every kernel;
  3. kernels — each kernel against its plain PyTorch version on the card,
               at the shapes the serving path gives it, timed with CUDA
               events beside its bound and, for K1, beside PyTorch's
               scaled_dot_product_attention (a yardstick the port never
               calls); K1's rows also give its device time from
               torch.profiler, without the wrapper's host cost;
               The training kernels likewise: K2 (the attention backward)
               and K3/K3b (the fused tied projection + CE, forward and
               backward) against their plain versions at the token counts
               of the train, sp-train and [8, 12800] steps, timed at the
               last beside a PyTorch yardstick; K2, K3 and K3b must give
               bit-identical results in two calls, and the K2 and K3b
               rows give their device time by part (K2: dq, dk/dv with the
               [CLS] partials, reduce, PyTorch; K3b: dl, dg, dE, dbias,
               PyTorch's copies); K4 (the selection) at the serving batch
               [64, 32768] (T 1.0 and 0.7), at a 512-token Jacobi
               window's [512, 32768], at the mass-sampling batch
               [1000, 32768] and at 8 such windows' [4096, 32768], by
               events and torch.profiler beside its bound, and for
               correctness alone at [1, 512],
               [133, 32768] and [3, 50000], without noise and at top_p
               1e-3 too, every row bit-identical across two calls; its
               two instantiations (a cluster of two CTAs a row, one CTA a
               row) timed against each other at 16 to 4,096 rows;
               with --k4-parent DIR, DIR's K4 (another checkout's
               csrc/nucleus_select.cu) is built alone into this
               checkout's _build/ and timed beside this one at the timed
               shapes, in the order parent, this, this, parent;
  4. model   — the flagship real-prose-vae-r5 weights on the card in bf16:
               prefill logits against the fp32 CPU model on a fixed input;
  5. serve   — ServeEngine (batch 64, max_length 512, fused selection)
               answers requests, some with >= 128-token prompts so bulk
               prefill runs K1; every request must complete and both
               kernels' launch counts, zeroed just before, must rise;
  6. train   — r5 in its training form (fp32 master weights, bf16
               compute) at full width and depth takes optimizer steps on
               [4, 4096] ragged random documents through K1, K2, K3 and
               K3b (their counts, zeroed just before, must rise); step 1's
               loss and all 165 gradients are held against the same step
               in fp32 through the plain versions on the card.
The Dh = 128 geometry (bench.py --heads 4, built from the JAX
initialisation with no archive; its decoder attention takes the packed
layout):
  7. kernels — K5 and K5b (the packed attention forward and backward:
               K1's kernel and K2's kernels at Dh = 128 on the packed
               layout) against their fp32 plain versions at three shapes
               up to [8, 12800, 4 * 128] on full rows, each timed by CUDA
               events and by torch.profiler's device time beside its bound
               and SDPA (forward and backward) under the band mask; K5b
               bit-identical across two calls, its device time by part as
               K2's;
  8. serve   — ServeEngine answers the same requests through bulk prefill
               (K5) and fused selection (K4); the bf16 prefill logits are
               held against the fp32 plain model on the card;
  9. train   — 3 optimizer steps at [4, 4096] through K5, K5b, K3 and K3b
               (K5 and K5b 6 launches a step), step 1 held against the fp32
               plain step as in phase 6.
Every other attention shape inside the JAX gates up to Dh 512 (the
generic pair of csrc/swa_generic.cu; K1/K2's head-major Dh 128
instantiation), and the Dh = 256 model (bench.py --heads 2, packed, from
the JAX initialisation):
  9a. kernels-generic — the generic forward and backward through the
               wrappers against their fp32 plain versions at K1's and
               K2's tolerances, bit-identical across two calls, each shape
               timed (events, device time, the backward by part: delta,
               dq, dk/dv, reduce; with the [CLS] slot dk/dv also by
               band, [CLS] chunks and reduce, the band from the same
               call without the slot) beside its bound, the plain
               versions and SDPA under the band mask where SDPA takes
               it: packed Dh 256 at K5's three shapes, head-major Dh 32
               (--heads 16) on full [8, 16, 12800] rows, block 256 at
               head-major Dh 64 and packed Dh 128 (causal and
               bidirectional, ragged), packed Dh 512 at [2, 2048],
               head-major Dh 24 (zero padding), Dh 40 at block 384
               (bidirectional), packed Dh 256 at block 384, K6's banded
               form at Dh 256 (q_off, the broadcast [CLS] block; the
               profiled forward and backward the generic kernels alone)
               and the dense causal route at Dh 32, 28 and 27 blocks
               (beside SDPA is_causal); the build phase prints each
               generic kernel's registers and spills. --generic-parent
               DIR runs this phase alone in DIR and here, DIR, this,
               this, DIR;
  9b. kernels-hm128 — K1/K2 at head-major Dh 128 likewise at
               [8, 4, 12800, 128] ragged and K6 banded at Dh 128; the
               dense causal pair at [14, 4, 3584, 128]; then the layers
               that take them, counted alone: a sparse layer of --heads 4
               over model 2 (K1/K2) and a dense causal Dh 128 layer (the
               dense causal pair), forward and backward;
  9c. model-h2 — the bf16 prefill logits of the Dh = 256 model (the
               generic forward) against the fp32 plain model on the card;
  9d. serve-h2 — ServeEngine answers phase 5's requests through bulk
               prefill (the generic forward) and fused selection (K4);
  9e. train-h2 — 3 optimizer steps at [4, 4096] through the generic pair
               (6 + 6 launches a step), K3 and K3b, step 1 held against
               the fp32 plain step as in phase 6.
Sequence parallelism, r5 at the pg19 preset's document shape (one
102,400-token document per micro-batch, 4 length shards of 25,600):
 10. kernels — K6 (the shard attention: one K1 launch with q_off and the
               broadcast [CLS] block as a slot of its own; its backward
               one K2 launch set with the same slot) forward and backward
               against its plain version on the banded branch at the shard
               shape q [1, 8, 25600, 64] over k_ext [1, 8, 25728, 64], on
               the square branch (shard 0), on ragged rows with a partial
               [CLS] (77 keys) and a filler row, and at windows 1 and 3;
               the backward bit-identical across two calls, and on a
               banded shard the profiled forward K1's kernel alone and the
               backward K2's kernels alone (no cuBLAS, no aten
               elementwise); timed beside its bound and SDPA over
               [CLS | k_ext] under the boolean band mask (a yardstick the
               port never calls);
 11. sp-train — one unsharded kernel step of r5 on a seeded document
               [1, 102400] (K1/K2 at [1, 8, 102400, 64]), then 4 ranks
               on this card (gloo: they share it; the spawn of phases
               37-43, so this phase runs with them, last) take the same
               step with the same weights, document and eps, and 1 more;
               the same pair again in fp32 through the plain versions.
               fp32: all 165 summed gradients at cosine >= 0.99, loss to
               1e-5; kernels: loss within 1e-3 relative, gradients at
               cosine >= 0.99 wherever the unsharded kernel step is itself
               that close to fp32 (see sp_train_plan); parameters bitwise
               equal across ranks, K6 launched on ranks 1-3, K1/K2 on rank
               0, K3/K3b on every rank.
The trainer loop (training/trainer.py) on bucketed document batches: a
stand-in corpus of 200 seeded documents of ids (no tokenizer needed),
lengths log-uniform over r5's 512-50,000 tokens, through the
data module's prepare_corpus, length buckets and accumulation groups;
the model from the JAX initialisation, configured by cli.assemble_config
on a run's meta.json:
 12. fit     — r5's hparams (tokens_per_batch 100,000, accumulate 2): 2
               steps of fit, validating and saving at steps 1 and 2,
               through K1, K2, K3 and K3b (their counts from the groups
               and validation batches fit ran); validation through the
               kernels against the plain versions on the same parameters
               and noise (val_nll and val_kl within 0.1%); the step-1
               checkpoint restored bit for bit and one step from it equal
               to the same step from the saved state; export_archive then
               load_run(<dir>): serving logits equal to the trained
               model's own; the shapes fed, real tokens/s, validation and
               checkpoint seconds and peak memory printed;
 13. fit-pg19 — pg19-fb8's hparams (102,400-token concatenated streams,
               tokens_per_batch 102,912, accumulate 4): 2 steps and one
               validation, every group [4, 1, 102400].
Evaluation (models/vae.py's estimators, test.py), on documents that
repeat a 100-id segment, each through the kernels against the plain
versions on the same eps:
 14. eval    — estimate_log_prob_iw of r5's trained weights on 4 ragged
               rows of up to 12,800 tokens, 8 samples in 2 chunks (16
               stacked rows a call; K1 6 x 2, K3 2 launches): the
               per-token IWAE NLL within 0.1% of the plain versions',
               where the plain run without the band's older block must
               move it by 1% or more; token-samples/s printed, and the
               time of test.py's default (100 samples in 100 chunks) on
               [8, 12800];
 15. eval-pg19 — the same on pg19-fb8's weights at one 102,400-token
               document, 4 samples in 4 chunks; its power check drops the
               query's own band block (pg19-fb8 hardly reads the older
               one on these documents);
 16. dreg    — K3/K3b alone at 102,400 tokens with the DReG kind of
               upstream gradient (w~ / num_tokens, a value per sample and
               document), then one r5 step with train_mc_samples 4 over
               [2, 12800] (102,400 token rows; K1 12, K2 6, K3 2, K3b 1)
               against the fp32 plain step as the train phases hold
               theirs, the bf16 plain step's distance from it beside,
               then 3 timed steps (seconds, real tokens/s, memory);
 17. test-entry — `sparse_vae_tpu_torch.test`'s main on the checkpoint
               the fit phase saved, with its stand-in corpus, 8 samples
               in 2 chunks: a finite, positive average, K1 and K3
               launched once a layer and once per chunk of every batch.
The Transformer LM family: draft-tlm-r5 (trained weights; d_model 256, 4
heads, 2 dense causal layers) and real-prose-lm-r4's geometry (meta
only; d_model 512, 8 heads, 6 dense layers; the JAX initialisation).
Phase 18 runs right after phase 3, beside the other kernel checks (a
process that has run many profiled phases has seen torch.profiler drop
the same records in every retake); phases 19-22 run last:
 18. lm-kernels — K3/K3b at their D = 256 instantiation against their
               plain versions at 16,384 and 50,176 tokens with padding
               tails, bit-identical across two calls, timed at 50,176
               beside F.linear + F.cross_entropy; the dense causal pair
               (csrc/causal_fwd.cu, causal_bwd.cu: the dense causal route,
               a causal band of L / 128 = 28 blocks with no [CLS] slot, at
               Dh 64 and 128) at [14, 8, 3584, 64] on full rows,
               [13, 4, 3584, 64] on ragged ones and lm-serve's
               [1, 8, 512, 64], against its plain versions, bit-identical
               across two calls, counted in the dense counters alone, its
               profiled calls holding no band kernel's record, timed
               (events, device time, the backward by part: delta, the
               pass, the dq rounding) beside SDPA with is_causal, forward
               and backward, with the bound;
 19. lm-serve — draft-tlm-r5's bf16 logits at [1, 512] (the dense route)
               against the fp32 CPU model; 12 requests through
               ServeEngine at batch 64, max_length 512, four of them
               bulk-prefilled at 512 positions (the dense causal forward
               once a layer each), selection through K4;
 20. lm-train — one bf16 step of draft-tlm-r5 at [13, 3584] and one of
               the r4 geometry at [4, 3584] through the dense causal pair
               and K3/K3b, each against the fp32 plain step on the
               same batch and dropout masks (loss 0.1%, every gradient at
               cosine >= 0.99 or the near-zero rule);
 21. lm-fit  — Trainer.fit at r4's meta.json hparams from the JAX
               initialisation, 4 steps on the stand-in corpus (documents
               of 512-3,125 ids padded to 512), validating and saving at
               steps 2 and 4; the last validation through the kernels
               against the plain versions (val_nll 0.1%); draft-tlm-r5 on
               documents of its own text at the validation batches'
               shapes against the plain versions, where cutting the plain
               attention to the diagonal block must move the NLL of the
               queries at the first 8 positions of each block by 1% or
               more;
 22. lm-test-entry — `sparse_vae_tpu_torch.test transformer-lm` on
               lm-fit's checkpoint: a finite, positive average, K1 once a
               layer and K3 once a batch; each of its batch shapes held
               as phase 21 holds draft-tlm-r5.
Sampling (models/generation.py's lockstep loop, serving.py's continuous
batching, the `sample` entry, the trainer's sampling callback), each in
a temporary working directory with a stand-in tokenizer (the checks read
ids):
 23. sample  — `sparse_vae_tpu_torch.sample transformer-vae
               real-prose-vae-r5`: one lockstep batch of 1000 x 256 (K4
               at [1000, 32768] once a step) and 2,000 documents through
               1,000 continuously refilled rows (at least one refill a
               row: the VAE's new z drawn into a live row), each saving
               its dataset;
               new tokens/s and document lengths printed; the lockstep
               batch again with every K4 choice held against the plain
               selection on the same penalised logits and noise (the
               entry's documents again), K4 timed on one step's logits,
               a profiled window of lockstep steps; at 64 x 128 the
               lockstep and continuous documents of one seed and z
               equal;
 24. sample-lm — the same, without the profile, for draft-tlm-r5 at 64
               rows and 128 documents; then Trainer.fit of its hparams for 2 steps
               with the sampling callback at step 2: an
               unconditional_sample record, no train_bleu, no
               sampling_error;
 25. sample-long — pg19-fb8's sample_resumable at batch 1, max_length
               102,400, no end token: 512 positions in one call and in
               two slices of 512, the buffers bit for bit.
Parallel and speculative decoding (models/parallel_decode.py,
models/spec_decode.py) through the `gen_bench` entry's rows, end token
-1, so that every mode makes seq - 1 tokens; passes, seconds and
launches of every mode printed:
 26. decode-r5 — r5 at batch 1 x 256: greedy ar, frontier (window
               128), frontier_draft3 and jacobi_full (chunk 128; sparse K1
               6 launches an iteration), each held against ar: where one
               differs, AR's two leading logits at the first differing
               position lie within GREEDY_TIE_MARGIN; sampled (top_p 0.9,
               penalty 1.2) frontier, frontier_fused (K4 at [128, 32768]
               once a pass) and speculative_draft3; frontier_fused again
               at batch 8 x 128 (K4 at [1024, 32768]); both fused runs
               again
               with every K4 choice held against the plain selection, the
               same tokens and passes;
 27. decode-spec — r5 verifying draft-tlm-r5's 8-token drafts
               (spec_draft_generate) at batch 1 x 64, greedy (held
               against decode-r5's AR) and sampled: passes, accepted
               drafts, tokens per pass; then the `sample` entry with
               spec_draft=transformer-lm:draft-tlm-r5 for 2 documents of
               64;
 28. decode-lm — draft-tlm-r5's full-document Jacobi at batch 1 x 512:
               greedy (the dense causal forward, 2 launches an iteration) held
               against its ar, and sampled with fused_select (K4 on every
               dirty chunk of 128), every K4 choice held.
The LSTM family (ops/rnn.py, models/lstm_lm.py, models/lstm_vae.py): the
lstm-benchmark preset's LSTM-VAE (d_model 1024, d_embedding 512, a
bidirectional 2 x 256 encoder, latent 64, vocab 32,768, tied embeddings
and logits, init_scale None: the JAX initialisation, seeded) at the
default data's 50,000 tokens a batch and documents of up to 25,000
tokens, and draft-lstm-r4's LSTM LM (meta.json only: 2 layers, d_model
256). The recurrence runs through torch's fused RNN (cuDNN, its TF32
off: fp32 as in the JAX package); its plain version is the step loop,
which no path runs on the card (the `rnn_step_loop` counter stays 0 on
every path; the oracle's calls move it):
 29. lstm-ops — the decoder's StackedRNN (in 576, H 1024) against the
               step loop at [4, 4096], forward and backward, then timed at
               [2, 25000] (ms, tokens/s); the masked BiLSTMEncoder at 1 and
               2 layers over ragged rows with an empty one against each
               row's trimmed step loop; a GRU stack; single decode steps
               against the scan;
 30. lstm-train — step 1 of the LSTM-VAE at [4, 4096] from the JAX
               initialisation, the fused RNN against the step loop on the
               same batch and eps (loss 0.1%, every gradient at cosine >=
               0.99 unless numerically zero); 2 timed steps at [2, 25000]
               (seconds, real tokens/s, peak memory); one step of
               draft-lstm-r4's LM at [13, 3584], held the same way;
 31. lstm-fit — Trainer.fit at lstm-benchmark on a stand-in corpus: 2
               steps, validating, saving and reconstructing every step;
               the step-1 checkpoint restored bit for bit; export_archive ->
               load_run(<dir>) with the logits of the trained model in
               bf16-rounded weights, bit for bit; a 2-step fit of
               draft-lstm-r4's LM; the `test` entry on both runs;
 32. lstm-sample — `sample lstm-vae <lstm-fit's archive>`: one lockstep
               batch of 1000 x 128 (the unfused selection: no K4); then
               `sample transformer-vae real-prose-vae-r5
               spec_draft=lstm-lm:<lstm-fit's LM>` for 2 documents of 128
               and gen_bench's spec_model row with that draft, greedy and
               sampled (passes, accepted drafts).
Cut for time: the fits' depth (2 and 2 steps), the test entry's samples
(8 in 2 chunks) and the draft runs' documents (2 of 128); no width.
The latent tooling (gather_latents.py, knn.py, reconstruct.py,
vae_console.py; their entries' dataset writer, tsne and interactive
loops are CPU work that tests/test_torch_latent.py drives) and the
mixture-of-experts LM real-prose-lm-moe (meta.json only: d_model 512, 8
heads, 6 dense causal layers of 8 experts, top-2, capacity factor 1.25,
bf16; the JAX initialisation, seed 0):
 33. latent  — in a temporary working directory holding a stand-in
               corpus of 64 documents of 512-4,096 ids and r5's trained
               weights saved as a run: gather (the posterior of every
               document, batches of 32 rows; the encoder launches no
               kernel) in bf16 against the fp32 plain model on the same
               batches; knn_scores on the card against knn.py's float64
               formulas; one reconstruction of a test document (max_length
               1,024, temperature 0.7: K4 once a step), every K4 choice
               held against the plain selection; a scripted vae_console
               session (help, load, encode, an expression, q);
 34. moe-train — 3 optimizer steps on one trainer group of its data
               shape (2 micro-batches of [48, 1024] ragged documents)
               through the dense causal pair (6 launches a
               micro-batch) and K3/K3b at D = 512; step 1 against the
               same step in fp32 through the plain versions (loss 0.1%,
               every gradient at cosine >= 0.99 or the near-zero rule),
               with the tokens whose top-2 experts or kept slots differ
               between the routes counted by layer; seconds a step, real
               tokens/s, peak memory, train_moe_aux, train_moe_z and the
               share of dispatches dropped by capacity printed;
 35. moe-fit — Trainer.fit at 3 of its 6 layers (MOE_FIT_DEPTH) for 2
               steps on a stand-in corpus of its
               document lengths, validating and saving at step 2; the
               checkpoint restored bit for bit and one step from it equal
               to the same step from the saved state; export_archive ->
               load_run(<dir>) serving the trained model's logits
               exactly;
 36. moe-serve — 12 requests through ServeEngine at batch 64 (dead rows
               present), four bulk-prefilled at 512 (the dense causal forward),
               selection through K4; greedy ar and jacobi_full at batch 1
               x 512, jacobi_full held against ar.
Cut for time in phases 26-27 when phases 33-36 came in: r5's document to
512 positions (window 256), the draft runs to 256 and the entry's
documents to 64; when phases 37-40 came in: fit to 2 steps (from 6),
sp-train's sharded kernel steps to 2 (from 3), sample-long to 512
positions (from 1,024), decode-r5 to 256 positions (window 128, from 512 and 256),
decode-spec's draft runs to 128 (from 256), sample's and lstm-sample's
documents to 256 tokens (from 512), lstm-fit to 2 steps (from 4) on 120
documents (from 200), moe-fit to 3 of its 6 layers.
The data, model and expert axes (parallel/mesh.py, tp.py, ep.py,
spmd.py): each phase spawns 4 ranks on this card (gloo: every collective
staged through the host; the NCCL branch needs a card a rank), holds
step 1 against the unsharded step on the same weights, documents and
noise, in bf16 through the kernels and in fp32 through the plain
versions (as sp-train: the fp32 pair loss 1e-5 and every gradient at
cosine >= 0.99; the kernel pair loss 1e-3 and cosine >= 0.99 or the
NOISY_GRAD_MARGIN rule), checks every rank's launch counts (the plain
routes 0 on every rank) and that every replicated parameter is bitwise
equal on every rank and every shard across its data peers, and prints
seconds a step, real tokens/s, the seconds in host-staged transfers and
each rank's peak memory:
 37. mesh-tp — r5 at full width over data 2 x model 2 (4 heads, half of
               each FFN and 16,384 rows of the tied table a shard) on
               [4, 4096] ragged documents, 3 steps: K1/K2 6 a step on
               every rank, K3/K3b none (the vocab-parallel loss);
 38. mesh-ep — real-prose-lm-moe over data 2 x expert 2 (4 experts a
               rank) on 2 micro-batches of [16, 1024]: step 1 held at
               capacity factor MESH_NO_DROP without dropout, then 2
               steps at 1.25 with dropout (masks per row shard), each
               rank's dropped share a layer printed;
               the dense causal pair 6 and K3/K3b 1 a micro-batch on every
               rank;
 39. mesh-moe-tp — the same over data 2 x model 2 (expert hidden 2,048
               -> 1,024 a shard): the dense causal pair 6 a micro-batch,
               K3/K3b
               none;
 40. mesh-fit — Trainer.fit of r5's hparams on data 2 x model 2 for 2
               steps, validating and saving each step (cut: documents of
               512-4,096 tokens in batches of 8,192, MESH_FIT_TOKENS);
               the step-1 checkpoint restored bit for bit and stepped
               into the run's step 2 bit for bit on every rank; the
               gathered checkpoint loaded on the card by
               load_checkpoint_for_name equal to the trained parameters,
               and its archive served by load_run with the trained
               model's logits exactly. Its ranks run beside seq-fit's (42).
The seq and pipe axes (parallel/mesh.py's (data, seq, model) and (data,
pipe) grids, spmd.py's seq mesh, pp.py), each phase's ranks in one spawn
and held as phases 37-39 (the unsharded steps on the same weights,
documents and noise; replicated parameters bitwise equal; every rank's
launch counts; seconds a step, real tokens/s, host-staged seconds and
each rank's peak memory):
 41. mesh-seq — r5 over seq 2 x model 2 on sp-train's [1, 102400]
               document and eps (sp-train's unsharded steps; 2 steps):
               seq shard 0 K1/K2, shard 1 K6 at q [1, 4, 51200, 64], no
               K3/K3b (the vocabulary split); the sharded DReG step (r5's
               geometry, JAX initialisation, train_mc_samples 4) over seq
               2 x model 2 on [2, 6400]; the nonvae-pg19 LM (JAX
               initialisation) over seq 4 on one [1, 92160] document
               (23,040 tokens a shard: K6 on ranks 1-3, K1/K2 on rank 0,
               K3/K3b at D = 512 on every rank; 2 steps); real-prose-lm-moe
               with sparse attention over seq 4 on one [8, 4096] group
               (step 1 at MESH_NO_DROP without dropout, step 2 at 1.25
               with dropout; each rank's dropped share a layer and the
               tokens whose routes differ from the unsharded forward's);
               real-prose-lm-moe as archived (dense) over seq raises the
               JAX package's ValueError; the encoder's numerically zero
               q/k gradients held against the unsharded bf16 step's own
               noise (SEQ_NEAR_ZERO);
 42. seq-fit — Trainer.fit of pg19-fb8's hparams over data 2 x seq 2
               (102,400-token streams, two a micro-batch: one a data
               shard; accumulation 2), 2 steps, validating and saving
               each step, held as mesh-fit (40); the bucket quantum
               (lcm(512, 2 x 2 x 128) = 512) and the trainer's override
               printed (None: pg19-fb8's 512 already is a multiple; the
               override runs in the CPU tests only);
 43. mesh-pipe — r5's trained weights over data 2 x pipe 2 (3 decoder
               layers and 3 z projections a stage) on M = 4 micro-batches
               of [4, 4096] (step 1 held against the unsharded
               accumulated step, then 2 more) and the r4 LM geometry on M
               = 4 of [4, 3584] (2 steps, the dense causal pair): the pair
               3 a micro-batch on every rank, K3/K3b on the last stage
               alone; each rank's idle seconds in the schedule beside the
               GPipe bubble (P - 1) / (M + P - 1) = 0.2.
Rematerialisation (models/remat.py) and the rest of the library surface:
 44. remat   — r5 in its training form at full rows [8, 12800] (right
               after phase 6): from one state, batch and noise, step 1
               without remat (first and last: its own spread) and under
               each of full, dots, dots_attn, dots_attn_qkv and offload,
               the loss and all 165 gradients bit-identical to no remat's
               (or, where the two no-remat runs differ, within their
               spread, the moved gradients named), then 3 timed steps;
               ms a step, peak memory over the steps (full must peak
               below no remat) and launches a step: K1 12 under full,
               dots and offload (the recompute launches it again), 6
               under the attn policies, which keep its out and lse; K2 6,
               K3/K3b 1;
 45. lm-options — (after phase 20) a Transformer LM at r5's width (d_model
               512, 8 heads, 6 sparse layers, V 32,768, window 2 x 128,
               bf16, dots_attn_qkv remat; the JAX initialisation) with a
               factorised embedding (d_embedding 256), an untied head and
               cross-attention to a [4, 512] context with its own table: 3
               steps on [4, 4096], K1/K2 6 a step, K3/K3b none (the untied
               loss is outside the fused tied CE, as in JAX), step 1 held
               against the fp32 plain step as phase 20 holds its steps;
               then the generic Transformer at the same width: its bf16
               logits through K1 against the fp32 plain model on the card
               (relative L2 within TRANSFORMER_REL, argmax agreement
               printed).
Every phase built from a run's meta.json or a preset rematerialises its
decoder layers as the meta says (every archived transformer run and
preset: grad_checkpointing with dots_attn_qkv): train, fit, fit-pg19,
lm-train's r4 geometry, lm-fit, moe-train, moe-fit, sp-train and the mesh
phases; their launch counts are unchanged (dots_attn_qkv keeps K1's
output), their memory and seconds are not.
Phases 11 and 37-43 share ONE spawn of 4 ranks (`mesh_phases`): every
phase's unsharded references first ("mesh-references"), then the ranks
run every phase's sharded runs in turn ("mesh-ranks"; rank 0 prints each
run's seconds), then each phase's checks, timed as the phase.
Cut for time when phases 41-43 came in: phases 37-39 to 2 steps (from
3); one spawn for phases 11 and 37-43 (from one a phase); decode-r5's
batch-8 run to 128 positions (from 256), decode-spec's draft runs to 64
(from 128), lstm-train's timed steps to 2 (from 3), lstm-sample's
documents to 128 tokens (from 256); every archive written uncompressed
(fit's, lstm-fit's, moe-fit's, mesh-fit's and seq-fit's; load_run reads
both forms); seq-fit's accumulation to 2 (pg19-fb8: 4 micro-batches of
one stream; here 2 of two, the same tokens a step) and its validation to
one batch.
No path may route a call to a plain version: on the card such a route
raises, and every path's `plain_routes` counters must stay 0.
Then one {"kernels": [...]} JSON line, the nvidia-smi line, and last
{"ok": true, "device": {...}}. Any failed check raises: no result line.
"""
from __future__ import annotations

import contextlib
import ctypes
import functools
import gc
import io
import json
import re
import subprocess
import sys
import tempfile
import time
from dataclasses import replace
from pathlib import Path

# The run writes nothing into the checkout but the kernel library
# (sparse_vae_tpu_torch/_build/): no bytecode caches either.
sys.dont_write_bytecode = True

import numpy as np
import torch
import torch.nn.functional as F

from sparse_vae_tpu_torch import gather_latents, profile_train, vae_console
from sparse_vae_tpu_torch import knn as knn_entry
from sparse_vae_tpu_torch import reconstruct as reconstruct_entry
from sparse_vae_tpu_torch import test as test_entry
from sparse_vae_tpu_torch.checkpoint import (export_archive, load_draft,
                                             load_run, model_from_hparams,
                                             serving_form)
from sparse_vae_tpu_torch import sample as sample_entry
from sparse_vae_tpu_torch.batch_generation import batch_generate_samples
from sparse_vae_tpu_torch.cli import (assemble_config, build_data,
                                      build_hparams, make_sample_fns)
from sparse_vae_tpu_torch.data.datasets import TokenizedCorpus
from sparse_vae_tpu_torch.data.text_data_module import (
    TextDataModule, TextDataModuleHparams)
from sparse_vae_tpu_torch.data.tokenizer import (tokenizer_cache_path,
                                                 train_tokenizer)
from sparse_vae_tpu_torch.models.base import CLS_ID, SEP_ID
from sparse_vae_tpu_torch.models.init import init_parameters
from sparse_vae_tpu_torch.models.moe import expert_capacity
from sparse_vae_tpu_torch.models.transformer import Transformer
from sparse_vae_tpu_torch.models.transformer_lm import (
    TransformerHparams, checkpoint_policy)
from sparse_vae_tpu_torch import gen_bench
from sparse_vae_tpu_torch.models import generation, parallel_decode
from sparse_vae_tpu_torch.models.generation import (SamplingParams,
                                                    gumbel_noise, prior_z)
from sparse_vae_tpu_torch.ops import (causal_kernel, ce_kernel, cuda_lib,
                                      launches, select_kernel, sp_kernel,
                                      swa_kernel)
from sparse_vae_tpu_torch.ops.rnn import (BiLSTMEncoder, StackedRNN,
                                          use_step_loop)
from sparse_vae_tpu_torch.ops import attention as tattn
from sparse_vae_tpu_torch.ops import sliding_window_attention as swa_plain
from sparse_vae_tpu_torch.ops.sliding_window_attention import (
    sliding_window_attention_bwd_plain,
    sliding_window_attention_packed_bwd_plain,
    sliding_window_attention_packed_plain, sliding_window_attention_plain)
from sparse_vae_tpu_torch.server import ServeEngine
from sparse_vae_tpu_torch.serving import continuous_batch_sample
from sparse_vae_tpu_torch.parallel.group import spawn
from sparse_vae_tpu_torch.parallel.sp import sp_pad_multiple
from sparse_vae_tpu_torch.train import bench_hparams, build_from_hparams
from sparse_vae_tpu_torch.train import build as build_training
from sparse_vae_tpu_torch.train import mesh_rank, run_hparams, train_rank
from sparse_vae_tpu_torch.training.data import synthetic_batch
from sparse_vae_tpu_torch.training.checkpointing import CheckpointManager
from sparse_vae_tpu_torch.training.optimizer import make_optimizer
from sparse_vae_tpu_torch.training.train_step import train_step
from sparse_vae_tpu_torch.training.trainer import Trainer, defer_accum_groups
from sparse_vae_tpu_torch.utils.config import to_dict

RUN = "real-prose-vae-r5"
# H100 SXM published peaks (NVIDIA data sheet, dense, at 700 W).
HBM_BYTES_PER_S = 3.35e12
BF16_TENSOR_FLOPS = 989e12
FP32_FLOPS = 67e12

# K1: out is compared in bf16: both sides round the softmax weights to bf16
# before the value product and the output to bf16 after it, in other
# summation orders (bf16 roundings of values of order 1); lse is fp32 on
# both sides and differs only by summation order.
K1_OUT_ATOL, K1_OUT_RTOL = 2e-2, 2e-2
K1_LSE_ATOL = 1e-3
# K4: a row may choose differently only when its bisection mass sat within
# fp32 summation rounding of the target at some step (relative margin
# below this) or its chosen token's p sits on the threshold.
K4_FLIP_MARGIN = 1e-4
# Model: the bf16 card path against the fp32 CPU path after 6 layers.
MODEL_MEAN_ABS_TOL = 0.25
MODEL_ARGMAX_AGREE = 0.9
# K2 and K3b: bf16 gradients against the fp32 plain versions, the largest
# error relative to the largest entry: one bf16 rounding of each output
# (2^-9) plus, in K3b, the rounding of the logit gradients to bf16 before
# the products, as the JAX kernel rounds them.
GRAD_REL_TOL = 1e-2
# K3: fp32 lse and nll, summation order over 32,768 logits.
K3_ATOL = 1e-4
# Train: the bf16 kernel step against the fp32 plain step: the loss within
# 0.1% relative (bf16 rounding of the activations; a fault in a share of
# the tokens, such as mis-masked padding, moves it by more), and every one
# of the 165 gradients at cosine >= 0.99.
TRAIN_LOSS_RTOL = 1e-3
TRAIN_GRAD_COS = 0.99
# Document lengths of the [8, 12800] training-shape kernel timings: full
# rows, the JAX train bench's traffic (bench.py: num_tokens = L).
TRAIN_LENGTHS = [12800] * 8
# The Dh = 128 model (bench.py --heads 4): its bf16 prefill logits against
# the fp32 plain model on the card, the largest |difference| relative to
# the largest |logit|: bf16 rounding of the activations through 6 layers
# and the head, about 1e-2 on an H100 (0.0243 of a largest |logit| of
# 2.37); the bound is three times that reading. Argmax agreement is not
# held here: the logits of a freshly initialised model are nearly flat,
# so which token is largest says little. K5/K5b's own checks carry the
# weight for the kernels.
MODEL_H4_REL_TOL = 3e-2
H4_SEED = 0          # the torch.Generator of the Dh = 128 initialisation
# Sequence parallelism: the pg19 preset's document (102,400 tokens, batch
# 1) over 4 length shards. K6's tolerances are K1's (out, lse) and K2's
# (gradients); the sharded step against the unsharded kernel step as the
# train phases hold the kernel step against the plain one.
SP = 4
SP_SEQ = 102400
SP_SEED = 21
# The fp32 plain sharded step against the fp32 plain unsharded one:
# summation order only (both 13.867570877 on an H100).
SP_FP32_LOSS_RTOL = 1e-5
# Where the unsharded bf16 kernel step is itself below TRAIN_GRAD_COS
# against the fp32 step (the encoder bottleneck's near-zero gradients at
# 102,400 tokens: 0.699 on an H100), the sharded kernel step may be no
# farther from fp32 than it, less this margin (bf16 noise of two
# different summation orders: 0.696 was measured beside that 0.699).
# The fit phases hold the kernel step against the bf16 plain step in the
# same way where that step is itself below TRAIN_GRAD_COS.
NOISY_GRAD_MARGIN = 0.05


class Phase:
    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.t0 = time.perf_counter()
        print(f"[{self.name}] start", flush=True)
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self.t0
        status = "failed" if exc[0] else "done"
        print(f"[{self.name}] {status} in {dt:.2f} s", flush=True)
        return False


def check(ok: bool, what: str):
    if not ok:
        raise AssertionError(what)


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean milliseconds of fn() over `iters` back-to-back calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# The profiler keeps only the kernel records that fall inside its window
# on the host's clock, and the card's clock, as it converts it, drifts
# from the host's over a run: minutes in, a window of a millisecond's
# work held none of its records (an H100 with torch 2.11 and CUDA 12.8:
# 0 of 10, in up to 12 traces in a row). So device_ms pads its window
# with idle host time on both sides, doubling the pad after a short
# trace (from TRACE_PAD_S up to TRACE_PAD_MAX_S) and starting each call
# from the pad that last sufficed.
DEVICE_TRACE_ATTEMPTS = 12
TRACE_PAD_S = 0.005
TRACE_PAD_MAX_S = 2.0
_trace_pad = [TRACE_PAD_S]


def device_ms(fn, iters: int = 10) -> dict:
    """Device milliseconds per call of fn() by kernel name, from
    torch.profiler over `iters` calls after one warm-up call: what the card
    spent, without the host's share of the call's time
    (profile_train.per_call_device_ms, which tolerates a dropped kernel
    record; a trace that lost more is taken again with a wider pad)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(DEVICE_TRACE_ATTEMPTS):
        pad = _trace_pad[0]
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            time.sleep(pad)
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
            time.sleep(pad)
        averages = prof.key_averages()
        times = profile_train.per_call_device_ms(averages, iters)
        if times is not None:
            return times
        launched, recorded = profile_train.kernel_records(averages)
        _trace_pad[0] = min(2 * pad, TRACE_PAD_MAX_S)
        print(f"profiler trace incomplete: {recorded} kernel records for "
              f"{launched} launches with {pad:g} s of pad; taken again "
              f"with {_trace_pad[0]:g} s", flush=True)
    raise AssertionError(f"the profiler dropped kernel records in "
                         f"{DEVICE_TRACE_ATTEMPTS} traces running")


def kernel_ms(times: dict, name: str) -> float:
    """The device ms of the kernels whose name contains `name`."""
    return sum(ms for key, ms in times.items() if name in key)


def bound(nbytes: float, ops: float, op_rate: float):
    byte_ms = nbytes / HBM_BYTES_PER_S * 1e3
    op_ms = ops / op_rate * 1e3
    return (byte_ms, "bytes") if byte_ms >= op_ms else (op_ms, "operations")


def device_phase() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(f"card: {smi}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, {torch.cuda.get_device_name(0)}",
          flush=True)
    # Full fp32 for the plain versions' fp32 products.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return smi


def build_phase():
    cuda_lib.library()
    info = cuda_lib.build_info
    print(f"library {info.path.name}: nvcc {info.seconds:.1f} s", flush=True)
    for line in ptxas_lines(info.ptxas_log):
        print(f"  {line}")


def ptxas_lines(log: str) -> list:
    """The build's `ptxas info` lines but ptxas's notes that it placed a
    warpgroup.arrive (C7519, one per accumulator use: hundreds), and after
    each kernel of csrc/swa_generic.cu its registers and spills (the
    function-properties line that carries them has no `ptxas` prefix):
    "ptxas <kernel>: N registers, S bytes spill stores, L loads"."""
    lines, name, spill = [], None, None
    for line in log.splitlines():
        line = line.strip()
        if "spill stores" in line:  # a function's properties, no prefix
            spill = line
        if "ptxas" not in line or "(C7519)" in line:
            continue
        lines.append(line)
        if "Compiling entry function" in line:
            name = line.split("'")[1]
        elif "Used" in line and name and "swa_generic" in name:
            m = re.search(r"(swa_generic_[a-z_]*?kernel)(?:ILi(\d+)E)?"
                          r"(?:Lb(\d)E)?", name)
            args = [a for a in m.group(2, 3) if a is not None]
            kernel = m.group(1) + (f"<{', '.join(args)}>" if args else "")
            name = None
            stores, loads = (int(w) for w in re.findall(
                r"(\d+) bytes spill (?:stores|loads)", spill or ""))
            regs = int(re.search(r"Used (\d+) registers", line).group(1))
            lines.append(f"ptxas {kernel}: {regs} registers, {stores} bytes "
                         f"spill stores, {loads} loads")
    return lines


def band_mask(L: int, lengths, window: int, block: int, device,
              causal: bool = True, include_cls: bool = True):
    """[B, 1, L, L] bool: the band of `window` blocks of `block` (causal,
    or the ceil-left / floor-right split), the [CLS] block where the band
    does not reach block 0, the causal triangle and the key prefix: the
    token mask the attention kernels apply."""
    pos = torch.arange(L, device=device)
    blk = pos // block
    left = window if causal else (window + 1) // 2
    first = blk - (left - 1)
    mask = (blk[None, :] >= first[:, None]) \
        & (blk[None, :] <= first[:, None] + window - 1)
    if include_cls:
        mask |= (first[:, None] > 0) & (blk[None, :] == 0)
    if causal:
        mask &= pos[None, :] <= pos[:, None]
    keys = pos[None, :] < torch.as_tensor(lengths, device=device)[:, None]
    return (mask[None] & keys[:, None, :])[:, None]


def k1_phase(b: int, L: int, lengths, seed: int, iters: int):
    h, d, window, block = 8, 64, 2, 128
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v = (torch.randn((b, h, L, d), generator=gen, device="cuda")
               .to(torch.bfloat16) for _ in range(3))
    lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    key_mask = torch.arange(L, device="cuda")[None, :] < lens[:, None]
    out, lse = swa_kernel.swa_fwd(q, k, v, lens, window_size=window,
                                  block_size=block, causal=True)
    torch.cuda.synchronize()
    ref, ref_lse = sliding_window_attention_plain(
        q, k, v, key_mask, window_size=window, block_size=block,
        causal=True, return_lse=True)
    err = (out.float() - ref.float()).abs()
    lse_err = (lse - ref_lse).abs().max().item()
    check(bool(torch.isfinite(out.float()).all()), "K1 out is not finite")
    check(bool((err <= K1_OUT_ATOL + K1_OUT_RTOL * ref.float().abs()).all()),
          f"K1 out disagrees with its plain version: max {err.max():.3g}")
    check(lse_err <= K1_LSE_ATOL, f"K1 lse disagrees: {lse_err:.3g}")

    mask = band_mask(L, lens, window, block, "cuda")
    ms = cuda_ms(lambda: swa_kernel.swa_fwd(q, k, v, lens,
                                            window_size=window,
                                            block_size=block), iters)
    plain_ms = cuda_ms(lambda: sliding_window_attention_plain(
        q, k, v, key_mask, window_size=window, block_size=block),
        max(3, iters // 10))
    library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, attn_mask=mask), max(3, iters // 10))
    device = kernel_ms(device_ms(lambda: swa_kernel.swa_fwd(
        q, k, v, lens, window_size=window, block_size=block)),
        "swa_fwd_kernel")
    pairs = int(mask.sum().item()) * h      # attended (query, key) pairs
    nbytes = 4 * q.numel() * 2 + lse.numel() * 4 + lens.numel() * 4
    bound_ms, bound_by = bound(nbytes, 4 * d * pairs, BF16_TENSOR_FLOPS)
    row = {"shape": [b, h, L, d], "lengths": list(lengths),
           "max_abs_err": err.max().item(), "lse_max_abs_err": lse_err,
           "ms": ms, "device_ms": device, "plain_ms": plain_ms,
           "library_ms": library_ms, "bound_ms": bound_ms,
           "bound_by": bound_by}
    print("K1 " + json.dumps(row), flush=True)
    return row


class ParentK4:
    """Another tree's K4 (`--k4-parent DIR`): DIR's csrc/nucleus_select.cu
    built alone into this checkout's _build/k4_parent/ (DIR is only read)
    and called through the same C entry, so that a run can time it beside
    this tree's kernel on the same card."""

    def __init__(self, root: str):
        src = (Path(root).resolve() / "sparse_vae_tpu_torch" / "csrc"
               / "nucleus_select.cu")
        out = cuda_lib.BUILD_DIR / "k4_parent" / "libk4_parent.so"
        out.parent.mkdir(parents=True, exist_ok=True)
        subprocess.run([cuda_lib._nvcc(), "-gencode",
                        "arch=compute_90a,code=sm_90a", "-std=c++17",
                        "-O3", "-Xcompiler", "-fPIC", "-shared", "-I",
                        str(src.parent), "-o", str(out), str(src)],
                       check=True, timeout=cuda_lib.NVCC_TIMEOUT_S)
        self.fn = ctypes.CDLL(str(out)).svt_nucleus_select
        self.fn.argtypes = cuda_lib._SIGNATURES["svt_nucleus_select"]
        self.fn.restype = ctypes.c_int

    def __call__(self, s, noise, top_p: float, temperature: float):
        out = torch.empty(s.shape[0], dtype=torch.int64, device=s.device)
        code = self.fn(s.data_ptr(),
                       None if noise is None else noise.data_ptr(),
                       out.data_ptr(), s.shape[0], s.shape[1], top_p,
                       temperature, select_kernel.NUM_ITERS,
                       torch.cuda.current_stream().cuda_stream)
        check(code == 0, f"the parent's K4 failed: CUDA error {code}")
        return out


def k4_on(cluster: int):
    """This tree's K4 on one instantiation (`svt_nucleus_select_on`: 2 a
    cluster of two CTAs a row, 1 one CTA a row), outside the wrapper and
    its launch count."""
    fn = cuda_lib.library().svt_nucleus_select_on

    def call(s, noise, top_p: float, temperature: float):
        out = torch.empty(s.shape[0], dtype=torch.int64, device=s.device)
        code = fn(s.data_ptr(), None if noise is None else noise.data_ptr(),
                  out.data_ptr(), s.shape[0], s.shape[1], top_p,
                  temperature, select_kernel.NUM_ITERS, cluster,
                  torch.cuda.current_stream().cuda_stream)
        check(code == 0, f"K4 on instantiation {cluster} failed: CUDA "
              f"error {code}")
        return out
    return call


def k4_agrees(got, s, noise, kw: dict):
    """K4's choices against the plain version's: a row may differ only
    where its bisection margin is below K4_FLIP_MARGIN or its chosen
    token's p sits on the threshold. Returns (the rows excused, the largest
    index difference on the others, the tokens the plain version keeps)."""
    n = s.shape[0]
    ref, thresh, margin = select_kernel.select_rows_plain(s, noise, **kw)
    differ = (got != ref).nonzero().flatten().tolist()
    t = kw["temperature"]
    scaled = s / t if t != 1.0 and t > 0.0 else s
    p_un = torch.exp(scaled - scaled.amax(dim=-1, keepdim=True))
    flips = []
    for r in differ:
        on_edge = any(abs(p_un[r, i].item() - thresh[r].item())
                      <= 1e-5 * thresh[r].item()
                      for i in (int(got[r]), int(ref[r])))
        if margin[r].item() < K4_FLIP_MARGIN or on_edge:
            flips.append(r)
    check(len(flips) == len(differ),
          f"K4 at {list(s.shape)} disagrees with its plain version on rows "
          f"{sorted(set(differ) - set(flips))}")
    held = torch.ones(n, dtype=torch.bool, device=s.device)
    held[flips] = False
    max_err = (got[held] - ref[held]).abs().max().item() if held.any() \
        else 0.0
    kept = int(((p_un >= thresh[:, None]) | (p_un == 1.0)).sum().item())
    return flips, max_err, kept


def k4_bound(s, noise, top_p: float, temperature: float, kept: int):
    """K4's least time on these inputs. Bytes: every logit once, the noise
    of the kept tokens only (all of it without a nucleus), one int64 a
    row. Operations as the function computes them: a divide an element
    when T != 1; with a nucleus max, subtract, exp and sum, a compare and
    a bin add an element at each histogram level, two compares to keep,
    then a noise add and a compare a kept token; without one, a noise add
    and a compare an element."""
    n, v = s.shape
    nucleus = 0.0 < top_p < 1.0
    noise_bytes = 0 if noise is None else 4 * (kept if nucleus else n * v)
    nbytes = 4 * n * v + noise_bytes + 8 * n
    per_element = int(temperature != 1.0 and temperature > 0.0)
    if nucleus:
        levels = min(3, -(-select_kernel.NUM_ITERS // 8))
        ops = n * v * (per_element + 6 + 2 * levels) + 2 * kept
    else:
        ops = n * v * (per_element + 1 + (noise is not None))
    return bound(nbytes, ops, FP32_FLOPS)


def k4_phase(temperature: float, seed: int, iters: int, n: int = 64,
             vocab: int = 32768, top_p: float = 0.9,
             with_noise: bool = True, parent: ParentK4 | None = None):
    """K4 against its plain version, and bit for bit across two calls;
    with iters > 0 also timed by events and torch.profiler beside its
    bound, and beside `parent` in the order parent, this, this, parent."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    # Peaked like a language model's logits, so the nucleus is a small set.
    s = 4.0 * torch.randn((n, vocab), generator=gen, device="cuda")
    noise = gumbel_noise((n, vocab), gen) if with_noise else None
    kw = {"top_p": top_p, "temperature": temperature}
    got = select_kernel.nucleus_gumbel_argmax(s, noise, **kw)
    again = select_kernel.nucleus_gumbel_argmax(s, noise, **kw)
    torch.cuda.synchronize()
    check(torch.equal(got, again), f"K4 at {[n, vocab]} gave other choices "
          f"in a second call on the same inputs")
    flips, max_err, kept = k4_agrees(got, s, noise, kw)
    row = {"shape": [n, vocab], "temperature": temperature, "top_p": top_p,
           "noise": with_noise, "max_abs_err": max_err,
           "ulp_flip_rows": len(flips), "bit_identical": True,
           "kept_tokens": kept}
    if iters:
        def kernel():
            return select_kernel.nucleus_gumbel_argmax(s, noise, **kw)

        ms = cuda_ms(kernel, iters)
        device = kernel_ms(device_ms(kernel), "nucleus_select")
        plain_ms = cuda_ms(lambda: select_kernel.nucleus_gumbel_argmax_plain(
            s, noise, **kw), max(3, iters // 10))
        bound_ms, bound_by = k4_bound(s, noise, top_p, temperature, kept)
        row.update({"ms": ms, "device_ms": device, "plain_ms": plain_ms,
                    "library_ms": None, "bound_ms": bound_ms,
                    "bound_by": bound_by})
        if parent is not None:
            def old():
                return parent(s, noise, top_p, temperature)

            turns = (("parent", old), ("this", kernel), ("this", kernel),
                     ("parent", old))
            timed = [(name, cuda_ms(fn, iters),
                      kernel_ms(device_ms(fn), "nucleus_select"))
                     for name, fn in turns]
            row["pccp"] = {
                "order": [name for name, _, _ in timed],
                "ms": [ms for _, ms, _ in timed],
                "device_ms": [dev for _, _, dev in timed]}
            for key, at in (("ms", 1), ("device_ms", 2)):
                row[f"parent_{key}"] = (timed[0][at] + timed[3][at]) / 2
    print("K4 " + json.dumps(row), flush=True)
    return row


def k4_instantiations(seed: int, iters: int,
                      rows=(16, 64, 100, 512, 1000, 2048, 4096)):
    """K4's two instantiations timed against each other on the same inputs
    ([rows, 32768], T 1.0, noise, top_p 0.9; turns cluster, one CTA, one
    CTA, cluster), each held against the plain version: the measurement
    behind svt_nucleus_select's rule (a cluster while 2 rows <= SMs)."""
    kw = {"top_p": 0.9, "temperature": 1.0}
    table = {}
    for i, n in enumerate(rows):
        gen = torch.Generator(device="cuda").manual_seed(seed + i)
        s = 4.0 * torch.randn((n, 32768), generator=gen, device="cuda")
        noise = gumbel_noise(s.shape, gen)
        entry = {}
        calls = {name: functools.partial(k4_on(cluster), s, noise, **kw)
                 for name, cluster in (("cluster", 2), ("one_cta", 1))}
        for name, call in calls.items():
            flips, _, _ = k4_agrees(call(), s, noise, kw)
            entry[name] = {"ulp_flip_rows": len(flips), "ms": [],
                           "device_ms": []}
        for name in ("cluster", "one_cta", "one_cta", "cluster"):
            call = calls[name]
            entry[name]["ms"].append(cuda_ms(call, iters))
            entry[name]["device_ms"].append(
                kernel_ms(device_ms(call), "nucleus_select"))
        for name in ("cluster", "one_cta"):
            for key in ("ms", "device_ms"):
                entry[name][key] = sum(entry[name][key]) / 2
        table[str(n)] = entry
    print("K4 instantiations " + json.dumps(table), flush=True)
    return table


def model_phase(model, seed: int = 0, length: int = 256):
    """Prefill logits of the card model (bf16, K1) against the fp32 CPU
    model (plain attention) on one fixed input."""
    cpu_model, _, _ = load_run(RUN, device="cpu", dtype=torch.float32)
    rng = np.random.default_rng(seed)
    vocab = model.hparams.vocab_size
    ids = rng.integers(3, vocab, size=(1, length))
    ids[0, 0] = 1
    ids[0, 200:] = 0                                   # right padding
    z = rng.standard_normal((1, 1, model.hparams.latent_depth))
    ids_t = torch.tensor(ids)
    z_t = torch.tensor(z, dtype=torch.float32)
    with torch.inference_mode():
        got = model.reconstruct(ids_t.cuda(), z_t.cuda()).float().cpu()
        ref = cpu_model.reconstruct(ids_t, z_t)
    real = ids_t[0] != 0
    diff = (got - ref).abs()[0, real]
    agree = (got.argmax(-1) == ref.argmax(-1))[0, real].float().mean().item()
    check(got.shape == ref.shape and bool(torch.isfinite(got).all()),
          "model logits are not finite or have the wrong shape")
    check(diff.mean().item() <= MODEL_MEAN_ABS_TOL,
          f"model logits mean abs err {diff.mean():.3g}")
    check(agree >= MODEL_ARGMAX_AGREE, f"model argmax agreement {agree:.3f}")
    print(f"model: logits max abs err {diff.max():.4g}, mean abs err "
          f"{diff.mean():.4g}, argmax agreement {agree:.4f} "
          f"(bf16 card vs fp32 CPU, {int(real.sum())} tokens)", flush=True)


def make_requests(vocab: int, prompt_lengths, max_tokens, seed: int):
    rng = np.random.default_rng(seed)
    return [([int(t) for t in rng.integers(3, vocab, size=p)], m)
            for p, m in zip(prompt_lengths, max_tokens)]


def serve_phase(model, requests, *, batch_size: int = 64,
                max_length: int = 512, slice_steps: int = 64,
                fused_select: bool = True, timeout: float = 300.0,
                before_traffic=None) -> dict:
    """Drive ServeEngine with `requests` [(prompt_tokens, max_tokens)] and
    check every answer. before_traffic() runs once the engine is ready,
    just before the first submit. Returns the run's statistics."""
    sampling = SamplingParams(temperature=1.0, top_p=0.9,
                              repetition_penalty=1.2)
    engine = ServeEngine(model, batch_size=batch_size, max_length=max_length,
                         sampling=sampling, end_token=SEP_ID,
                         slice_steps=slice_steps, fused_select=fused_select,
                         rng_seed=0)
    try:
        deadline = time.monotonic() + timeout
        while not engine.snapshot()["ready"]:
            check("fatal" not in engine.snapshot(), "engine failed to start")
            check(time.monotonic() < deadline, "engine never became ready")
            time.sleep(0.05)
        if before_traffic is not None:
            before_traffic()
        if model.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        t0 = time.monotonic()
        done_at = {}
        futures = []
        for i, (prompt, max_tokens) in enumerate(requests):
            fut = engine.submit(max_tokens, seed=1000 + i,
                                prompt_tokens=prompt or None)
            fut.add_done_callback(
                lambda f, i=i: done_at.setdefault(i, time.monotonic()))
            futures.append(fut)
        outs = [f.result(max(1.0, deadline - time.monotonic()))
                for f in futures]
        wall = time.monotonic() - t0
        vocab = model.hparams.vocab_size
        new_tokens = 0
        for (prompt, max_tokens), out in zip(requests, outs):
            p = len(prompt)
            check(np.array_equal(out[:p], prompt), "prompt not echoed")
            new = out[p:]
            check(1 <= len(new) <= max_tokens,
                  f"{len(new)} new tokens for max_tokens={max_tokens}")
            check(bool(((new >= 0) & (new < vocab)).all()),
                  "token id out of range")
            new_tokens += len(new)
        snap = engine.snapshot()
    finally:
        engine.shutdown(timeout=30.0)
    check(not engine._thread.is_alive(), "engine worker did not stop")
    check(snap["served"] == len(requests), "not every request was served")
    latency = np.array([done_at[i] - t0 for i in range(len(requests))])
    stats = {"requests": len(requests), "new_tokens": new_tokens,
             "wall_s": wall, "tokens_per_s": new_tokens / wall,
             "latency_p50_s": float(np.median(latency)),
             "latency_max_s": float(latency.max()),
             "prefills": snap["prefills"], "slices": snap["slices"]}
    if model.device.type == "cuda":
        stats["max_memory_allocated_bytes"] = \
            torch.cuda.max_memory_allocated()
    return stats


def rel_err(got, want) -> float:
    """Largest |got - want| relative to the largest |want|."""
    return ((got.float() - want.float()).abs().max()
            / want.float().abs().max().clamp_min(1e-30)).item()


def band_pairs(L: int, lengths, window: int, block: int) -> int:
    """Attended (query, key) pairs of the causal band + [CLS] pattern over
    all rows, per head: what K1/K2 compute for this run's lengths."""
    pos = torch.arange(L, device="cuda", dtype=torch.int64)
    qb = pos // block
    band_lo = (qb - window + 1).clamp_min(0) * block
    total = 0
    for n in lengths:
        keys = (torch.minimum(pos, torch.tensor(n - 1, device="cuda"))
                - band_lo + 1).clamp_min(0)
        cls = torch.where(qb - window + 1 > 0, min(block, n), 0)
        total += int((keys + cls).sum())
    return total


def k2_phase(b: int, L: int, lengths, seed: int, iters: int,
             time_it: bool = False):
    """K2 against its plain version; timed beside the plain version and
    the backward of scaled_dot_product_attention under the band mask."""
    h, d, window, block = 8, 64, 2, 128
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v, do = (torch.randn((b, h, L, d), generator=gen, device="cuda")
                   .to(torch.bfloat16) for _ in range(4))
    lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    out, lse = swa_kernel.swa_fwd(q, k, v, lens)
    got = swa_kernel.swa_bwd(q, k, v, lens, lse, out, do)
    again = swa_kernel.swa_bwd(q, k, v, lens, lse, out, do)
    torch.cuda.synchronize()
    check(all(torch.equal(a, b) for a, b in zip(got, again)),
          f"K2 gives different gradients in two calls on the same inputs "
          f"at {[b, h, L, d]}")
    del again
    want = sliding_window_attention_bwd_plain(q, k, v, lens, lse, out, do)
    errs = [rel_err(g, w) for g, w in zip(got, want)]
    abs_err = max((g.float() - w.float()).abs().max().item()
                  for g, w in zip(got, want))
    del want
    check(all(bool(torch.isfinite(g.float()).all()) for g in got),
          "K2 gradients are not finite")
    check(max(errs) <= GRAD_REL_TOL,
          f"K2 disagrees with its plain version: rel errors {errs}")
    row = {"shape": [b, h, L, d], "lengths": list(lengths),
           "max_abs_err": abs_err, "rel_errs_dq_dk_dv": errs,
           "bit_identical": True}
    if time_it:
        row["ms"] = cuda_ms(lambda: swa_kernel.swa_bwd(
            q, k, v, lens, lse, out, do), iters)
        # On the device, by part: dq (with delta), dk/dv (the band and the
        # [CLS] partials, one launch), the [CLS] reduce, and PyTorch's
        # allocations.
        times = device_ms(lambda: swa_kernel.swa_bwd(
            q, k, v, lens, lse, out, do), 5)
        row["device_ms"] = sum(times.values())
        row["parts_device_ms"] = k2_parts(times)
        row["plain_ms"] = cuda_ms(lambda: sliding_window_attention_bwd_plain(
            q, k, v, lens, lse, out, do), 2, warmup=1)
        row["library_ms"] = sdpa_backward_ms(q, k, v, do, lens, window,
                                             block)
        pairs = band_pairs(L, lengths, window, block) * h
        # 5 tensors read (q, k, v, out, do), lse and lengths, 3 written.
        nbytes = 8 * q.numel() * 2 + lse.numel() * 4 + lens.numel() * 4
        # Per attended pair: s and dp recomputed, dq, dk, dv: 5 products
        # of 64 multiply-adds.
        row["bound_ms"], row["bound_by"] = bound(nbytes, 10 * d * pairs,
                                                 BF16_TENSOR_FLOPS)
        row["pairs"] = pairs
    print("K2 " + json.dumps(row), flush=True)
    return row


# The kernels of csrc/swa_bwd.cu (K2, K5b and K6's backward).
K2_KERNELS = {"dq": "swa_dq_kernel", "dkv": "swa_dkv_kernel",
              "reduce": "swa_cls_reduce_kernel"}


# The kernels of csrc/swa_generic.cu's backward, by name prefix: the
# Hopper kernels (Dh <= 256: dq with delta, dk/dv with the [CLS]
# partials, the reduce) and the mma.sync ones beyond (delta, dq, dk/dv).
GENERIC_BWD_KERNELS = {"delta": "swa_generic_delta",
                       "dq": "swa_generic_dq",
                       "dkv": "swa_generic_dkv",
                       "reduce": "swa_generic_reduce"}
# The kernels of csrc/causal_bwd.cu (the dense causal pair's backward):
# delta with the counters zeroed, the one pass over key tiles, the dq
# rounding.
CAUSAL_BWD_KERNELS = {"delta": "causal_delta_kernel",
                      "pass": "causal_bwd_kernel",
                      "dq_round": "causal_dq_kernel"}
# A family's forward kernel name and backward kernels: K1/K2 (any of their
# instantiations), the generic pair, or the dense causal pair.
FAMILIES = {"k1": ("swa_fwd_kernel", K2_KERNELS),
            "generic": ("swa_generic_fwd", GENERIC_BWD_KERNELS),
            "causal": ("causal_fwd_kernel", CAUSAL_BWD_KERNELS)}
# Kernel names of the band pairs: none may run on the dense route at
# Dh 64 and 128.
BAND_KERNELS = ("swa_fwd_kernel", *K2_KERNELS.values(), "swa_generic")


def k2_parts(times: dict, kernels: dict = K2_KERNELS) -> dict:
    """The device ms of csrc/swa_bwd.cu's kernels (K2, K5b), or of another
    backward's `kernels`, by part from `device_ms`, and the rest
    (PyTorch's) beside them."""
    parts = {part: kernel_ms(times, name)
             for part, name in kernels.items()}
    parts["pytorch"] = sum(times.values()) - sum(parts.values())
    return parts


def sdpa_backward_ms(q, k, v, do, lens, window, block, mask=None):
    """Backward of F.scaled_dot_product_attention under the band mask, or
    under `mask` when given (a dense O(L^2) yardstick the port never
    calls): forward + backward minus forward."""
    L = q.shape[2]
    if mask is None:
        mask = band_mask(L, lens, window, block, "cuda")
    qq, kk, vv = (t.detach().requires_grad_() for t in (q, k, v))

    def fwd():
        return F.scaled_dot_product_attention(qq, kk, vv, attn_mask=mask)

    def fwd_bwd():
        torch.autograd.grad(fwd(), (qq, kk, vv), do)

    try:
        total = cuda_ms(fwd_bwd, 2, warmup=1)
        fwd_only = cuda_ms(fwd, 2, warmup=1)
    except torch.OutOfMemoryError:
        print("K2 library yardstick: out of memory at this shape",
              flush=True)
        return None
    finally:
        del mask
    return total - fwd_only


def k5_phase(b: int, L: int, lengths, seed: int, iters: int,
             heads: int = 4):
    """K5 and K5b on packed [b, L, heads * 128] operands against their fp32
    plain versions; timed beside the plain versions and SDPA forward and
    backward under the band mask on the head-major transposes."""
    d, window, block = 128, 2, 128
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v, do = (torch.randn((b, L, heads * d), generator=gen,
                               device="cuda").to(torch.bfloat16)
                   for _ in range(4))
    lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    out, lse = swa_kernel.swa_fwd_packed(q, k, v, lens, heads)
    got = swa_kernel.swa_bwd_packed(q, k, v, lens, lse, out, do, heads)
    again = swa_kernel.swa_bwd_packed(q, k, v, lens, lse, out, do, heads)
    torch.cuda.synchronize()
    check(all(torch.equal(a, b) for a, b in zip(got, again)),
          f"K5b gives different gradients in two calls on the same inputs "
          f"at {[b, L, heads * d]}")
    del again
    q32, k32, v32 = q.float(), k.float(), v.float()
    ref, ref_lse = sliding_window_attention_packed_plain(q32, k32, v32, lens,
                                                         heads)
    err = (out.float() - ref).abs()
    lse_err = (lse - ref_lse).abs().max().item()
    agree = bool((err <= K1_OUT_ATOL + K1_OUT_RTOL * ref.abs()).all())
    del ref, ref_lse
    check(bool(torch.isfinite(out.float()).all()), "K5 out is not finite")
    check(agree, f"K5 out disagrees with its plain version: max "
          f"{err.max():.3g}")
    check(lse_err <= K1_LSE_ATOL, f"K5 lse disagrees: {lse_err:.3g}")
    want = sliding_window_attention_packed_bwd_plain(
        q32, k32, v32, lens, lse, out.float(), do.float(), heads)
    errs = [rel_err(g, w) for g, w in zip(got, want)]
    bwd_abs = max((g.float() - w).abs().max().item()
                  for g, w in zip(got, want))
    del want, q32, k32, v32
    check(all(bool(torch.isfinite(g.float()).all()) for g in got),
          "K5b gradients are not finite")
    check(max(errs) <= GRAD_REL_TOL,
          f"K5b disagrees with its plain version: rel errors {errs}")
    fwd = {"shape": [b, L, heads * d], "lengths": list(lengths),
           "max_abs_err": err.max().item(), "lse_max_abs_err": lse_err}
    bwd = {"shape": [b, L, heads * d], "lengths": list(lengths),
           "max_abs_err": bwd_abs, "rel_errs_dq_dk_dv": errs,
           "bit_identical": True}
    pairs = band_pairs(L, lengths, window, block) * heads
    fwd["ms"] = cuda_ms(lambda: swa_kernel.swa_fwd_packed(
        q, k, v, lens, heads), iters)
    fwd["device_ms"] = kernel_ms(device_ms(lambda: swa_kernel.swa_fwd_packed(
        q, k, v, lens, heads)), "swa_fwd")
    few = max(2, iters // 10)
    fwd["plain_ms"] = cuda_ms(lambda: sliding_window_attention_packed_plain(
        q, k, v, lens, heads), few, warmup=1)
    heads_major = [t.view(b, L, heads, d).transpose(1, 2)
                   for t in (q, k, v, do)]
    mask = band_mask(L, lens, window, block, "cuda")
    try:
        fwd["library_ms"] = cuda_ms(lambda: F.scaled_dot_product_attention(
            *heads_major[:3], attn_mask=mask), few, warmup=1)
    except torch.OutOfMemoryError:
        print("K5 library yardstick: out of memory at this shape",
              flush=True)
        fwd["library_ms"] = None
    del mask
    # q, k, v read and out written once (bf16), lse written, lengths
    # read; per attended pair 2 products of d multiply-adds.
    nbytes = 4 * q.numel() * 2 + lse.numel() * 4 + lens.numel() * 4
    fwd["bound_ms"], fwd["bound_by"] = bound(nbytes, 4 * d * pairs,
                                             BF16_TENSOR_FLOPS)
    bwd["ms"] = cuda_ms(lambda: swa_kernel.swa_bwd_packed(
        q, k, v, lens, lse, out, do, heads), iters)
    # On the device, by part, as K2's (the same kernels at Dh = 128).
    times = device_ms(lambda: swa_kernel.swa_bwd_packed(
        q, k, v, lens, lse, out, do, heads), 5)
    bwd["device_ms"] = sum(times.values())
    bwd["parts_device_ms"] = k2_parts(times)
    bwd["plain_ms"] = cuda_ms(
        lambda: sliding_window_attention_packed_bwd_plain(
            q, k, v, lens, lse, out, do, heads), few, warmup=1)
    bwd["library_ms"] = sdpa_backward_ms(*heads_major, lens, window,
                                         block)
    # 5 tensors read (q, k, v, out, do), lse and lengths, 3 written;
    # per pair s and dp recomputed, dq, dk, dv: 5 products.
    nbytes = 8 * q.numel() * 2 + lse.numel() * 4 + lens.numel() * 4
    bwd["bound_ms"], bwd["bound_by"] = bound(nbytes, 10 * d * pairs,
                                             BF16_TENSOR_FLOPS)
    fwd["pairs"] = bwd["pairs"] = pairs
    print("K5 " + json.dumps(fwd), flush=True)
    print("K5b " + json.dumps(bwd), flush=True)
    return fwd, bwd


def attention_case(name: str, b: int, L: int, lengths, d: int, heads: int,
                   seed: int, iters: int, *, packed: bool, block: int = 128,
                   window: int = 2, causal: bool = True,
                   include_cls: bool = True, family: str = "generic",
                   counter: str = "generic", library: bool = True):
    """The sliding-window attention forward and backward at one shape,
    head-major [b, heads, L, d] or packed [b, L, heads * d], through the
    wrappers (swa_kernel.swa_fwd / swa_bwd or their packed twins), which
    must launch `counter`'s kernels (the generic pair, or K1/K2's Dh 128
    instantiation) once a call: out, lse and the gradients against the
    fp32 plain versions at K1's and K2's tolerances, both bit-identical
    across two calls; timed by CUDA events and torch.profiler's device
    time beside the plain versions, the bound and (library) SDPA with
    the band mask on head-major views, where SDPA takes the shape."""
    fwd_kernel, bwd_kernels = FAMILIES[family]
    gen = torch.Generator(device="cuda").manual_seed(seed)
    shape = (b, L, heads * d) if packed else (b, heads, L, d)
    q, k, v, do = (torch.randn(shape, generator=gen, device="cuda")
                   .to(torch.bfloat16) for _ in range(4))
    lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    kw = dict(window_size=window, block_size=block, causal=causal,
              include_cls=include_cls)

    def fwd():
        if packed:
            return swa_kernel.swa_fwd_packed(q, k, v, lens, heads, **kw)
        return swa_kernel.swa_fwd(q, k, v, lens, **kw)

    def bwd(out, lse):
        if packed:
            return swa_kernel.swa_bwd_packed(q, k, v, lens, lse, out, do,
                                             heads, **kw)
        return swa_kernel.swa_bwd(q, k, v, lens, lse, out, do, **kw)

    before = read_counts()
    out, lse = fwd()
    grads = bwd(out, lse)
    out2, lse2 = fwd()
    again = bwd(out, lse)
    torch.cuda.synchronize()
    after = read_counts()
    moved = {key: after[key] - before[key] for key in after
             if after[key] != before[key]}
    check(moved == {f"swa_fwd_{counter}": 2, f"swa_bwd_{counter}": 2},
          f"{name} launched {moved}, not the {counter} kernels twice")
    check(torch.equal(out, out2) and torch.equal(lse, lse2)
          and all(torch.equal(x, y) for x, y in zip(grads, again)),
          f"{name} differs in two calls at {list(shape)}")
    del out2, lse2, again
    q32, k32, v32 = q.float(), k.float(), v.float()
    if packed:
        ref, ref_lse = sliding_window_attention_packed_plain(
            q32, k32, v32, lens, heads, **kw)
    else:
        key_mask = torch.arange(L, device="cuda")[None, :] < lens[:, None]
        ref, ref_lse = sliding_window_attention_plain(
            q32, k32, v32, key_mask, return_lse=True, **kw)
    err = (out.float() - ref).abs()
    agree = bool((err <= K1_OUT_ATOL + K1_OUT_RTOL * ref.abs()).all())
    finite = torch.isfinite(ref_lse)
    same_rows = torch.equal(finite, torch.isfinite(lse))
    lse_err = (lse[finite] - ref_lse[finite]).abs().max().item()
    del ref, ref_lse
    check(bool(torch.isfinite(out.float()).all()),
          f"{name} out is not finite")
    check(agree, f"{name} out disagrees with its plain version: max "
          f"{err.max():.3g}")
    check(same_rows, f"{name} lse is -inf on other rows than the plain "
          f"version's")
    check(lse_err <= K1_LSE_ATOL, f"{name} lse disagrees: {lse_err:.3g}")
    if packed:
        want = sliding_window_attention_packed_bwd_plain(
            q32, k32, v32, lens, lse, out.float(), do.float(), heads, **kw)
    else:
        want = sliding_window_attention_bwd_plain(
            q32, k32, v32, lens, lse, out.float(), do.float(), **kw)
    errs = [rel_err(g, w) for g, w in zip(grads, want)]
    bwd_abs = max((g.float() - w).abs().max().item()
                  for g, w in zip(grads, want))
    del want, q32, k32, v32
    check(all(bool(torch.isfinite(g.float()).all()) for g in grads),
          f"{name} gradients are not finite")
    check(max(errs) <= GRAD_REL_TOL,
          f"{name} gradients disagree with the plain version: {errs}")
    gc.collect()
    torch.cuda.empty_cache()

    mask = band_mask(L, lengths, window, block, "cuda", causal,
                     include_cls)
    pairs = int(mask.sum().item()) * heads
    row = {"shape": list(shape), "layout": "packed" if packed
           else "head_major", "head_dim": d, "block": block,
           "window": window, "causal": causal, "include_cls": include_cls,
           "lengths": list(lengths), "pairs": pairs}
    few = max(2, iters // 10)
    fwd_row = {**row, "max_abs_err": err.max().item(),
               "lse_max_abs_err": lse_err, "bit_identical": True,
               "ms": cuda_ms(fwd, iters),
               "device_ms": kernel_ms(device_ms(fwd), fwd_kernel)}
    times = device_ms(lambda: bwd(out, lse), 5)
    bwd_row = {**row, "max_abs_err": bwd_abs, "rel_errs_dq_dk_dv": errs,
               "bit_identical": True, "ms": cuda_ms(lambda: bwd(out, lse),
                                                    iters),
               "device_ms": sum(times.values()),
               "parts_device_ms": k2_parts(times, bwd_kernels)}
    if family == "generic" and include_cls:
        bwd_row["dkv_parts_device_ms"] = dkv_parts(
            bwd_row["parts_device_ms"], fwd, bwd, kw)
    if packed:
        fwd_row["plain_ms"] = cuda_ms(
            lambda: sliding_window_attention_packed_plain(
                q, k, v, lens, heads, **kw), few, warmup=1)
        bwd_row["plain_ms"] = cuda_ms(
            lambda: sliding_window_attention_packed_bwd_plain(
                q, k, v, lens, lse, out, do, heads, **kw), few, warmup=1)
        views = [t.view(b, L, heads, d).transpose(1, 2)
                 for t in (q, k, v, do)]
    else:
        fwd_row["plain_ms"] = cuda_ms(
            lambda: sliding_window_attention_plain(q, k, v, key_mask, **kw),
            few, warmup=1)
        bwd_row["plain_ms"] = cuda_ms(
            lambda: sliding_window_attention_bwd_plain(
                q, k, v, lens, lse, out, do, **kw), few, warmup=1)
        views = [q, k, v, do]
    fwd_row["library_ms"] = bwd_row["library_ms"] = None
    if library:
        try:
            fwd_row["library_ms"] = cuda_ms(
                lambda: F.scaled_dot_product_attention(
                    *views[:3], attn_mask=mask), few, warmup=1)
            bwd_row["library_ms"] = sdpa_backward_ms(
                *views, lens, window, block, mask)
        except (torch.OutOfMemoryError, RuntimeError) as exc:
            print(f"{name} library yardstick: {type(exc).__name__}: "
                  f"{str(exc)[:120]}", flush=True)
    del mask
    # Forward: q, k, v read and out written (bf16), lse written, lengths
    # read; per attended pair 2 products of d multiply-adds. Backward:
    # q, k, v, out, do read and three gradients written, lse read; per
    # pair s and dp recomputed, dq, dk, dv: 5 products.
    fwd_row["bound_ms"], fwd_row["bound_by"] = bound(
        4 * q.numel() * 2 + lse.numel() * 4 + lens.numel() * 4,
        4 * d * pairs, BF16_TENSOR_FLOPS)
    bwd_row["bound_ms"], bwd_row["bound_by"] = bound(
        8 * q.numel() * 2 + lse.numel() * 4 + lens.numel() * 4,
        10 * d * pairs, BF16_TENSOR_FLOPS)
    print(f"{name} fwd " + json.dumps(fwd_row), flush=True)
    print(f"{name} bwd " + json.dumps(bwd_row), flush=True)
    return fwd_row, bwd_row


def dkv_parts(parts: dict, fwd, bwd, kw: dict) -> dict:
    """The generic dk/dv of a call with the [CLS] slot by part: "band",
    the device ms of the same call's dk/dv without the [CLS] slot (the
    same band tasks, key block 0's band part written out directly);
    "cls_chunks", the rest of the dk/dv launch (the [CLS] CTAs, by
    difference); "reduce", the reduce kernel."""
    kw["include_cls"] = False
    try:
        out, lse = fwd()
        band = k2_parts(device_ms(lambda: bwd(out, lse), 5),
                        GENERIC_BWD_KERNELS)["dkv"]
    finally:
        kw["include_cls"] = True
    return {"band": band, "cls_chunks": parts["dkv"] - band,
            "reduce": parts["reduce"]}


def generic_phase() -> dict:
    """The generic pair (csrc/swa_generic.cu) against the fp32 plain
    versions at the shapes the JAX gates admit and no tuned instantiation
    takes: packed Dh 256 (bench.py --heads 2) at K5's three shapes,
    head-major Dh 32 (--heads 16) on full [8, 16, 12800] rows, block 256
    at head-major Dh 64 and packed Dh 128 both ways on ragged rows, packed
    Dh 512 (one head of d_model 512), K6's banded form at Dh 256 and the
    dense causal route at Dh 32; every case bit-identical across two
    calls."""
    rows = {}
    for tag, b, L, lengths, iters in (
            ("serve", 1, 512, [417], 50),
            ("long", 4, 4096, [4096, 3001, 1500, 129], 20),
            ("train", 8, 12800, TRAIN_LENGTHS, 3)):
        rows[f"h2_{tag}"] = attention_case(
            f"generic packed Dh 256 {tag}", b, L, lengths, 256, 2,
            seed=70 + b, iters=iters, packed=True)
    rows["h16_train"] = attention_case(
        "generic head-major Dh 32", 8, 12800, TRAIN_LENGTHS, 32, 16,
        seed=74, iters=3, packed=False)
    for causal in (True, False):
        way = "causal" if causal else "bidirectional"
        rows[f"block256_hm64_{way}"] = attention_case(
            f"generic head-major Dh 64 block 256 {way}", 4, 4096,
            [4096, 3001, 1500, 129], 64, 8, seed=75 + causal, iters=5,
            packed=False, block=256, causal=causal)
        rows[f"block256_packed128_{way}"] = attention_case(
            f"generic packed Dh 128 block 256 {way}", 4, 4096,
            [4096, 3001, 1500, 129], 128, 4, seed=77 + causal, iters=5,
            packed=True, block=256, causal=causal)
    rows["packed512"] = attention_case(
        "generic packed Dh 512", 2, 2048, [2048, 1000], 512, 1, seed=79,
        iters=5, packed=True)
    # Head dims that are no multiple of 16 (the zero padding), block 384,
    # and the dense route at an odd block count.
    rows["hm24"] = attention_case(
        "generic head-major Dh 24", 4, 4096, [4096, 3001, 1500, 129], 24, 8,
        seed=86, iters=5, packed=False)
    rows["block384_hm40_bidirectional"] = attention_case(
        "generic head-major Dh 40 block 384 bidirectional", 4, 4608,
        [4608, 3001, 1500, 129], 40, 8, seed=87, iters=5, packed=False,
        block=384, causal=False)
    rows["block384_packed256"] = attention_case(
        "generic packed Dh 256 block 384", 4, 4608, [4608, 3001, 1500, 129],
        256, 2, seed=88, iters=5, packed=True, block=384)
    rows["k6_dh256"] = k6_phase(2, 4096, 8192, [4224, 3000],
                                [128, 77], 2, seed=80, h=2, time_it=True,
                                d=256, family="generic")
    rows["dense_dh32"] = dense_phase(4, 16, 3584, [3584, 3101, 2049, 1024],
                                     seed=81, iters=5, d=32,
                                     family="generic")
    rows["dense_dh32_odd"] = dense_phase(
        4, 16, 3456, [3456, 3101, 2049, 1024], seed=89, iters=5, d=32,
        family="generic")
    return rows


def hm128_phase() -> dict:
    """K1/K2's head-major Dh 128 instantiation against the fp32 plain
    versions: at [8, 4, 12800, 128] on ragged rows and K6's banded form at
    Dh 128; the dense causal pair at [14, 4, 3584, 128]; then the paths
    that take them, counted alone: a sparse layer of bench.py --heads 4
    over model 2 (tensor parallelism keeps the head-major layout; K1/K2)
    and a dense causal Dh 128 layer (the dense causal pair), forward and
    backward."""
    rows = {"train": attention_case(
        "K1/K2 head-major Dh 128", 8, 12800, [12800, 11001, 7500, 3001] * 2,
        128, 4, seed=82, iters=5, packed=False, family="k1",
        counter="hm128")}
    rows["k6"] = k6_phase(2, 4096, 8192, [4224, 3000], [128, 77], 2,
                          seed=83, h=4, time_it=True, d=128)
    rows["dense"] = dense_phase(14, 4, 3584, [3584] * 14, seed=84, iters=5,
                                d=128, family="causal")
    torch.manual_seed(85)
    layers = [tattn.Attention(512, 4, causal=True, sparse=True, tp_size=2),
              tattn.Attention(512, 4, causal=True, sparse=False)]
    x = torch.randn((4, 3584, 512), device="cuda", dtype=torch.bfloat16,
                    requires_grad=True)
    mask = torch.arange(3584, device="cuda")[None, :] < torch.tensor(
        [[3584], [3584], [2000], [129]], device="cuda")
    layers = [layer.to("cuda", torch.bfloat16) for layer in layers]
    reset_counts()
    for layer in layers:
        layer(x, kv_mask=mask).float().square().mean().backward()
    torch.cuda.synchronize()
    counts = read_counts()
    check_counts("hm128-layers", counts, {"swa_fwd_hm128": 1,
                                          "swa_bwd_hm128": 1,
                                          "swa_fwd_dense": 1,
                                          "swa_bwd_dense": 1})
    check(bool(torch.isfinite(x.grad).all()), "hm128 layers' gradient is "
          "not finite")
    rows["layers"] = {"launches": counts}
    print("hm128-layers " + json.dumps({"launches": counts}), flush=True)
    return rows


def ce_inputs(t: int, seed: int, vocab: int = 32768, d: int = 512,
              padded: int = 0):
    """Tied-CE inputs; the last `padded` tokens are padding (label 0,
    dnll 0), as the tail of a short document gives them."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    g = torch.randn((t, d), generator=gen, device="cuda").to(torch.bfloat16)
    table = (0.05 * torch.randn((vocab, d), generator=gen, device="cuda")
             ).to(torch.bfloat16)
    bias = 0.1 * torch.randn(vocab, generator=gen, device="cuda")
    labels = torch.randint(1, vocab, (t,), generator=gen, device="cuda")
    dnll = torch.full((t,), 1.0 / (t - padded), device="cuda")
    labels[t - padded:] = 0
    dnll[t - padded:] = 0.0
    return g, table, bias, labels, dnll


# K3 and K3b are held against their plain versions at the token counts
# of the main paths, as (tokens, padding tokens at the tail): a train step
# at [4, 4096] (one chunk of K3b), an sp-train rank's 25,600 (two chunks
# of 12,800) and the [8, 12800] step's 102,400 (seven chunks of 14,720,
# the last 14,080), where both are also timed. The last two tails end
# inside a 128-token tile.
CE_CHECKS = ((16384, 2048), (25600, 3261), (102400, 12861))


def ce_check(g, table, bias, labels, dnll) -> dict:
    """K3 and K3b against their plain versions on the same inputs (the
    plain backward in fp32), and K3b's second call bit-identical to its
    first; fails on a disagreement."""
    t = g.shape[0]
    nll, lse = ce_kernel.tied_ce_fwd(g, table, bias, labels)
    nll2, lse2 = ce_kernel.tied_ce_fwd(g, table, bias, labels)
    grads = ce_kernel.tied_ce_bwd(g, table, bias, labels, lse, dnll)
    again = ce_kernel.tied_ce_bwd(g, table, bias, labels, lse, dnll)
    torch.cuda.synchronize()
    check(torch.equal(nll, nll2) and torch.equal(lse, lse2),
          f"K3 gives a different lse in two calls on the same inputs at "
          f"T = {t}")
    del nll2, lse2
    check(all(torch.equal(a, b) for a, b in zip(grads, again)),
          f"K3b gives different gradients in two calls on the same inputs "
          f"at T = {t}")
    del again
    want_nll, want_lse = ce_kernel.tied_ce_fwd_plain(g, table, bias, labels)
    want = ce_kernel.tied_ce_bwd_plain(g.float(), table.float(), bias,
                                       labels, want_lse, dnll)
    fwd_err = max((lse - want_lse).abs().max().item(),
                  (nll - want_nll).abs().max().item())
    bwd_errs = [rel_err(a, w) for a, w in zip(grads, want)]
    bwd_abs = max((a.float() - w.float()).abs().max().item()
                  for a, w in zip(grads, want))
    check(bool(torch.isfinite(nll).all()),
          f"K3 nll is not finite at T = {t}")
    check(fwd_err <= K3_ATOL, f"K3 disagrees with its plain version at "
          f"T = {t}: {fwd_err:.3g}")
    check(all(bool(torch.isfinite(a.float()).all()) for a in grads),
          f"K3b gradients are not finite at T = {t}")
    check(max(bwd_errs) <= GRAD_REL_TOL,
          f"K3b disagrees with its plain version at T = {t}: rel errors "
          f"{bwd_errs}")
    return {"tokens": t, "chunk_tokens": ce_kernel.bwd_chunk(
        t, table.shape[0]), "fwd_vocab_splits": ce_kernel.fwd_splits(
        t, table.shape[0], torch.cuda.get_device_properties(
            0).multi_processor_count),
        "padding": int((dnll == 0).sum().item()),
        "fwd_err": fwd_err, "bwd_abs_err": bwd_abs,
        "rel_errs_dg_dE_dbias": bwd_errs}


def k3_phase(seed: int, ce_checks=CE_CHECKS, d: int = 512,
             label: str = ""):
    """K3 and K3b at model width `d` against their plain versions at each
    of `ce_checks`; timed at the last of them beside the plain versions
    and F.linear + F.cross_entropy forward and backward."""
    checks = []
    for i, (t, padded) in enumerate(ce_checks):
        g, table, bias, labels, dnll = ce_inputs(t, seed + i, d=d,
                                                 padded=padded)
        checks.append(ce_check(g, table, bias, labels, dnll))
    fwd_err = max(c["fwd_err"] for c in checks)
    bwd_abs = max(c["bwd_abs_err"] for c in checks)

    t, vocab, d = g.shape[0], table.shape[0], g.shape[1]
    _, lse = ce_kernel.tied_ce_fwd(g, table, bias, labels)
    fwd_ms = cuda_ms(lambda: ce_kernel.tied_ce_fwd(g, table, bias, labels),
                     5)
    bwd_ms = cuda_ms(lambda: ce_kernel.tied_ce_bwd(g, table, bias, labels,
                                                   lse, dnll), 3)
    plain_fwd_ms = cuda_ms(lambda: ce_kernel.tied_ce_fwd_plain(
        g, table, bias, labels), 1, warmup=1)
    plain_bwd_ms = cuda_ms(lambda: ce_kernel.tied_ce_bwd_plain(
        g, table, bias, labels, lse, dnll), 1, warmup=1)
    lib_fwd_ms, lib_bwd_ms = ce_library_ms(g, table, bias, labels)
    fwd_device = kernel_ms(device_ms(lambda: ce_kernel.tied_ce_fwd(
        g, table, bias, labels), 3), "tied_ce_kernel")
    # K3b's parts on the device: the logit gradients (dl), the two
    # gradient products, the dbias sum, and PyTorch's share (the E^T and
    # g^T copies, the fp32 label-row term, the dtype casts).
    bwd_times = device_ms(lambda: ce_kernel.tied_ce_bwd(
        g, table, bias, labels, lse, dnll), 3)
    parts = {"dl": kernel_ms(bwd_times, "ce_dl_kernel"),
             "dg": kernel_ms(bwd_times, "ce_gemm_kernel<0,"),
             "dE": kernel_ms(bwd_times, "ce_gemm_kernel<1,"),
             "dbias": kernel_ms(bwd_times, "ce_dbias_kernel")}
    parts["pytorch"] = sum(bwd_times.values()) - sum(parts.values())
    flops = 2 * t * vocab * d
    in_bytes = g.numel() * 2 + table.numel() * 2 + vocab * 4 + t * 8
    # K3: reads once, writes lse and nll; one product of 2 T V D.
    fwd_bound = bound(in_bytes + 2 * t * 4, flops, BF16_TENSOR_FLOPS)
    # K3b: reads the inputs, lse and dnll, writes dg, dE and dbias; the
    # least work is the logits once and the two gradient products
    # (3 x 2 T V D, what the kernels do).
    bwd_bound = bound(in_bytes + 2 * t * 4 + g.numel() * 2
                      + table.numel() * 2 + vocab * 4, 3 * flops,
                      BF16_TENSOR_FLOPS)
    shape = [t, vocab, d]
    check_tokens = [c["tokens"] for c in checks]
    k3 = {"shape": shape, "check_tokens": check_tokens,
          "max_abs_err": fwd_err, "bit_identical": True,
          "vocab_splits": [c["fwd_vocab_splits"] for c in checks],
          "ms": fwd_ms, "device_ms": fwd_device, "plain_ms": plain_fwd_ms,
          "library_ms": lib_fwd_ms, "bound_ms": fwd_bound[0],
          "bound_by": fwd_bound[1]}
    k3b = {"shape": shape, "check_tokens": check_tokens,
           "max_abs_err": bwd_abs, "checks": checks, "bit_identical": True,
           "ms": bwd_ms, "device_ms": sum(bwd_times.values()),
           "parts_device_ms": parts, "chunk_tokens": ce_kernel.bwd_chunk(
               t, vocab), "plain_ms": plain_bwd_ms,
           "library_ms": lib_bwd_ms, "bound_ms": bwd_bound[0],
           "bound_by": bwd_bound[1]}
    print(f"K3{label} " + json.dumps(k3), flush=True)
    print(f"K3b{label} " + json.dumps(k3b), flush=True)
    return k3, k3b


def ce_library_ms(g, table, bias, labels):
    """(forward ms, backward ms) of F.linear + F.cross_entropy on the same
    inputs (bf16 logits, as autocast would give), a yardstick the port
    never calls."""
    gg, tt, bb = (x.detach().requires_grad_() for x in (g, table, bias))

    def fwd():
        logits = F.linear(gg, tt, bb.to(gg.dtype))
        return F.cross_entropy(logits.float(), labels, reduction="sum")

    def fwd_bwd():
        torch.autograd.grad(fwd(), (gg, tt, bb))

    try:
        fwd_ms = cuda_ms(fwd, 2, warmup=1)
        total = cuda_ms(fwd_bwd, 2, warmup=1)
    except torch.OutOfMemoryError:
        print("K3 library yardstick: out of memory at this shape",
              flush=True)
        return None, None
    return fwd_ms, total - fwd_ms


def train_phase(make, expect: dict, steps: int = 3, batch: int = 4,
                seq: int = 4096, seed: int = 11, name: str = "train") -> dict:
    """The model of `make(use_kernels, dtype)` -> (model, objective,
    optimizer) trains for `steps` optimizer steps on the card through the
    kernels; step 1 is held against the fp32 plain step on the card.
    expect: {counter: launches per step, or None for at least one}; every
    other kernel counter and both plain_routes counters must stay 0."""
    device = "cuda"
    model, objective, optimizer = make(True, None)
    rng = np.random.default_rng(seed)
    vocab = model.hparams.vocab_size
    batches = [synthetic_batch(rng, batch, seq, vocab, device=device)
               for _ in range(steps)]
    gen = torch.Generator(device=device).manual_seed(seed)
    noise = {"eps": torch.randn((batch, 1, model.hparams.latent_depth),
                                generator=gen, device=device),
             "mi": torch.randn((objective.mi_samples, batch,
                                model.hparams.latent_depth),
                               generator=gen, device=device)}
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    losses, step_s, first_grads = [], [], None
    for step in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        metrics = train_step(model, objective, optimizer, [batches[step]],
                             step, [noise] if step == 0 else None, gen)
        losses.append(float(metrics["loss"]))
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        if step == 0:
            first_grads = {n: p.grad.detach().clone()
                           for n, p in model.named_parameters()}
            first_metrics = {k: float(v) for k, v in metrics.items()}
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated()
    check(all(np.isfinite(losses)), f"{name} losses not finite: {losses}")
    check_counts(name, counts, {k: None if n is None else n * steps
                                for k, n in expect.items()})
    del model, optimizer

    ref, ref_objective, _ = make(False, torch.float32)
    ref_loss, _ = ref_objective.loss(ref, batches[0], 0, noise)
    ref_loss.backward()
    ref_loss = ref_loss.detach().item()
    cos = {}
    for pname, p in ref.named_parameters():
        a, w = first_grads[pname].double(), p.grad.double()
        cos[pname] = float((a * w).sum() / (a.norm() * w.norm()).clamp_min(
            1e-300))
    del ref
    worst = sorted(cos.items(), key=lambda kv: kv[1])[:3]
    loss_rel = abs(losses[0] - ref_loss) / abs(ref_loss)
    check(len(cos) == 165, f"{len(cos)} gradients compared, not 165")
    check(loss_rel <= TRAIN_LOSS_RTOL,
          f"{name} step 1 loss {losses[0]} vs fp32 plain {ref_loss}")
    check(worst[0][1] >= TRAIN_GRAD_COS,
          f"{name} step 1 gradients disagree with fp32 plain: {worst}")
    stats = {"steps": steps, "batch": [batch, seq],
             "real_tokens": [int(b["num_tokens"].sum()) for b in batches],
             "losses": losses, "step_s": step_s, "step1": first_metrics,
             "fp32_plain_loss": ref_loss, "loss_rel_err": loss_rel,
             "min_grad_cosine": worst, "launches": counts,
             "max_memory_allocated_bytes": peak}
    print(f"{name} " + json.dumps(stats), flush=True)
    return stats


REMAT_POLICIES = (None, "full", "dots", "dots_attn", "dots_attn_qkv",
                  "offload", None)    # no remat first and last: its spread
REMAT_TIMED_STEPS = 3
REMAT_SEED = 67
# K1 a step: the forward's launch a layer, and under these policies the
# recompute's again (dots_attn and dots_attn_qkv keep its out and lse).
REMAT_REPEATS_K1 = ("full", "dots", "offload")


def set_remat(model, name):
    """Every decoder layer of `model` under policy `name` (None: none)."""
    remat = None if name is None else checkpoint_policy(name)
    for layer in model.decoder_layers:
        layer.remat = remat


def remat_phase(smi: str) -> dict:
    """r5 in its training form (bf16 over fp32 masters) at full rows
    [8, 12800], from one state, batch and noise: for no remat and each of
    the five policies, step 1's loss and all 165 gradients bit-identical
    to no remat's (no remat runs first and last: where its two runs
    differ, a policy is held within their spread and the gradients that
    moved are named), then REMAT_TIMED_STEPS timed steps; each policy's
    ms a step, its peak memory over the steps (after a reset) and its
    launches a step, K1's 12 under full, dots and offload (the recompute
    launches it again) and 6 under the two attn policies, as without
    remat."""
    model, objective, optimizer = build_training(RUN, "cuda", 1)[:3]
    hp = model.hparams
    start = {k: v.detach().clone() for k, v in model.state_dict().items()}
    opt_start = optimizer.state_dict()
    rng = np.random.default_rng(REMAT_SEED)
    batch = synthetic_batch(rng, len(TRAIN_LENGTHS), TRAIN_LENGTHS[0],
                            hp.vocab_size, min_tokens=TRAIN_LENGTHS[0],
                            device="cuda")
    noise = step_noise(hp, objective, [batch], REMAT_SEED)
    runs, ref = [], None
    for name in REMAT_POLICIES:
        set_remat(model, name)
        model.load_state_dict(start)
        optimizer.load_state_dict(opt_start)
        gen = torch.Generator(device="cuda").manual_seed(REMAT_SEED)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        loss = float(train_step(model, objective, optimizer, [batch], 0,
                                noise, gen)["loss"])
        counts = read_counts()
        grads = {n: p.grad.detach().float().cpu()
                 for n, p in model.named_parameters()}
        step_s = []
        for step in range(1, REMAT_TIMED_STEPS + 1):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            train_step(model, objective, optimizer, [batch], step, None,
                       gen)
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t0)
        peak = torch.cuda.max_memory_allocated()
        check_counts(f"remat {name}", counts, {
            "swa_fwd": 12 if name in REMAT_REPEATS_K1 else 6,
            "swa_bwd": 6, "tied_ce_fwd": 1, "tied_ce_bwd": 1})
        run = {"policy": name, "loss": loss, "step_ms": [
            1e3 * t for t in step_s], "max_memory_allocated_bytes": peak,
            "launches_per_step": counts}
        if ref is None:
            ref = (loss, grads)
        else:
            run["loss_diff"] = loss - ref[0]
            run["moved"] = {n: float((g - ref[1][n]).abs().max())
                            for n, g in grads.items()
                            if not torch.equal(g, ref[1][n])}
        runs.append(run)
        del grads
    check(len(ref[1]) == 165, f"{len(ref[1])} gradients, not 165")
    spread = runs[-1]
    for run in runs[1:-1]:
        over = {n: d for n, d in run["moved"].items()
                if d > spread["moved"].get(n, 0.0)}
        check(abs(run["loss_diff"]) <= abs(spread["loss_diff"]) and not over,
              f"remat {run['policy']}: step 1 differs from no remat "
              f"beyond the no-remat spread: loss {run['loss_diff']}, "
              f"gradients {sorted(over.items())[:5]}")
    plain = runs[0]["max_memory_allocated_bytes"]
    full = next(r for r in runs if r["policy"] == "full")
    check(full["max_memory_allocated_bytes"] < plain,
          f"remat full peaks at {full['max_memory_allocated_bytes']} "
          f"bytes, no remat at {plain}")
    out = {"batch": [len(TRAIN_LENGTHS), TRAIN_LENGTHS[0]],
           "bit_identical": all(not r["moved"] and r["loss_diff"] == 0
                                for r in runs[1:]),
           "nondeterministic_without_remat": spread["moved"],
           "runs": runs, "card": smi}
    print("remat " + json.dumps(out), flush=True)
    del model, optimizer
    gc.collect()
    torch.cuda.empty_cache()
    return out


def bench_model(use_kernels: bool = True, dtype=None, train: bool = False,
                heads: int = 4):
    """The Dh = 128 model (bench.py --heads 4), or the bench's model at
    another head count (heads=2: packed Dh 256), from the JAX
    initialisation drawn from a torch.Generator seeded H4_SEED."""
    gen = torch.Generator().manual_seed(H4_SEED)
    if train:
        return build_from_hparams(bench_hparams(heads), gen, "cuda",
                                  use_kernels, dtype)[:3]
    model, _ = model_from_hparams(bench_hparams(heads), gen, device="cuda",
                                  dtype=dtype, use_kernels=use_kernels)
    return model


def model_bench_phase(model, seed: int = 0, length: int = 256,
                      heads: int = 4) -> dict:
    """Prefill logits of the bf16 Dh = 128 model (K5), or of the bench's
    model at `heads` heads, against the fp32 plain model on the card, on
    one fixed input."""
    ref_model = bench_model(use_kernels=False, dtype=torch.float32,
                            heads=heads)
    rng = np.random.default_rng(seed)
    ids = rng.integers(3, model.hparams.vocab_size, size=(1, length))
    ids[0, 0] = 1
    ids[0, 200:] = 0                                   # right padding
    z = rng.standard_normal((1, 1, model.hparams.latent_depth))
    ids_t = torch.tensor(ids, device="cuda")
    z_t = torch.tensor(z, dtype=torch.float32, device="cuda")
    with torch.inference_mode():
        got = model.reconstruct(ids_t, z_t).float()
        ref = ref_model.reconstruct(ids_t, z_t)
    del ref_model
    real = ids_t[0] != 0
    diff = (got - ref).abs()[0, real]
    rel = (diff.max() / ref[0, real].abs().max()).item()
    check(got.shape == ref.shape and bool(torch.isfinite(got).all()),
          f"h{heads} model logits are not finite or have the wrong shape")
    check(rel <= MODEL_H4_REL_TOL,
          f"h{heads} model logits rel err {rel:.3g}")
    row = {"max_abs_err": diff.max().item(), "mean_abs_err":
           diff.mean().item(), "max_abs_logit": ref[0, real].abs().max()
           .item(), "rel_err": rel, "tokens": int(real.sum())}
    print(f"model-h{heads} " + json.dumps(row), flush=True)
    return row


reset_counts = launches.reset
read_counts = launches.read


def sp_mask(S: int, start: int, ext_lens, cls_lens, window: int,
            block: int = 128):
    """[B, 1, S, block + ctx + S] bool: what one shard's queries attend
    in the key layout [CLS block | k_ext], the mask K6 applies (shard 0:
    K1's band + [CLS] slot over its local keys, the [CLS] columns unused)."""
    ctx = (window - 1) * block
    i = torch.arange(S, device="cuda")
    e = torch.arange(ctx + S, device="cuda")
    t = start + i                                    # query positions
    g = start - ctx + e                              # extended key positions
    ext = torch.tensor(ext_lens, device="cuda")
    if start == 0:
        local = e - ctx
        band = ((t[:, None] // block - local[None, :] // block < window)
                | (local[None, :] // block == 0)) & (local[None, :] >= 0) \
            & (local[None, :] <= t[:, None])
        keys = (local[None, :] >= 0) & (local[None, :] < ext[:, None])
        ext_mask = band[None] & keys[:, None, :]
        cls_mask = torch.zeros((len(ext_lens), S, block), dtype=torch.bool,
                               device="cuda")
    else:
        band = (g[None, :] // block > t[:, None] // block - window) \
            & (g[None, :] <= t[:, None])
        ext_mask = band[None] & (e[None, :] < ext[:, None])[:, None, :]
        cls = torch.arange(block, device="cuda")[None, :] < torch.tensor(
            cls_lens, device="cuda")[:, None]
        cls_mask = cls[:, None, :].expand(-1, S, -1)
    return torch.cat([cls_mask, ext_mask], dim=2)[:, None]


def k6_phase(b: int, S: int, start: int, ext_lens, cls_lens, window: int,
             seed: int, h: int = 8, time_it: bool = False, d: int = 64,
             block: int = 128, family: str = "k1"):
    """K6 forward and backward (ops/sp_kernel.py: one K1 call with q_off,
    the backward one K2 call, the broadcast [CLS] block a slot of each)
    against its plain version on the same bf16 inputs, the backward
    bit-identical across two calls; filler rows (ext_len 0 and cls_len 0)
    must give out 0 and zero gradients with no NaN. Timed beside its plain
    version and SDPA over [CLS | k_ext] under the same mask when time_it;
    then a banded shard's profiled forward must launch K1's kernel only
    and its backward K2's kernels only. d, block and family: another head
    dim or block, and the kernels that take it (`FAMILIES`)."""
    fwd_kernel, bwd_kernels = FAMILIES[family]
    ctx = (window - 1) * block
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(
            torch.bfloat16)

    q, do = randn(b, h, S, d), randn(b, h, S, d)
    k_ext, v_ext = randn(b, h, ctx + S, d), randn(b, h, ctx + S, d)
    cls_k, cls_v = randn(b, h, block, d), randn(b, h, block, d)
    if start == 0:       # shard 0 receives a zero halo
        k_ext[:, :, :ctx] = 0
        v_ext[:, :, :ctx] = 0
    ext_len = torch.tensor(ext_lens, dtype=torch.int32, device="cuda")
    cls_len = torch.tensor(cls_lens, dtype=torch.int32, device="cuda")
    args = (q, k_ext, v_ext, cls_k, cls_v, start, ext_len, cls_len)
    out, lse = sp_kernel.sp_fwd(*args, window, block)
    grads = sp_kernel.sp_bwd(*args, out, lse, do, window, block)
    again = sp_kernel.sp_bwd(*args, out, lse, do, window, block)
    torch.cuda.synchronize()
    check(all(torch.equal(a, b) for a, b in zip(grads, again)),
          f"K6's backward gives different gradients in two calls at "
          f"start {start}, window {window}")
    del again
    # The plain forward rounds the band's output to bf16 before the
    # logaddexp merge with the [CLS] part, as JAX does; the kernel rounds
    # the joint output once: about one bf16 rounding apart, inside K1's
    # tolerance.
    ref, ref_lse = sp_kernel.sp_fwd_plain(*args, window, block)
    want = sp_kernel.sp_bwd_plain(*args, out, lse, do, window, block)
    check(all(bool(torch.isfinite(t.float()).all()) for t in (out, *grads)),
          "K6 out or gradients are not finite")
    err = (out.float() - ref.float()).abs()
    check(bool((err <= K1_OUT_ATOL + K1_OUT_RTOL * ref.float().abs()).all()),
          f"K6 out disagrees with its plain version: max {err.max():.3g}")
    check(torch.equal(torch.isinf(lse), torch.isinf(ref_lse)),
          "K6 lse is -inf on other rows than its plain version's")
    finite = torch.isfinite(ref_lse)
    lse_err = (lse[finite] - ref_lse[finite]).abs().max().item()
    check(lse_err <= K1_LSE_ATOL, f"K6 lse disagrees: {lse_err:.3g}")
    errs = [rel_err(g, w) for g, w in zip(grads, want)]
    abs_err = max((g.float() - w.float()).abs().max().item()
                  for g, w in zip(grads, want))
    check(max(errs) <= GRAD_REL_TOL,
          f"K6 gradients disagree with the plain version: {errs}")
    filler = [r for r in range(b) if ext_lens[r] == 0 and cls_lens[r] == 0]
    for r in filler:
        check(bool((out[r] == 0).all()) and all(
            bool((g[r] == 0).all()) for g in grads),
            f"K6 filler row {r} is not zero")
    row = {"shape": [b, h, S, d], "k_ext": list(k_ext.shape),
           "start": start, "window": window, "ext_len": list(ext_lens),
           "cls_len": list(cls_lens), "filler_rows": filler,
           "max_abs_err": err.max().item(), "lse_max_abs_err": lse_err,
           "bwd_max_abs_err": abs_err,
           "rel_errs_dq_dkext_dvext_dclsk_dclsv": errs,
           "bwd_bit_identical": True}
    if time_it:
        mask = sp_mask(S, start, ext_lens, cls_lens, window, block)
        pairs = int(mask.sum().item()) * h
        keys = torch.cat([cls_k, k_ext], dim=2)
        values = torch.cat([cls_v, v_ext], dim=2)
        row["ms"] = cuda_ms(lambda: sp_kernel.sp_fwd(*args, window, block),
                            10)
        # On the device: the whole call, and K1's kernel inside it (on a
        # banded shard all of it: the band and the broadcast [CLS] block
        # in one launch).
        times = device_ms(lambda: sp_kernel.sp_fwd(*args, window, block))
        row["device_ms"] = sum(times.values())
        row["k1_device_ms"] = kernel_ms(times, fwd_kernel)
        if start > 0:
            others = sorted(name for name in times
                            if fwd_kernel not in name)
            check(not others, f"K6's forward on a banded shard launched "
                  f"other kernels than {fwd_kernel}: {others}")
            print(f"K6 forward on a banded shard: {len(times)} kernel, "
                  f"{fwd_kernel} (no cuBLAS, no aten elementwise)",
                  flush=True)
        row["bwd_ms"] = cuda_ms(lambda: sp_kernel.sp_bwd(
            *args, out, lse, do, window, block), 10)
        # The backward on the device, and K2's kernels inside it (on a
        # banded shard all of it: the band and the broadcast [CLS] block
        # in one K2 call).
        times = device_ms(lambda: sp_kernel.sp_bwd(
            *args, out, lse, do, window, block))
        row["bwd_device_ms"] = sum(times.values())
        parts = k2_parts(times, bwd_kernels)
        row["bwd_k2_device_ms"] = sum(parts.values()) - parts["pytorch"]
        row["bwd_parts_device_ms"] = parts
        if start > 0:
            others = sorted(name for name in times if not any(
                kernel in name for kernel in bwd_kernels.values()))
            check(not others, f"K6's backward on a banded shard launched "
                  f"other kernels than {family}'s: {others}")
            print(f"K6 backward on a banded shard: {len(times)} kernels, "
                  f"all {family}'s (no cuBLAS or aten matmul)", flush=True)
        row["plain_ms"] = cuda_ms(lambda: sp_kernel.sp_fwd_plain(
            *args, window, block), 2, warmup=1)
        row["bwd_plain_ms"] = cuda_ms(lambda: sp_kernel.sp_bwd_plain(
            *args, out, lse, do, window, block), 2, warmup=1)
        try:
            row["library_ms"] = cuda_ms(
                lambda: F.scaled_dot_product_attention(
                    q, keys, values, attn_mask=mask), 2, warmup=1)
        except torch.OutOfMemoryError:
            print("K6 library yardstick: out of memory", flush=True)
            row["library_ms"] = None
        row["bwd_library_ms"] = sdpa_backward_ms(q, keys, values, do, None,
                                                 window, block, mask)
        del mask, keys, values
        lens_bytes = 2 * b * 4
        # Forward: q, k_ext, v_ext, cls_k, cls_v read and out written
        # (bf16), lse written (fp32); per attended pair 2 products of Dh
        # multiply-adds.
        io = (2 * q.numel() + 2 * k_ext.numel() + 2 * cls_k.numel()) * 2
        row["bound_ms"], row["bound_by"] = bound(
            io + lse.numel() * 4 + lens_bytes, 4 * d * pairs,
            BF16_TENSOR_FLOPS)
        # Backward: those inputs, out and do read, lse read, the five
        # gradients written; per pair s and dp recomputed, dq, dk, dv.
        row["bwd_bound_ms"], row["bwd_bound_by"] = bound(
            2 * io + q.numel() * 2 + lse.numel() * 4 + lens_bytes,
            10 * d * pairs, BF16_TENSOR_FLOPS)
        row["pairs"] = pairs
    label = "" if (d, block, family) == (64, 128, "k1") else \
        f" {family} Dh {d} block {block}"
    print(f"K6{label} " + json.dumps(row), flush=True)
    return row


def cosines(got: dict, want: dict) -> dict:
    out = {}
    for name, w in want.items():
        a, w = got[name].double(), w.double()
        out[name] = float((a * w).sum() / (a.norm() * w.norm()).clamp_min(
            1e-300))
    return out


def unsharded_sp_step(use_kernels: bool, dtype, noise=None):
    """One unsharded step of r5 on the sp-train document [1, SP_SEQ]:
    (loss, gradients on the CPU, launch counts, seconds, peak bytes,
    noise). noise: the posterior noise, drawn from SP_SEED when None."""
    model, objective, optimizer = build_training(
        RUN, "cuda", 1, use_kernels=use_kernels, dtype=dtype)[:3]
    hp = model.hparams
    rng = np.random.default_rng(SP_SEED)
    mb = synthetic_batch(rng, 1, SP_SEQ, hp.vocab_size,
                         pad_to_multiple_of=sp_pad_multiple(hp, SP),
                         device="cuda")
    check(mb["token_ids"].shape == (1, SP_SEQ), "the document is padded")
    if noise is None:
        gen = torch.Generator(device="cuda").manual_seed(SP_SEED)
        noise = {"eps": torch.randn((1, 1, hp.latent_depth), generator=gen,
                                    device="cuda"),
                 "mi": torch.randn((objective.mi_samples, 1,
                                    hp.latent_depth), generator=gen,
                                   device="cuda")}
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    metrics = train_step(model, objective, optimizer, [mb], 0, [noise])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = read_counts()
    grads = {n: p.grad.detach().float().cpu()
             for n, p in model.named_parameters()}
    out = (float(metrics["loss"]), grads, counts, seconds,
           torch.cuda.max_memory_allocated(), noise)
    del model, objective, optimizer, metrics, mb
    gc.collect()
    torch.cuda.empty_cache()
    return out


def sp_pair_rank(group, kernel_args: tuple, plain_args: tuple) -> tuple:
    """One rank of sp-train: train.train_rank through the kernels, then
    through the fp32 plain versions, in one process."""
    kernel = train_rank(group, *kernel_args)
    gc.collect()
    torch.cuda.empty_cache()
    return kernel, train_rank(group, *plain_args)


def sp_train_plan(steps: int = 2) -> tuple:
    """r5's step on one [1, SP_SEQ] document, unsharded (here) and over SP
    ranks (a part of `mesh_phases`' one spawn) with the same weights,
    document and eps, each in bf16 through the kernels and in fp32
    through the plain versions (train.train_rank); then 1 more sharded
    kernel step.

    The fp32 pair is held exactly (loss 1e-5 relative, all 165 gradients
    at cosine >= 0.99). The kernel pair: loss within 1e-3 relative; a
    gradient at cosine >= 0.99 with the unsharded kernel step wherever that
    step is itself at >= 0.99 with the fp32 one, and elsewhere no farther
    from the fp32 gradient than the unsharded kernel step less
    NOISY_GRAD_MARGIN: a few tensors whose gradients are near zero (the
    encoder bottleneck's, at this length) sit at bf16 noise in either
    bf16 step, so the unsharded kernel step is no reference for them.
    Every rank on the card, one backend, the same losses and bitwise equal
    parameters after every step. The finish's stats carry "refs", the
    unsharded steps mesh-seq holds r5 over seq x model against."""
    a_loss, a_grads, a_counts, a_s, a_peak, noise = unsharded_sp_step(
        True, None)
    check_counts("sp-train unsharded", a_counts,
                 {"swa_fwd": 6, "swa_bwd": 6, "tied_ce_fwd": 1,
                  "tied_ce_bwd": 1})
    c_loss, c_grads, c_counts, c_s, _, _ = unsharded_sp_step(
        False, torch.float32, noise)
    args = (RUN, steps, 1, SP_SEQ, SP_SEED, 1,
            [{k: v.cpu() for k, v in noise.items()}], True, False)
    part = (args + (True, None),
            args[:1] + (1,) + args[2:] + (False, torch.float32))

    def finish(got):
        records, plain, seconds = pair_runs(got[0])
        for step in range(steps):
            check(len({r["param_digests"][step] for r in records}) == 1,
                  f"parameters differ across ranks after step {step + 1}")
        held = held_sharded("sp-train", records[0]["metrics"][0]["loss"],
                            records[0]["grads"],
                            {"loss": a_loss, "grads": a_grads},
                            {"loss": c_loss, "grads": c_grads},
                            plain[0]["metrics"][0]["loss"],
                            plain[0]["grads"])
        check(held["gradients"] == 165,
              f"{held['gradients']} gradients compared, not 165")
        for r in records:
            c = r["launches"]
            check(c["swa_plain_routes"] == 0 and c["ce_plain_routes"] == 0,
                  f"rank {r['rank']} took a plain route: {c}")
            check(c["tied_ce_fwd"] > 0 and c["tied_ce_bwd"] > 0,
                  f"rank {r['rank']} ran no K3/K3b: {c}")
            if r["rank"] == 0:
                check(c["swa_fwd"] > 0 and c["swa_bwd"] > 0
                      and c["sp_windowed_attention"] == 0,
                      f"rank 0 ran no K1/K2 or ran K6: {c}")
            else:
                check(c["sp_windowed_attention"] > 0
                      and c["sp_windowed_attention_bwd"] > 0
                      and c["swa_fwd"] == 0 and c["swa_bwd"] == 0,
                      f"rank {r['rank']} ran no K6 or ran K1/K2: {c}")
        held["fp32"].update(unsharded_step_s=c_s,
                            step_s_by_rank=[r["step_s"] for r in plain])
        stats = {"sp": SP, "backend": records[0]["backend"],
                 "document": [1, SP_SEQ],
                 "unsharded": {"loss": a_loss, "step_s": a_s, "launches":
                               a_counts, "max_memory_allocated_bytes":
                               a_peak},
                 "losses": [m["loss"] for m in records[0]["metrics"]],
                 **held, "ranks_s": seconds,
                 "step_s_by_rank": [r["step_s"] for r in records],
                 "max_memory_allocated_by_rank": [
                     r.get("max_memory_allocated") for r in records],
                 "launches_by_rank": [r["launches"] for r in records]}
        print("sp-train " + json.dumps(stats), flush=True)
        return stats

    refs = {"noise": [{k: v.cpu() for k, v in noise.items()}],
            "a": {"loss": a_loss, "grads": a_grads, "launches": a_counts,
                  "seconds": a_s, "peak": a_peak, "real_tokens": SP_SEQ},
            "c": {"loss": c_loss, "grads": c_grads, "launches": c_counts}}
    return ("sp-train", [("sp-train", sp_pair_rank, part)], finish), refs


# -- fit: the trainer loop on bucketed document batches --------------------

REPO = Path(__file__).resolve().parent
PG19_RUN = "real-prose-pg19-fb8"
FIT_DOCS = 200       # documents of the stand-in corpus
FIT_SEED = 23
FIT_STEPS = 2        # r5: validation and a checkpoint at steps 1 and 2
FIT_EVERY = 1
PG19_STEPS = 2       # pg19-fb8: one validation, at step 2
PG19_STREAM = 102400
# The stand-in of the validation held against the plain versions: each
# document repeats one seeded segment of VAL_PERIOD ids, so a trained model
# predicts a token from its copy one period back, inside the attention
# band, and val_nll depends on the band
# (tests/test_torch_trainer.py::
# test_the_stand_in_validation_sees_the_attention_band). On uniform ids
# it depends on it far less: the mean over uniform targets stays near
# ln V whatever the attention gives.
VAL_PERIOD = 100
# The plain loss holds a chunk's fp32 logits [rows x chunk, V] and their
# gradient; the chunk runs along the length, so a group of many short
# rows (65 rows of 1,536 tokens, padded to one chunk of 2,048: 16 GiB of
# logits) would not fit beside the activations. The plain references
# of the fit and evaluation phases take chunks of at most this many
# tokens (the summation order aside, the same loss).
PLAIN_CE_TOKENS = 16384
# The run shows that the check can fail: the plain validation with the
# band's older block dropped must move val_nll by at least VAL_POWER times
# TRAIN_LOSS_RTOL.
VAL_POWER = 10


def fit_corpus(n_docs: int, min_tokens: int, max_tokens: int, vocab: int,
               seed: int, period=None) -> TokenizedCorpus:
    """A stand-in for a tokenized corpus, as training/data.py's batches
    stand in for a corpus's: the phase does not count on a tokenizer
    library on the card's machine, so the documents are ids, each [CLS],
    ids uniform in [3, vocab) (with `period`, one segment of that many
    such ids, repeated), then [SEP], of lengths log-uniform over
    [min_tokens, max_tokens], with num_bytes = 4 x tokens. They go through
    the data module's steps after tokenization
    (TextDataModule.prepare_corpus) and its batching as a tokenized corpus
    does."""
    rng = np.random.default_rng(seed)
    lengths = np.clip(np.round(np.exp(rng.uniform(
        np.log(min_tokens), np.log(max_tokens), size=n_docs))),
        min_tokens, max_tokens).astype(np.int64)
    docs = []
    for n in lengths:
        if period is None:
            doc = rng.integers(3, vocab, size=n).astype(np.uint16)
        else:
            doc = np.resize(rng.integers(3, vocab, size=period).astype(
                np.uint16), n)
        doc[0], doc[-1] = CLS_ID, SEP_ID
        docs.append(doc)
    return TokenizedCorpus(docs=docs, num_bytes=4 * lengths)


def cpu_state(state: dict) -> dict:
    """A CPU copy of Trainer.state(...)."""
    opt = state["optimizer"]
    return {"params": {k: v.detach().cpu().clone()
                       for k, v in state["params"].items()},
            "optimizer": {"count": opt["count"],
                          "exp_avg": [m.cpu().clone()
                                      for m in opt["exp_avg"]],
                          "exp_avg_sq": [v.cpu().clone()
                                         for v in opt["exp_avg_sq"]]},
            "step": state["step"], "generator": state["generator"].clone()}


def states_equal(a: dict, b: dict) -> bool:
    """Bit for bit: params, both moments, counts, step, generator."""
    return (a["step"] == b["step"]
            and torch.equal(a["generator"], b["generator"])
            and a["params"].keys() == b["params"].keys()
            and all(torch.equal(a["params"][k], b["params"][k])
                    for k in a["params"])
            and a["optimizer"]["count"] == b["optimizer"]["count"]
            and all(len(a["optimizer"][n]) == len(b["optimizer"][n])
                    and all(torch.equal(x, y) for x, y in zip(
                        a["optimizer"][n], b["optimizer"][n]))
                    for n in ("exp_avg", "exp_avg_sq")))


class FitTrainer(Trainer):
    """The Trainer, recording what fit does: each group's shape, real
    tokens, seconds (between synchronisations), loss and grad_norm, and
    the first group of each shape; each validation's seconds and batches;
    each checkpoint's seconds; and a CPU copy of the state saved at
    `capture_step`."""

    def __init__(self, *args, capture_step=None, **kwargs):
        super().__init__(*args, **kwargs)
        self.capture_step = capture_step
        self.steps, self.validations, self.saves = [], [], []
        self.groups = {}
        self.captured = None

    def _step(self, model, optimizer, stacked, step, generator):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        self.groups.setdefault(tuple(stacked["token_ids"].shape), stacked)
        metrics = super()._step(model, optimizer, stacked, step, generator)
        loss, grad_norm = float(metrics["loss"]), float(metrics["grad_norm"])
        torch.cuda.synchronize()
        self.steps.append({"shape": list(stacked["token_ids"].shape),
                           "real_tokens": int(stacked["num_tokens"].sum()),
                           "seconds": time.perf_counter() - t0,
                           "loss": loss, "grad_norm": grad_norm})
        return metrics

    def validate(self, model, generator=None, max_batches=None, step=0):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = super().validate(model, generator, max_batches, step)
        limit = max_batches or self.thp.limit_val_batches
        n = len(self._val_batches)
        self.validations.append({
            "step": step, "seconds": time.perf_counter() - t0,
            "batches": n if limit is None else min(n, limit), **out})
        return out

    def _save(self, model, optimizer, step, generator, best=False):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        super()._save(model, optimizer, step, generator, best)
        self.saves.append({"step": step, "best": best,
                           "seconds": time.perf_counter() - t0})
        if step == self.capture_step and self.captured is None:
            self.captured = cpu_state(self.state(model, optimizer, step,
                                                 generator))


def plain_chunk(hp, rows: int) -> int:
    """The plain loss's chunk along the length for `rows` rows a call:
    at most PLAIN_CE_TOKENS tokens of fp32 logits at a time."""
    return max(1, min(hp.loss_chunk_size or 2048, PLAIN_CE_TOKENS // rows))


def step_noise(hp, objective, microbatches: list, seed: int) -> list:
    """One noise dict a micro-batch, drawn from `seed`: {"eps": [rows, 1,
    latent], "mi": [mi_samples, rows, latent]}, or with train_mc_samples
    K > 1 (the IWAE/DReG bound) {"eps": [K, rows, 1, latent]}."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    noise = []
    for mb in microbatches:
        rows = mb["token_ids"].shape[0]
        if hp.train_mc_samples > 1:
            noise.append({"eps": torch.randn(
                (hp.train_mc_samples, rows, 1, hp.latent_depth),
                generator=gen, device="cuda")})
            continue
        noise.append({
            "eps": torch.randn((rows, 1, hp.latent_depth), generator=gen,
                               device="cuda"),
            "mi": torch.randn((objective.mi_samples, rows, hp.latent_depth),
                              generator=gen, device="cuda")})
    return noise


def run_step(run: str, microbatches: list, use_kernels: bool, dtype,
             noise=None, seed: int = 0, mc_samples: int = 1):
    """One optimizer step of runs/<run>'s trained weights in the training
    form on `microbatches`, with train_mc_samples `mc_samples`: (loss,
    gradients on the CPU, launch counts, noise, hparams). noise: as
    step_noise gives it, drawn from `seed` when None. Through the plain
    versions the loss's chunks take at most PLAIN_CE_TOKENS tokens."""
    model, objective, optimizer = build_training(
        run, "cuda", len(microbatches), use_kernels=use_kernels,
        dtype=dtype)[:3]
    hp = model.hparams
    hp.train_mc_samples = mc_samples     # the objective reads the same hp
    if not use_kernels:
        rows = microbatches[0]["token_ids"].shape[0]
        hp.loss_chunk_size = plain_chunk(hp, mc_samples * rows)
    if noise is None:
        noise = step_noise(hp, objective, microbatches, seed)
    reset_counts()
    metrics = train_step(model, objective, optimizer, microbatches, 0, noise)
    loss = float(metrics["loss"])
    counts = read_counts()
    grads = {n: p.grad.detach().float().cpu()
             for n, p in model.named_parameters()}
    del model, objective, optimizer, metrics
    gc.collect()
    torch.cuda.empty_cache()
    return loss, grads, counts, noise, hp


def step_against_plain(run: str, mbs: list, name: str, seed: int,
                       expect: dict, mc_samples: int = 1) -> dict:
    """One optimizer step of runs/<run>'s trained weights in the training
    form on the micro-batches `mbs`, in bf16 through the kernels (launch
    counts `expect`), against the same step with the same noise in fp32
    through the plain versions: the loss within TRAIN_LOSS_RTOL and each
    of the 165 gradients at cosine >= TRAIN_GRAD_COS. A gradient below
    that passes only as sp_train_plan's near-zero gradients do: where
    the same step in bf16 through the plain versions is below
    TRAIN_GRAD_COS too (the bf16 noise of a gradient near zero, no
    kernel's), and the kernel step is no farther from fp32 than that step
    less NOISY_GRAD_MARGIN."""
    loss, grads, counts, noise, hp = run_step(
        run, mbs, True, None, seed=seed, mc_samples=mc_samples)
    check_counts(name, counts, expect)
    ref_loss, ref_grads, ref_counts, _, _ = run_step(
        run, mbs, False, torch.float32, noise, mc_samples=mc_samples)
    check_counts(f"{name} fp32 plain", ref_counts, {})
    cos = cosines(grads, ref_grads)
    loss_rel = abs(loss - ref_loss) / abs(ref_loss)
    check(len(cos) == 165, f"{len(cos)} gradients compared, not 165")
    check(np.isfinite(loss) and loss_rel <= TRAIN_LOSS_RTOL,
          f"{name}: loss {loss} vs fp32 plain {ref_loss}")
    noisy = {n: {"kernels_vs_fp32": c} for n, c in cos.items()
             if c < TRAIN_GRAD_COS}
    if noisy:
        _, plain_grads, _, _, _ = run_step(run, mbs, False, None, noise,
                                           mc_samples=mc_samples)
        plain_cos = cosines(plain_grads, ref_grads)
        for n, c in noisy.items():
            c["bf16_plain_vs_fp32"] = plain_cos[n]
            check(plain_cos[n] < TRAIN_GRAD_COS
                  and c["kernels_vs_fp32"]
                  >= plain_cos[n] - NOISY_GRAD_MARGIN,
                  f"{name}: {n} disagrees with fp32 plain: {c}")
    held = {n: c for n, c in cos.items() if n not in noisy}
    return {"loss": loss, "fp32_plain_loss": ref_loss,
            "loss_rel_err": loss_rel,
            "min_grad_cosine": sorted(held.items(),
                                      key=lambda kv: kv[1])[:3],
            "near_zero_gradients": noisy, "launches": counts}


def fit_group_check(run: str, stacked: dict, seed: int) -> dict:
    """train_phase's check on a group [k, rows, L] that fit fed:
    step_against_plain on runs/<run>'s trained weights, K1/K2 once a
    layer and K3/K3b once a micro-batch."""
    k, rows, length = stacked["token_ids"].shape
    name = f"fit {run} group {[k, rows, length]}"
    mbs = [{key: torch.from_numpy(arr[i]).to("cuda", torch.int64)
            for key, arr in stacked.items()} for i in range(k)]
    layers = json.loads((REPO / "runs" / run / "meta.json").read_text())[
        "model_hparams"]["num_layers"]
    held = step_against_plain(run, mbs, name, seed, {
        "swa_fwd": layers * k, "swa_bwd": layers * k,
        "tied_ce_fwd": k, "tied_ce_bwd": k})
    return {"group": [k, rows, length],
            "real_tokens": int(stacked["num_tokens"].sum()),
            **{key: held[key] for key in (
                "loss", "fp32_plain_loss", "loss_rel_err",
                "min_grad_cosine", "near_zero_gradients")}}


@contextlib.contextmanager
def band_without_block(which: str = "older"):
    """The plain attention with one block of each query block's band
    dropped, "older" (the band's oldest) or "current" (the query's own
    block): a K1 with a wrong band, which a check on the plain versions
    must tell from the right one."""
    real = swa_plain._band_indices

    def cut(num_blocks, window_size, include_cls, causal=True, device=None,
            q_off=0):
        k_idx, valid = real(num_blocks, window_size, include_cls, causal,
                            device, q_off)
        valid = valid.clone()
        column = int(include_cls) + (window_size - 1 if which == "current"
                                     else 0)
        valid[:, column] = False
        return k_idx, valid

    swa_plain._band_indices = cut
    try:
        yield
    finally:
        swa_plain._band_indices = real


def validate_against_plain(n_docs: int, log_root: Path) -> dict:
    """Trainer.validate of r5's trained weights in the training form,
    through the kernels against the plain versions (the same bf16
    compute, parameters and noise), on the validation split of a stand-in
    corpus whose documents repeat a segment of VAL_PERIOD ids: val_nll
    within TRAIN_LOSS_RTOL, K1 and K3 launched once a layer and once a
    batch. The run shows that this can fail a wrong kernel: the plain
    validation with the band's older block dropped must move val_nll by
    at least VAL_POWER x TRAIN_LOSS_RTOL. val_kl is not compared: the
    encoder runs no kernel."""
    meta = json.loads((REPO / "runs" / RUN / "meta.json").read_text())
    data_hp = meta["data_hparams"]
    cfg = assemble_config("transformer-vae", [], base_meta=meta)
    data = TextDataModule(cfg.data)
    data.prepare_corpus(fit_corpus(
        n_docs, data_hp["min_tokens_per_sample"],
        data_hp["max_tokens_per_sample"],
        meta["model_hparams"]["vocab_size"], FIT_SEED + 1,
        period=VAL_PERIOD))
    model, objective, _, _ = build_training(RUN, "cuda", 1)
    trainer = Trainer(model.hparams, objective, data, cfg.trainer, name=RUN,
                      log_root=log_root, enable_logging=False,
                      device="cuda")
    reset_counts()
    got = trainer.validate(model, step=FIT_STEPS)
    counts = read_counts()
    limit = trainer.thp.limit_val_batches
    batches = len(trainer._val_batches)
    batches = batches if limit is None else min(batches, limit)
    check_counts("validate", counts, {
        "swa_fwd": model.hparams.num_layers * batches,
        "tied_ce_fwd": batches})
    del model
    plain = build_training(RUN, "cuda", 1, use_kernels=False)[0]
    reset_counts()
    want = trainer.validate(plain, step=FIT_STEPS)
    with band_without_block("older"):
        cut = trainer.validate(plain, step=FIT_STEPS)
    check_counts("validate plain", read_counts(), {})
    del plain
    gc.collect()
    torch.cuda.empty_cache()
    rel = abs(got["val_nll"] - want["val_nll"]) / abs(want["val_nll"])
    power = abs(cut["val_nll"] - want["val_nll"]) / abs(want["val_nll"])
    check(rel <= TRAIN_LOSS_RTOL,
          f"validation, kernels {got} vs plain {want}")
    check(power >= VAL_POWER * TRAIN_LOSS_RTOL,
          f"the stand-in cannot tell a band without its older block: "
          f"val_nll {cut['val_nll']} vs {want['val_nll']}")
    return {"batches": batches, "kernels": got, "plain": want,
            "plain_band_cut": cut, "val_nll_rel_err": rel,
            "band_cut_rel_change": power}


def fit_run(run: str, dotlist: list, corpus, steps: int, val_step: int,
            log_root: Path, capture_step=None, sample_every=None):
    """Trainer.fit of the run's family (the Transformer-VAE or the
    Transformer LM) from the JAX initialisation with runs/<run>/meta.json
    as the base (fit_trainer_run), checking the launch counts of the
    groups and validations fit ran (K1/K2 on the sliding-window or the
    dense causal route, as the model's attention is). With
    `sample_every`, the sampling callback's selection runs through K4."""
    meta = json.loads((REPO / "runs" / run / "meta.json").read_text())
    trainer, outcome, counts, peak, seconds = fit_trainer_run(
        meta["experiment"], dotlist, corpus, steps, val_step, log_root, run,
        meta, capture_step, sample_every)
    hp = trainer.hp
    layers = hp.num_layers
    micro = trainer.thp.accumulate_grad_batches * steps
    val_batches = sum(v["batches"] for v in trainer.validations)
    route = "" if hp.sparse_self_attention else "_dense"
    width = "_d256" if hp.d_model == 256 else ""
    expect = {f"swa_fwd{route}": layers * (micro + val_batches),
              f"swa_bwd{route}": layers * micro,
              f"tied_ce_fwd{width}": micro + val_batches,
              f"tied_ce_bwd{width}": micro}
    if sample_every is not None:
        expect["nucleus_select"] = None
    check_counts(f"fit {run}", counts, expect)
    return trainer, outcome, counts, peak, seconds


def fit_trainer_run(experiment: str, dotlist: list, corpus, steps: int,
                    val_step: int, log_root: Path, name: str,
                    base_meta=None, capture_step=None, sample_every=None):
    """Trainer.fit from the JAX initialisation, configured by
    cli.assemble_config with `base_meta` (a run's meta.json) as the base
    and `dotlist` on top, on `corpus` through prepare_corpus, for `steps`
    steps, validating every `val_step` steps. Checks the stop, the finite
    losses and grad norms and the validations; returns (trainer, outcome,
    counts, peak bytes, seconds), the counts of the groups and
    validations fit ran. With `sample_every`, fit runs the sampling
    callback of cli.make_sample_fns every that many steps (the working
    directory must hold the data's tokenizer)."""
    cfg = assemble_config(experiment, dotlist, base_meta=base_meta)
    data = TextDataModule(cfg.data)
    data.prepare_corpus(corpus)
    k = cfg.trainer.accumulate_grad_batches
    # val_every = int(num_batches * val_check_interval / k) = val_step.
    vci = (val_step + 0.5) * k / max(1, data.num_batches("train"))
    cfg = assemble_config(experiment, dotlist + [
        f"trainer.val_check_interval={vci!r}",
        f"trainer.max_steps={steps}"], base_meta=base_meta)
    overrides = dict(cfg.model_overrides)
    overrides.setdefault("vocab_size", cfg.data.vocab_size)
    hp, objective = build_hparams(experiment, overrides)
    callbacks = {}
    if sample_every is not None:
        cfg.trainer.sample_every_n_steps = sample_every
        callbacks = dict(zip(("sample_fn", "reconstruct_fn"),
                             make_sample_fns(experiment, objective)))
    trainer = FitTrainer(hp, objective, data, cfg.trainer,
                         experiment=experiment, name=name,
                         log_root=log_root, device="cuda",
                         capture_step=capture_step, **callbacks)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    outcome = trainer.fit()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated()
    check(trainer.val_every == val_step,
          f"{name}: validation every {trainer.val_every} steps, not "
          f"{val_step}")
    check((outcome.step, outcome.stopped_reason) == (steps, "max_steps"),
          f"{name}: fit stopped at {outcome.step}: {outcome.stopped_reason}")
    check(len(trainer.steps) == steps, f"{name}: {len(trainer.steps)} steps")
    check(all(np.isfinite(s["loss"]) and np.isfinite(s["grad_norm"])
              for s in trainer.steps),
          f"{name}: a loss or grad_norm is not finite: {trainer.steps}")
    names = ("val_nll", "val_bpb", "val_loss") + (
        ("val_kl",) if experiment.endswith("vae") else ())
    check(all(np.isfinite(v[n]) for v in trainer.validations
              for n in names),
          f"{name}: a validation metric is not finite")
    check([v["step"] for v in trainer.validations]
          == list(range(val_step, steps + 1, val_step)),
          f"{name}: validated at {[v['step'] for v in trainer.validations]}")
    return trainer, outcome, counts, peak, seconds


def fit_stats(trainer, counts, peak, seconds, smi) -> dict:
    steps = trainer.steps
    later = steps[1:] or steps
    return {
        "steps": len(steps),
        "shapes_fed": sorted({tuple(s["shape"]) for s in steps}),
        "step_s": [s["seconds"] for s in steps],
        "real_tokens": [s["real_tokens"] for s in steps],
        "real_tokens_per_s": sum(s["real_tokens"] for s in steps)
        / sum(s["seconds"] for s in steps),
        "real_tokens_per_s_after_step_1":
            sum(s["real_tokens"] for s in later)
            / sum(s["seconds"] for s in later),
        "losses": [s["loss"] for s in steps],
        "grad_norms": [s["grad_norm"] for s in steps],
        "validations": trainer.validations, "saves": trainer.saves,
        "fit_s": seconds, "launches": counts,
        "max_memory_allocated_bytes": peak, "card": smi}


def fit_r5_phase(smi: str, depth=None, n_docs: int = FIT_DOCS,
                 log_root=None) -> dict:
    """r5's geometry and data hparams (runs/real-prose-vae-r5/meta.json
    as the base: d_model 512, 6 + 3 layers, tokens_per_batch 100,000,
    accumulate 2, documents of 512-50,000 tokens, bf16) trained by fit
    for FIT_STEPS steps from the JAX initialisation on the stand-in
    corpus, validating and saving every FIT_EVERY steps, with depth
    decoder layers when given. Then, each raising on failure:
    - validation through the kernels equals fit's own at that step bit
      for bit;
    - the step-FIT_EVERY checkpoint restores the state fit saved, bit for
      bit, and one step from it equals the same step from the saved
      state, bit for bit;
    - export_archive, then load_run(<dir>) in the serving form: logits on
      2 x 256 tokens equal to the trained model's own serving form;
    - the first group of each shape fit fed, held against the plain
      versions (fit_group_check) on r5's trained weights;
    - validation of r5's trained weights through the kernels against the
      plain versions (validate_against_plain).
    The run's checkpoints go under `log_root` (kept for test_entry_phase)
    or a temporary directory."""
    dotlist = [f"trainer.checkpoint_every_n_steps={FIT_EVERY}",
               "trainer.log_every_n_steps=1"]
    if depth is not None:
        dotlist.append(f"model.num_layers={depth}")
    meta = json.loads((REPO / "runs" / RUN / "meta.json").read_text())
    data_hp = meta["data_hparams"]
    corpus = fit_corpus(n_docs, data_hp["min_tokens_per_sample"],
                        data_hp["max_tokens_per_sample"],
                        meta["model_hparams"]["vocab_size"], FIT_SEED)
    with contextlib.ExitStack() as stack:
        if log_root is None:
            log_root = Path(stack.enter_context(tempfile.TemporaryDirectory(
                prefix="chip_smoke_fit_")))
        trainer, outcome, counts, peak, seconds = fit_run(
            RUN, dotlist, corpus, FIT_STEPS, FIT_EVERY, log_root,
            capture_step=FIT_EVERY)
        stats = fit_stats(trainer, counts, peak, seconds, smi)
        model, hp = outcome.model, trainer.hp

        got = Trainer.validate(trainer, model, step=FIT_STEPS)
        own = {k: trainer.validations[-1][k] for k in got}
        check(got == own, f"validation at step {FIT_STEPS} is not fit's: "
              f"{got} vs {own}")

        saved = trainer.captured
        check(saved is not None and saved["step"] == FIT_EVERY,
              "no state was captured at the checkpoint")
        restored, restored_opt = trainer.init_state(
            torch.Generator().manual_seed(1))
        restored_gen = torch.Generator(device="cuda")
        check(trainer.restore(restored, restored_opt, restored_gen,
                              step=FIT_EVERY) == FIT_EVERY,
              "the checkpoint's step")
        check(states_equal(cpu_state(trainer.state(
            restored, restored_opt, FIT_EVERY, restored_gen)), saved),
            "the restored state is not the saved one")
        twin, twin_opt = trainer.init_state(torch.Generator().manual_seed(2))
        twin.load_state_dict(saved["params"])
        twin_opt.load_state_tensors(saved["optimizer"])
        twin_gen = torch.Generator(device="cuda")
        twin_gen.set_state(saved["generator"])
        group = next(defer_accum_groups(
            trainer.data.epoch_batches("train", seed=FIT_SEED),
            trainer.thp.accumulate_grad_batches, {}))[0]
        Trainer._step(trainer, restored, restored_opt, group, FIT_EVERY,
                      restored_gen)
        Trainer._step(trainer, twin, twin_opt, group, FIT_EVERY, twin_gen)
        check(states_equal(
            cpu_state(trainer.state(restored, restored_opt, FIT_EVERY + 1,
                                    restored_gen)),
            cpu_state(trainer.state(twin, twin_opt, FIT_EVERY + 1,
                                    twin_gen))),
            "a step from the restored state differs from the same step "
            "from the saved state")
        stats["resume"] = {"step": FIT_EVERY, "group": list(
            group["token_ids"].shape), "bit_identical": True}
        del restored, restored_opt, twin, twin_opt

        t0 = time.perf_counter()
        out = export_archive(model, trainer.meta(), log_root / "archive",
                             step=outcome.step, compress=False)
        export_s = time.perf_counter() - t0
        served, _, _ = load_run(str(out), device="cuda")
        own_form = serving_form(model)
        gen = torch.Generator(device="cuda").manual_seed(FIT_SEED)
        ids = torch.randint(3, hp.vocab_size, (2, 256), generator=gen,
                            device="cuda")
        ids[:, 0] = CLS_ID
        eps = torch.randn((2, 1, hp.latent_depth), generator=gen,
                          device="cuda")
        with torch.no_grad():
            a, b = served(ids, eps)[0], own_form(ids, eps)[0]
        check(torch.equal(a, b), "the archive's serving logits differ from "
              f"the trained model's: {(a - b).abs().max().item()}")
        stats["archive"] = {"export_s": export_s, "logits_equal": True,
                            "shape": list(a.shape)}
        groups = [trainer.groups[shape] for shape in sorted(trainer.groups)]
        del served, own_form, model, outcome, trainer
        gc.collect()
        torch.cuda.empty_cache()
        stats["groups_against_plain"] = [
            fit_group_check(RUN, group, FIT_SEED + i)
            for i, group in enumerate(groups)]
        stats["validate_against_plain"] = validate_against_plain(
            n_docs, log_root)
    print("fit " + json.dumps(stats), flush=True)
    return stats


def fit_pg19_phase(smi: str) -> dict:
    """pg19-fb8's data regime (runs/real-prose-pg19-fb8/meta.json as the
    base: concatenated 102,400-token streams, tokens_per_batch 102,912,
    accumulate 4, free bits 8.0) on the same stand-in corpus: PG19_STEPS
    steps and one validation; every group fed is [4, 1, 102400] (the
    exact-bucket rule: no padding to 114,688), and that group is held
    against the plain versions on pg19-fb8's trained weights
    (fit_group_check)."""
    meta = json.loads((REPO / "runs" / PG19_RUN / "meta.json").read_text())
    r5_data = json.loads((REPO / "runs" / RUN / "meta.json").read_text())[
        "data_hparams"]
    corpus = fit_corpus(FIT_DOCS, r5_data["min_tokens_per_sample"],
                        r5_data["max_tokens_per_sample"],
                        meta["model_hparams"]["vocab_size"], FIT_SEED)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_fit_") as tmp:
        trainer, outcome, counts, peak, seconds = fit_run(
            PG19_RUN, ["trainer.log_every_n_steps=1"], corpus, PG19_STEPS,
            PG19_STEPS, Path(tmp))
        check(all(s["shape"] == [4, 1, PG19_STREAM] for s in trainer.steps),
              f"pg19 fed {[s['shape'] for s in trainer.steps]}")
        check(len(trainer.validations) == 1, "pg19: one validation")
        stats = fit_stats(trainer, counts, peak, seconds, smi)
        groups = list(trainer.groups.values())
        del trainer, outcome
    gc.collect()
    torch.cuda.empty_cache()
    stats["groups_against_plain"] = [fit_group_check(PG19_RUN, group,
                                                     FIT_SEED)
                                     for group in groups]
    print("fit-pg19 " + json.dumps(stats), flush=True)
    return stats


# -- evaluation: the IWAE estimator, DReG training, the test entry ----------

# eval: r5's trained weights on 4 ragged rows of 12,800 tokens, 8 samples
# in 2 chunks (each chunk one reconstruct_ll over 16 stacked rows);
# eval-pg19: pg19-fb8's on one 102,400-token document, 4 samples in 4
# chunks; both on documents that repeat a VAL_PERIOD-id segment, through
# the kernels against the plain versions on the same eps.
EVAL_LENGTHS = [12800, 11001, 7500, 3001]
EVAL_SAMPLES, EVAL_ITERS = 8, 2
PG19_EVAL_LENGTHS = [PG19_STREAM]
PG19_EVAL_SAMPLES, PG19_EVAL_ITERS = 4, 4
EVAL_SEED = 29
# The band cut each evaluation's power check makes: r5 predicts a token
# from its copy one period back (older band block), pg19-fb8 hardly does
# (its IWAE NLL moved 0.06% without the older block, 3% without the
# query's own block, at [2, 2048] on the CPU:
# tests/test_torch_eval.py::test_the_stand_in_iwae_sees_the_attention_band).
EVAL_CUTS = {RUN: "older", PG19_RUN: "current"}
# dreg: one r5 step with train_mc_samples 4 over a [2, 12800] micro-batch:
# K * B * L = 102,400 token rows, the [8, 12800] train step's.
DREG_SAMPLES = 4
DREG_LENGTHS = [12800, 9731]
DREG_TIMED_STEPS = 3
# test-entry: sparse_vae_tpu_torch.test on fit's checkpoint.
TEST_SAMPLES, TEST_ITERS = 8, 2


def segment_documents(lengths, width: int, vocab: int, seed: int,
                      period: int = VAL_PERIOD, device="cuda") -> dict:
    """{"token_ids": [B, width], "num_tokens": [B]} on `device`: row b is
    [CLS], one seeded segment of `period` ids in [3, vocab) repeated, and
    [SEP] at lengths[b] - 1, then padding (fit_corpus's documents); a
    row of length 0 is all padding."""
    rng = np.random.default_rng(seed)
    ids = np.zeros((len(lengths), width), np.int64)
    for row, n in enumerate(lengths):
        if n:
            ids[row, :n] = np.resize(rng.integers(3, vocab, size=period), n)
            ids[row, 0], ids[row, n - 1] = CLS_ID, SEP_ID
    return {"token_ids": torch.from_numpy(ids).to(device),
            "num_tokens": torch.tensor([int(n) for n in lengths],
                                       device=device)}


def iwae_run(run: str, batches: list, num_samples: int, num_iter: int,
             eps: list, use_kernels: bool, cut=None, repeats: int = 0
             ) -> dict:
    """test.batch_nll (the IWAE NLL per token over a batch's rows) of
    runs/<run>'s trained weights in the training form on each of
    `batches` with its `eps`, through the kernels or the plain versions
    (the loss in chunks of at most PLAIN_CE_TOKENS tokens), under the band
    cut `cut` (band_without_block's argument) if given; `repeats` more
    passes over the batches are timed. Returns the nlls, the launch counts
    and seconds of the first pass, the timed passes' seconds and the peak
    memory."""
    model = build_training(run, "cuda", 1, use_kernels=use_kernels)[0]
    band = band_without_block(cut) if cut else contextlib.nullcontext()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    seconds = []
    with torch.no_grad(), band:
        for i in range(1 + repeats):
            if i == 0:
                reset_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            nlls = []
            for batch, e in zip(batches, eps):
                if not use_kernels:
                    model.hparams.loss_chunk_size = plain_chunk(
                        model.hparams,
                        num_samples // num_iter * batch["token_ids"].shape[0])
                nlls.append(test_entry.batch_nll(model, batch, num_samples,
                                                 num_iter, eps=e))
            torch.cuda.synchronize()
            seconds.append(time.perf_counter() - t0)
            if i == 0:
                counts, first = read_counts(), nlls
    peak = torch.cuda.max_memory_allocated()
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return {"nll": first, "launches": counts, "first_s": seconds[0],
            "timed_s": seconds[1:], "max_memory_allocated_bytes": peak}


def iwae_against_plain(run: str, batches: list, num_samples: int,
                       num_iter: int, seed: int, name: str,
                       repeats: int = 0):
    """iwae_run of runs/<run>'s trained weights on `batches` (documents
    that repeat a segment) through the kernels, K1 once a layer and K3
    once a chunk of samples for each batch, against the plain versions on
    the same eps, drawn from `seed`: each batch's IWAE NLL per token
    within TRAIN_LOSS_RTOL. The plain run with the band cut EVAL_CUTS[run]
    must move each by VAL_POWER x that or more. Returns the kernels', the
    plain and the cut runs, and each batch's relative error and change."""
    hp = json.loads((REPO / "runs" / run / "meta.json").read_text())[
        "model_hparams"]
    gen = torch.Generator(device="cuda").manual_seed(seed)
    eps = [torch.randn((num_samples, b["token_ids"].shape[0], 1,
                        hp["latent_depth"]), generator=gen, device="cuda")
           for b in batches]
    got = iwae_run(run, batches, num_samples, num_iter, eps, True,
                   repeats=repeats)
    check_counts(name, got["launches"], {
        "swa_fwd": hp["num_layers"] * num_iter * len(batches),
        "tied_ce_fwd": num_iter * len(batches)})
    want = iwae_run(run, batches, num_samples, num_iter, eps, False)
    cut = iwae_run(run, batches, num_samples, num_iter, eps, False,
                   cut=EVAL_CUTS[run])
    for r in (want, cut):
        check_counts(f"{name} plain", r["launches"], {})
    rel = [abs(g - w) / abs(w) for g, w in zip(got["nll"], want["nll"])]
    power = [abs(c - w) / abs(w) for c, w in zip(cut["nll"], want["nll"])]
    for b, g, w, c, r, m in zip(batches, got["nll"], want["nll"],
                                cut["nll"], rel, power):
        shape = list(b["token_ids"].shape)
        check(np.isfinite(g) and r <= TRAIN_LOSS_RTOL,
              f"{name} {shape}: IWAE NLL through the kernels {g} vs plain "
              f"{w}")
        check(m >= VAL_POWER * TRAIN_LOSS_RTOL,
              f"{name} {shape}: the plain IWAE without the band's "
              f"{EVAL_CUTS[run]} block moves by {m:.3g} only: {c} vs {w}")
    return got, want, cut, rel, power


def test_default_timing(run: str, lengths, seed: int) -> dict:
    """The time of test.py's default, 100 samples in 100 chunks, on one
    batch of segment_documents of `lengths` through the kernels (timed
    only: eval_phase holds the same path against the plain versions)."""
    meta = json.loads((REPO / "runs" / run / "meta.json").read_text())
    batch = segment_documents(lengths, max(lengths),
                              meta["model_hparams"]["vocab_size"], seed)
    model = build_training(run, "cuda", 1)[0]
    gen = torch.Generator(device="cuda").manual_seed(seed)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.no_grad():
        nll = test_entry.batch_nll(model, batch, 100, 100, generator=gen)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return {"lengths": list(lengths), "num_samples": 100, "num_iter": 100,
            "nll": nll, "seconds": seconds,
            "token_samples_per_s": sum(lengths) * 100 / seconds}


def eval_phase(run: str, lengths, num_samples: int, num_iter: int,
               smi: str, name: str, default_lengths=None) -> dict:
    """estimate_log_prob_iw of runs/<run>'s trained weights on
    segment_documents of `lengths`, held against the plain versions
    (iwae_against_plain). Prints the token-samples per second (real
    tokens x samples / s) over all the timed kernel calls, the best call's
    beside it, and, with default_lengths, the time of test.py's default on
    a batch of those lengths (test_default_timing)."""
    hp = json.loads((REPO / "runs" / run / "meta.json").read_text())[
        "model_hparams"]
    batch = segment_documents(lengths, max(lengths), hp["vocab_size"],
                              EVAL_SEED)
    got, want, cut, rel, power = iwae_against_plain(
        run, [batch], num_samples, num_iter, EVAL_SEED, name, repeats=2)
    token_samples = sum(lengths) * num_samples
    timed = got["timed_s"]
    stats = {"run": run, "rows": len(lengths), "lengths": list(lengths),
             "num_samples": num_samples, "num_iter": num_iter,
             "stacked_rows": num_samples // num_iter * len(lengths),
             "nll_kernels": got["nll"][0], "nll_plain": want["nll"][0],
             "nll_rel_err": rel[0], "band_cut": EVAL_CUTS[run],
             "nll_plain_band_cut": cut["nll"][0],
             "band_cut_rel_change": power[0],
             "first_s": got["first_s"], "timed_s": timed,
             "token_samples": token_samples,
             "token_samples_per_s": token_samples * len(timed) / sum(timed),
             "token_samples_per_s_best": token_samples / min(timed),
             "plain_s": want["first_s"],
             "max_memory_allocated_bytes": got["max_memory_allocated_bytes"],
             "launches": got["launches"], "card": smi}
    if default_lengths:
        stats["test_default"] = test_default_timing(run, default_lengths,
                                                    EVAL_SEED + 2)
    print(f"{name} " + json.dumps(stats), flush=True)
    return stats


def nonuniform_ce_check(rows: int, length: int, k: int, seed: int) -> dict:
    """K3 and K3b against their plain versions (ce_check) at K * rows *
    length tokens with the DReG step's kind of upstream gradient: dnll of
    document b under sample j is w~[j, b] / num_tokens[b], w~ a softmax
    over the samples, 0 on the padding at each document's tail."""
    t = k * rows * length
    g, table, bias, labels, _ = ce_inputs(t, seed)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    lengths = torch.randint(length // 2, length + 1, (rows,), generator=gen,
                            device="cuda")
    w = torch.softmax(4.0 * torch.randn((k, rows), generator=gen,
                                        device="cuda"), dim=0)
    pos = torch.arange(length, device="cuda")
    real = (pos[None, :] < lengths[:, None]).repeat(k, 1)      # [k*rows, L]
    dnll = ((w / lengths).reshape(-1)[:, None] * real).reshape(-1)
    labels = torch.where(real.reshape(-1), labels, 0)
    out = ce_check(g, table, bias, labels, dnll.float().contiguous())
    out["dnll_range"] = [dnll[dnll > 0].min().item(), dnll.max().item()]
    return out


def dreg_phase(smi: str, lengths=None, samples: int = DREG_SAMPLES,
               timed_steps: int = DREG_TIMED_STEPS) -> dict:
    """One optimizer step of r5's trained weights with train_mc_samples
    `samples` (the IWAE bound with the DReG gradient) over one micro-batch
    of segment_documents, through the kernels (K1 twice a layer: the
    weights pass without gradients and the gradient pass; K2 once a
    layer; K3 twice; K3b once, with dnll = w~ / num_tokens, a different
    value for each sample of each document) against the fp32 plain step
    (step_against_plain). Before it, K3/K3b alone on that kind of dnll
    (nonuniform_ce_check); after it, `timed_steps` steps through the
    kernels from a fresh model, each timed between synchronisations, with
    their peak memory (the first also takes the fresh model's
    allocations: the rate is given over all and after step 1, as fit's)."""
    lengths = lengths or DREG_LENGTHS
    meta = json.loads((REPO / "runs" / RUN / "meta.json").read_text())
    hp = meta["model_hparams"]
    ce = nonuniform_ce_check(len(lengths), max(lengths), samples, EVAL_SEED)
    batch = segment_documents(lengths, max(lengths), hp["vocab_size"],
                              EVAL_SEED + 1)
    layers = hp["num_layers"]
    held = step_against_plain(
        RUN, [batch], f"dreg K={samples} {[len(lengths), max(lengths)]}",
        EVAL_SEED, {"swa_fwd": 2 * layers, "swa_bwd": layers,
                    "tied_ce_fwd": 2, "tied_ce_bwd": 1},
        mc_samples=samples)

    model, objective, optimizer = build_training(RUN, "cuda", 1)[:3]
    model.hparams.train_mc_samples = samples
    noise = step_noise(model.hparams, objective, [batch], EVAL_SEED)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    step_s = []
    for step in range(timed_steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        float(train_step(model, objective, optimizer, [batch], step,
                         noise)["loss"])
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated()
    del model, objective, optimizer
    gc.collect()
    torch.cuda.empty_cache()
    real = sum(lengths)
    later = step_s[1:] or step_s
    stats = {"shape": [len(lengths), max(lengths)], "lengths": list(lengths),
             "train_mc_samples": samples,
             "token_rows": samples * len(lengths) * max(lengths), **held,
             "step_s": step_s, "max_memory_allocated_bytes": peak,
             "real_tokens_per_s": real * len(step_s) / sum(step_s),
             "real_tokens_per_s_after_step_1":
                 real * len(later) / sum(later),
             "nonuniform_ce": ce, "card": smi}
    print("dreg " + json.dumps(stats), flush=True)
    return stats


def test_entry_phase(smi: str, log_root: Path, n_docs: int = FIT_DOCS
                     ) -> dict:
    """`python -m sparse_vae_tpu_torch.test transformer-vae <r5 fit run>
    num_samples=TEST_SAMPLES num_iter=TEST_ITERS`, as `test.main` run in
    the directory that holds `log_root` (a sparse-vae-logs directory),
    on the checkpoint fit_r5_phase saved there. Its data is what the
    run's data hparams resolve to there: the token cache, into which the
    phase saves fit's stand-in corpus, and a tokenizer, for which it
    saves one trained on a line of text (the entry reads nothing of it
    but its byte lengths, for a bits-per-byte that it does not report).
    The average must be finite and positive, with K1 once a layer and K3
    once a chunk of samples for every test batch with a real row. The
    entry's model is fit's, six steps from a random start, whose NLL on
    uniform ids is near ln V whatever the kernels compute; so each of
    those batches, at its shape and row lengths, is then held against
    the plain versions as documents that repeat a segment on r5's trained
    weights (iwae_against_plain)."""
    meta = json.loads((REPO / "runs" / RUN / "meta.json").read_text())
    data_hp = meta["data_hparams"]
    corpus = fit_corpus(n_docs, data_hp["min_tokens_per_sample"],
                        data_hp["max_tokens_per_sample"],
                        meta["model_hparams"]["vocab_size"], FIT_SEED)
    saved = json.loads((log_root / "transformer-vae" / RUN / "checkpoints"
                        / "meta.json").read_text())
    layers = saved["model_hparams"]["num_layers"]
    with contextlib.chdir(log_root.parent):
        data = TextDataModule(TextDataModuleHparams(**saved["data_hparams"]))
        corpus.save(data._token_cache_path())
        train_tokenizer(
            iter(["A stand-in tokenizer for the token cache."]),
            data.hparams.vocab_size,
            save_path=tokenizer_cache_path(data.hparams.dataset_name))
        data.prepare_corpus(corpus)
        batches = [b for b in data.epoch_batches("test", seed=0)
                   if (np.asarray(b.num_tokens) > 0).any()]
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.perf_counter()
        average = test_entry.main(
            ["test", "transformer-vae", RUN, f"num_samples={TEST_SAMPLES}",
             f"num_iter={TEST_ITERS}"])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = read_counts()
        peak = torch.cuda.max_memory_allocated()
    check(np.isfinite(average) and average > 0,
          f"test entry: average {average}")
    check_counts("test-entry", counts, {
        "swa_fwd": layers * TEST_ITERS * len(batches),
        "tied_ce_fwd": TEST_ITERS * len(batches)})
    held = [segment_documents(b.num_tokens, b.token_ids.shape[1],
                              meta["model_hparams"]["vocab_size"],
                              EVAL_SEED + 3 + i)
            for i, b in enumerate(batches)]
    got, want, cut, rel, power = iwae_against_plain(
        RUN, held, TEST_SAMPLES, TEST_ITERS, EVAL_SEED + 3,
        "test-entry held")
    tokens = sum(int(np.asarray(b.num_tokens).sum()) for b in batches)
    stats = {"average": average, "batches": len(batches),
             "shapes": [list(b.token_ids.shape) for b in batches],
             "real_tokens": tokens, "num_samples": TEST_SAMPLES,
             "num_iter": TEST_ITERS, "seconds_with_load": seconds,
             "max_memory_allocated_bytes": peak, "launches": counts,
             "against_plain": {
                 "nll_kernels": got["nll"], "nll_plain": want["nll"],
                 "nll_rel_err": rel, "band_cut": EVAL_CUTS[RUN],
                 "band_cut_rel_change": power,
                 "ce_tokens_a_call": [
                     TEST_SAMPLES // TEST_ITERS * int(np.prod(
                         b.token_ids.shape)) for b in batches]},
             "card": smi}
    print("test-entry " + json.dumps(stats), flush=True)
    return stats


# -- the Transformer LM family ----------------------------------------------

# draft-tlm-r5: trained weights, d_model 256, 4 heads (Dh 64), 2 dense
# causal layers; real-prose-lm-r4: meta.json only, d_model 512, 8 heads,
# 6 dense causal layers, built from the JAX initialisation. Both: vocab
# 32,768, documents of 512-3,125 tokens padded to 512, tokens_per_batch
# 50,000 (micro-batches up to [13, 3584]).
LM_RUN = "draft-tlm-r5"
LM_GEOMETRY = "real-prose-lm-r4"
# K3/K3b at the LM's D = 256: a 16,384-token call and the preset's
# 50,000-token micro-batch as [14, 3584] (50,176 slots), each with a
# padding tail that ends inside a 128-token tile.
LM_CE_CHECKS = ((16384, 2048), (50176, 6173))
# The dense causal route: a causal band of L / 128 blocks (28 at 3,584)
# without a [CLS] slot, the dense causal pair at Dh 64 and 128. The r4
# geometry's heads on full rows, and draft-tlm-r5's on ragged rows.
LM_DENSE_LENGTHS = [3584, 3584, 3101, 3000, 2560, 2049, 1800, 1537, 1024,
                    700, 513, 300, 129]
# draft-tlm-r5's micro-batch shape (its meta: 50,000 tokens a batch, the
# longest bucket 3,584 wide) and the r4 geometry's step shape for the
# fp32 plain reference, whose masked dense attention holds [B, H, L, L]
# fp32 scores a layer for the backward (6 layers x 8 heads at [4, 3584]:
# ~30 GB; at [13, 3584] it would not fit).
LM_TRAIN_SHAPES = {LM_RUN: (13, 3584), LM_GEOMETRY: (4, 3584)}
LM_FIT_STEPS = 4     # r4 geometry: validation and a checkpoint at 2 and 4
LM_FIT_EVERY = 2
# The documents of the checks on draft-tlm-r5's weights are its own text:
# LM_POOL rows of LM_POOL_LEN ids that it samples at temperature 1 from
# [CLS], read on across rows. It does not copy a repeated segment (a
# repeat of 100 uniform ids moved its NLL by 4.5e-5 under the cut below)
# and reads mostly its last ~16 tokens, so the power check looks where a
# band that stopped at the query's own block would bite: the NLL of the
# queries at the first LM_NEAR positions of every block past the first.
# The plain run with the attention cut to the diagonal block must move
# that NLL by LM_CUT_POWER or more (8.2% on the CPU in fp32 at 1,024
# tokens, the whole NLL 0.8%).
LM_POOL, LM_POOL_LEN, LM_POOL_SEED = 16, 1024, 53
LM_NEAR = 8
LM_CUT_POWER = 1e-2


def dense_pairs(L: int, lengths) -> int:
    """Attended (query, key) pairs of causal attention over a row's valid
    keys, per head, summed over the rows: each query at position i reads
    keys 0 .. min(i, n - 1)."""
    return sum(n * (n + 1) // 2 + (L - n) * n for n in lengths)


def sdpa_causal_ms(q, k, v, do, iters: int):
    """(forward ms, backward ms) of F.scaled_dot_product_attention with
    is_causal (every key valid: a yardstick the port never calls)."""
    qq, kk, vv = (t.detach().requires_grad_() for t in (q, k, v))

    def fwd():
        return F.scaled_dot_product_attention(qq, kk, vv, is_causal=True)

    def fwd_bwd():
        torch.autograd.grad(fwd(), (qq, kk, vv), do)

    fwd_ms = cuda_ms(fwd, iters)
    return fwd_ms, cuda_ms(fwd_bwd, iters) - fwd_ms


def key_tile_dq(q, k, v, lens, lse, out, do, tile: int):
    """The share of key tile `tile` (keys 128 tile ..) in each query row's
    dq, from the plain backward's terms in fp32: what a lost add of that
    tile takes away."""
    keys = slice(tile * 128, (tile + 1) * 128)
    scale = q.shape[-1] ** -0.5
    kt, vt, dof = k[:, :, keys].float(), v[:, :, keys].float(), do.float()
    pos = torch.arange(q.shape[2], device=q.device)
    mask = ((pos[keys][None, :] <= pos[:, None])[None]
            & (pos[keys][None, :] < lens[:, None].long())[:, None])[:, None]
    s = torch.matmul(q.float(), kt.transpose(-1, -2)) * scale
    p = torch.where(mask, torch.exp(s - lse[..., None]), 0.0)
    delta = (dof * out.float()).sum(dim=-1, keepdim=True)
    ds = p * (torch.matmul(dof, vt.transpose(-1, -2)) - delta) * scale
    return torch.matmul(ds, kt)


def dense_phase(b: int, h: int, L: int, lengths, seed: int, iters: int,
                d: int = 64, family: str = "causal"):
    """The dense causal route (window L / 128, no [CLS] slot) through the
    kernels that take it against their plain versions: out within K1's
    tolerances, lse within K1_LSE_ATOL, gradients within GRAD_REL_TOL of
    the largest entry, both bit-identical across two calls; timed beside
    the plain versions and SDPA with is_causal, with the bound. family:
    the kernels that take the head dim (`FAMILIES`: the dense causal pair
    at Dh 64 and 128, through causal_kernel.causal_fwd / causal_bwd; the
    generic pair at the other widths, through swa_kernel.swa_fwd /
    swa_bwd). Each row of out, dq, dk and dv past
    `causal_kernel.row_start` is within ROW_REL_TOL of the plain
    version's norm (`causal_kernel.row_rel_err`). The causal family's
    calls count in the dense counters alone, its profiled calls hold no
    band kernel's record, and it reads the per-row ratio on two planted
    faults as well (key tile n - 2's values taken from tile n - 3, and
    that tile's dq adds lost), each of which must exceed ROW_REL_TOL."""
    block = 128
    fwd_kernel, bwd_kernels = FAMILIES[family]
    causal = family == "causal"
    kw = dict(window_size=L // block, block_size=block, causal=True,
              include_cls=False)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v, do = (torch.randn((b, h, L, d), generator=gen, device="cuda")
                   .to(torch.bfloat16) for _ in range(4))
    lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    key_mask = torch.arange(L, device="cuda")[None, :] < lens[:, None]

    def fwd():
        if causal:
            return causal_kernel.causal_fwd(q, k, v, lens)
        return swa_kernel.swa_fwd(q, k, v, lens, **kw)

    def bwd():
        if causal:
            return causal_kernel.causal_bwd(q, k, v, lens, lse, out, do)
        return swa_kernel.swa_bwd(q, k, v, lens, lse, out, do, **kw)

    before = read_counts()
    out, lse = fwd()
    out2, lse2 = fwd()
    grads, again = bwd(), bwd()
    torch.cuda.synchronize()
    after = read_counts()
    moved = {key: after[key] - before[key] for key in after
             if after[key] != before[key]}
    want_moved = ({"swa_fwd_dense": 2, "swa_bwd_dense": 2} if causal
                  else {"swa_fwd_generic": 2, "swa_bwd_generic": 2})
    check(moved == want_moved, f"dense {family} Dh {d} launched {moved}")
    check(torch.equal(out, out2) and torch.equal(lse, lse2)
          and all(torch.equal(x, y) for x, y in zip(grads, again)),
          f"dense {family} differs in two calls at {[b, h, L, d]}")
    del out2, lse2, again

    def fwd_plain(q, k, v):
        if causal:
            return causal_kernel.causal_attention_plain(q, k, v, lens)
        return sliding_window_attention_plain(q, k, v, key_mask,
                                              return_lse=True, **kw)

    def bwd_plain(q, k, v, out, do):
        if causal:
            return causal_kernel.causal_attention_bwd_plain(
                q, k, v, lens, lse, out, do)
        return sliding_window_attention_bwd_plain(q, k, v, lens, lse, out,
                                                  do, **kw)

    ref, ref_lse = fwd_plain(q, k, v)
    err = (out.float() - ref.float()).abs()
    finite = torch.isfinite(ref_lse)
    check(torch.equal(finite, torch.isfinite(lse)),
          f"dense {family} lse is -inf on other rows than the plain "
          f"version's")
    lse_err = (lse[finite] - ref_lse[finite]).abs().max().item()
    check(bool(torch.isfinite(out.float()).all()),
          f"dense {family} out is not finite")
    check(bool((err <= K1_OUT_ATOL + K1_OUT_RTOL * ref.float().abs()).all()),
          f"dense {family} disagrees with its plain version: max "
          f"{err.max():.3g}")
    check(lse_err <= K1_LSE_ATOL,
          f"dense {family} lse disagrees: {lse_err:.3g}")
    fwd_err = err.max().item()
    del err
    want = bwd_plain(q, k, v, out, do)
    errs = [rel_err(g, w) for g, w in zip(grads, want)]
    bwd_abs = max((g.float() - w.float()).abs().max().item()
                  for g, w in zip(grads, want))
    check(all(bool(torch.isfinite(g.float()).all()) for g in grads),
          f"dense {family} gradients are not finite")
    check(max(errs) <= GRAD_REL_TOL,
          f"dense {family} gradients disagree with the plain version: "
          f"{errs}")
    rows = {name: causal_kernel.row_rel_err(x, w) for name, x, w in zip(
        ("out", "dq", "dk", "dv"), (out, *grads), (ref, *want))}
    planted = None
    if causal:
        tile = L // block - 2
        shifted = v.clone()
        shifted[:, :, tile * block:(tile + 1) * block] = \
            v[:, :, (tile - 1) * block:tile * block]
        planted = {
            "v_tile_shifted": causal_kernel.row_rel_err(
                fwd_plain(q, k, shifted)[0], ref),
            "dq_add_lost": causal_kernel.row_rel_err(
                want[0].float() - key_tile_dq(q, k, v, lens, lse, out, do,
                                              tile), want[0])}
        del shifted
        check(min(planted.values()) > causal_kernel.ROW_REL_TOL,
              f"a planted fault passes the per-row gate: {planted}")
    check(max(rows.values()) <= causal_kernel.ROW_REL_TOL,
          f"dense {family} Dh {d} rows disagree with the plain version's:"
          f" {rows} (planted faults: {planted})")
    del ref, ref_lse, want
    gc.collect()
    torch.cuda.empty_cache()

    pairs = dense_pairs(L, lengths) * h
    lib_fwd, lib_bwd = sdpa_causal_ms(q, k, v, do, max(3, iters // 2))
    fwd_bound = bound(4 * q.numel() * 2 + lse.numel() * 4 + b * 4,
                      4 * d * pairs, BF16_TENSOR_FLOPS)
    bwd_bound = bound(8 * q.numel() * 2 + lse.numel() * 4 + b * 4,
                      10 * d * pairs, BF16_TENSOR_FLOPS)
    fwd_times = device_ms(fwd)
    bwd_times = device_ms(bwd, 5)
    if causal:
        band = [key for key in (*fwd_times, *bwd_times)
                if any(name in key for name in BAND_KERNELS)]
        check(not band, f"the dense route at Dh {d} ran band kernels: "
              f"{band}")
    shape = [b, h, L, d]
    fwd_row = {"shape": shape, "lengths": list(lengths),
               "window": L // block, "family": family,
               "max_abs_err": fwd_err, "lse_max_abs_err": lse_err,
               "row_rel_err": rows["out"],
               "planted_row_rel_err": planted,
               "bit_identical": True, "ms": cuda_ms(fwd, iters),
               "device_ms": kernel_ms(fwd_times, fwd_kernel),
               "plain_ms": cuda_ms(lambda: fwd_plain(q, k, v), 1,
                                   warmup=1),
               "library": "F.scaled_dot_product_attention(is_causal=True)",
               "library_ms": lib_fwd, "bound_ms": fwd_bound[0],
               "bound_by": fwd_bound[1], "pairs": pairs}
    bwd_row = {"shape": shape, "lengths": list(lengths),
               "window": L // block, "family": family,
               "max_abs_err": bwd_abs, "rel_errs_dq_dk_dv": errs,
               "row_rel_errs_dq_dk_dv": [rows["dq"], rows["dk"],
                                         rows["dv"]],
               "bit_identical": True, "ms": cuda_ms(bwd, iters),
               "device_ms": sum(bwd_times.values()),
               "parts_device_ms": k2_parts(bwd_times, bwd_kernels),
               "plain_ms": cuda_ms(lambda: bwd_plain(q, k, v, out, do), 1,
                                   warmup=1),
               "library": "the backward of F.scaled_dot_product_attention("
                          "is_causal=True)",
               "library_ms": lib_bwd, "bound_ms": bwd_bound[0],
               "bound_by": bwd_bound[1], "pairs": pairs}
    if causal:
        print(f"dense fwd Dh {d} " + json.dumps(fwd_row), flush=True)
        print(f"dense bwd Dh {d} " + json.dumps(bwd_row), flush=True)
    else:
        print(f"K1 dense {family} Dh {d} " + json.dumps(fwd_row), flush=True)
        print(f"K2 dense {family} Dh {d} " + json.dumps(bwd_row), flush=True)
    return fwd_row, bwd_row


# The dense causal pair's shapes: the r4 geometry's heads on full rows,
# draft-tlm-r5's on ragged rows, and lm-serve's prefill of one 512-token
# prompt (four query tiles: latency decides).
DENSE_SHAPES = {"full": (14, 8, 3584, [3584] * 14, 43, 5),
                "ragged": (13, 4, 3584, LM_DENSE_LENGTHS, 44, 5),
                "serve": (1, 8, 512, [512], 45, 50)}


def lm_kernels_phase() -> dict:
    """K3/K3b at D = 256 (LM_CE_CHECKS) and the dense causal pair at
    `DENSE_SHAPES` (Dh 64)."""
    k3, k3b = k3_phase(41, LM_CE_CHECKS, d=256, label=" D=256")
    rows = {"k3": k3, "k3b": k3b}
    for tag, (b, h, L, lengths, seed, iters) in DENSE_SHAPES.items():
        rows[f"fwd_{tag}"], rows[f"bwd_{tag}"] = dense_phase(
            b, h, L, lengths, seed=seed, iters=iters)
    return rows


def lm_serve_phase(smi: str) -> dict:
    """draft-tlm-r5 on the card in bf16: prefill logits at [1, 512] (the
    dense causal forward once a layer) against the fp32 CPU model (the masked
    dense path); then 12 requests through ServeEngine at batch 64,
    max_length 512, four with prompts long enough to bulk-prefill at 512
    positions (the dense causal forward once a layer each; shorter prompts
    pad to 128-384 and take the masked dense path), selection through
    K4."""
    model, hp, _ = load_run(LM_RUN, device="cuda")
    cpu_model, _, _ = load_run(LM_RUN, device="cpu", dtype=torch.float32)
    rng = np.random.default_rng(45)
    ids = torch.tensor(rng.integers(3, hp.vocab_size, size=(1, 512)))
    ids[0, 0] = CLS_ID
    reset_counts()
    with torch.inference_mode():
        got = model(ids.cuda()).float().cpu()
        torch.cuda.synchronize()
        check_counts("lm-serve logits", read_counts(),
                     {"swa_fwd_dense": hp.num_layers})
        ref = cpu_model(ids)
    del cpu_model
    diff = (got - ref).abs()
    agree = (got.argmax(-1) == ref.argmax(-1)).float().mean().item()
    check(bool(torch.isfinite(got).all()) and got.shape == ref.shape,
          "draft logits are not finite or have the wrong shape")
    check(diff.mean().item() <= MODEL_MEAN_ABS_TOL,
          f"draft logits mean abs err {diff.mean():.3g}")
    check(agree >= MODEL_ARGMAX_AGREE, f"draft argmax agreement {agree:.3f}")
    prompts = [0, 127, 0, 400, 300, 0, 450, 150, 0, 420, 0, 390]
    requests = make_requests(
        hp.vocab_size, prompt_lengths=prompts,
        max_tokens=[256, 128, 192, 96, 96, 64, 48, 256, 128, 80, 96, 100],
        seed=46)
    stats = serve_phase(model, requests, before_traffic=reset_counts)
    counts = read_counts()
    long_prompts = sum(1 + p > 384 for p in prompts)
    check_counts("lm-serve", counts, {
        "swa_fwd_dense": hp.num_layers * long_prompts,
        "nucleus_select": None})
    stats.update(logits={"max_abs_err": diff.max().item(),
                         "mean_abs_err": diff.mean().item(),
                         "argmax_agreement": agree},
                 prefills_at_512=long_prompts, launches=counts, card=smi)
    print("lm-serve " + json.dumps(stats), flush=True)
    return stats


def lm_builder(name: str):
    """make(use_kernels, dtype) -> (model, objective, optimizer) in the
    training form: runs/<name>'s trained weights, or for LM_GEOMETRY its
    meta.json hparams from the JAX initialisation (seed 0)."""
    if name == LM_GEOMETRY:
        hp = run_hparams(LM_GEOMETRY)
        return lambda kernels, dtype: build_from_hparams(
            hp, torch.Generator().manual_seed(0), "cuda",
            use_kernels=kernels, dtype=dtype)[:3]
    return lambda kernels, dtype: build_training(
        name, "cuda", 1, use_kernels=kernels, dtype=dtype)[:3]


def lm_step(make, mbs: list, use_kernels: bool, dtype, seed: int):
    """One optimizer step of make(use_kernels, dtype)'s LM on `mbs`, its
    dropout masks drawn from a generator seeded `seed` (the same masks on
    every path): (loss, gradients on the CPU, launch counts, seconds)."""
    model, objective, optimizer = make(use_kernels, dtype)
    if not use_kernels:
        model.hparams.loss_chunk_size = plain_chunk(
            model.hparams, mbs[0]["token_ids"].shape[0])
    gen = torch.Generator(device="cuda").manual_seed(seed)
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss = float(train_step(model, objective, optimizer, mbs, 0, None,
                            gen)["loss"])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = read_counts()
    grads = {n: p.grad.detach().float().cpu()
             for n, p in model.named_parameters()}
    del model, objective, optimizer
    gc.collect()
    torch.cuda.empty_cache()
    return loss, grads, counts, seconds


def lm_train_phase(smi: str) -> dict:
    """One bf16 step of draft-tlm-r5 (trained weights) at its micro-batch
    shape and one of the r4 geometry (JAX initialisation) through K1/K2 on
    the dense route and K3/K3b at their widths, each against the fp32
    plain step on the same batch and dropout masks: the loss within
    TRAIN_LOSS_RTOL, every gradient at cosine >= TRAIN_GRAD_COS or, below
    it, as step_against_plain allows a near-zero one."""
    out = {}
    for i, name in enumerate((LM_RUN, LM_GEOMETRY)):
        make = lm_builder(name)
        rows, width = LM_TRAIN_SHAPES[name]
        rng = np.random.default_rng(47 + i)
        mbs = [synthetic_batch(rng, rows, width, 32768, device="cuda")]
        torch.cuda.reset_peak_memory_stats()
        loss, grads, counts, seconds = lm_step(make, mbs, True, None, 48 + i)
        peak = torch.cuda.max_memory_allocated()
        layers, width = (2, "_d256") if name == LM_RUN else (6, "")
        check_counts(f"lm-train {name}", counts, {
            "swa_fwd_dense": layers, "swa_bwd_dense": layers,
            f"tied_ce_fwd{width}": 1, f"tied_ce_bwd{width}": 1})
        ref_loss, ref_grads, ref_counts, _ = lm_step(make, mbs, False,
                                                     torch.float32, 48 + i)
        check_counts(f"lm-train {name} fp32 plain", ref_counts, {})
        cos = cosines(grads, ref_grads)
        loss_rel = abs(loss - ref_loss) / abs(ref_loss)
        check(len(cos) == 15 * layers + 6,
              f"{len(cos)} gradients compared for {name}")
        check(np.isfinite(loss) and loss_rel <= TRAIN_LOSS_RTOL,
              f"lm-train {name}: loss {loss} vs fp32 plain {ref_loss}")
        noisy = {n: {"kernels_vs_fp32": c} for n, c in cos.items()
                 if c < TRAIN_GRAD_COS}
        if noisy:
            _, plain_grads, _, _ = lm_step(make, mbs, False, None, 48 + i)
            plain_cos = cosines(plain_grads, ref_grads)
            for n, c in noisy.items():
                c["bf16_plain_vs_fp32"] = plain_cos[n]
                check(plain_cos[n] < TRAIN_GRAD_COS
                      and c["kernels_vs_fp32"]
                      >= plain_cos[n] - NOISY_GRAD_MARGIN,
                      f"lm-train {name}: {n} disagrees with fp32 plain: {c}")
        held = {n: c for n, c in cos.items() if n not in noisy}
        out[name] = {
            "batch": [rows, width],
            "real_tokens": int(mbs[0]["num_tokens"].sum()),
            "loss": loss, "fp32_plain_loss": ref_loss,
            "loss_rel_err": loss_rel, "gradients": len(cos),
            "min_grad_cosine": sorted(held.items(),
                                      key=lambda kv: kv[1])[:3],
            "near_zero_gradients": noisy, "step_s_first": seconds,
            "max_memory_allocated_bytes": peak, "launches": counts}
    out["card"] = smi
    print("lm-train " + json.dumps(out), flush=True)
    return out


OPTIONS_GROUP = (4, 4096)
OPTIONS_CONTEXT = (4, 512)
OPTIONS_STEPS = 3
OPTIONS_SEED = 73
TRANSFORMER_GROUP = (2, 4096)
TRANSFORMER_REL = 2e-2     # bf16 logits' relative L2 distance from fp32


def options_hparams(use_kernels: bool = True) -> TransformerHparams:
    """A Transformer LM at r5's width (d_model 512, 8 heads, 6 sparse
    layers, window 2 x 128, V 32,768, bf16, remat as every preset) with
    all three options: a factorised input embedding (d_embedding 256),
    an untied head and cross-attention with its own context table."""
    return TransformerHparams(
        d_model=512, num_heads=8, num_layers=6, vocab_size=32768,
        d_embedding=256, tie_embedding_weights=False, cross_attention=True,
        sparse_self_attention=True, attn_window_size=2,
        attn_block_size=128, loss_chunk_size=2048, precision="bf16",
        grad_checkpointing=True, remat_policy="dots_attn_qkv",
        use_pallas_kernel=use_kernels)


def options_step(use_kernels: bool, dtype, batch: dict, ctx, steps: int):
    """`steps` optimizer steps of the options LM (the JAX initialisation,
    seed 0) on one batch and context, its FFN dropout masks from a
    generator seeded OPTIONS_SEED: (losses, step-1 gradients on the CPU,
    launch counts, seconds a step)."""
    model, hp = model_from_hparams(
        options_hparams(use_kernels), torch.Generator().manual_seed(0),
        "cuda", dtype=dtype, train=True, use_kernels=use_kernels)
    if not use_kernels:
        hp.loss_chunk_size = plain_chunk(hp, batch["token_ids"].shape[0])
    opt = make_optimizer(model.parameters(), lr=hp.lr,
                         lr_decay_steps=hp.lr_decay_steps,
                         grad_clip_threshold=hp.grad_clip_threshold)
    gen = torch.Generator(device="cuda").manual_seed(OPTIONS_SEED)
    ids = batch["token_ids"]
    losses, step_s, grads = [], [], None
    reset_counts()
    for step in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        opt.zero_grad(set_to_none=True)
        hidden = model.forward_hidden(ids, False, gen, context_ids=ctx)
        nll, count = model.sequence_nll(hidden, model.labels_for(ids))
        loss = nll / count
        loss.backward()
        if step == 0:
            grads = {n: p.grad.detach().float().cpu()
                     for n, p in model.named_parameters()}
        opt.step()
        losses.append(float(loss.detach()))
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
    counts = read_counts()
    del model, opt
    gc.collect()
    torch.cuda.empty_cache()
    return losses, grads, counts, step_s


def lm_options_phase(smi: str) -> dict:
    """The Transformer LM's options at r5's width (options_hparams): 3
    steps on [4, 4096] with cross-attention to a [4, 512] context, K1/K2 6
    launches a step (the sparse self-attention; the cross-attention is
    dense, as JAX's XLA path) and no K3/K3b (the untied head's loss is the
    chunked projection outside the fused tied CE, as in JAX); step 1 held
    against the fp32 plain step on the same batch, context and dropout
    masks as lm-train holds its steps. Then the generic Transformer
    (models/transformer.py) at the same width, 6 sparse layers: its bf16
    forward logits through K1 (6 launches) against the fp32 plain model on
    the card with the same weights, on [2, 4096] with a padded row."""
    rng = np.random.default_rng(OPTIONS_SEED)
    rows, width = OPTIONS_GROUP
    batch = synthetic_batch(rng, rows, width, 32768, device="cuda")
    ctx = torch.from_numpy(rng.integers(3, 32768, size=OPTIONS_CONTEXT)).to(
        "cuda")
    ctx[1, 300:] = 0
    torch.cuda.reset_peak_memory_stats()
    losses, grads, counts, step_s = options_step(True, None, batch, ctx,
                                                 OPTIONS_STEPS)
    peak = torch.cuda.max_memory_allocated()
    check(all(np.isfinite(losses)), f"lm-options losses {losses}")
    check_counts("lm-options", counts, {"swa_fwd": 6 * OPTIONS_STEPS,
                                        "swa_bwd": 6 * OPTIONS_STEPS})
    ref_losses, ref_grads, ref_counts, _ = options_step(
        False, torch.float32, batch, ctx, 1)
    check_counts("lm-options fp32 plain", ref_counts, {})
    cos = cosines(grads, ref_grads)
    loss_rel = abs(losses[0] - ref_losses[0]) / abs(ref_losses[0])
    check(loss_rel <= TRAIN_LOSS_RTOL,
          f"lm-options: loss {losses[0]} vs fp32 plain {ref_losses[0]}")
    noisy = {n: {"kernels_vs_fp32": c} for n, c in cos.items()
             if c < TRAIN_GRAD_COS}
    if noisy:
        _, plain_grads, _, _ = options_step(False, None, batch, ctx, 1)
        plain_cos = cosines(plain_grads, ref_grads)
        for n, c in noisy.items():
            c["bf16_plain_vs_fp32"] = plain_cos[n]
            check(plain_cos[n] < TRAIN_GRAD_COS
                  and c["kernels_vs_fp32"]
                  >= plain_cos[n] - NOISY_GRAD_MARGIN,
                  f"lm-options: {n} disagrees with fp32 plain: {c}")
    held = {n: c for n, c in cos.items() if n not in noisy}
    check(any(n.startswith("context_embedding") for n in held)
          and any(n.startswith("embedding_projection") for n in held)
          and any(n.startswith("output_embedding") for n in held),
          "lm-options: an option's leaves are missing")
    out = {"batch": [rows, width], "context": list(OPTIONS_CONTEXT),
           "real_tokens": int(batch["num_tokens"].sum()),
           "losses": losses, "fp32_plain_loss": ref_losses[0],
           "loss_rel_err": loss_rel, "gradients": len(cos),
           "min_grad_cosine": sorted(held.items(),
                                     key=lambda kv: kv[1])[:3],
           "near_zero_gradients": noisy, "step_s": step_s,
           "max_memory_allocated_bytes": peak, "launches": counts}

    kw = dict(vocab_size=32768, d_model=512, num_heads=8, num_layers=6,
              causal=True, sparse_self_attention=True, window_size=2,
              block_size=128)
    ref = init_parameters(Transformer(**kw, use_pallas_kernel=False),
                          torch.Generator().manual_seed(1)).to("cuda")
    model = Transformer(**kw).to("cuda")
    model.load_state_dict(ref.state_dict())
    model = model.to(torch.bfloat16)
    rows, width = TRANSFORMER_GROUP
    tb = synthetic_batch(rng, rows, width, 32768, device="cuda")
    ids = tb["token_ids"]
    mask = ids != 0
    reset_counts()
    with torch.no_grad():
        got = model(ids, mask).float()
        t_counts = read_counts()
        want = ref(ids, mask)
    real = mask[..., None].expand_as(want)
    diff = (got - want)[real]
    rel = float(diff.norm() / want[real].norm())
    agree = float((got.argmax(-1) == want.argmax(-1))[mask].float().mean())
    check(bool(torch.isfinite(got).all()) and rel <= TRANSFORMER_REL,
          f"generic Transformer bf16 logits {rel} from fp32 plain")
    check_counts("lm-options transformer", t_counts, {"swa_fwd": 6})
    out["transformer"] = {"batch": [rows, width],
                          "real_tokens": int(tb["num_tokens"].sum()),
                          "rel_l2_err": rel, "argmax_agree": agree,
                          "max_abs_err": float(diff.abs().max()),
                          "launches": t_counts}
    del model, ref, got, want
    gc.collect()
    torch.cuda.empty_cache()
    out["card"] = smi
    print("lm-options " + json.dumps(out), flush=True)
    return out


@contextlib.contextmanager
def attention_cut_to_diagonal_block(block: int = 128):
    """The plain dense attention with each query reading only the keys of
    its own block: a K1 with a wrong band, which a check on the plain
    versions must tell from the right one."""
    real = tattn.dense_attention

    def cut(q, k, v, mask=None):
        if q.shape[2] == k.shape[2] > 1:
            pos = torch.arange(q.shape[2], device=q.device)
            own = (pos[:, None] // block) == (pos[None, :] // block)
            mask = own if mask is None else mask & own
        return real(q, k, v, mask)

    tattn.dense_attention = cut
    try:
        yield
    finally:
        tattn.dense_attention = real


def lm_nll(model, objective, batches: list) -> dict:
    """The NLL per real token over `batches` through objective.eval_stats
    ("nll") and each batch's ("per_batch"); and the NLL of the queries at
    the first LM_NEAR positions of every 128-token block past the first
    ("near", "near_per_batch"), through the model's sequence_nll with the
    other labels masked: one more forward a batch."""
    sums, near = [], []
    with torch.no_grad():
        for batch in batches:
            stats = objective.eval_stats(model, batch)
            sums.append((float(stats["nll_sum"]),
                         float(stats["token_count"])))
            ids = batch["token_ids"]
            pos = torch.arange(ids.shape[1], device=ids.device)
            keep = ((pos % 128) < LM_NEAR) & (pos >= 128)
            labels = torch.where(keep, model.labels_for(ids), 0)
            s, n = model.sequence_nll(model.forward_hidden(ids), labels)
            near.append((float(s), max(float(n), 1.0)))
    return {"nll": sum(s for s, _ in sums) / sum(n for _, n in sums),
            "per_batch": [s / n for s, n in sums],
            "near": sum(s for s, _ in near) / sum(n for _, n in near),
            "near_per_batch": [s / n for s, n in near]}


def lm_against_plain(batches: list, name: str) -> dict:
    """draft-tlm-r5's trained weights in the training form (bf16 compute)
    on `batches` through the kernels (the dense causal forward once a layer,
    K3 once a batch, each twice: lm_nll) against the plain versions at
    the same precision: each batch's NLL and its block-start NLL within
    TRAIN_LOSS_RTOL; and the plain run with the attention cut to the
    diagonal block must move the block-start NLL by LM_CUT_POWER or
    more."""
    model, objective, _, _ = build_training(LM_RUN, "cuda", 1)
    reset_counts()
    got = lm_nll(model, objective, batches)
    check_counts(f"{name} kernels", read_counts(), {
        "swa_fwd_dense": 2 * model.hparams.num_layers * len(batches),
        "tied_ce_fwd_d256": 2 * len(batches)})
    del model
    plain, objective, _, _ = build_training(LM_RUN, "cuda", 1,
                                            use_kernels=False)
    plain.hparams.loss_chunk_size = plain_chunk(
        plain.hparams, max(b["token_ids"].shape[0] for b in batches))
    reset_counts()
    want = lm_nll(plain, objective, batches)
    with attention_cut_to_diagonal_block():
        cut = lm_nll(plain, objective, batches)
    check_counts(f"{name} plain", read_counts(), {})
    del plain
    gc.collect()
    torch.cuda.empty_cache()
    rels = [abs(a - b) / abs(b) for a, b in zip(
        got["per_batch"] + got["near_per_batch"],
        want["per_batch"] + want["near_per_batch"])]
    power = abs(cut["near"] - want["near"]) / abs(want["near"])
    check(max(rels) <= TRAIN_LOSS_RTOL,
          f"{name}: NLL through the kernels {got} vs plain {want}")
    check(power >= LM_CUT_POWER,
          f"{name}: the diagonal-block cut moves the block-start NLL by "
          f"{power:.3g} only: {cut['near']} vs {want['near']}")
    return {"nll_kernels": got["nll"], "nll_plain": want["nll"],
            "near_nll_kernels": got["near"], "near_nll_plain": want["near"],
            "nll_rel_errs": rels, "cut_near_nll": cut["near"],
            "cut_nll": cut["nll"], "cut_rel_change_near": power,
            "cut_rel_change": abs(cut["nll"] - want["nll"])
            / abs(want["nll"])}


@functools.lru_cache(maxsize=None)
def lm_sample_pool() -> np.ndarray:
    """[LM_POOL, LM_POOL_LEN] ids that draft-tlm-r5 (the serving form on
    the card) samples from [CLS] at temperature 1, ids 0-2 excluded, one
    decode_step at a time."""
    model, _, _ = load_run(LM_RUN, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(LM_POOL_SEED)
    caches = model.init_caches(LM_POOL, LM_POOL_LEN)
    tok = torch.full((LM_POOL,), CLS_ID, dtype=torch.int64, device="cuda")
    out = []
    with torch.inference_mode():
        for i in range(LM_POOL_LEN):
            logits, caches = model.decode_step(tok, caches, i)
            logits[:, :3] = float("-inf")
            tok = torch.multinomial(torch.softmax(logits.float(), -1), 1,
                                    generator=gen)[:, 0]
            out.append(tok)
    return torch.stack(out, 1).cpu().numpy()


def lm_model_batch(num_tokens, width: int, offset: int) -> dict:
    """{"token_ids", "num_tokens", "num_bytes"} on the card: row b is
    [CLS], draft-tlm-r5's own text (lm_sample_pool read on from `offset`,
    wrapping), and [SEP] at num_tokens[b] - 1, then padding;
    num_bytes = 4 x tokens."""
    flat = lm_sample_pool().reshape(-1)
    lengths = [int(n) for n in num_tokens]
    ids = np.zeros((len(lengths), width), np.int64)
    for row, n in enumerate(lengths):
        if n:
            ids[row, :n] = np.take(flat, np.arange(offset, offset + n),
                                   mode="wrap")
            ids[row, 0], ids[row, n - 1] = CLS_ID, SEP_ID
            offset += n
    num = torch.tensor(lengths, device="cuda")
    return {"token_ids": torch.from_numpy(ids).to("cuda"),
            "num_tokens": num, "num_bytes": 4 * num}


def lm_fit_phase(smi: str, log_root: Path) -> dict:
    """real-prose-lm-r4's meta.json hparams (d_model 512, 8 heads, 6 dense
    layers, tokens_per_batch 50,000, accumulate 2, documents of 512-3,125
    tokens padded to 512, bf16; grad_checkpointing read, not applied)
    trained by fit for LM_FIT_STEPS steps from the JAX initialisation on
    the stand-in corpus, validating and saving every LM_FIT_EVERY steps
    (checkpoints under `log_root`, for lm_test_entry_phase); its last
    validation through the kernels against the plain versions on fit's
    parameters (val_nll within TRAIN_LOSS_RTOL); then draft-tlm-r5's
    trained weights on documents of its own text at the shapes and row
    lengths of fit's validation batches, through the kernels against the
    plain versions, with the diagonal-block cut (lm_against_plain)."""
    meta = json.loads((REPO / "runs" / LM_GEOMETRY / "meta.json"
                       ).read_text())
    data_hp = meta["data_hparams"]
    corpus = fit_corpus(FIT_DOCS, data_hp["min_tokens_per_sample"],
                        data_hp["max_tokens_per_sample"],
                        meta["model_hparams"]["vocab_size"], FIT_SEED)
    trainer, outcome, counts, peak, seconds = fit_run(
        LM_GEOMETRY, [f"trainer.checkpoint_every_n_steps={LM_FIT_EVERY}",
                      "trainer.log_every_n_steps=1"], corpus, LM_FIT_STEPS,
        LM_FIT_EVERY, log_root)
    stats = fit_stats(trainer, counts, peak, seconds, smi)
    model, hp = outcome.model, trainer.hp
    got = Trainer.validate(trainer, model, step=LM_FIT_STEPS)
    plain, _ = model_from_hparams(hp, torch.Generator(), "cuda", train=True,
                                  use_kernels=False)
    plain.load_state_dict(model.state_dict())
    del model, outcome
    reset_counts()
    want = Trainer.validate(trainer, plain, step=LM_FIT_STEPS)
    check_counts("lm-fit validate plain", read_counts(), {})
    rel = abs(got["val_nll"] - want["val_nll"]) / abs(want["val_nll"])
    check(rel <= TRAIN_LOSS_RTOL,
          f"lm-fit validation, kernels {got} vs plain {want}")
    stats["validate_against_plain"] = {"kernels": got, "plain": want,
                                       "val_nll_rel_err": rel}
    val_batches = [{k: torch.from_numpy(np.asarray(v)).to("cuda",
                                                         torch.int64)
                    for k, v in b._asdict().items()}
                   for b in trainer._val_batches]
    del plain, trainer
    gc.collect()
    torch.cuda.empty_cache()
    stats["draft_against_plain"] = lm_against_plain(
        [lm_model_batch(b["num_tokens"].tolist(), b["token_ids"].shape[1],
                        1000 * i) for i, b in enumerate(val_batches)],
        "lm-fit draft validation")
    print("lm-fit " + json.dumps(stats), flush=True)
    return stats


def lm_test_entry_phase(smi: str, log_root: Path) -> dict:
    """`python -m sparse_vae_tpu_torch.test transformer-lm <r4 fit run>`
    as test.main in the directory holding `log_root`, on the checkpoint
    lm_fit_phase saved there (its corpus and a stand-in tokenizer saved
    where the run's data hparams look for them, as test_entry_phase
    does): a finite, positive average, the dense causal forward once a layer
    and K3 once a batch for every test batch with a real row. Then each
    of those batches, at its shape and row lengths, becomes documents of
    draft-tlm-r5's own text (lm_model_batch) held on its trained weights
    against the plain versions (lm_against_plain)."""
    meta = json.loads((REPO / "runs" / LM_GEOMETRY / "meta.json"
                       ).read_text())
    data_hp = meta["data_hparams"]
    corpus = fit_corpus(FIT_DOCS, data_hp["min_tokens_per_sample"],
                        data_hp["max_tokens_per_sample"],
                        meta["model_hparams"]["vocab_size"], FIT_SEED)
    saved = json.loads((log_root / "transformer-lm" / LM_GEOMETRY
                        / "checkpoints" / "meta.json").read_text())
    layers = saved["model_hparams"]["num_layers"]
    with contextlib.chdir(log_root.parent):
        data = TextDataModule(TextDataModuleHparams(**saved["data_hparams"]))
        corpus.save(data._token_cache_path())
        train_tokenizer(
            iter(["A stand-in tokenizer for the token cache."]),
            data.hparams.vocab_size,
            save_path=tokenizer_cache_path(data.hparams.dataset_name))
        data.prepare_corpus(corpus)
        batches = [b for b in data.epoch_batches("test", seed=0)
                   if (np.asarray(b.num_tokens) > 0).any()]
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.perf_counter()
        average = test_entry.main(["test", "transformer-lm", LM_GEOMETRY])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = read_counts()
        peak = torch.cuda.max_memory_allocated()
    check(np.isfinite(average) and average > 0,
          f"lm test entry: average {average}")
    check_counts("lm-test-entry", counts, {
        "swa_fwd_dense": layers * len(batches),
        "tied_ce_fwd": len(batches)})
    held = lm_against_plain(
        [lm_model_batch(b.num_tokens, b.token_ids.shape[1], 777 * i)
         for i, b in enumerate(batches)], "lm-test-entry held")
    stats = {"average": average, "batches": len(batches),
             "shapes": [list(b.token_ids.shape) for b in batches],
             "real_tokens": sum(int(np.asarray(b.num_tokens).sum())
                                for b in batches),
             "seconds_with_load": seconds,
             "max_memory_allocated_bytes": peak, "launches": counts,
             "against_plain": held, "card": smi}
    print("lm-test-entry " + json.dumps(stats), flush=True)
    return stats


# -- sampling: the lockstep loop, continuous batching, resumable slices ----

# sample: r5 at the reference's mass-sampling batch (1000 rows; the
# reference's 700,000 documents of <= 512 tokens are cut to one lockstep
# batch and 2,000 continuous documents of <= 256), its lockstep and
# continuous documents equal at
# SAMPLE_SMALL; sample-lm: draft-tlm-r5 at a smaller count; sample-long:
# pg19-fb8 at batch 1 over LONG_STEPS of its 102,400 positions, in two
# slices and in one call.
SAMPLE_BATCH, SAMPLE_LEN, SAMPLE_DOCS = 1000, 256, 2000
LM_SAMPLE_BATCH, LM_SAMPLE_DOCS = 64, 128
SAMPLE_SMALL = (64, 128)
SAMPLE_SEED = 61
LONG_STEPS, LONG_SLICES = 512, 2
VOCAB = 32768           # every archived run's
K4_CAPTURE_STEP = 100   # the lockstep step whose K4 inputs are timed


class K4Held:
    """Holds every K4 choice of a sampling run against the plain
    selection on the same penalised logits and noise (k4_agrees): it
    stands in for the wrapper where models/generation.py calls it, calls
    the wrapper, then the plain version (which counts no launch). Keeps
    the inputs of step `capture_step` for timing."""

    def __init__(self, capture_step=None):
        self.capture_step = capture_step
        self.steps, self.rows, self.flips, self.max_err = 0, 0, 0, 0.0
        self.captured = None

    def __call__(self, s, noise, **kw):
        got = select_kernel.nucleus_gumbel_argmax(s, noise, **kw)
        flips, err, kept = k4_agrees(got, s, noise, kw)
        self.steps += 1
        self.rows += s.shape[0]
        self.flips += len(flips)
        self.max_err = max(self.max_err, err)
        if self.steps == self.capture_step:
            self.captured = (s.clone(), noise.clone(), dict(kw), kept)
        return got

    @contextlib.contextmanager
    def patched(self):
        """Stand in for the wrapper where the lockstep loop
        (models/generation.py) and the parallel decoders
        (models/parallel_decode.py) call it."""
        wrapper = generation.nucleus_gumbel_argmax
        generation.nucleus_gumbel_argmax = self
        parallel_decode.nucleus_gumbel_argmax = self
        try:
            yield self
        finally:
            generation.nucleus_gumbel_argmax = wrapper
            parallel_decode.nucleus_gumbel_argmax = wrapper

    def stats(self) -> dict:
        return {"steps": self.steps, "rows": self.rows,
                "ulp_flip_rows": self.flips, "max_abs_err": self.max_err}


def stand_in_tokenizer(run: str):
    """A tokenizer trained on one line, saved in the working directory
    where runs/<run>'s data hparams look for it (the entries decode ids
    with it; the checks read ids only)."""
    meta = json.loads((REPO / "runs" / run / "meta.json").read_text())
    data_hp = meta["data_hparams"]
    train_tokenizer(iter(["A stand-in tokenizer for the sampled ids."]),
                    data_hp["vocab_size"],
                    save_path=tokenizer_cache_path(data_hp["dataset_name"]))


def doc_stats(docs) -> dict:
    lengths = np.array([len(d) for d in docs])
    ended = np.array([len(d) > 0 and d[-1] == SEP_ID for d in docs])
    return {"documents": len(docs), "mean_length": float(lengths.mean()),
            "median_length": float(np.median(lengths)),
            "max_length": int(lengths.max()),
            "ended_share": float(ended.mean())}


def unpadded(doc):
    doc = np.asarray(doc)
    return doc[doc != 0]


def entry_run(name: str, experiment: str, run: str, args: list) -> tuple:
    """`python -m sparse_vae_tpu_torch.sample <experiment> <run> <args>`
    as sample.main in the working directory, the counts zeroed just
    before it and read just after: (its result, the counts, peak bytes)."""
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    out = sample_entry.main(["sample", experiment, run, *args])
    torch.cuda.synchronize()
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated()
    check(len(out["documents"]) == int(args[0].split("=")[1]),
          f"{name}: {len(out['documents'])} documents")
    check(all(((d >= 0) & (d < VOCAB)).all() for d in out["documents"]),
          f"{name}: a token id out of range")
    print(f"{name} " + json.dumps({
        **doc_stats(out["documents"]), "new_tokens": out["new_tokens"],
        "seconds": out["seconds"],
        "new_tokens_per_s": out["new_tokens"] / out["seconds"],
        "splits": out["splits"], "launches": counts,
        "max_memory_allocated_bytes": peak}), flush=True)
    return out, counts, peak


def lockstep_steps(docs, max_length: int) -> int:
    """The lockstep loop's steps for these trimmed documents: up to the
    longest document's end token, at most max_length - 2."""
    return min(max(len(d) for d in docs), max_length - 2)


def k4_on_logits(held: K4Held) -> dict:
    """K4 timed on the captured step's real logits and noise beside the
    plain version and its bound."""
    check(held.captured is not None,
          f"no K4 inputs at step {held.capture_step}")
    s, noise, kw, kept = held.captured

    def kernel():
        return select_kernel.nucleus_gumbel_argmax(s, noise, **kw)

    ms = cuda_ms(kernel, 50)
    device = kernel_ms(device_ms(kernel), "nucleus_select")
    plain_ms = cuda_ms(lambda: select_kernel.nucleus_gumbel_argmax_plain(
        s, noise, **kw), 5)
    bound_ms, bound_by = k4_bound(s, noise, kw["top_p"],
                                  kw["temperature"], kept)
    return {"shape": list(s.shape), "step": held.capture_step,
            "kept_tokens": kept, "ms": ms, "device_ms": device,
            "plain_ms": plain_ms, "library_ms": None, "bound_ms": bound_ms,
            "bound_by": bound_by}


SAMPLE_WINDOW = "chip_smoke.sample_window"


def lockstep_profile(model, batch: int, warm: int = 16,
                     steps: int = 16) -> dict:
    """Where a lockstep sampling step's time goes at `batch` rows, every
    row live (no end token): `warm` positions, then a torch.profiler
    window of `steps` more that starts and ends in a synchronize: the
    host-clock step, the device's busy time a step and idle share
    (profile_train.busy_share), kernels a step, and the largest kernels'
    device ms a step."""
    from torch.profiler import ProfilerActivity, profile, record_function
    latent = getattr(model.hparams, "latent_depth", 0)
    zs = (prior_z(SAMPLE_SEED, batch, latent, model.device),) if latent \
        else ()
    kw = {"end_token": -1}
    state, caches = model.sample_resumable(
        SAMPLE_SEED, SAMPLE_LEN, batch, *zs, max_steps=warm, **kw)[:2]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function(SAMPLE_WINDOW):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            model.sample_resumable(SAMPLE_SEED, SAMPLE_LEN, batch, *zs,
                                   state=state, caches=caches,
                                   max_steps=steps, **kw)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    window_us, busy_us = profile_train.busy_share(prof.events(),
                                                  SAMPLE_WINDOW)
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and not e.is_user_annotation]
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:8]
    return {"rows": batch, "steps": steps, "step_ms": 1e3 * wall / steps,
            "device_busy_ms_per_step": busy_us / 1e3 / steps,
            "device_idle_share": 1.0 - busy_us / window_us,
            "kernels_per_step": sum(e.count for e in events) / steps,
            "top_device_ms_per_step": {
                e.key[:80]: e.self_device_time_total / 1e3 / steps
                for e in top}}


def sampling_phase(smi: str, name: str, experiment: str, run: str,
                   batch: int, docs: int, profiled: bool) -> dict:
    """The `sample` entry on runs/<run> in a temporary working directory:
    one lockstep batch of `batch` x SAMPLE_LEN (K4 at [batch, 32768] each
    step: its launches are the loop's steps), then `docs` documents
    through `batch` continuously refilled rows (continuous=1); each saves
    its dataset. Then the lockstep batch again with every K4 choice held
    against the plain selection (K4Held), which must give the entry's
    documents; K4 timed on one of its steps' logits; with `profiled`, a
    profiled window of lockstep steps at `batch` rows
    (lockstep_profile); and at
    SAMPLE_SMALL the lockstep and continuous documents of one seed and z
    equal."""
    # Every one of the `docs` documents ends in one of the `batch` rows,
    # so docs - batch of them were refilled into a row that had finished
    # one.
    check(docs > batch, f"{name}: {docs} documents through {batch} rows "
          "refill no row")
    stats = {"card": smi, "refills": docs - batch}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_sample_") as tmp, \
            contextlib.chdir(tmp):
        stand_in_tokenizer(run)
        lock, counts, peak = entry_run(
            name, experiment, run,
            [f"num_samples={batch}", f"batch_size={batch}",
             f"max_length={SAMPLE_LEN}"])
        steps = lockstep_steps(lock["documents"], SAMPLE_LEN)
        check_counts(name, counts, {"nucleus_select": steps})
        cont, cont_counts, cont_peak = entry_run(
            f"{name}-continuous", experiment, run,
            [f"num_samples={docs}", f"batch_size={batch}",
             f"max_length={SAMPLE_LEN}", "continuous=1"])
        check_counts(f"{name} continuous", cont_counts,
                     {"nucleus_select": None})
        check(cont["splits"] == {"train": docs - docs // 10,
                                 "test": docs // 10},
              f"{name}: splits {cont['splits']}")
    for key, out, c, p in (("lockstep", lock, counts, peak),
                           ("continuous", cont, cont_counts, cont_peak)):
        stats[key] = {**doc_stats(out["documents"]),
                      "new_tokens": out["new_tokens"],
                      "seconds": out["seconds"],
                      "new_tokens_per_s": out["new_tokens"] / out["seconds"],
                      "launches": c, "max_memory_allocated_bytes": p}
    stats["lockstep"]["steps"] = steps
    stats["lockstep"]["step_ms"] = 1e3 * lock["seconds"] / steps

    model, _, _ = load_run(run, device="cuda")
    held = K4Held(capture_step=K4_CAPTURE_STEP)
    with held.patched():
        again = model.sample(0, SAMPLE_LEN, batch)
        torch.cuda.synchronize()
    check(held.steps == steps, f"{name}: {held.steps} held steps")
    trimmed = batch_generate_samples(lambda i: again, batch, SAMPLE_LEN,
                                     progress=False)
    check(all(np.array_equal(a, b) for a, b in
              zip(trimmed, lock["documents"])),
          f"{name}: the held run gave other documents than the entry")
    stats["k4_held"] = held.stats()
    stats["k4_on_logits"] = k4_on_logits(held)
    del held
    if profiled:
        stats["profile"] = lockstep_profile(model, batch)

    b, ml = SAMPLE_SMALL
    latent = getattr(model.hparams, "latent_depth", 0)
    z = prior_z(SAMPLE_SEED, b, latent, model.device) if latent else None
    args = (SAMPLE_SEED, ml, b) + ((z,) if latent else ())
    small = batch_generate_samples(
        lambda i: model.sample(*args), b, ml, progress=False)
    small_cont = continuous_batch_sample(
        model, SAMPLE_SEED, b, ml, b, slice_steps=32, z_pool=z)
    check(all(np.array_equal(unpadded(x), unpadded(y))
              for x, y in zip(small, small_cont)),
          f"{name}: lockstep and continuous documents differ at "
          f"{list(SAMPLE_SMALL)}")
    stats["small_equal"] = {"shape": list(SAMPLE_SMALL),
                            **doc_stats(small_cont)}
    del model
    gc.collect()
    torch.cuda.empty_cache()
    print(f"{name} " + json.dumps(stats), flush=True)
    return stats


def lm_callback_phase(smi: str) -> dict:
    """Trainer.fit of draft-tlm-r5's hparams from the JAX initialisation,
    2 steps on the stand-in corpus with the sampling callback of
    cli.make_sample_fns at step 2 (one sample of 511 positions at batch
    1: K4's cluster instantiation): an `unconditional_sample` text, no
    `train_bleu` or reconstruction (an LM reconstructs nothing), and no
    `sampling_error`."""
    meta = json.loads((REPO / "runs" / LM_RUN / "meta.json").read_text())
    data_hp = meta["data_hparams"]
    corpus = fit_corpus(FIT_DOCS, data_hp["min_tokens_per_sample"],
                        data_hp["max_tokens_per_sample"],
                        meta["model_hparams"]["vocab_size"], FIT_SEED)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_cb_") as tmp, \
            contextlib.chdir(tmp):
        stand_in_tokenizer(LM_RUN)
        trainer, outcome, counts, peak, seconds = fit_run(
            LM_RUN, [], corpus, 2, 2, Path(tmp) / "sparse-vae-logs",
            sample_every=2)
        records = [json.loads(x) for x in (trainer.run_dir
                                           / "metrics.jsonl")
                   .read_text().splitlines()]
        del trainer, outcome
    texts = {key: [r["step"] for r in records if key in r]
             for key in ("text_unconditional_sample", "text_reconstruction",
                         "train_bleu", "text_sampling_error")}
    check(texts["text_sampling_error"] == [],
          f"lm callback: sampling_error {records}")
    check(texts["text_unconditional_sample"] == [2]
          and not texts["text_reconstruction"] and not texts["train_bleu"],
          f"lm callback: records at {texts}")
    stats = {"fit_s": seconds, "records": texts, "launches": counts,
             "max_memory_allocated_bytes": peak, "card": smi}
    print("lm-callback " + json.dumps(stats), flush=True)
    return stats


def sample_long_phase(smi: str) -> dict:
    """pg19-fb8 (bf16) `sample_resumable` at batch 1 and max_length
    102,400 (K4's cluster instantiation), without an end token:
    LONG_STEPS positions in one call, then in LONG_SLICES slices from the
    same seed and z: the token buffers bit for bit. The decode ring holds
    two 128-token blocks, so the run overwrites it LONG_STEPS / 256
    times."""
    model, _, _ = load_run(PG19_RUN, device="cuda")
    kw = {"end_token": -1}
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    one, _, z = model.sample_resumable(SAMPLE_SEED, PG19_STREAM, 1,
                                       max_steps=LONG_STEPS, **kw)
    torch.cuda.synchronize()
    one_s = time.perf_counter() - t0
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated()
    check_counts("sample-long", counts, {"nucleus_select": LONG_STEPS})
    state = caches = None
    t0 = time.perf_counter()
    for _ in range(LONG_SLICES):
        state, caches, z = model.sample_resumable(
            SAMPLE_SEED, PG19_STREAM, 1, z, state=state, caches=caches,
            max_steps=LONG_STEPS // LONG_SLICES, **kw)
    torch.cuda.synchronize()
    sliced_s = time.perf_counter() - t0
    check(one.index == state.index == LONG_STEPS + 1,
          f"sample-long: positions {one.index}, {state.index}")
    check(torch.equal(one.tokens, state.tokens),
          "sample-long: the slices differ from the one-shot call")
    written = one.tokens[0, 1:LONG_STEPS + 1]
    check(bool(((written >= 0) & (written < VOCAB)).all()),
          "sample-long: a token id out of range")
    stats = {"max_length": PG19_STREAM, "positions": LONG_STEPS,
             "slices": LONG_SLICES, "one_call_s": one_s,
             "step_ms": 1e3 * one_s / LONG_STEPS,
             "sliced_s": sliced_s,
             "distinct_tokens": int(written.unique().numel()),
             "launches": counts, "max_memory_allocated_bytes": peak,
             "card": smi}
    del model, one, state, caches
    gc.collect()
    torch.cuda.empty_cache()
    print("sample-long " + json.dumps(stats), flush=True)
    return stats


# Parallel and speculative decoding (phases 26-28): r5 at batch 1 over
# DECODE_SEQ positions without an end token, so that every mode makes
# DECODE_SEQ - 1 tokens (gen_bench's rows, window DECODE_WINDOW, drafts of
# DECODE_DRAFT-grams); the fused frontier again at DECODE_ROWS rows over
# DECODE_WIDE_SEQ; draft-tlm-r5 as r5's draft at DECODE_SPEC_K tokens a
# pass over DECODE_SPEC_SEQ; the `sample` entry's spec_draft= for
# DECODE_SPEC_DOCS documents of DECODE_SPEC_LEN; draft-tlm-r5's own
# full-document Jacobi at DECODE_LM_SEQ. The batch-8 frontier, the draft
# runs and the entry's documents are cut to these lengths for the run's
# time (PERF.md): at 1,024 positions the three phases took 322 s; r5's
# document went from 1,024 positions (window 512) to 512 (window 256),
# the draft runs from 512 positions to 256 and the entry's documents from
# 128 tokens to 64 when the latent and MoE phases came in (decode-r5
# took 190 s and decode-spec 88 s of a run of 885 s), and r5's document
# to 256 (window 128) when the mesh phases came in (decode-r5 took 127 s
# of a run of 1,286 s).
DECODE_SEQ, DECODE_WINDOW, DECODE_DRAFT, DECODE_ROWS = 256, 128, 3, 8
DECODE_WIDE_SEQ = 128
DECODE_SPEC_K, DECODE_SPEC_SEQ = 8, 64
DECODE_SPEC_DOCS, DECODE_SPEC_LEN = 2, 64
DECODE_LM_SEQ = 512
DRAFT_SPEC = f"transformer-lm:{LM_RUN}"
# A greedy mode may part from AR only where AR's choice was a near tie:
# at the first differing position AR's two leading logits (from the
# teacher-forced forward over AR's tokens) lie within this many units.
# The window pass, the chunk peek and the full forward reduce in other
# orders than the ring decode step, in bf16 through every layer: r5's
# bf16 logits sit 0.25 from fp32 on average (MODEL_MEAN_ABS_TOL), so two
# bf16 paths can order logits that close either way.
GREEDY_TIE_MARGIN = 0.25


def leading_gap(model, tokens, z, position: int) -> float:
    """AR's two leading logits' gap at `position` of its buffer [1, L]
    (start token first), from the teacher-forced forward."""
    with torch.no_grad():
        buf = tokens.to(model.device)
        hidden = (model.reconstruct_hidden(buf, z) if z is not None
                  else model.forward_hidden(buf))
        top = model.project(hidden[:, position]).topk(2, dim=-1).values
    return float(top[0, 0] - top[0, 1])


def held_against_ar(name: str, model, ar, got, z=None) -> dict:
    """A greedy mode's tokens [1, L - 1] against AR's: the count that
    differ and the first such position, where AR's two leading logits must
    lie within GREEDY_TIE_MARGIN."""
    first = gen_bench.first_mismatch(ar, got)
    out = {"mismatch_tokens": int((ar != got).sum()),
           "first_mismatch": first}
    if first is not None:
        buf = F.pad(ar, (1, 0), value=CLS_ID)
        out["leading_gap"] = leading_gap(model, buf, z, first)
        check(out["leading_gap"] < GREEDY_TIE_MARGIN,
              f"{name}: parts from AR at {first}, where AR's two leading "
              f"logits are {out['leading_gap']:.4f} apart")
    return out


def counted(record: dict):
    """gen_bench.run_mode's `timed` hook: each row's launch counts, zeroed
    just before it and read just after."""
    def wrap(name, fn):
        def run():
            reset_counts()
            out = fn()
            torch.cuda.synchronize()
            record[name] = read_counts()
            return out
        return run
    return wrap


def total(*count_dicts) -> dict:
    """Every counter summed over the runs' count dicts."""
    return {name: sum(c[name] for c in count_dicts)
            for name in launches.COUNTERS}


def mode_stats(runs: dict, counts: dict) -> dict:
    """Each row's passes, seconds, tokens a pass, accepted drafts and
    non-zero launch counts."""
    return {name: {"passes": r["passes"], "seconds": r["seconds"],
                   "tokens_per_pass": (r["tokens"].shape[1]
                                       / max(r["passes"], 1)),
                   "accepted": r["accepted"],
                   "launches": {k: v for k, v in counts[name].items() if v}}
            for name, r in runs.items()}


def decode_r5_phase(smi: str) -> dict:
    """r5's parallel decoders through gen_bench's rows at batch 1 x
    DECODE_SEQ: greedy ar, frontier, frontier_draft3 and jacobi_full
    (sparse K1, 6 launches an iteration), each greedy mode held against
    ar (held_against_ar); sampled frontier, frontier_fused (K4 at
    [512, 32768] once a pass) and speculative_draft3; frontier_fused again
    at DECODE_ROWS rows over DECODE_WIDE_SEQ (K4 at [4096, 32768]).
    Both fused runs are run
    again with every K4 choice held against the plain selection (K4Held)
    and must give the same tokens and passes."""
    model, hp, _ = load_run(RUN, device="cuda")
    z = prior_z(gen_bench.Z_SEED, DECODE_ROWS, hp.latent_depth,
                model.device)
    one = gen_bench.Bench(model, seq=DECODE_SEQ, window=DECODE_WINDOW,
                          draft=DECODE_DRAFT, z=z)
    wide = gen_bench.Bench(model, seq=DECODE_WIDE_SEQ, batch=DECODE_ROWS,
                           window=DECODE_WINDOW, draft=DECODE_DRAFT, z=z)
    spec = f"speculative_draft{DECODE_DRAFT}"
    counts = {"greedy": {}, "sampled": {}, "wide": {}}
    greedy_row, greedy = gen_bench.run_mode(
        one, gen_bench.GREEDY, "greedy", check=True, full=True,
        timed=counted(counts["greedy"]))
    sampled_row, sampled = gen_bench.run_mode(
        one, gen_bench.SAMPLED, "sampled",
        names=["frontier", "frontier_fused", spec],
        timed=counted(counts["sampled"]))
    _, wide_runs = gen_bench.run_mode(
        wide, gen_bench.SAMPLED, "sampled", names=["frontier_fused"],
        timed=counted(counts["wide"]))
    ar = greedy["ar"]["tokens"]
    check(ar.shape == (1, DECODE_SEQ - 1)
          and bool((ar[0, :-1] != 0).all()),
          f"decode-r5: AR made {int((ar != 0).sum())} tokens")
    held = {name: held_against_ar(f"decode-r5 {name}", model, ar,
                                  run["tokens"], z[:1])
            for name, run in greedy.items() if name != "ar"}
    jacobi_k1 = 6 * greedy["jacobi_full"]["passes"]
    for name, c in counts["greedy"].items():
        check_counts(f"decode-r5 greedy {name}", c,
                     {"swa_fwd": jacobi_k1} if name == "jacobi_full"
                     else {})
    for name, c in counts["sampled"].items():
        check_counts(f"decode-r5 sampled {name}", c, {
            "nucleus_select": sampled[name]["passes"]}
            if name == "frontier_fused" else {})
    check_counts("decode-r5 sampled frontier_fused wide",
                 counts["wide"]["frontier_fused"],
                 {"nucleus_select": wide_runs["frontier_fused"]["passes"]})
    k4_held = {}
    for bench, runs in ((one, sampled), (wide, wide_runs)):
        holder = K4Held()
        with holder.patched():
            tokens, passes, _ = gen_bench.rows(
                bench, gen_bench.SAMPLED)["frontier_fused"]()
        torch.cuda.synchronize()
        check(torch.equal(tokens.cpu(), runs["frontier_fused"]["tokens"])
              and passes == runs["frontier_fused"]["passes"]
              and holder.steps == passes,
              f"decode-r5: the held fused frontier at {bench.batch} rows "
              "differs from the timed one")
        k4_held[f"rows_{bench.batch}"] = holder.stats()
    stats = {"card": smi, "seq": DECODE_SEQ, "window": DECODE_WINDOW,
             "wide_seq": DECODE_WIDE_SEQ,
             "greedy": mode_stats(greedy, counts["greedy"]),
             "greedy_held_against_ar": held,
             "sampled": mode_stats(sampled, counts["sampled"]),
             f"sampled_rows_{DECODE_ROWS}": mode_stats(wide_runs,
                                                       counts["wide"]),
             "gen_bench_rows": [greedy_row, sampled_row],
             "k4_held": k4_held,
             "launches": total(*counts["greedy"].values(),
                               *counts["sampled"].values(),
                               *counts["wide"].values())}
    del model
    gc.collect()
    torch.cuda.empty_cache()
    print("decode-r5 " + json.dumps(stats), flush=True)
    return {**stats, "ar_tokens": ar, "z": z[:1]}


def decode_spec_phase(smi: str, ar, z) -> dict:
    """Draft-model speculative sampling, r5 verifying draft-tlm-r5's
    DECODE_SPEC_K-token drafts at batch 1 x DECODE_SPEC_SEQ (gen_bench's
    spec_model row), greedy (held against the prefix of decode-r5's AR
    tokens: greedy AR's first positions do not depend on its length) and
    sampled; then the `sample` entry with spec_draft= for
    DECODE_SPEC_DOCS documents. Neither path launches a kernel: the chunk
    peek, the draft's dense decode steps and the [1, V] selections are
    plain tensor code."""
    model, _, _ = load_run(RUN, device="cuda")
    # The shorter run's last slot is the exhaustion slot ([PAD]).
    ar = F.pad(ar[:, :DECODE_SPEC_SEQ - 2], (0, 1))
    bench = gen_bench.Bench(model, seq=DECODE_SPEC_SEQ, z=z,
                            spec_k=DECODE_SPEC_K,
                            spec=load_draft(DRAFT_SPEC, DECODE_SPEC_K,
                                            model.device))
    row = f"spec_model_k{DECODE_SPEC_K}"
    stats = {"card": smi, "seq": DECODE_SPEC_SEQ, "k": DECODE_SPEC_K}
    jsons = []
    all_counts = []
    for label, sampling in (("greedy", gen_bench.GREEDY),
                            ("sampled", gen_bench.SAMPLED)):
        counts = {}
        json_row, runs = gen_bench.run_mode(bench, sampling, label,
                                            names=[row],
                                            timed=counted(counts))
        check_counts(f"decode-spec {label}", counts[row], {})
        all_counts.append(counts[row])
        jsons.append(json_row)
        stats[label] = mode_stats(runs, counts)[row]
        if label == "greedy":
            stats["greedy_held_against_ar"] = held_against_ar(
                f"decode-spec {row}", model, ar, runs[row]["tokens"], z)
    stats["gen_bench_rows"] = jsons
    del model, bench
    gc.collect()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_spec_") as tmp, \
            contextlib.chdir(tmp):
        stand_in_tokenizer(RUN)
        out, counts, peak = entry_run(
            "decode-spec-entry", "transformer-vae", RUN,
            [f"num_samples={DECODE_SPEC_DOCS}", "batch_size=1",
             f"max_length={DECODE_SPEC_LEN}", f"spec_draft={DRAFT_SPEC}",
             f"spec_k={DECODE_SPEC_K}"])
    check_counts("decode-spec entry", counts, {})
    stats["launches"] = total(*all_counts, counts)
    stats["entry"] = {**doc_stats(out["documents"]),
                      "new_tokens": out["new_tokens"],
                      "seconds": out["seconds"],
                      "max_memory_allocated_bytes": peak}
    print("decode-spec " + json.dumps(stats), flush=True)
    return stats


def decode_lm_phase(smi: str) -> dict:
    """draft-tlm-r5's full-document Jacobi at batch 1 x DECODE_LM_SEQ:
    gen_bench's greedy ar and jacobi_full (chunk 128; the dense causal
    forward, 2 launches an iteration), jacobi_full held against ar; then
    sampled with fused_select (K4 at [128, 32768] on every dirty chunk),
    every K4 choice held against the plain selection."""
    model, _, _ = load_run(LM_RUN, device="cuda")
    bench = gen_bench.Bench(model, seq=DECODE_LM_SEQ)
    counts = {}
    json_row, greedy = gen_bench.run_mode(
        bench, gen_bench.GREEDY, "greedy", names=["ar", "jacobi_full"],
        timed=counted(counts))
    check_counts("decode-lm ar", counts["ar"], {})
    check_counts("decode-lm jacobi_full", counts["jacobi_full"],
                 {"swa_fwd_dense": 2 * greedy["jacobi_full"]["passes"]})
    held = held_against_ar("decode-lm jacobi_full", model,
                           greedy["ar"]["tokens"],
                           greedy["jacobi_full"]["tokens"])
    holder = K4Held()
    reset_counts()
    t0 = time.perf_counter()
    with holder.patched():
        tokens, passes = model.parallel_generate(
            gen_bench.SEED, DECODE_LM_SEQ, 1, gen_bench.SAMPLED,
            end_token=-1, chunk_size=gen_bench.JACOBI_CHUNK,
            fused_select=True)
    torch.cuda.synchronize()
    fused_s = time.perf_counter() - t0
    fused_counts = read_counts()
    check_counts("decode-lm fused", fused_counts,
                 {"swa_fwd_dense": 2 * passes,
                  "nucleus_select": holder.steps})
    check(tokens.shape == (1, DECODE_LM_SEQ - 1) and holder.steps > 0,
          f"decode-lm: fused Jacobi {tuple(tokens.shape)}, "
          f"{holder.steps} K4 calls")
    stats = {"card": smi, "seq": DECODE_LM_SEQ,
             "greedy": mode_stats(greedy, counts),
             "greedy_held_against_ar": held,
             "sampled_fused": {"passes": passes, "seconds": fused_s,
                               "tokens_per_pass": (DECODE_LM_SEQ - 1)
                               / passes,
                               "launches": {k: v for k, v in
                                            fused_counts.items() if v},
                               "k4_held": holder.stats()},
             "gen_bench_row": json_row,
             "launches": total(*counts.values(), fused_counts)}
    del model
    gc.collect()
    torch.cuda.empty_cache()
    print("decode-lm " + json.dumps(stats), flush=True)
    return stats


# -- the LSTM family --------------------------------------------------------

# The lstm-benchmark preset's LSTM-VAE (hparam_presets.py: d_model 1024,
# d_embedding 512, a bidirectional one-layer encoder of 2 x 256, latent
# 64, tied embeddings and logits, init_scale None) at the default data's
# vocab (32,768), 50,000 tokens a batch and documents of up to 25,000
# tokens; draft-lstm-r4's LSTM LM (meta.json only: 2 layers, d_model 256,
# init_scale 0.02). Both from the JAX initialisation, seeded.
LSTM_EXPERIMENT, LSTM_PRESET = "lstm-vae", "lstm-benchmark"
LSTM_LM_RUN = "draft-lstm-r4"
LSTM_SEED = 71
LSTM_CHECK = (4, 4096)           # [rows, L] held against the step loop
LSTM_LONG = (2, 25000)           # a batch of the longest documents
LSTM_ENCODER_LENGTHS = [4096, 3001, 129, 0]
LSTM_GRU = (4, 1024)
LSTM_SINGLE_STEPS = 256
LSTM_LM_CHECK = (13, 3584)       # draft-lstm-r4's longest micro-batch
LSTM_TIMED_STEPS = 2
LSTM_FIT_DOCS, LSTM_FIT_STEPS, LSTM_FIT_EVERY = 120, 2, 1
LSTM_LM_FIT_STEPS = 2
LSTM_TEST_SAMPLES, LSTM_TEST_ITERS = 8, 2
LSTM_SAMPLE_BATCH, LSTM_SAMPLE_LEN = 1000, 128   # the reference's batch
LSTM_SPEC_K, LSTM_SPEC_DOCS, LSTM_SPEC_LEN = 8, 2, 128
# The fused RNN (cuDNN with TF32 off) against the fp32 step loop on the
# card: outputs and states within this absolute error (h lies in [-1, 1],
# c is O(1); fp32 summation order over thousands of steps), gradients
# within LSTM_GRAD_REL of each tensor's largest entry.
LSTM_OUT_ATOL = 1e-4
LSTM_GRAD_REL = 1e-3
# A train step's gradient whose norm is below this share of the largest
# gradient's is numerically zero: its cosine is recorded, not held.
LSTM_NEAR_ZERO = 1e-6


def lstm_hparams(experiment: str = LSTM_EXPERIMENT):
    """The lstm-benchmark preset's LSTM-VAE hparams at the default data's
    vocab, as `train lstm-vae preset=lstm-benchmark` builds them
    (cli.assemble_config, build_hparams), or draft-lstm-r4's LM's."""
    if experiment == "lstm-lm":
        return run_hparams(LSTM_LM_RUN)
    cfg = assemble_config(LSTM_EXPERIMENT, [f"preset={LSTM_PRESET}"])
    return build_hparams(LSTM_EXPERIMENT, {
        **cfg.model_overrides, "vocab_size": cfg.data.vocab_size})[0]


def lstm_model(hp, use_kernels: bool = True):
    """hp's model from the JAX initialisation (a CPU generator seeded with
    LSTM_SEED) in the training form on the card: the fused RNN, or with
    use_kernels False the step loop."""
    return model_from_hparams(hp, torch.Generator().manual_seed(LSTM_SEED),
                              "cuda", train=True,
                              use_kernels=use_kernels)[0]


def held_outputs(name: str, got: tuple, want: tuple) -> float:
    err = max((g - w).abs().max().item() for g, w in zip(got, want))
    check(err <= LSTM_OUT_ATOL, f"{name}: the fused RNN is {err} from the "
          "step loop")
    return err


def held_grads(name: str, got: dict, want: dict) -> float:
    worst = max(rel_err(got[n], w) for n, w in want.items())
    check(got.keys() == want.keys() and worst <= LSTM_GRAD_REL,
          f"{name}: a gradient is {worst} of its largest entry from the "
          "step loop's")
    return worst


def lstm_ops_phase(smi: str) -> dict:
    """ops/rnn.py on the card, the fused RNN against the step loop:
    - the LSTM-VAE's decoder StackedRNN (in 576, H 1024) from z's initial
      state over [4, 4096] embeddings: outputs, final states and the
      gradients of the decoder, the embedding and z_to_hidden; then timed
      over [2, 25000], forward and forward + backward;
    - the masked BiLSTMEncoder (in 512, H 256) at 1 layer (the preset's)
      and 2 over ragged rows and an empty one, against each row's trimmed
      step loop (the empty row: tanh(c0));
    - a GRU stack at [4, 1024], outputs and gradients;
    - LSTM_SINGLE_STEPS decode steps against the scan.
    The fused calls run with every counter at 0 before them, and the step
    loop's counter stays 0 through them."""
    hp = lstm_hparams()
    model = lstm_model(hp)
    dec = model.decoder
    rows, length = LSTM_CHECK
    fused_counts = []

    def fused_only(name: str):
        """The fused calls since the last reset moved no counter."""
        torch.cuda.synchronize()
        fused_counts.append(read_counts())
        check_counts(name, fused_counts[-1], {})
    gen = torch.Generator(device="cuda").manual_seed(LSTM_SEED)
    ids = torch.randint(3, hp.vocab_size, (rows, length), generator=gen,
                        device="cuda")
    z = torch.randn((rows, hp.latent_depth), generator=gen, device="cuda")
    w = torch.randn((rows, length, hp.d_model), generator=gen,
                    device="cuda")

    def decoder_run(step_loop: bool):
        model.zero_grad(set_to_none=True)
        x = torch.cat([model.decoder_embedding(ids),
                       z[:, None].expand(-1, length, -1)], dim=-1)
        out, finals = use_step_loop(dec, step_loop)(
            x, model._decoder_init(z))
        h_n, c_n = finals[0]
        ((out * w).sum() + h_n.sum() + c_n.sum()).backward()
        grads = {n: p.grad.detach().clone()
                 for n, p in model.named_parameters() if p.grad is not None}
        return (out.detach(), h_n.detach(), c_n.detach()), grads

    reset_counts()
    fused, fused_grads = decoder_run(False)
    fused_only("lstm-ops decoder")
    loop, loop_grads = decoder_run(True)
    stats = {"card": smi, "decoder": {
        "shape": [rows, length, dec.w_ih_0.shape[1]],
        "hidden": hp.d_model,
        "max_abs_err": held_outputs("lstm-ops decoder", fused, loop),
        "grad_rel_err": held_grads("lstm-ops decoder", fused_grads,
                                   loop_grads),
        "gradients": sorted(loop_grads)}}
    model.zero_grad(set_to_none=True)
    del fused, fused_grads, loop, loop_grads, w

    x = torch.cat([model.decoder_embedding(ids),
                   z[:, None].expand(-1, length, -1)], dim=-1).detach()
    init = [tuple(s.detach() for s in st) for st in model._decoder_init(z)]
    with torch.no_grad():
        reset_counts()
        fused_ms = cuda_ms(lambda: use_step_loop(dec, False)(x, init),
                           iters=3, warmup=1)
        fused_only("lstm-ops decoder timing")
        plain_ms = cuda_ms(lambda: use_step_loop(dec)(x, init), iters=1,
                           warmup=0)
    use_step_loop(dec, False)
    long_rows, long_len = LSTM_LONG
    x_long = torch.randn((long_rows, long_len, x.shape[-1]), generator=gen,
                         device="cuda", requires_grad=True)
    z_long = torch.randn((long_rows, hp.latent_depth), generator=gen,
                         device="cuda")
    init_long = [tuple(s.detach() for s in st)
                 for st in model._decoder_init(z_long)]

    def forward():
        with torch.no_grad():
            dec(x_long, init_long)

    def forward_backward():
        out, _ = dec(x_long, init_long)
        out.sum().backward()

    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    long_fwd_ms = cuda_ms(forward, iters=3, warmup=1)
    long_train_ms = cuda_ms(forward_backward, iters=3, warmup=1)
    fused_only("lstm-ops decoder [2, 25000]")
    tokens = long_rows * long_len
    stats["decoder"].update({
        "fused_ms": fused_ms, "plain_ms": plain_ms,
        "long": {"shape": [long_rows, long_len], "forward_ms": long_fwd_ms,
                 "forward_backward_ms": long_train_ms,
                 "forward_tokens_per_s": tokens / long_fwd_ms * 1e3,
                 "forward_backward_tokens_per_s":
                     tokens / long_train_ms * 1e3,
                 "max_memory_allocated_bytes":
                     torch.cuda.max_memory_allocated()}})
    del x_long, x, init, init_long
    model.zero_grad(set_to_none=True)

    # The masked encoder: the preset's one layer, then two.
    stats["encoder"] = []
    lengths = torch.tensor(LSTM_ENCODER_LENGTHS, device="cuda")
    width = max(LSTM_ENCODER_LENGTHS)
    mask = torch.arange(width, device="cuda")[None, :] < lengths[:, None]
    x = torch.randn((len(lengths), width, hp.d_embedding), generator=gen,
                    device="cuda")
    for layers in (1, 2):
        enc = model.encoder if layers == 1 else init_parameters(
            BiLSTMEncoder(hp.d_embedding, hp.d_model // 4, layers).cuda(),
            torch.Generator(device="cuda").manual_seed(LSTM_SEED), None)
        c0 = torch.randn((2, hp.d_model // 4), generator=gen, device="cuda")
        with torch.no_grad():
            reset_counts()
            got = enc(x, mask, c0)
            fused_only(f"lstm-ops encoder {layers}")
            want = []
            for r, n in enumerate(LSTM_ENCODER_LENGTHS):
                if n == 0:
                    want.append(torch.tanh(c0).reshape(-1))
                    continue
                row = x[r:r + 1, :n]
                halves = []
                for d, xd in ((0, row), (1, torch.flip(row, dims=(1,)))):
                    c = c0[d:d + 1]
                    _, finals = use_step_loop(getattr(enc, f"dir_{d}"))(
                        xd, [(torch.tanh(c), c)] * layers)
                    halves.append(finals[-1][0][0])
                want.append(torch.cat(halves))
        err = (got - torch.stack(want)).abs().max().item()
        check(err <= LSTM_OUT_ATOL and torch.equal(
            got[-1], torch.tanh(c0).reshape(-1)),
            f"lstm-ops encoder at {layers} layers: {err} from the trimmed "
            "step loop")
        stats["encoder"].append({"layers": layers,
                                 "lengths": LSTM_ENCODER_LENGTHS,
                                 "max_abs_err": err})

    # A GRU stack at the decoder's width.
    gru = init_parameters(StackedRNN(hp.d_embedding, hp.d_model, 1, "GRU")
                          .cuda(), torch.Generator(device="cuda")
                          .manual_seed(LSTM_SEED), None)
    g_rows, g_len = LSTM_GRU
    xg = torch.randn((g_rows, g_len, hp.d_embedding), generator=gen,
                     device="cuda")
    hg = torch.tanh(torch.randn((g_rows, hp.d_model), generator=gen,
                                device="cuda"))

    def gru_run(step_loop: bool):
        gru.zero_grad(set_to_none=True)
        out, finals = use_step_loop(gru, step_loop)(xg, [hg])
        (out.square().sum() + finals[0].sum()).backward()
        return ((out.detach(), finals[0].detach()),
                {n: p.grad.detach().clone()
                 for n, p in gru.named_parameters()})

    reset_counts()
    fused, fused_grads = gru_run(False)
    fused_only("lstm-ops gru")
    loop, loop_grads = gru_run(True)
    stats["gru"] = {"shape": [g_rows, g_len, hp.d_embedding],
                    "hidden": hp.d_model,
                    "max_abs_err": held_outputs("lstm-ops gru", fused, loop),
                    "grad_rel_err": held_grads("lstm-ops gru", fused_grads,
                                               loop_grads)}

    # Single decode steps (the fused cell) against the scan.
    with torch.no_grad():
        xs = torch.cat([model.decoder_embedding(ids[:, :LSTM_SINGLE_STEPS]),
                        z[:, None].expand(-1, LSTM_SINGLE_STEPS, -1)], -1)
        states = model._decoder_init(z)
        reset_counts()
        scan, _ = dec(xs, states)
        steps = []
        for t in range(LSTM_SINGLE_STEPS):
            h, states = dec.step(xs[:, t], states)
            steps.append(h)
        fused_only("lstm-ops single steps")
    err = (torch.stack(steps, 1) - scan).abs().max().item()
    check(err <= LSTM_OUT_ATOL, f"lstm-ops: decode steps {err} from the "
          "scan")
    stats["single_steps"] = {"steps": LSTM_SINGLE_STEPS, "rows": rows,
                             "max_abs_err": err}
    stats["cudnn_allow_tf32"] = torch.backends.cudnn.allow_tf32
    check(not torch.backends.cudnn.allow_tf32,
          "cuDNN's TF32 is on: the LSTM would not run in fp32")
    stats["launches"] = total(*fused_counts)
    del model, dec, gru
    gc.collect()
    torch.cuda.empty_cache()
    print("lstm-ops " + json.dumps(stats), flush=True)
    return stats


def lstm_step(hp, batch: dict, noise, use_kernels: bool):
    """One optimizer step of hp's model from the JAX initialisation on
    `batch` with `noise`, the fused RNN or the step loop: (metrics,
    gradients, counts)."""
    model, objective, optimizer, _ = build_from_hparams(
        hp, torch.Generator().manual_seed(LSTM_SEED), "cuda",
        use_kernels=use_kernels)
    reset_counts()
    metrics = train_step(model, objective, optimizer, [batch], 0,
                         None if noise is None else [noise])
    torch.cuda.synchronize()
    counts = read_counts()
    grads = {n: p.grad.detach().clone() for n, p in model.named_parameters()}
    del model, objective, optimizer
    gc.collect()
    torch.cuda.empty_cache()
    return {k: float(v) for k, v in metrics.items()}, grads, counts


def lstm_step_against_loop(name: str, hp, batch: dict, noise) -> dict:
    """lstm_step through the fused RNN (no counter moves) against the
    same step through the step loop: the loss within TRAIN_LOSS_RTOL,
    every gradient at cosine >= TRAIN_GRAD_COS unless its norm is below
    LSTM_NEAR_ZERO of the largest."""
    metrics, grads, counts = lstm_step(hp, batch, noise, True)
    check_counts(name, counts, {})
    ref, ref_grads, ref_counts = lstm_step(hp, batch, noise, False)
    check_counts(f"{name} step loop", ref_counts, {"rnn_step_loop": None})
    cos = cosines(grads, ref_grads)
    norms = {n: g.norm().item() for n, g in ref_grads.items()}
    largest = max(norms.values())
    near_zero = {n: {"cosine": c, "norm_share": norms[n] / largest}
                 for n, c in cos.items()
                 if norms[n] <= LSTM_NEAR_ZERO * largest}
    held = {n: c for n, c in cos.items() if n not in near_zero}
    worst = sorted(held.items(), key=lambda kv: kv[1])[:3]
    loss_rel = abs(metrics["loss"] - ref["loss"]) / abs(ref["loss"])
    check(np.isfinite(metrics["loss"]) and loss_rel <= TRAIN_LOSS_RTOL,
          f"{name}: loss {metrics['loss']} vs the step loop's {ref['loss']}")
    check(worst[0][1] >= TRAIN_GRAD_COS,
          f"{name}: gradients disagree with the step loop's: {worst}")
    return {"loss": metrics["loss"], "step_loop_loss": ref["loss"],
            "loss_rel_err": loss_rel, "gradients": len(cos),
            "min_grad_cosine": worst, "near_zero_gradients": near_zero,
            "launches": counts}


def lstm_train_phase(smi: str) -> dict:
    """The LSTM-VAE (lstm-benchmark) trained from the JAX initialisation:
    step 1 on [4, 4096] ragged documents with a seeded eps and marginal-KL
    draws, the fused RNN against the step loop (lstm_step_against_loop);
    then LSTM_TIMED_STEPS optimizer steps at [2, 25000] (seconds, real
    tokens/s, peak memory). Then one step of draft-lstm-r4's LSTM LM (2
    layers) at [13, 3584], held the same way."""
    hp = lstm_hparams()
    rng = np.random.default_rng(LSTM_SEED)
    rows, length = LSTM_CHECK
    batch = synthetic_batch(rng, rows, length, hp.vocab_size, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(LSTM_SEED)
    noise = {"eps": torch.randn((rows, hp.latent_depth), generator=gen,
                                device="cuda"),
             "mi": torch.randn((10, rows, hp.latent_depth), generator=gen,
                               device="cuda")}
    stats = {"card": smi, "vae_step1": {
        "shape": [rows, length], **lstm_step_against_loop(
            "lstm-train vae", hp, batch, noise)}}

    model, objective, optimizer, _ = build_from_hparams(
        hp, torch.Generator().manual_seed(LSTM_SEED), "cuda")
    long_rows, long_len = LSTM_LONG
    batches = [synthetic_batch(rng, long_rows, long_len, hp.vocab_size,
                               device="cuda")
               for _ in range(LSTM_TIMED_STEPS)]
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    step_s, losses = [], []
    for step, b in enumerate(batches):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        metrics = train_step(model, objective, optimizer, [b], step,
                             generator=gen)
        losses.append(float(metrics["loss"]))
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
    check_counts("lstm-train timed", read_counts(), {})
    check(all(np.isfinite(losses)), f"lstm-train losses: {losses}")
    real = [int(b["num_tokens"].sum()) for b in batches]
    later = slice(1, None) if len(step_s) > 1 else slice(None)
    stats["vae_timed"] = {
        "shape": list(batches[0]["token_ids"].shape), "step_s": step_s,
        "losses": losses, "real_tokens": real,
        "real_tokens_per_s_after_step_1":
            sum(real[later]) / sum(step_s[later]),
        "max_memory_allocated_bytes": torch.cuda.max_memory_allocated()}
    del model, objective, optimizer, batches
    gc.collect()
    torch.cuda.empty_cache()

    lm_hp = lstm_hparams("lstm-lm")
    lm_rows, lm_len = LSTM_LM_CHECK
    lm_batch = synthetic_batch(rng, lm_rows, lm_len, lm_hp.vocab_size,
                               device="cuda")
    stats["lm_step1"] = {"run": LSTM_LM_RUN, "shape": [lm_rows, lm_len],
                         "layers": lm_hp.num_layers,
                         **lstm_step_against_loop("lstm-train lm", lm_hp,
                                                  lm_batch, None)}
    stats["launches"] = total(stats["vae_step1"]["launches"],
                              stats["lm_step1"]["launches"])
    print("lstm-train " + json.dumps(stats), flush=True)
    return stats


def bf16_rounded(model):
    """A copy of `model` whose parameters are rounded through bf16, as an
    archive stores them."""
    import copy
    out = copy.deepcopy(model)
    with torch.no_grad():
        for p in out.parameters():
            p.copy_(p.to(torch.bfloat16).to(p.dtype))
    return out.eval().requires_grad_(False)


def save_tokenizer(data_hparams: dict):
    """A tokenizer trained on one line, saved in the working directory
    where `data_hparams` look for their dataset's (the checks read ids
    only)."""
    train_tokenizer(iter(["A stand-in tokenizer for the token cache."]),
                    data_hparams["vocab_size"],
                    save_path=tokenizer_cache_path(
                        data_hparams["dataset_name"]))


def save_test_data(data_hparams: dict, corpus):
    """The stand-in corpus where `data_hparams` look for their token cache
    in the working directory, and a tokenizer for their dataset."""
    data = TextDataModule(TextDataModuleHparams(**data_hparams))
    corpus.save(data._token_cache_path())
    save_tokenizer(data_hparams)


def lstm_test_entry(experiment: str, name: str, args: list) -> dict:
    """`python -m sparse_vae_tpu_torch.test <experiment> <name> <args>` as
    test.main in the working directory: a finite, positive average, no
    counter moved."""
    gc.collect()
    torch.cuda.empty_cache()
    reset_counts()
    t0 = time.perf_counter()
    average = test_entry.main(["test", experiment, name, *args])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = read_counts()
    check(np.isfinite(average) and average > 0,
          f"test {experiment}: average {average}")
    check_counts(f"test {experiment}", counts, {})
    return {"average": average, "args": args, "seconds_with_load": seconds,
            "launches": counts}


def lstm_fit_phase(smi: str, log_root: Path) -> dict:
    """Trainer.fit of the LSTM-VAE at lstm-benchmark on a stand-in corpus
    of LSTM_FIT_DOCS documents of 16-25,000 ids (the default data's
    lengths): LSTM_FIT_STEPS steps of 2 micro-batches of <= 50,000 tokens,
    validating, saving and running the sampling callback every
    LSTM_FIT_EVERY steps. Then: the step-LSTM_FIT_EVERY checkpoint
    restored bit for bit; export_archive -> load_run(<dir>) giving the
    logits of the trained model rounded to bf16, bit for bit; the
    callback's reconstruction records (no sample: kl_weight is below 1
    through the annealing). Then a LSTM_LM_FIT_STEPS-step fit of
    draft-lstm-r4's LM from its meta.json, exported too, and the `test`
    entry on both runs' checkpoints. Works in the directory that holds
    `log_root`; returns the archives for lstm_sample_phase."""
    stats = {"card": smi}
    with contextlib.chdir(log_root.parent):
        data_hp = TextDataModuleHparams()
        corpus = fit_corpus(LSTM_FIT_DOCS, data_hp.min_tokens_per_sample,
                            data_hp.max_tokens_per_sample,
                            data_hp.vocab_size, FIT_SEED)
        save_test_data(to_dict(data_hp), corpus)
        dotlist = [f"preset={LSTM_PRESET}",
                   f"trainer.checkpoint_every_n_steps={LSTM_FIT_EVERY}",
                   "trainer.log_every_n_steps=1"]
        trainer, outcome, counts, peak, seconds = fit_trainer_run(
            LSTM_EXPERIMENT, dotlist, corpus, LSTM_FIT_STEPS,
            LSTM_FIT_EVERY, log_root, LSTM_PRESET,
            capture_step=LSTM_FIT_EVERY, sample_every=LSTM_FIT_EVERY)
        check_counts("fit lstm-vae", counts, {})
        stats["vae"] = fit_stats(trainer, counts, peak, seconds, smi)
        model = outcome.model
        saved = trainer.captured
        restored, restored_opt = trainer.init_state(
            torch.Generator().manual_seed(1))
        restored_gen = torch.Generator(device="cuda")
        check(trainer.restore(restored, restored_opt, restored_gen,
                              step=LSTM_FIT_EVERY) == LSTM_FIT_EVERY,
              "the LSTM checkpoint's step")
        check(saved is not None and states_equal(cpu_state(trainer.state(
            restored, restored_opt, LSTM_FIT_EVERY, restored_gen)), saved),
            "the restored LSTM state is not the saved one")
        stats["vae"]["resume"] = {"step": LSTM_FIT_EVERY,
                                  "bit_identical": True}
        del restored, restored_opt
        records = [json.loads(x) for x in (trainer.run_dir / "metrics.jsonl")
                   .read_text().splitlines()]
        recon = sorted(r["step"] for r in records
                       if "text_reconstruction" in r)
        check(recon == list(range(LSTM_FIT_EVERY, LSTM_FIT_STEPS + 1,
                                  LSTM_FIT_EVERY))
              and not any("text_sampling_error" in r for r in records),
              f"the sampling callback's records: {recon}")
        stats["vae"]["reconstructions_at"] = recon
        vae_dir = export_archive(model, trainer.meta(),
                                 log_root.parent / "archive-vae",
                                 step=outcome.step, compress=False)
        served, _, _ = load_run(str(vae_dir), device="cuda")
        own = bf16_rounded(model)
        gen = torch.Generator(device="cuda").manual_seed(FIT_SEED)
        ids = torch.randint(3, model.hparams.vocab_size, (2, 512),
                            generator=gen, device="cuda")
        z = torch.randn((2, model.hparams.latent_depth), generator=gen,
                        device="cuda")
        with torch.no_grad():
            a, b = served.reconstruct(ids, z), own.reconstruct(ids, z)
        check(torch.equal(a, b), "the LSTM archive's logits differ from the "
              f"trained model's: {(a - b).abs().max().item()}")
        stats["vae"]["archive"] = {"logits_equal": True,
                                   "shape": list(a.shape)}
        del served, own, model, outcome, trainer
        gc.collect()
        torch.cuda.empty_cache()

        meta = json.loads((REPO / "runs" / LSTM_LM_RUN / "meta.json")
                          .read_text())
        lm_data = meta["data_hparams"]
        lm_corpus = fit_corpus(LSTM_FIT_DOCS, lm_data["min_tokens_per_sample"],
                               lm_data["max_tokens_per_sample"],
                               lm_data["vocab_size"], FIT_SEED + 1)
        save_test_data(lm_data, lm_corpus)
        trainer, outcome, counts, peak, seconds = fit_trainer_run(
            "lstm-lm", [f"trainer.checkpoint_every_n_steps="
                        f"{LSTM_LM_FIT_STEPS}"], lm_corpus,
            LSTM_LM_FIT_STEPS, LSTM_LM_FIT_STEPS, log_root, LSTM_LM_RUN,
            base_meta=meta)
        check_counts("fit lstm-lm", counts, {})
        stats["lm"] = fit_stats(trainer, counts, peak, seconds, smi)
        lm_dir = export_archive(outcome.model, trainer.meta(),
                                log_root.parent / "archive-lm",
                                step=outcome.step, compress=False)
        del outcome, trainer
        gc.collect()
        torch.cuda.empty_cache()
        stats["test_entry"] = {
            LSTM_EXPERIMENT: lstm_test_entry(
                LSTM_EXPERIMENT, LSTM_PRESET,
                [f"num_samples={LSTM_TEST_SAMPLES}",
                 f"num_iter={LSTM_TEST_ITERS}"]),
            "lstm-lm": lstm_test_entry("lstm-lm", LSTM_LM_RUN, [])}
    stats["archives"] = {"vae": str(vae_dir), "lm": str(lm_dir)}
    stats["launches"] = total(
        stats["vae"]["launches"], stats["lm"]["launches"],
        *(t["launches"] for t in stats["test_entry"].values()))
    print("lstm-fit " + json.dumps(stats), flush=True)
    return stats


def lstm_sample_phase(smi: str, archives: dict) -> dict:
    """The `sample` entry on lstm-fit's LSTM-VAE archive: one lockstep
    batch of 1000 x 128 (the unfused selection, no K4); then r5 verifying
    lstm-fit's LSTM LM's LSTM_SPEC_K-token drafts: the `sample` entry with
    spec_draft=lstm-lm:<archive> for LSTM_SPEC_DOCS documents of
    LSTM_SPEC_LEN, and gen_bench's spec_model row with the same draft,
    greedy and sampled (passes, accepted drafts). No path launches a
    kernel or runs the step loop."""
    stats = {"card": smi}
    draft = f"lstm-lm:{archives['lm']}"
    with tempfile.TemporaryDirectory(prefix="chip_smoke_lstm_") as tmp, \
            contextlib.chdir(tmp):
        meta = json.loads((Path(archives["vae"]) / "meta.json").read_text())
        save_tokenizer(meta["data_hparams"])
        stand_in_tokenizer(RUN)
        out, counts, peak = entry_run(
            "lstm-sample", LSTM_EXPERIMENT, archives["vae"],
            [f"num_samples={LSTM_SAMPLE_BATCH}",
             f"batch_size={LSTM_SAMPLE_BATCH}",
             f"max_length={LSTM_SAMPLE_LEN}"])
        check_counts("lstm-sample", counts, {})
        stats["sample"] = {**doc_stats(out["documents"]),
                           "new_tokens": out["new_tokens"],
                           "seconds": out["seconds"],
                           "new_tokens_per_s":
                               out["new_tokens"] / out["seconds"],
                           "max_memory_allocated_bytes": peak,
                           "launches": counts}
        out, spec_counts, peak = entry_run(
            "lstm-spec-entry", "transformer-vae", RUN,
            [f"num_samples={LSTM_SPEC_DOCS}", "batch_size=1",
             f"max_length={LSTM_SPEC_LEN}", f"spec_draft={draft}",
             f"spec_k={LSTM_SPEC_K}"])
        check_counts("lstm-spec entry", spec_counts, {})
        stats["spec_entry"] = {**doc_stats(out["documents"]),
                               "new_tokens": out["new_tokens"],
                               "seconds": out["seconds"],
                               "max_memory_allocated_bytes": peak}
    model, hp, _ = load_run(RUN, device="cuda")
    bench = gen_bench.Bench(
        model, seq=LSTM_SPEC_LEN, spec_k=LSTM_SPEC_K,
        z=prior_z(gen_bench.Z_SEED, 1, hp.latent_depth, model.device),
        spec=load_draft(draft, LSTM_SPEC_K, model.device))
    row = f"spec_model_k{LSTM_SPEC_K}"
    mode_counts = []
    for label, sampling in (("greedy", gen_bench.GREEDY),
                            ("sampled", gen_bench.SAMPLED)):
        counts = {}
        json_row, runs = gen_bench.run_mode(bench, sampling, label,
                                            names=[row],
                                            timed=counted(counts))
        check_counts(f"lstm-spec gen_bench {label}", counts[row], {})
        mode_counts.append(counts[row])
        stats[f"gen_bench_{label}"] = {**mode_stats(runs, counts)[row],
                                       "row": json_row}
    del model, bench
    gc.collect()
    torch.cuda.empty_cache()
    stats["launches"] = total(stats["sample"]["launches"], spec_counts,
                              *mode_counts)
    print("lstm-sample " + json.dumps(stats), flush=True)
    return stats


# -- the latent tooling and the mixture-of-experts LM ------------------------

# The latent tooling (phase 33) on r5's trained weights over a stand-in
# corpus of LATENT_DOCS documents of 512-LATENT_MAX_TOKENS ids, saved where
# r5's data hparams look for their token cache, in a temporary working
# directory that also holds r5's weights as a run this package's trainer
# saved (the entries' loader reads such runs).
LATENT_DOCS, LATENT_MAX_TOKENS, LATENT_SEED = 64, 4096, 81
# gather's loc and scale in bf16 against the fp32 plain model on the same
# batches, the largest |difference| relative to the largest |fp32 value|:
# bf16 rounding of the Perceiver's activations, 4.8e-3 (loc) and 9.0e-4
# (scale) on the CPU at 1,024 and 4,096 tokens; the bound is about four
# times the larger reading. The encoder launches no kernel: its
# attention is dense, as in the JAX package.
LATENT_REL_TOL = 2e-2
# knn_scores in fp32 on the card against knn.py's formulas in float64.
KNN_REL, KNN_ATOL = 1e-5, 1e-6
LATENT_CONSOLE = ["help", f"load {RUN}",
                  "encode A stand-in line of text for the console.",
                  "posterior.loc.float().norm().item()", "q"]

# real-prose-lm-moe (phases 34-36; meta.json only): a transformer-lm at
# d_model 512, 8 heads, 6 dense causal layers, 8 experts a layer, top-2,
# capacity factor 1.25, tied embeddings, loss chunk 2,048, bf16, from the
# JAX initialisation (seed 0). Its data: 50,000 tokens a batch, documents
# of 512-3,125 tokens padded to 512, accumulate 2. The train phase takes
# one trainer group of its 1,024-token bucket: 2 micro-batches of
# MOE_GROUP = [48, 1024] (49,152 slots; documents of 513-1,024 tokens),
# whose fp32 plain reference (the masked dense attention keeps
# [48, 8, 1024, 1024] fp32 scores a layer for the backward) fits beside
# the model; a group of its 3,584 bucket ([13, 3584]) would not.
MOE_RUN = "real-prose-lm-moe"
MOE_GROUP, MOE_STEPS, MOE_SEED = (48, 1024), 3, 87
MOE_FIT_STEPS = 2    # one validation and a checkpoint, at step 2
MOE_FIT_DEPTH = 3    # of 6 layers: the export's compression took 33.75 s
MOE_FIT_DOCS = 120


def write_run(experiment: str, name: str, model, meta: dict):
    """`model`'s parameters saved as this package's trainer saves a run
    (sparse-vae-logs/<experiment>/<name>/ in the working directory, step
    0), for the entries that load runs by name."""
    CheckpointManager(experiment, name).save(
        0, {"params": model.state_dict(), "step": 0}, meta)


def knn_against_numpy(loc, scale, docs) -> float:
    """knn_scores on the card for each document of `docs` against
    knn.py's numpy formulas in float64: the largest error relative to the
    largest |score| of its list, checked against KNN_REL."""
    loc64, scale64 = loc.astype(np.float64), scale.astype(np.float64)
    loc_t = torch.tensor(loc, device="cuda")
    scale_t = torch.tensor(scale, device="cuda")
    worst = 0.0
    for i in docs:
        got = knn_entry.knn_scores(loc_t, scale_t, i)
        d2 = np.sum((loc64[i] - loc64) ** 2, axis=-1)
        norms = np.linalg.norm(loc64, axis=-1) * np.linalg.norm(loc64[i])
        cos = loc64 @ loc64[i] / np.maximum(norms, 1e-12)
        var_p, var_q = scale64[i] ** 2, scale64 ** 2
        kl = 0.5 * np.sum(var_p / var_q + (loc64[i] - loc64) ** 2 / var_q
                          - 1.0 + np.log(var_q / var_p), axis=-1)
        for name, g, w in zip(("l2", "cos", "kl"), got, (d2, cos, kl)):
            err = float(np.abs(g.cpu().numpy() - w).max())
            check(err <= KNN_REL * np.abs(w).max() + KNN_ATOL,
                  f"knn {name} of document {i}: error {err:.3g}")
            worst = max(worst, err / max(float(np.abs(w).max()), 1e-30))
    return worst


def latent_phase(smi: str, n_docs: int = LATENT_DOCS,
                 max_length: int = reconstruct_entry.MAX_LENGTH) -> dict:
    """The latent tooling's compute on the card, on r5's trained weights in
    bf16 over a stand-in corpus (LATENT_DOCS documents of ids), in a
    temporary working directory holding the corpus, a stand-in tokenizer
    and r5's weights saved as a run: `gather_latents.gather` against the
    fp32 plain model on the same batches (LATENT_REL_TOL; the encoder
    launches no kernel); `knn.knn_scores` on the card against knn.py's
    float64 formulas; one `reconstruct.reconstruct` of a test document
    (max_length 1024, temperature 0.7: K4 once a step), every K4 choice
    held against the plain selection on the same logits and noise; a
    scripted `vae_console` session (help, load, encode, an expression,
    q). The entries' dataset writer (`datasets`), tsne (sklearn,
    matplotlib) and the interactive loops are CPU work that the tests
    drive (tests/test_torch_latent.py); none of them runs here."""
    meta = json.loads((REPO / "runs" / RUN / "meta.json").read_text())
    data_hp = meta["data_hparams"]
    corpus = fit_corpus(n_docs, data_hp["min_tokens_per_sample"],
                        LATENT_MAX_TOKENS,
                        meta["model_hparams"]["vocab_size"], LATENT_SEED)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_latent_") as tmp, \
            contextlib.chdir(tmp):
        save_test_data(data_hp, corpus)
        model, hp, _ = load_run(RUN, device="cuda")
        write_run("transformer-vae", RUN, model, meta)
        cfg = assemble_config("transformer-vae", [])
        cfg.data = TextDataModuleHparams(**data_hp)
        data = build_data(cfg)
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loc, scale, titles, doc_index = gather_latents.gather(model, data)
        torch.cuda.synchronize()
        gather_s = time.perf_counter() - t0
        check_counts("latent gather", read_counts(), {})
        check(loc.shape == (n_docs, hp.latent_depth)
              and doc_index.tolist() == list(range(n_docs))
              and bool(np.isfinite(loc).all() and (scale > 0).all()),
              f"gather: {loc.shape}, {doc_index[:4]}")
        plain, _, _ = load_run(RUN, device="cuda", dtype=torch.float32,
                               use_kernels=False)
        p_loc, p_scale, _, _ = gather_latents.gather(plain, data)
        del plain
        rel = {name: float(np.abs(got - want).max() / np.abs(want).max())
               for name, got, want in (("loc", loc, p_loc),
                                       ("scale", scale, p_scale))}
        check(max(rel.values()) <= LATENT_REL_TOL,
              f"gather bf16 against fp32 plain: {rel}")
        knn_err = knn_against_numpy(loc, scale,
                                    (0, n_docs // 3, n_docs - 1))

        doc = data.splits["test"].docs[0]
        tokens = torch.as_tensor(np.asarray(doc, np.int64),
                                 device="cuda")[None, :]
        holder = K4Held()
        reset_counts()
        t0 = time.perf_counter()
        with holder.patched():
            recon = reconstruct_entry.reconstruct(model, tokens,
                                                  max_length=max_length)
        torch.cuda.synchronize()
        recon_s = time.perf_counter() - t0
        recon_counts = read_counts()
        check_counts("latent reconstruct", recon_counts,
                     {"nucleus_select": holder.steps})
        check(recon.shape == (1, max_length - 1) and holder.steps > 0
              and bool(((recon >= 0) & (recon < hp.vocab_size)).all()),
              f"reconstruct: {tuple(recon.shape)}, {holder.steps} steps")

        buf = io.StringIO()
        answers = iter(LATENT_CONSOLE)
        with contextlib.redirect_stdout(buf):
            console = vae_console.main(
                ["vae_console", RUN, f"device={model.device.type}"],
                read=lambda prompt: next(answers))
        out = buf.getvalue().splitlines()
        posterior = console.env["posterior"]
        check(out.count(f"Loaded transformer VAE run '{RUN}'.") == 2
              and tuple(posterior.loc.shape) == (1, 1, hp.latent_depth)
              and bool(torch.isfinite(posterior.loc).all())
              and np.isfinite(float(out[-1])),
              f"console session: {out}")
        del console, model
    gc.collect()
    torch.cuda.empty_cache()
    stats = {"documents": n_docs, "gather_s": gather_s,
             "gather_rel_err_vs_fp32_plain": rel,
             "knn_max_rel_err_vs_float64": knn_err,
             "reconstruct": {"steps": holder.steps, "seconds": recon_s,
                             "new_tokens": int((recon != 0).sum()),
                             "k4_held": holder.stats()},
             "console_lines": len(LATENT_CONSOLE),
             "launches": recon_counts, "card": smi}
    print("latent " + json.dumps(stats), flush=True)
    return stats


def moe_hparams(depth=None):
    hp = run_hparams(MOE_RUN)
    return hp if depth is None else replace(hp, num_layers=depth)


def moe_builder(hp):
    """make(use_kernels, dtype) -> (model, objective, optimizer): `hp`'s
    MoE LM from the JAX initialisation (seed 0), in the training form."""
    return lambda kernels, dtype: build_from_hparams(
        hp, torch.Generator().manual_seed(0), "cuda", use_kernels=kernels,
        dtype=dtype)[:3]


def moe_routes(make, use_kernels: bool, dtype, ids) -> list:
    """Each MoE layer's (assign [N, k], keep [k, N]) in the forward of
    make(use_kernels, dtype)'s model over `ids`, without gradients."""
    model = make(use_kernels, dtype)[0]
    stats = []
    with torch.no_grad():
        model.forward_hidden(ids, moe_stats=stats)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return [(s["assign"], s["keep"]) for s in stats]


def route_flips(a: list, b: list, valid) -> list:
    """Per layer, the real tokens whose top-k experts or kept bits differ
    between two forwards' routes."""
    return [int(((ra != rb).any(-1) | (ka != kb).any(0))[valid].sum())
            for (ra, ka), (rb, kb) in zip(a, b)]


def moe_steps(make, mbs: list, steps: int, seed: int) -> dict:
    """`steps` optimizer steps of make(True, None)'s model on the group
    `mbs`, its dropout masks from a generator seeded `seed`: each step's
    metrics and seconds, step 1's gradients on the CPU, the launch counts
    of all the steps and the peak memory."""
    model, objective, optimizer = make(True, None)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    out = {"metrics": [], "seconds": []}
    for step in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        metrics = train_step(model, objective, optimizer, mbs, step, None,
                             gen)
        metrics = {k: float(v) for k, v in metrics.items()}
        torch.cuda.synchronize()
        out["seconds"].append(time.perf_counter() - t0)
        out["metrics"].append(metrics)
        if step == 0:
            out["grads"] = {n: p.grad.detach().float().cpu()
                            for n, p in model.named_parameters()}
    out["launches"] = read_counts()
    out["peak"] = torch.cuda.max_memory_allocated()
    del model, objective, optimizer
    gc.collect()
    torch.cuda.empty_cache()
    return out


def moe_train_phase(smi: str, depth=None, group=MOE_GROUP,
                    steps: int = MOE_STEPS) -> dict:
    """real-prose-lm-moe at full width (depth layers when given) from the
    JAX initialisation: `steps` optimizer steps on one trainer group of
    its data shape (2 micro-batches of `group` ragged documents), through
    the dense causal pair and K3/K3b at D = 512, their counts
    from the steps; step 1's loss within TRAIN_LOSS_RTOL of the same
    step in fp32 through the plain versions on the same batch and
    dropout masks, and every gradient at cosine >= TRAIN_GRAD_COS or, below
    it, as lm_train_phase allows a near-zero one. The routes of the first
    micro-batch in the two forwards are compared (route_flips): bf16
    kernels against fp32 plain, and against bf16 plain (the kernels' own
    share). Seconds a step, real tokens/s, peak memory, train_moe_aux,
    train_moe_z and the share of dispatches dropped by capacity are
    printed."""
    hp = moe_hparams(depth)
    make = moe_builder(hp)
    accumulate = json.loads((REPO / "runs" / MOE_RUN / "meta.json")
                            .read_text())["trainer_hparams"][
                                "accumulate_grad_batches"]
    rows, width = group
    rng = np.random.default_rng(MOE_SEED)
    mbs = [synthetic_batch(rng, rows, width, hp.vocab_size,
                           min_tokens=width // 2 + 1, device="cuda")
           for _ in range(accumulate)]
    real = sum(int(mb["num_tokens"].sum()) for mb in mbs)
    run = moe_steps(make, mbs, steps, MOE_SEED)
    layers = hp.num_layers
    micro = accumulate * steps
    check_counts("moe-train", run["launches"], {
        "swa_fwd_dense": layers * micro, "swa_bwd_dense": layers * micro,
        "tied_ce_fwd": micro, "tied_ce_bwd": micro})
    loss = run["metrics"][0]["loss"]
    ref_loss, ref_grads, ref_counts, _ = lm_step(make, mbs, False,
                                                 torch.float32, MOE_SEED)
    check_counts("moe-train fp32 plain", ref_counts, {})
    cos = cosines(run["grads"], ref_grads)
    loss_rel = abs(loss - ref_loss) / abs(ref_loss)
    check(len(cos) == len(ref_grads) == 6 + 16 * layers,
          f"{len(cos)} gradients compared")
    check(np.isfinite(loss) and loss_rel <= TRAIN_LOSS_RTOL,
          f"moe-train: loss {loss} vs fp32 plain {ref_loss}")
    noisy = {n: {"kernels_vs_fp32": c} for n, c in cos.items()
             if c < TRAIN_GRAD_COS}
    if noisy:
        _, plain_grads, _, _ = lm_step(make, mbs, False, None, MOE_SEED)
        plain_cos = cosines(plain_grads, ref_grads)
        for n, c in noisy.items():
            c["bf16_plain_vs_fp32"] = plain_cos[n]
            check(plain_cos[n] < TRAIN_GRAD_COS
                  and c["kernels_vs_fp32"]
                  >= plain_cos[n] - NOISY_GRAD_MARGIN,
                  f"moe-train: {n} disagrees with fp32 plain: {c}")
    held = {n: c for n, c in cos.items() if n not in noisy}
    ids = mbs[0]["token_ids"]
    valid = (ids != 0).reshape(-1)
    kernel_routes = moe_routes(make, True, None, ids)
    flips_fp32 = route_flips(kernel_routes,
                             moe_routes(make, False, torch.float32, ids),
                             valid)
    flips_bf16 = route_flips(kernel_routes,
                             moe_routes(make, False, None, ids), valid)
    dispatches = int(valid.sum()) * hp.moe_top_k
    dropped = [1.0 - int(keep.sum()) / dispatches
               for _, keep in kernel_routes]
    timed = run["seconds"][1:] or run["seconds"]
    stats = {
        "layers": layers, "experts": hp.num_experts, "top_k": hp.moe_top_k,
        "capacity_factor": hp.moe_capacity_factor,
        "group": [accumulate, rows, width], "real_tokens": real,
        "expert_capacity_a_micro_batch": expert_capacity(
            rows * width, hp.num_experts, hp.moe_top_k,
            hp.moe_capacity_factor),
        "loss": loss, "fp32_plain_loss": ref_loss, "loss_rel_err": loss_rel,
        "gradients": len(cos),
        "min_grad_cosine": sorted(held.items(), key=lambda kv: kv[1])[:3],
        "gradients_at_bf16_noise": noisy,
        "route_flips_vs_fp32_plain": flips_fp32,
        "route_flips_vs_bf16_plain": flips_bf16,
        "real_tokens_first_micro_batch": int(valid.sum()),
        "dropped_share_by_layer": dropped,
        "step_s": run["seconds"],
        "real_tokens_per_s": real * len(timed) / sum(timed),
        "train_moe_aux": [m["train_moe_aux"] for m in run["metrics"]],
        "train_moe_z": [m["train_moe_z"] for m in run["metrics"]],
        "train_nll": [m["train_nll"] for m in run["metrics"]],
        "max_memory_allocated_bytes": run["peak"],
        "launches": run["launches"], "card": smi}
    print("moe-train " + json.dumps(stats), flush=True)
    return stats


def moe_fit_phase(smi: str, log_root: Path, depth=None,
                  n_docs: int = MOE_FIT_DOCS) -> dict:
    """Trainer.fit at real-prose-lm-moe's meta.json hparams from the JAX
    initialisation (depth layers when given) for MOE_FIT_STEPS steps on a
    stand-in corpus of its document lengths, validating and saving at
    the last step (fit_run checks the launch counts of the groups and the
    validation); then the checkpoint restores the saved state bit for
    bit, one step from it equals the same step from the saved state bit
    for bit, and the archive export_archive writes serves the trained
    model's logits through load_run(<dir>) exactly."""
    meta = json.loads((REPO / "runs" / MOE_RUN / "meta.json").read_text())
    data_hp = meta["data_hparams"]
    corpus = fit_corpus(n_docs, data_hp["min_tokens_per_sample"],
                        data_hp["max_tokens_per_sample"],
                        meta["model_hparams"]["vocab_size"], FIT_SEED)
    dotlist = [f"trainer.checkpoint_every_n_steps={MOE_FIT_STEPS}",
               "trainer.log_every_n_steps=1"]
    if depth is not None:
        dotlist.append(f"model.num_layers={depth}")
    trainer, outcome, counts, peak, seconds = fit_run(
        MOE_RUN, dotlist, corpus, MOE_FIT_STEPS, MOE_FIT_STEPS, log_root,
        capture_step=MOE_FIT_STEPS)
    stats = fit_stats(trainer, counts, peak, seconds, smi)
    model, hp = outcome.model, trainer.hp
    saved = trainer.captured
    check(saved is not None and saved["step"] == MOE_FIT_STEPS,
          "no state was captured at the checkpoint")
    restored, restored_opt = trainer.init_state(
        torch.Generator().manual_seed(1))
    restored_gen = torch.Generator(device="cuda")
    check(trainer.restore(restored, restored_opt, restored_gen,
                          step=MOE_FIT_STEPS) == MOE_FIT_STEPS,
          "the checkpoint's step")
    check(states_equal(cpu_state(trainer.state(
        restored, restored_opt, MOE_FIT_STEPS, restored_gen)), saved),
        "the restored state is not the saved one")
    twin, twin_opt = trainer.init_state(torch.Generator().manual_seed(2))
    twin.load_state_dict(saved["params"])
    twin_opt.load_state_tensors(saved["optimizer"])
    twin_gen = torch.Generator(device="cuda")
    twin_gen.set_state(saved["generator"])
    group = next(defer_accum_groups(
        trainer.data.epoch_batches("train", seed=FIT_SEED),
        trainer.thp.accumulate_grad_batches, {}))[0]
    Trainer._step(trainer, restored, restored_opt, group, MOE_FIT_STEPS,
                  restored_gen)
    Trainer._step(trainer, twin, twin_opt, group, MOE_FIT_STEPS, twin_gen)
    check(states_equal(
        cpu_state(trainer.state(restored, restored_opt, MOE_FIT_STEPS + 1,
                                restored_gen)),
        cpu_state(trainer.state(twin, twin_opt, MOE_FIT_STEPS + 1,
                                twin_gen))),
        "a step from the restored state differs from the same step from "
        "the saved state")
    stats["resume"] = {"step": MOE_FIT_STEPS,
                       "group": list(group["token_ids"].shape),
                       "bit_identical": True}
    del restored, restored_opt, twin, twin_opt
    t0 = time.perf_counter()
    out = export_archive(model, trainer.meta(), log_root / "moe-archive",
                         step=outcome.step, compress=False)
    export_s = time.perf_counter() - t0
    served, served_hp, _ = load_run(str(out), device="cuda")
    own_form = serving_form(model)
    gen = torch.Generator(device="cuda").manual_seed(FIT_SEED)
    ids = torch.randint(3, hp.vocab_size, (2, 512), generator=gen,
                        device="cuda")
    ids[:, 0] = CLS_ID
    ids[1, 300:] = 0
    with torch.no_grad():
        a, b = served(ids), own_form(ids)
    check(served_hp.num_experts == hp.num_experts and torch.equal(a, b),
          "the archive's serving logits differ from the trained model's: "
          f"{(a - b).abs().max().item()}")
    stats["archive"] = {"export_s": export_s, "logits_equal": True,
                        "shape": list(a.shape)}
    del served, own_form, model, outcome, trainer
    gc.collect()
    torch.cuda.empty_cache()
    print("moe-fit " + json.dumps(stats), flush=True)
    return stats


def moe_serve_phase(smi: str, depth=None, seq: int = DECODE_LM_SEQ) -> dict:
    """The MoE LM (the JAX initialisation, bf16 serving form) answers 12
    requests through ServeEngine at batch 64, max_length 512 (52 rows
    dead, fed [PAD], which take no expert slot), four bulk-prefilled at
    512 positions (the dense causal forward once a layer each), selection
    through K4; then gen_bench's greedy ar and full-document Jacobi at batch 1 x
    `seq` (the dense causal forward once a layer an iteration), Jacobi held
    against ar as decode-lm holds draft-tlm-r5's."""
    hp = moe_hparams(depth)
    model, hp = model_from_hparams(hp, torch.Generator().manual_seed(0),
                                   "cuda")
    prompts = [0, 127, 0, 400, 300, 0, 450, 150, 0, 420, 0, 390]
    requests = make_requests(
        hp.vocab_size, prompt_lengths=prompts,
        max_tokens=[256, 128, 192, 96, 96, 64, 48, 256, 128, 80, 96, 100],
        seed=88)
    stats = serve_phase(model, requests, before_traffic=reset_counts)
    counts = read_counts()
    long_prompts = sum(1 + p > 384 for p in prompts)
    check_counts("moe-serve", counts, {
        "swa_fwd_dense": hp.num_layers * long_prompts,
        "nucleus_select": None})
    bench = gen_bench.Bench(model, seq=seq)
    decode_counts = {}
    json_row, greedy = gen_bench.run_mode(
        bench, gen_bench.GREEDY, "greedy", names=["ar", "jacobi_full"],
        timed=counted(decode_counts))
    check_counts("moe-serve ar", decode_counts["ar"], {})
    check_counts("moe-serve jacobi_full", decode_counts["jacobi_full"], {
        "swa_fwd_dense": hp.num_layers * greedy["jacobi_full"]["passes"]})
    held = held_against_ar("moe-serve jacobi_full", model,
                           greedy["ar"]["tokens"],
                           greedy["jacobi_full"]["tokens"])
    del model, bench
    gc.collect()
    torch.cuda.empty_cache()
    stats.update(prefills_at_512=long_prompts, launches=total(
        counts, *decode_counts.values()), serve_launches=counts,
        greedy=mode_stats(greedy, decode_counts),
        greedy_held_against_ar=held, gen_bench_row=json_row, card=smi)
    print("moe-serve " + json.dumps(stats), flush=True)
    return stats


# -- the data, model and expert axes ------------------------------------------

MESH = 4               # ranks of each mesh phase, all on this card (gloo)
MESH_SEED = 41
MESH_STEPS = 2         # step 1 held, then 1 more
MESH_TP_GROUP = (4, 4096)     # r5: one micro-batch of [4, 4096]
MESH_MOE_GROUP = (8, 1024)    # the MoE LM: 16 rows a step in 2 of [8, 1024]
MESH_MOE_SEED = 43
# A capacity factor of E / k: each expert's capacity holds every token of
# a call, so no token is dropped on one device or on a mesh and the
# sharded step is the unsharded step's (capacity pools per shard are the
# one layout-dependent behaviour, parallel/ep.py).
MESH_NO_DROP = 4.0
# Two bf16 steps in different summation orders, each at an angle theta
# from the fp32 gradient, may be 2 theta apart. The unsharded kernel step
# is a reference for a sharded one at TRAIN_GRAD_COS only where its own
# angle to fp32 is at most half the angle TRAIN_GRAD_COS allows:
# cos(arccos(0.99) / 2) = 0.9975. Between that and TRAIN_GRAD_COS the
# sharded step is held to TRAIN_GRAD_COS against the unsharded step or
# against fp32 itself, as the train phases hold a kernel step (mesh-tp's
# first run: the bottleneck's learned queries at 0.9933 and 0.9935 from
# fp32 unsharded and sharded, 0.988 from each other; mesh-moe-tp's:
# layer 2's v_linear bias at 0.9902 and 0.9893 from fp32, 0.9905 from
# each other).
MESH_REFERENCE_COS = float(np.cos(np.arccos(TRAIN_GRAD_COS) / 2))
MESH_FIT_STEPS = 2
MESH_FIT_DOCS = 80
MESH_FIT_SEED = 47
# mesh-fit's cut of r5's data shape: documents of 512-4,096 tokens in
# batches of 8,192 tokens (r5: 512-50,000 in 100,000), so that a step's
# host-staged all-reduces stay within the run's time.
MESH_FIT_TOKENS = (512, 4096, 8192)


def mesh_source_hparams(source):
    return run_hparams(source) if isinstance(source, str) else source


def mesh_global_noise(source, rows: int, accumulate: int, seed: int):
    """Per micro-batch, the global batch's posterior noise {"eps", "mi"}
    ({"eps": [K, rows, 1, latent]} with train_mc_samples K > 1) on the
    CPU for a VAE run; None for a language model."""
    hp = mesh_source_hparams(source)
    if not hasattr(hp, "latent_depth"):
        return None
    gen = torch.Generator().manual_seed(seed)
    if hp.train_mc_samples > 1:
        return [{"eps": torch.randn((hp.train_mc_samples, rows, 1,
                                     hp.latent_depth), generator=gen)}
                for _ in range(accumulate)]
    return [{"eps": torch.randn((rows, 1, hp.latent_depth), generator=gen),
             "mi": torch.randn((10, rows, hp.latent_depth), generator=gen)}
            for _ in range(accumulate)]


def unsharded_mesh_step(source, group, accumulate: int, seed: int, noise,
                        use_kernels: bool, dtype) -> dict:
    """One unsharded step of `source` (a run name or hparams from the JAX
    initialisation drawn from `seed`) on the batches mesh_rank draws from
    `seed`, with the same noise and no dropout: loss, gradients on the
    CPU, launch counts, seconds and peak bytes."""
    rows, width = group
    if isinstance(source, str):
        model, objective, optimizer, _ = build_training(
            source, "cuda", accumulate, use_kernels=use_kernels,
            dtype=dtype)
    else:
        model, objective, optimizer, _ = build_from_hparams(
            source, torch.Generator().manual_seed(seed), "cuda",
            use_kernels=use_kernels, dtype=dtype)
    if hasattr(model, "decoder_layers"):
        model.hparams.input_dropout = 0.0
        for layer in model.decoder_layers:
            layer.dropout_rate = 0.0
    rng = np.random.default_rng(seed)
    mbs = [{k: v.to("cuda") for k, v in synthetic_batch(
        rng, rows, width, model.hparams.vocab_size).items()}
        for _ in range(accumulate)]
    noise = None if noise is None else [
        {k: v.to("cuda") for k, v in n.items()} for n in noise]
    gen = torch.Generator(device="cuda").manual_seed(seed)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    metrics = train_step(model, objective, optimizer, mbs, 0, noise, gen)
    torch.cuda.synchronize()
    out = {"loss": float(metrics["loss"]),
           "seconds": time.perf_counter() - t0, "launches": read_counts(),
           "peak": torch.cuda.max_memory_allocated(),
           "real_tokens": sum(int(mb["num_tokens"].sum()) for mb in mbs),
           "grads": {n: p.grad.detach().float().cpu()
                     for n, p in model.named_parameters()}}
    del model, objective, optimizer, metrics, mbs
    gc.collect()
    torch.cuda.empty_cache()
    return out


def mesh_pair_rank(world, kernel_args: tuple, plain_args: tuple) -> tuple:
    """One rank of a mesh phase: train.mesh_rank's run through the
    kernels, then its fp32 plain run, in one process."""
    kernel = mesh_rank(world, *kernel_args)
    gc.collect()
    torch.cuda.empty_cache()
    return kernel, mesh_rank(world, *plain_args)


def run_parts(world, parts: list) -> list:
    """One rank of the mesh phases (37-43): each part (label, fn, args)
    as fn(world, *args), in turn; rank 0 prints each part's seconds.
    Returns [(result, seconds)] a part."""
    out = []
    for label, fn, args in parts:
        t0 = time.perf_counter()
        result = fn(world, *args)
        gc.collect()
        torch.cuda.empty_cache()
        seconds = time.perf_counter() - t0
        if world.rank == 0:
            print(f"[{label} ranks] done in {seconds:.1f} s", flush=True)
        out.append((result, seconds))
    return out


def mesh_part(source, tp: int, ep: int, group, accumulate: int, seed: int,
              noise, first_step=None, drops: bool = False, sp: int = 1,
              steps: int = MESH_STEPS, plain_source=None) -> tuple:
    """train.mesh_rank's arguments for `steps` mesh steps of `source`
    through the kernels (step 1 held; first_step as there) and for one
    through the fp32 plain versions (of plain_source where given: the
    same model with a smaller loss chunk, so that four ranks' fp32
    logits fit beside each other on the card)."""
    rows, width = group
    args = (source, steps, rows, width, seed, accumulate, tp, ep, noise,
            True, False, True, None, first_step, drops, sp)
    plain_args = ((plain_source or source), 1) + args[2:11] + (
        False, torch.float32, first_step, False, sp)
    return args, plain_args


def check_mesh_records(records: list):
    """Every rank on the card, one backend, the same finite losses."""
    check([r["rank"] for r in records] == list(range(MESH)),
          "a rank is missing")
    check(all(r["device"].startswith("cuda") for r in records),
          "a rank ran off the card")
    check(len({r["backend"] for r in records}) == 1,
          "the ranks disagree on the backend")
    losses = [[m["loss"] for m in r["metrics"]] for r in records]
    check(all(np.isfinite(x).all() and x == losses[0] for x in losses),
          f"the ranks' losses differ or are not finite: {losses}")


def pair_runs(got: list) -> tuple:
    """A pair part's results on every rank [(kernel, plain), seconds] ->
    (the kernel records, the plain records, the part's seconds), each set
    of records checked by `check_mesh_records`."""
    runs = [[pair[i] for pair, _ in got] for i in (0, 1)]
    for records in runs:
        check_mesh_records(records)
    return runs[0], runs[1], max(sec for _, sec in got)


def held_sharded(name: str, b_loss: float, b_grads: dict, a: dict,
                 c: dict, d_loss: float, d_grads: dict,
                 reference_cos: float = TRAIN_GRAD_COS,
                 zero_share: float = 0.0) -> dict:
    """Hold a sharded step against the unsharded one, as sp-train does:
    the fp32 plain pair (d against c) at loss SP_FP32_LOSS_RTOL and every
    gradient at cosine >= TRAIN_GRAD_COS; the kernel pair (b against a)
    at loss TRAIN_LOSS_RTOL and cosine >= TRAIN_GRAD_COS wherever the
    unsharded kernel step a is within `reference_cos` of fp32 c;
    where a is within TRAIN_GRAD_COS of c but not `reference_cos`, b at
    cosine >= TRAIN_GRAD_COS with a or with c; elsewhere no farther from
    c than a, less NOISY_GRAD_MARGIN (MESH_REFERENCE_COS says why a mesh
    phase asks more of a than sp-train). With zero_share, a gradient below
    the reference whose fp32 norm is at most zero_share of the largest
    gradient's is numerically zero: it is held against the unsharded
    kernel step's own noise, b at most twice as far from c as a is and
    at a cosine with c of at least half a's, so that a zeroed or
    sign-flipped gradient fails (SEQ_NEAR_ZERO says where and why)."""
    d_cos = cosines(d_grads, c["grads"])
    check(len(d_cos) == len(c["grads"]) == len(b_grads),
          f"{name}: {len(d_cos)} gradients compared")
    check(abs(d_loss - c["loss"]) <= SP_FP32_LOSS_RTOL * abs(c["loss"]),
          f"{name}: fp32 sharded loss {d_loss} vs unsharded {c['loss']}")
    check(min(d_cos.values()) >= TRAIN_GRAD_COS,
          f"{name}: fp32 sharded gradients disagree with the unsharded "
          f"fp32 step: {sorted(d_cos.items(), key=lambda kv: kv[1])[:3]}")
    loss_rel = abs(b_loss - a["loss"]) / abs(a["loss"])
    check(loss_rel <= TRAIN_LOSS_RTOL,
          f"{name}: step 1 loss {b_loss} vs unsharded {a['loss']}")
    ba_cos = cosines(b_grads, a["grads"])
    ac_cos = cosines(a["grads"], c["grads"])
    bc_cos = cosines(b_grads, c["grads"])
    noisy = {n: {"unsharded_vs_fp32": ac_cos[n], "sharded_vs_fp32": bc_cos[n],
                 "sharded_vs_unsharded": ba_cos[n]}
             for n in ac_cos if ac_cos[n] < reference_cos}
    held = {n: v for n, v in ba_cos.items() if n not in noisy}
    check(min(held.values()) >= TRAIN_GRAD_COS,
          f"{name}: step 1 gradients disagree with the unsharded step: "
          + str([(n, v, "unsharded_vs_fp32", ac_cos[n], "sharded_vs_fp32",
                  bc_cos[n]) for n, v in sorted(
                      held.items(), key=lambda kv: kv[1])[:5]]))
    norms = {n: float(g.double().norm()) for n, g in c["grads"].items()}
    largest = max(norms.values())
    zero = {}
    for n in noisy:
        if zero_share and norms[n] <= zero_share * largest:
            want = c["grads"][n].double()
            zero[n] = {**noisy[n], "norm_share": norms[n] / largest,
                       "sharded_distance": float(
                           (b_grads[n].double() - want).norm()) / norms[n],
                       "unsharded_distance": float(
                           (a["grads"][n].double() - want).norm())
                       / norms[n]}
    check(all(v["sharded_distance"] <= 2 * v["unsharded_distance"]
              and v["sharded_vs_fp32"] >= v["unsharded_vs_fp32"] / 2
              for v in zero.values()),
          f"{name}: a numerically zero gradient is farther from fp32 than "
          f"the unsharded step's noise allows: {zero}")
    far = {}
    for n, v in noisy.items():
        if n in zero:
            continue
        if v["unsharded_vs_fp32"] >= TRAIN_GRAD_COS:
            ok = max(v["sharded_vs_unsharded"],
                     v["sharded_vs_fp32"]) >= TRAIN_GRAD_COS
        else:
            ok = (v["sharded_vs_fp32"]
                  >= v["unsharded_vs_fp32"] - NOISY_GRAD_MARGIN)
        if not ok:
            far[n] = v
    check(not far, f"{name}: too far from fp32 sharded: {far}; every "
          f"gradient below the reference: {noisy}")
    return {"loss": b_loss, "unsharded_loss": a["loss"],
            "loss_rel_err": loss_rel, "gradients": len(ba_cos),
            "min_grad_cosine": sorted(held.items(),
                                      key=lambda kv: kv[1])[:3],
            "near_zero_gradients": noisy, "numerically_zero": zero,
            "fp32": {"unsharded_loss": c["loss"], "sharded_loss": d_loss,
                     "min_grad_cosine": sorted(
                         d_cos.items(), key=lambda kv: kv[1])[:3]}}


def mesh_layout_specs(source, tp: int, ep: int) -> dict:
    """The names of the parameters sharded on the mesh."""
    from sparse_vae_tpu_torch.checkpoint import model_class
    from sparse_vae_tpu_torch.parallel import ep as pep
    from sparse_vae_tpu_torch.parallel import tp as ptp
    hp = mesh_source_hparams(source)
    with torch.device("meta"):
        template = model_class(hp)(hp)
    if tp > 1:
        return ptp.param_specs(template, ptp.shards_vocab(hp, tp))
    return pep.param_specs(template) if ep > 1 else {}


def mesh_replicas_equal(name: str, records: list, specs: dict, tp: int):
    """Every replicated parameter bitwise equal on every rank; every
    sharded one bitwise equal across the ranks that hold the same shard
    (data peers: world ranks with the same model or expert coordinate)."""
    inner = "model" if tp > 1 else "expert"
    for pname in records[0]["local_digests"]:
        if pname in specs:
            by_shard = {}
            for r in records:
                by_shard.setdefault(r["coords"].get(inner, 0), set()).add(
                    r["local_digests"][pname])
            check(all(len(d) == 1 for d in by_shard.values()),
                  f"{name}: shard of {pname} differs across data peers")
        else:
            check(len({r["local_digests"][pname] for r in records}) == 1,
                  f"{name}: replicated {pname} differs across ranks")


def mesh_rank_counts(name: str, records: list, expect: dict):
    for r in records:
        check_counts(f"{name} rank {r['rank']}", r["launches"], expect)


def mesh_references(source, group, accumulate: int, seed: int,
                    first_step=None) -> dict:
    """The unsharded steps a mesh phase is held against (at first_step's
    capacity factor, without dropout): the global noise and the steps
    through the kernels (a) and through the fp32 plain versions (c)."""
    rows, _ = group
    hold = source
    if first_step and "capacity_factor" in first_step:
        hold = replace(source, moe_capacity_factor=first_step[
            "capacity_factor"])
    noise = mesh_global_noise(hold, rows, accumulate, seed)
    return {"noise": noise,
            "a": unsharded_mesh_step(hold, group, accumulate, seed, noise,
                                     True, None),
            "c": unsharded_mesh_step(hold, group, accumulate, seed, noise,
                                     False, torch.float32)}


def mesh_step_plan(name: str, smi: str, source, tp: int, ep: int, group,
                   accumulate: int, seed: int, expect: dict,
                   first_step=None, refs=None) -> tuple:
    """One mesh's phase as a plan (`mesh_phases`): the unsharded kernel
    and fp32 plain steps of `source` (at first_step's capacity factor,
    without dropout) computed here, the same step on MESH ranks through
    the kernels, then MESH_STEPS - 1 more at the run's own settings, and
    through the fp32 plain versions, held by `hold_mesh_part`."""
    refs = refs or mesh_references(source, group, accumulate, seed,
                                   first_step)
    check_counts(f"{name} unsharded", refs["a"]["launches"],
                 {**{k: v * accumulate for k, v in expect.items()
                     if not k.startswith("tied_ce")},
                  "tied_ce_fwd": accumulate, "tied_ce_bwd": accumulate})
    moe = getattr(mesh_source_hparams(source), "num_experts", 0) > 1
    part = mesh_part(source, tp, ep, group, accumulate, seed, refs["noise"],
                     first_step, drops=moe)

    def finish(got):
        records, plain, seconds = pair_runs(got[0])
        stats = hold_mesh_part(name, smi, source, {"model": tp,
                                                   "expert": ep},
                               group, accumulate, refs, (records, plain),
                               expect)
        stats["ranks_s"] = seconds
        print(f"{name} " + json.dumps(stats), flush=True)
        return stats

    return name, [(name, mesh_pair_rank, part)], finish


def hold_mesh_part(name: str, smi: str, source, axes: dict, group,
                   accumulate: int, refs: dict, runs, expect,
                   steps: int = MESH_STEPS, zero_share: float = 0.0) -> dict:
    """Hold one mesh run (`runs`: its kernel and plain records) against
    the unsharded steps `refs` by `held_sharded`; every rank's launch
    counts against `expect` a micro-batch (a dict, or a function of the
    rank's record; the plain-route counters 0), the parameters checked by
    `mesh_replicas_equal` after the last step. Prints seconds a step,
    real tokens/s, the time in host-staged transfers, each rank's peak
    memory and, for an MoE model, each rank's dropped share a layer in
    the last step. axes: the mesh's model, expert and seq sizes;
    zero_share as `held_sharded`'s."""
    rows, width = group
    a, c = refs["a"], refs["c"]
    tp, ep = axes.get("model", 1), axes.get("expert", 1)
    check_counts(f"{name} unsharded fp32 plain", c["launches"], {})
    records, plain = runs
    moe = getattr(mesh_source_hparams(source), "num_experts", 0) > 1
    stats = held_sharded(name, records[0]["metrics"][0]["loss"],
                         records[0]["grads"], a, c,
                         plain[0]["metrics"][0]["loss"], plain[0]["grads"],
                         MESH_REFERENCE_COS, zero_share)
    for r in records:
        per_mb = expect(r) if callable(expect) else expect
        check_counts(f"{name} rank {r['rank']}", r["launches"],
                     {k: v * accumulate * steps for k, v in per_mb.items()})
    mesh_rank_counts(f"{name} fp32 plain", plain, {})
    mesh_replicas_equal(name, records, mesh_layout_specs(source, tp, ep),
                        tp)
    for r in records:
        check(len(set(r["param_digests"])) == steps,
              f"{name}: rank {r['rank']}'s parameters did not move")
    stats.update(mesh_timing(records, a, plain))
    stats.update(mesh={"data": MESH // (tp * ep * axes.get("seq", 1)),
                       **axes},
                 group=[accumulate, rows, width],
                 losses=[m["loss"] for m in records[0]["metrics"]],
                 card=smi)
    if moe:
        stats.update(
            train_moe_aux=[m["train_moe_aux"]
                           for m in records[0]["metrics"]],
            train_moe_z=[m["train_moe_z"] for m in records[0]["metrics"]],
            dropped_share_by_layer_by_rank=[
                r["dropped_share_by_layer"] for r in records])
    return stats


def mesh_timing(records: list, unsharded: dict, plain: list) -> dict:
    """Seconds a step (the first and the rest), real tokens/s of the
    global batch, seconds in host-staged transfers and peak memory, by
    rank."""
    later = [r["step_s"][1:] or r["step_s"] for r in records]
    slowest = max(sum(s) / len(s) for s in later)
    return {"step_s_by_rank": [r["step_s"] for r in records],
            "staged_s_by_rank": [r["staged_s"] for r in records],
            "staged_share_after_step_1": max(
                sum(r["staged_s"][1:] or r["staged_s"])
                / sum(r["step_s"][1:] or r["step_s"]) for r in records),
            "real_tokens_a_step": unsharded["real_tokens"],
            "real_tokens_per_s_after_step_1":
                unsharded["real_tokens"] / slowest,
            "unsharded_step_s": unsharded["seconds"],
            "unsharded_real_tokens_per_s":
                unsharded["real_tokens"] / unsharded["seconds"],
            "unsharded_max_memory_allocated": unsharded["peak"],
            "max_memory_allocated_by_rank": [
                r.get("max_memory_allocated") for r in records],
            "fp32_plain_step_s_by_rank": [r["step_s"] for r in plain],
            "launches_by_rank": [r["launches"] for r in records]}


def mesh_tp_plan(smi: str) -> tuple:
    """r5 at full width over data 2 x model 2 (4 heads and half of each
    FFN a shard, the 32,768-row tied table split into 16,384 rows a
    shard) on [4, 4096] ragged documents: K1/K2 6 launches a step on
    every rank, K3/K3b none (the vocab-parallel cross-entropy runs in
    torch products)."""
    return mesh_step_plan("mesh-tp", smi, RUN, 2, 1, MESH_TP_GROUP, 1,
                          MESH_SEED, {"swa_fwd": 6, "swa_bwd": 6})


MESH_MOE_FIRST_STEP = {"capacity_factor": MESH_NO_DROP, "dropout": False}


def mesh_moe_references() -> dict:
    """The unsharded MoE steps mesh-ep and mesh-moe-tp are both held
    against (one model, batches and noise)."""
    return mesh_references(moe_hparams(), MESH_MOE_GROUP, mesh_moe_accumulate(),
                           MESH_MOE_SEED, MESH_MOE_FIRST_STEP)


def mesh_moe_accumulate() -> int:
    return json.loads((REPO / "runs" / MOE_RUN / "meta.json").read_text())[
        "trainer_hparams"]["accumulate_grad_batches"]


def mesh_moe_plan(name: str, smi: str, tp: int, ep: int, refs) -> tuple:
    """real-prose-lm-moe at full width (6 layers of 8 experts, top-2) over
    data 2 x expert 2 (ep) or data 2 x model 2 (tp), on micro-batches of
    MESH_MOE_GROUP ragged documents, accumulation 2 (the run's): step 1
    at capacity factor MESH_NO_DROP without dropout held against the
    unsharded step, then a step at the run's 1.25 with its dropout (masks
    per row shard), each rank's dropped share a layer printed. K1/K2 on
    the dense causal route 6 launches a micro-batch on every rank, K3/K3b
    once a micro-batch under ep and never under tp (the vocabulary is
    split). refs: mesh_moe_references(), shared by the two phases."""
    expect = {"swa_fwd_dense": 6, "swa_bwd_dense": 6}
    if ep > 1:
        expect.update(tied_ce_fwd=1, tied_ce_bwd=1)
    return mesh_step_plan(
        name, smi, moe_hparams(), tp, ep, MESH_MOE_GROUP,
        mesh_moe_accumulate(), MESH_MOE_SEED, expect, MESH_MOE_FIRST_STEP,
        refs)


def mesh_fit_one(world, name: str, run: str, mesh_kw: dict, dotlist: list,
                 corpus, log_root: str) -> dict:
    """One rank of a mesh fit: Trainer.fit of `run`'s hparams on the mesh
    of `mesh_kw` (FitTrainer, capturing the step-1 state), then the step-1
    checkpoint restored into a new state and stepped on the run's second
    group, against the run's step-2 checkpoint. Returns the steps,
    validations, saves, launches, peak memory, staged seconds, the bucket
    quantum a seq mesh needs (sp_pad_multiple) and the trainer's override
    of it (None where the data's pad_to_multiple_of already is one),
    whether the resumed step is bit for bit the unbroken one, and on rank
    0 the gathered trained parameters on the CPU."""
    from sparse_vae_tpu_torch.parallel import group as pgroup
    from sparse_vae_tpu_torch.parallel.mesh import create_mesh
    mesh = create_mesh(world, **mesh_kw)
    meta = json.loads((REPO / "runs" / run / "meta.json").read_text())
    cfg = assemble_config("transformer-vae", dotlist, base_meta=meta)
    data = TextDataModule(cfg.data)
    data.prepare_corpus(corpus)
    overrides = dict(cfg.model_overrides)
    overrides.setdefault("vocab_size", cfg.data.vocab_size)
    hp, objective = build_hparams("transformer-vae", overrides)
    trainer = FitTrainer(hp, objective, data, cfg.trainer,
                         experiment="transformer-vae", name=name,
                         log_root=Path(log_root), mesh=mesh,
                         capture_step=1)
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    pgroup.staged_seconds = 0.0
    t0 = time.perf_counter()
    outcome = trainer.fit()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts, staged = read_counts(), pgroup.staged_seconds
    peak = torch.cuda.max_memory_allocated()
    model, optimizer = trainer.init_state(torch.Generator().manual_seed(1))
    generator = torch.Generator(device="cuda")
    step = trainer.restore(model, optimizer, generator, step=1)
    restored = cpu_state(trainer.state(model, optimizer, step, generator))
    trainer._pending_groups = {}    # the epoch's groups as fit met them
    groups = trainer._accum_groups(trainer.thp.seed)
    next(groups)
    Trainer._step(trainer, model, optimizer, next(groups)[0], step,
                  generator)
    resumed = cpu_state(trainer.state(model, optimizer, step + 1,
                                      generator))
    unbroken = cpu_state(trainer.ckpt.restore(2, map_location="cpu"))
    record = {"rank": world.rank, "step": outcome.step,
              "coords": {a: mesh.coord(a) for a in mesh.shape},
              "stopped": outcome.stopped_reason, "fit_s": seconds,
              "steps": trainer.steps, "validations": trainer.validations,
              "saves": trainer.saves, "launches": counts, "peak": peak,
              "staged_s": staged, "pad_multiple": trainer._pad_multiple,
              "pad_quantum": sp_pad_multiple(
                  hp, mesh.size("seq"), cfg.data.pad_to_multiple_of),
              "restored_equal": (trainer.captured is not None
                                 and states_equal(restored,
                                                  trainer.captured)),
              "resumed_equal": states_equal(resumed, unbroken)}
    if world.rank == 0:
        record["params"] = {k: v.detach().cpu() for k, v in
                            outcome.model.state_dict().items()}
        record["meta"] = trainer.meta()
    del model, optimizer, outcome, trainer
    gc.collect()
    torch.cuda.empty_cache()
    return record


def mesh_fits_rank(world, fits: list) -> list:
    """One rank of the mesh fits, `mesh_fit_one` each in turn."""
    return [mesh_fit_one(world, *fit) for fit in fits]


def mesh_fit_held(name: str, run: str, records: list, log_root: Path,
                  steps: int, expect, smi: str, layout: dict) -> dict:
    """A mesh fit's checks: MESH_FIT_STEPS steps, a validation each, every
    rank's launches against expect(record, micro-batches, validation
    batches), the step-1 state restored bit for bit and one step from it
    equal to the run's step-2 checkpoint bit for bit on every rank, the
    gathered checkpoint loaded on the card by load_checkpoint_for_name
    equal to the trained parameters bit for bit, and, exported by
    export_archive, served by load_run(<dir>) with the trained model's
    serving logits. layout: the mesh and the run's cuts, printed."""
    from sparse_vae_tpu_torch import load_checkpoint_for_name
    for r in records:
        check((r["step"], r["stopped"]) == (steps, "max_steps"),
              f"{name} rank {r['rank']} stopped at {r['step']}: "
              f"{r['stopped']}")
        check([v["step"] for v in r["validations"]]
              == list(range(1, steps + 1)),
              f"{name} validated at {r['validations']}")
        check(all(np.isfinite(s["loss"]) for s in r["steps"]),
              f"{name}: a loss is not finite")
        micro = sum(s["shape"][0] for s in r["steps"])
        val_batches = sum(v["batches"] for v in r["validations"])
        check_counts(f"{name} rank {r['rank']}", r["launches"],
                     expect(r, micro, val_batches))
        check(r["restored_equal"], f"{name} rank {r['rank']}: the "
              "restored state is not the saved one")
        check(r["resumed_equal"], f"{name} rank {r['rank']}: a step from "
              "the step-1 checkpoint is not the run's step 2")
        check([{k: v for k, v in val.items() if k != "seconds"}
               for val in r["validations"]]
              == [{k: v for k, v in val.items() if k != "seconds"}
                  for val in records[0]["validations"]],
              f"{name}: the ranks' validations differ")
    trained = records[0]["params"]
    model, hp, _, state, _ = load_checkpoint_for_name(
        "transformer-vae", name, root=log_root, device="cuda")
    check(state["step"] == steps and all(
        torch.equal(state["params"][k].cpu(), v) for k, v in trained.items()),
        f"{name}: the checkpoint is not the trained parameters")
    out = export_archive(model, records[0]["meta"], log_root / name,
                         step=steps, compress=False)
    served, _, _ = load_run(str(out), device="cuda")
    own_form = serving_form(model)
    gen = torch.Generator(device="cuda").manual_seed(MESH_FIT_SEED)
    ids = torch.randint(3, hp.vocab_size, (2, 256), generator=gen,
                        device="cuda")
    ids[:, 0] = CLS_ID
    eps = torch.randn((2, 1, hp.latent_depth), generator=gen, device="cuda")
    with torch.no_grad():
        a, b = served(ids, eps)[0], own_form(ids, eps)[0]
    check(torch.equal(a, b), f"{name}: the archive's serving logits differ "
          f"from the trained model's: {(a - b).abs().max().item()}")
    del model, served, own_form
    gc.collect()
    torch.cuda.empty_cache()
    steps_fed = records[0]["steps"]
    stats = {"run": run, "layout": layout,
             "pad_multiple": records[0]["pad_multiple"],
             "pad_quantum": records[0]["pad_quantum"],
             "shapes_fed": [s["shape"] for s in steps_fed],
             "step_s_by_rank": [[s["seconds"] for s in r["steps"]]
                                for r in records],
             "real_tokens": [s["real_tokens"] for s in steps_fed],
             "real_tokens_per_s": sum(s["real_tokens"] for s in steps_fed)
             / max(sum(s["seconds"] for s in r["steps"]) for r in records),
             "staged_s_by_rank": [r["staged_s"] for r in records],
             "fit_s_by_rank": [r["fit_s"] for r in records],
             "losses": [s["loss"] for s in steps_fed],
             "validations": records[0]["validations"],
             "saves_by_rank": [r["saves"] for r in records],
             "resume_bit_identical": True, "checkpoint_equal": True,
             "archive_logits_equal": True,
             "max_memory_allocated_by_rank": [r["peak"] for r in records],
             "launches_by_rank": [r["launches"] for r in records],
             "card": smi}
    print(f"{name} " + json.dumps(stats), flush=True)
    return stats


def mesh_fit_plan(smi: str, log_root: Path) -> tuple:
    """Two Trainer.fit runs on MESH ranks of this card, one part of
    `mesh_phases`, each for MESH_FIT_STEPS steps, validating and saving
    every step, held by `mesh_fit_held`:
    - mesh-fit: r5's hparams from the JAX initialisation on data 2 x
      model 2, on a stand-in corpus cut to MESH_FIT_TOKENS; every rank's
      K1/K2 counts (6 a micro-batch and validation batch), no K3/K3b;
    - seq-fit: pg19-fb8's hparams (concatenated 102,400-token streams,
      free bits 8.0) on data 2 x seq 2, on fit-pg19's stand-in corpus:
      the bucket quantum override printed and checked (lcm(512, 2 x 2 x
      128) = 512: none), two streams a micro-batch (one a data shard),
      accumulation 2 (cut: pg19-fb8 takes one stream a micro-batch and
      4); seq shard 0 K1/K2, shard 1 K6 (6 a micro-batch and validation
      batch), K3/K3b once a micro-batch (and validation batch, K3) on
      every rank.
    The plan's finish returns (mesh-fit's stats, seq-fit's)."""
    r5_meta = json.loads((REPO / "runs" / RUN / "meta.json").read_text())
    lo, hi, tokens = MESH_FIT_TOKENS
    vocab = r5_meta["model_hparams"]["vocab_size"]
    mesh_corpus = fit_corpus(MESH_FIT_DOCS, lo, hi, vocab, MESH_FIT_SEED)
    common = ["trainer.num_devices=4", "trainer.checkpoint_every_n_steps=1",
              "trainer.log_every_n_steps=1",
              f"trainer.max_steps={MESH_FIT_STEPS}",
              "trainer.val_check_interval=0.001"]
    mesh_dotlist = common + ["trainer.model_parallel=2",
                             "trainer.limit_val_batches=2",
                             f"data.min_tokens_per_sample={lo}",
                             f"data.max_tokens_per_sample={hi}",
                             f"data.tokens_per_batch={tokens}"]
    pg19 = json.loads((REPO / "runs" / PG19_RUN / "meta.json").read_text())
    seq_corpus = fit_corpus(FIT_DOCS, r5_meta["data_hparams"][
        "min_tokens_per_sample"], r5_meta["data_hparams"][
        "max_tokens_per_sample"], vocab, FIT_SEED)
    seq_dotlist = common + [
        "trainer.seq_parallel=2", "trainer.limit_val_batches=1",
        "trainer.accumulate_grad_batches=2",
        f"data.tokens_per_batch="
        f"{2 * pg19['data_hparams']['tokens_per_batch']}"]
    fits = [("mesh-fit", RUN, {"model_axis": 2}, mesh_dotlist, mesh_corpus,
             str(log_root)),
            ("seq-fit", PG19_RUN, {"seq_axis": 2}, seq_dotlist, seq_corpus,
             str(log_root))]
    layers = r5_meta["model_hparams"]["num_layers"]

    def tp_expect(r, micro, val):
        return {"swa_fwd": layers * (micro + val), "swa_bwd": layers * micro}

    def seq_expect(r, micro, val):
        ce = {"tied_ce_fwd": micro + val, "tied_ce_bwd": micro}
        if r["coords"]["seq"] == 0:
            return {"swa_fwd": layers * (micro + val),
                    "swa_bwd": layers * micro, **ce}
        return {"sp_windowed_attention": layers * (micro + val),
                "sp_windowed_attention_bwd": layers * micro, **ce}

    def finish(got):
        ranks = [result for result, _ in got[0]]
        seconds = max(sec for _, sec in got[0])
        mesh_fit = mesh_fit_held(
            "mesh-fit", RUN, [r[0] for r in ranks], log_root,
            MESH_FIT_STEPS, tp_expect, smi,
            {"mesh": {"data": 2, "model": 2}, "document_tokens": [lo, hi],
             "tokens_per_batch": tokens, "ranks_s_with_seq_fit": seconds})
        seq_fit = mesh_fit_held(
            "seq-fit", PG19_RUN, [r[1] for r in ranks], log_root,
            MESH_FIT_STEPS, seq_expect, smi,
            {"mesh": {"data": 2, "seq": 2}, "streams_a_micro_batch": 2,
             "accumulate_grad_batches": 2,
             "ranks_s_with_mesh_fit": seconds})
        return mesh_fit, seq_fit

    return "seq-fit", [("mesh-fit+seq-fit", mesh_fits_rank, (fits,))], \
        finish


# -- the seq and pipe axes ----------------------------------------------------

SEQ_SEED = 53
SEQ_R5 = 2             # r5 over seq 2 x model 2 on sp-train's document
# The DReG step's [rows, L] (K = 4: 51,200 token rows, 25,600 a rank; at
# dreg's [2, 12800] four ranks' fp32 plain steps outgrew the card).
SEQ_DREG = (2, 6400)
SEQ_LM = (1, 92160)    # nonvae-pg19's longest document, over seq 4
SEQ_MOE = (8, 4096)    # the MoE twin's trainer group, over seq 4
# The loss chunk of the MoE twin's fp32 plain sharded step: at the run's
# 2,048 each rank's chunk of fp32 logits is [8 x 2048, 32768], 2 GiB,
# and four ranks' steps outgrew the card (the summation order aside, the
# same loss).
SEQ_PLAIN_CHUNK = 512
# On 51,200-token shards under tensor parallelism seven of the encoder's
# attention q/k gradients are 1.2e-9 to 2.2e-7 of the largest gradient's
# norm (on an H100): numerically zero (below fp32's resolution
# against the step's gradient, far below bf16's), so their cosines are
# bf16 noise in any layout (r5's middle-layer q_linear: 0.953 unsharded,
# 0.930 over seq 4, 0.890 over seq 2 x model 2, each against fp32; the
# bottleneck's k_linear 0.709 unsharded). As the LSTM phases call a
# gradient below LSTM_NEAR_ZERO numerically zero, mesh-seq holds such a
# gradient (fp32 norm at most this share of the largest) against the
# unsharded bf16 step's own distance and cosine from fp32
# (`held_sharded`), not by the cosine rules.
SEQ_NEAR_ZERO = LSTM_NEAR_ZERO
PIPE_R5 = (4, 4096)    # r5 over data 2 x pipe 2, M micro-batches of it
PIPE_LM = (4, 3584)    # the r4 LM geometry likewise
PIPE_M = 4
PIPE_STEPS = 3         # step 1 held, then 2 more
PIPE_SEED = 59


def nonvae_pg19_hparams():
    """The `nonvae-pg19` preset's Transformer LM (hparam_presets.py:
    d_model 512, 6 sparse layers, bf16, documents up to 92,160 tokens)."""
    cfg = assemble_config("transformer-lm", ["preset=nonvae-pg19"])
    overrides = dict(cfg.model_overrides)
    overrides.setdefault("vocab_size", cfg.data.vocab_size)
    return build_hparams("transformer-lm", overrides)[0]


def by_seq_coord(first: dict, later: dict):
    """Launch counts a micro-batch by the rank's seq coordinate: shard 0
    runs `first` (K1/K2 over its own block band), every other shard
    `later` (K6: the band over its left halo plus the broadcast [CLS])."""
    return lambda r: first if r["coords"].get("seq", 0) == 0 else later


def seq_counts(layers: int, passes: int = 1, ce: int = 0) -> object:
    """by_seq_coord for `layers` decoder layers, `passes` forwards a
    micro-batch (the DReG step's weights pass without gradients is one
    more), and `ce` K3/K3b launches a micro-batch on every rank."""
    tail = {"tied_ce_fwd": ce, "tied_ce_bwd": ce} if ce else {}
    return by_seq_coord(
        {"swa_fwd": layers * passes, "swa_bwd": layers, **tail},
        {"sp_windowed_attention": layers * passes,
         "sp_windowed_attention_bwd": layers, **tail})


def seq_route_flips(records: list, unsharded_routes: list, ids,
                    sp: int) -> list:
    """Per rank and layer, the real tokens of the rank's length shard
    (ids: the global [rows, L] batch) whose top-k experts or kept slots
    differ from the unsharded forward's."""
    rows, width = ids.shape
    out = []
    for r in records:
        s = r["coords"].get("seq", 0)
        part = slice(s * width // sp, (s + 1) * width // sp)
        local = [(ua.cpu().reshape(rows, width, -1)[:, part].reshape(
                      -1, ua.shape[-1]),
                  uk.cpu().reshape(-1, rows, width)[..., part].reshape(
                      uk.shape[0], -1))
                 for ua, uk in unsharded_routes]
        out.append(route_flips(r["routes"], local,
                               (ids[:, part] != 0).reshape(-1)))
    return out


def mesh_seq_plan(smi: str, r5_refs: dict) -> tuple:
    """The seq axis inside a mesh, four mesh runs of `mesh_phases`' MESH
    ranks on this card, each held against the unsharded steps on the same
    weights, documents and noise by `hold_mesh_part`:
    - r5 over seq 2 x model 2 on sp-train's [1, 102400] document and eps
      (its unsharded steps, `r5_refs`), 2 steps: seq shard 0 K1/K2, shard
      1 K6 at q [1, 4, 51200, 64], no K3/K3b (the vocabulary split);
    - the sharded DReG step: r5's geometry from the JAX initialisation
      with train_mc_samples 4 over seq 2 x model 2 on [2, 6400] (K1 or
      K6 twice a layer, K2 or K6's backward once);
    - the nonvae-pg19 LM (the JAX initialisation) over seq 4 on one
      [1, 92160] document, 23,040 tokens a shard: K6 on ranks 1-3, K1/K2
      on rank 0, K3/K3b on every rank; step 1 without dropout, step 2
      with it (masks per length shard);
    - real-prose-lm-moe with sparse attention over seq 4 on one [8, 4096]
      group: step 1 at MESH_NO_DROP without dropout, step 2 at 1.25 with
      dropout; each rank's dropped share a layer, and the tokens whose
      routes differ from the unsharded forward's.
    Then real-prose-lm-moe as archived (dense attention) over a seq group
    raises the JAX package's ValueError."""
    from sparse_vae_tpu_torch.checkpoint import model_class
    from sparse_vae_tpu_torch.parallel.group import AxisGroup
    from sparse_vae_tpu_torch.parallel.sp import sp_localize
    dreg_hp = replace(run_hparams(RUN), train_mc_samples=DREG_SAMPLES)
    lm_hp = nonvae_pg19_hparams()
    moe_hp = replace(moe_hparams(), sparse_self_attention=True)
    first = MESH_MOE_FIRST_STEP
    refs = {"dreg": mesh_references(dreg_hp, SEQ_DREG, 1, SEQ_SEED),
            "lm": mesh_references(lm_hp, SEQ_LM, 1, SEQ_SEED),
            "moe": mesh_references(moe_hp, SEQ_MOE, 1, SEQ_SEED, first)}
    hold = replace(moe_hp, moe_capacity_factor=first["capacity_factor"])
    rng = np.random.default_rng(SEQ_SEED)
    ids = synthetic_batch(rng, *SEQ_MOE, moe_hp.vocab_size)["token_ids"]
    moe_routes_ref = moe_routes(
        lambda kernels, dtype: build_from_hparams(
            hold, torch.Generator().manual_seed(SEQ_SEED), "cuda",
            use_kernels=kernels, dtype=dtype)[:3], True, None,
        ids.to("cuda"))
    layers = run_hparams(RUN).num_layers
    parts = {
        "r5": (RUN, {"model": 2, "seq": SEQ_R5}, (1, SP_SEQ), r5_refs,
               mesh_part(RUN, 2, 1, (1, SP_SEQ), 1, SP_SEED,
                         r5_refs["noise"], sp=SEQ_R5),
               seq_counts(layers)),
        "dreg": (dreg_hp, {"model": 2, "seq": 2}, SEQ_DREG, refs["dreg"],
                 mesh_part(dreg_hp, 2, 1, SEQ_DREG, 1, SEQ_SEED,
                           refs["dreg"]["noise"], sp=2, steps=1),
                 seq_counts(layers, passes=2)),
        "lm": (lm_hp, {"seq": MESH}, SEQ_LM, refs["lm"],
               mesh_part(lm_hp, 1, 1, SEQ_LM, 1, SEQ_SEED, None,
                         {"dropout": False}, sp=MESH),
               seq_counts(lm_hp.num_layers, ce=1)),
        "moe": (moe_hp, {"seq": MESH}, SEQ_MOE, refs["moe"],
                mesh_part(moe_hp, 1, 1, SEQ_MOE, 1, SEQ_SEED, None, first,
                          drops=True, sp=MESH, plain_source=replace(
                              moe_hp, loss_chunk_size=SEQ_PLAIN_CHUNK)),
                seq_counts(moe_hp.num_layers, ce=1))}

    def finish(got):
        stats = {}
        for (name, (source, axes, group, ref, args, expect)), part in zip(
                parts.items(), got):
            records, plain, seconds = pair_runs(part)
            stats[name] = hold_mesh_part(f"mesh-seq {name}", smi, source,
                                         axes, group, 1, ref,
                                         (records, plain), expect,
                                         args[0][1], SEQ_NEAR_ZERO)
            stats[name]["ranks_s"] = seconds
        records = pair_runs(got[3])[0]
        stats["moe"]["real_tokens_by_rank"] = [
            int((ids.reshape(SEQ_MOE[0], MESH, -1)[:, r["coords"]["seq"]]
                 != 0).sum()) for r in records]
        stats["moe"]["route_flips_by_rank_by_layer"] = seq_route_flips(
            records, moe_routes_ref, ids, MESH)
        dense = run_hparams(MOE_RUN)
        with torch.device("meta"):
            archived = model_class(dense)(dense)
        try:
            sp_localize(archived, AxisGroup(0, MESH, torch.device("cpu"),
                                            "gloo"))
            refused = None
        except ValueError as err:
            refused = str(err)
        check(refused is not None and "sparse sliding-window" in refused,
              f"the dense {MOE_RUN} over seq was not refused: {refused}")
        stats["dense_moe_over_seq"] = refused
        stats["card"] = smi
        print("mesh-seq " + json.dumps(stats), flush=True)
        return stats

    return "mesh-seq", [(f"mesh-seq {name}", mesh_pair_rank, part[4])
                        for name, part in parts.items()], finish


def pipe_rank(world, source, steps: int, rows: int, width: int, seed: int,
              micro: int, noise, use_kernels: bool, dtype) -> dict:
    """One rank of a pipelined run (parallel/pp.py) on data 2 x pipe 2:
    `steps` steps of `source` (a run name or hparams from the JAX
    initialisation drawn from `seed`), without dropout, each over `micro`
    micro-batches of this rank's rows of seeded [rows, width] batches (the
    same as unsharded_mesh_step's), the first with `noise`. Returns the
    rank's coordinates, metrics, step seconds, host-staged seconds, the
    schedule's seconds and this stage's busy seconds a step, launch
    counts, peak memory, a digest of its parameters after each step and
    of each at the end (full-model names), and the first step's gradients
    of its parameters on the CPU."""
    from sparse_vae_tpu_torch.parallel import group as pgroup
    from sparse_vae_tpu_torch.parallel import pp
    from sparse_vae_tpu_torch.parallel.mesh import create_mesh, shard_batch
    from sparse_vae_tpu_torch.train import param_digest, param_digest_of
    from sparse_vae_tpu_torch.train import run_lr
    mesh = create_mesh(world, pipe_axis=2)
    if isinstance(source, str):
        model, objective, _, _ = build_training(
            source, "cuda", micro, use_kernels=use_kernels, dtype=dtype)
        meta = json.loads((REPO / "runs" / source / "meta.json")
                          .read_text())
        lr = run_lr(model.hparams, meta, micro)
    else:
        model, objective, _, _ = build_from_hparams(
            source, torch.Generator().manual_seed(seed), "cuda",
            use_kernels=use_kernels, dtype=dtype)
        lr = model.hparams.lr
    hp = model.hparams
    hp.input_dropout = 0.0
    for layer in model.decoder_layers:
        layer.dropout_rate = 0.0
    stage = pp.pp_localize(model, mesh)
    optimizer = pp.make_pp_optimizer(
        stage, lr=lr, lr_decay_steps=hp.lr_decay_steps,
        grad_clip_threshold=hp.grad_clip_threshold,
        weight_decay=hp.weight_decay)
    step_fn = pp.make_pp_train_step(stage, objective, optimizer, mesh,
                                    deterministic=True, timed=True)
    s, _, per = stage.pipe_stage
    rng = np.random.default_rng(seed)
    generator = torch.Generator(device="cuda").manual_seed(seed)
    noise = None if noise is None else [
        {k: v.to("cuda") for k, v in n.items()} for n in noise]
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    pgroup.staged_seconds = 0.0
    record = {"rank": world.rank, "device": str(mesh.device),
              "backend": world.backend,
              "coords": {a: mesh.coord(a) for a in mesh.shape},
              "metrics": [], "step_s": [], "staged_s": [], "timing": [],
              "param_digests": []}
    for step in range(steps):
        mbs = [{k: v.to("cuda") for k, v in shard_batch(synthetic_batch(
                    rng, rows, width, hp.vocab_size), mesh).items()}
               for _ in range(micro)]
        torch.cuda.synchronize()
        staged0, t0 = pgroup.staged_seconds, time.perf_counter()
        metrics = step_fn(mbs, step, noise if step == 0 else None,
                          generator)
        out = {k: float(v) for k, v in metrics.items()}
        torch.cuda.synchronize()
        record["step_s"].append(time.perf_counter() - t0)
        record["staged_s"].append(pgroup.staged_seconds - staged0)
        record["metrics"].append(out)
        record["timing"].append(step_fn.timing)
        record["param_digests"].append(param_digest(stage))
        if step == 0:
            record["grads"] = {pp.global_name(n, s, per):
                               p.grad.detach().float().cpu()
                               for n, p in stage.named_parameters()}
    record["launches"] = read_counts()
    record["local_digests"] = {pp.global_name(n, s, per): param_digest_of([p])
                               for n, p in stage.named_parameters()}
    record["max_memory_allocated"] = torch.cuda.max_memory_allocated()
    del model, stage, optimizer
    gc.collect()
    torch.cuda.empty_cache()
    return record


def pipe_pair_rank(world, kernel_args: tuple, plain_args: tuple) -> tuple:
    """One rank of a mesh-pipe run: its kernel run, then its fp32 plain
    run (one step)."""
    kernel = pipe_rank(world, *kernel_args)
    return kernel, pipe_rank(world, *plain_args)


def pipe_part(source, group, steps: int, seed: int, noise) -> tuple:
    rows, width = group
    args = (source, steps, rows, width, seed, PIPE_M, noise, True, None)
    return args, args[:1] + (1,) + args[2:7] + (False, torch.float32)


def stage_grads(records: list) -> dict:
    """The full model's gradients of a pipelined step: each stage's from
    its first rank, the shared leaves from rank 0."""
    out = {}
    for r in reversed(records):
        out.update(r["grads"])
    return out


def hold_pipe_part(name: str, smi: str, source, group, refs: dict, runs,
                   steps: int, dense: bool) -> dict:
    """A pipelined run held against the unsharded accumulated steps by
    `held_sharded`; each stage's launches (K1/K2 num_layers / 2 a
    micro-batch on every rank, on the dense route for the LM; K3/K3b once
    a micro-batch on the last stage, never on the first; the plain routes
    0); the shared parameters bitwise equal on every rank and each
    stage's on its data peers; each rank's idle seconds in the schedule
    beside the GPipe bubble (P - 1) / (M + P - 1)."""
    records, plain = runs
    layers = mesh_source_hparams(source).num_layers
    per = layers // 2
    stats = held_sharded(name, records[0]["metrics"][0]["loss"],
                         stage_grads(records), refs["a"], refs["c"],
                         plain[0]["metrics"][0]["loss"], stage_grads(plain),
                         MESH_REFERENCE_COS)
    fwd, bwd = (("swa_fwd_dense", "swa_bwd_dense") if dense
                else ("swa_fwd", "swa_bwd"))
    for r in records:
        n = PIPE_M * steps
        last = r["coords"]["pipe"] == 1
        check_counts(f"{name} rank {r['rank']}", r["launches"],
                     {fwd: per * n, bwd: per * n,
                      **({"tied_ce_fwd": n, "tied_ce_bwd": n} if last
                         else {})})
        check(len(set(r["param_digests"])) == steps,
              f"{name}: rank {r['rank']}'s parameters did not move")
    mesh_rank_counts(f"{name} fp32 plain", plain, {})
    for pname in records[0]["local_digests"]:
        holders = [r for r in records if pname in r["local_digests"]]
        staged = pname.startswith(("decoder_layers.", "z_projections."))
        check(len(holders) == (2 if staged else MESH)
              and len({r["local_digests"][pname] for r in holders}) == 1,
              f"{name}: {pname} differs across the ranks that hold it")
    bubble = 1 / (PIPE_M + 1)
    stats.update(
        mesh={"data": 2, "pipe": 2}, micro_batches=PIPE_M,
        group=[PIPE_M, *group], steps=steps,
        losses=[m["loss"] for m in records[0]["metrics"]],
        step_s_by_rank=[r["step_s"] for r in records],
        staged_s_by_rank=[r["staged_s"] for r in records],
        schedule_s_by_rank=[[t["schedule_s"] for t in r["timing"]]
                            for r in records],
        idle_s_by_rank=[[t["schedule_s"] - t["busy_s"] for t in r["timing"]]
                        for r in records],
        idle_share_by_rank=[[1 - t["busy_s"] / t["schedule_s"]
                             for t in r["timing"]] for r in records],
        gpipe_bubble=bubble,
        real_tokens_a_step=refs["a"]["real_tokens"],
        real_tokens_per_s_after_step_1=refs["a"]["real_tokens"] / max(
            sum(r["step_s"][1:] or r["step_s"])
            / len(r["step_s"][1:] or r["step_s"]) for r in records),
        unsharded_step_s=refs["a"]["seconds"],
        max_memory_allocated_by_rank=[r["max_memory_allocated"]
                                      for r in records],
        launches_by_rank=[r["launches"] for r in records], card=smi)
    return stats


def mesh_pipe_plan(smi: str) -> tuple:
    """The pipe axis (parallel/pp.py) over data 2 x pipe 2, two runs of
    `mesh_phases`' MESH ranks, each stage 3 of the 6 decoder layers (and the
    VAE's 3 z projections), the micro-batches of accumulation the
    pipeline's (PIPE_M = 4):
    - r5's trained weights on M micro-batches of [4, 4096] ragged
      documents: step 1 held against the unsharded accumulated step on
      the same weights, documents and eps, then PIPE_STEPS - 1 more;
    - the r4 LM geometry (the JAX initialisation; 6 dense causal layers:
      the dense causal pair) on M of [4, 3584], 2 steps, step 1 held
      the same way.
    Each as `hold_pipe_part`, in bf16 through the kernels and in fp32
    through the plain versions."""
    lm_hp = run_hparams(LM_GEOMETRY)
    refs = {"r5": mesh_references(RUN, PIPE_R5, PIPE_M, PIPE_SEED),
            "lm": mesh_references(lm_hp, PIPE_LM, PIPE_M, PIPE_SEED)}
    parts = [pipe_part(RUN, PIPE_R5, PIPE_STEPS, PIPE_SEED,
                       refs["r5"]["noise"]),
             pipe_part(lm_hp, PIPE_LM, 2, PIPE_SEED, None)]

    def finish(got):
        stats = {}
        for name, source, group, steps, dense, part in (
                ("r5", RUN, PIPE_R5, PIPE_STEPS, False, got[0]),
                ("lm", lm_hp, PIPE_LM, 2, True, got[1])):
            records, plain, seconds = pair_runs(part)
            stats[name] = hold_pipe_part(f"mesh-pipe {name}", smi, source,
                                         group, refs[name], (records, plain),
                                         steps, dense)
            stats[name]["ranks_s"] = seconds
        print("mesh-pipe " + json.dumps(stats), flush=True)
        return stats

    return "mesh-pipe", [(f"mesh-pipe {name}", pipe_pair_rank, part)
                         for name, part in zip(("r5", "lm"), parts)], finish


def mesh_phases(smi: str, log_root: Path) -> dict:
    """The phases of several ranks (11 and 37-43): each phase's unsharded
    references here first ("mesh-references"), then ONE spawn of MESH
    ranks on this card (gloo: they share it) that runs every phase's
    sharded runs in turn ("mesh-ranks", `run_parts`: rank 0 prints each
    run's seconds; one spawn pays the ranks' start, imports and CUDA
    set-up once), then each phase's checks and its JSON line, timed as
    the phase. Returns {phase: stats}; the fits' phase gives mesh-fit's
    and seq-fit's."""
    with Phase("mesh-references"):
        sp_plan, r5_seq_refs = sp_train_plan()
        moe_refs = mesh_moe_references()
        plans = [sp_plan, mesh_tp_plan(smi),
                 mesh_moe_plan("mesh-ep", smi, 1, 2, moe_refs),
                 mesh_moe_plan("mesh-moe-tp", smi, 2, 1, moe_refs),
                 mesh_seq_plan(smi, r5_seq_refs),
                 mesh_fit_plan(smi, log_root),
                 mesh_pipe_plan(smi)]
        del moe_refs, r5_seq_refs
    parts = [part for _, plan_parts, _ in plans for part in plan_parts]
    gc.collect()
    torch.cuda.empty_cache()
    with Phase("mesh-ranks"):
        ranks = spawn(run_parts, MESH, "cuda", (parts,), timeout=1100)
    out, i = {}, 0
    for name, plan_parts, finish in plans:
        got = [[rank[i + j] for rank in ranks]
               for j in range(len(plan_parts))]
        i += len(plan_parts)
        with Phase(name):
            out[name] = finish(got)
    return out


def check_counts(path: str, counts: dict, expect: dict):
    """expect: {counter: exact count, or None for at least one}; every
    other counter, the plain_routes ones included, must be 0."""
    for name, n in counts.items():
        want = expect.get(name, 0)
        ok = n > 0 if want is None else n == want
        check(ok, f"the {path} path gave {name} = {n}, expected "
              f"{'> 0' if want is None else want}")


# The numbers `--compare` sets side by side, by a JSON line's leaf key.
COMPARED_KEYS = ("step_s", "step_s_by_rank", "step_ms", "step_ms_all",
                 "wall_s", "seconds", "tokens_per_s", "new_tokens_per_s",
                 "real_tokens_per_s_after_step_1", "fit_s",
                 "max_memory_allocated_bytes")


def log_numbers(path) -> dict:
    """{phase: {key path: value}} of a chip_smoke log: each phase's
    seconds ("[name] done in X s") and the COMPARED_KEYS leaves of the
    JSON lines ("<tag> {...}") printed inside it, by tag and key path."""
    import re
    out, phase = {}, None

    def leaves(value, path):
        if isinstance(value, dict):
            for key, item in value.items():
                yield from leaves(item, f"{path}/{key}")
        elif path.rsplit("/", 1)[-1] in COMPARED_KEYS:
            yield path, value

    for line in Path(path).read_text().splitlines():
        mark = re.match(r"^\[([\w-]+)\] (?:start|done in ([\d.]+) s)$", line)
        if mark:
            phase = mark.group(1)
            if mark.group(2):
                out.setdefault(phase, {})["seconds"] = float(mark.group(2))
            continue
        tagged = re.match(r"^([\w-]+) (\{.*\})$", line)
        if tagged and phase is not None:
            try:
                record = json.loads(tagged.group(2))
            except ValueError:
                continue
            out.setdefault(phase, {}).update(
                leaves(record, tagged.group(1)))
    return out


def compare_logs(before, after) -> None:
    """Print log_numbers of two logs phase by phase: before | after."""
    a, b = log_numbers(before), log_numbers(after)

    def fmt(value):
        if isinstance(value, float):
            return f"{value:.6g}"
        if isinstance(value, list):
            return "[" + ", ".join(fmt(v) for v in value) + "]"
        return "-" if value is None else str(value)

    for phase in list(a) + [p for p in b if p not in a]:
        print(f"[{phase}]")
        keys = list(a.get(phase, {}))
        keys += [k for k in b.get(phase, {}) if k not in keys]
        for key in keys:
            print(f"  {key}: {fmt(a.get(phase, {}).get(key))} | "
                  f"{fmt(b.get(phase, {}).get(key))}")


PARENT_TIMEOUT_S = 900


def parent_runs(parent: str, mode: str, commands) -> list:
    """Each command of `commands` (the arguments after the Python
    executable) in another checkout (DIR: its own chip_smoke.py, package
    and build) and in this one, each in its own process, in the order
    parent, this, this, parent: [(run label, [stdout of each command])].
    Raises if a command fails."""
    runs = []
    for n, (who, root) in enumerate((("parent", parent), ("this", REPO),
                                     ("this", REPO), ("parent", parent))):
        outs = []
        for argv in commands:
            t0 = time.perf_counter()
            done = subprocess.run([sys.executable, *argv], cwd=root,
                                  capture_output=True, text=True,
                                  timeout=PARENT_TIMEOUT_S)
            print(f"{mode} run {n} ({who}, {root}) command "
                  f"{len(outs)}: exit {done.returncode}, "
                  f"{time.perf_counter() - t0:.1f} s", flush=True)
            if done.returncode != 0:
                print(done.stdout[-4000:] + done.stderr[-4000:], flush=True)
                raise AssertionError(f"{mode}: the {who} tree's command "
                                     f"{len(outs)} failed")
            outs.append(done.stdout)
        runs.append((f"{n} {who}", outs))
    return runs


def labelled_lines(stdout: str):
    """(label, JSON text) of each "label {...}" line of a run's output."""
    for line in stdout.splitlines():
        label, brace, rest = line.partition(" {")
        if brace:
            yield label, "{" + rest


# The numbers of a kernels-generic row that --generic-parent sets side by
# side.
GENERIC_COMPARED = ("ms", "device_ms", "parts_device_ms",
                    "dkv_parts_device_ms", "max_abs_err")


def generic_parent(parent: str) -> dict:
    """The kernels-generic phase in another checkout and in this one
    (`parent_runs`): every row the two trees share, with its times from
    each run, by the row's label."""
    code = ("import chip_smoke as cs; cs.device_phase(); cs.build_phase(); "
            "cs.generic_phase()")
    runs = {}
    for run, (stdout,) in parent_runs(parent, "--generic-parent",
                                      [["-c", code]]):
        for label, text in labelled_lines(stdout):
            if "ms" not in text:
                continue
            row = json.loads(text)
            runs.setdefault(label, []).append(
                {"run": run, **{key: row[key] for key in GENERIC_COMPARED
                                if key in row}})
    for label, rows in runs.items():
        print(f"generic-parent {label} " + json.dumps(rows), flush=True)
    return runs


# The dense route's shapes that --dense-parent times in both trees:
# DENSE_SHAPES at Dh 64 and the r4 geometry's heads at Dh 128.
# (The code names the shapes itself: the parent's script may have no
# DENSE_SHAPES.)
DENSE_PARENT_CODE = (
    "import chip_smoke as cs; cs.device_phase(); cs.build_phase(); "
    "[cs.dense_phase(b, h, L, lengths, seed=seed, iters=iters) "
    f"for b, h, L, lengths, seed, iters in {list(DENSE_SHAPES.values())}]; "
    "cs.dense_phase(14, 4, 3584, [3584] * 14, seed=84, iters=5, d=128)")
DENSE_COMPARED = ("ms", "device_ms", "parts_device_ms", "max_abs_err",
                  "library_ms", "bound_ms")
# The r4 LM's training step in each tree (profile_train's JSON line).
R4_STEP = ["-m", "sparse_vae_tpu_torch.profile_train",
           "geometry=real-prose-lm-r4", "batch=14", "seq=3584"]
R4_COMPARED = ("step_ms_median", "device_ms_per_step", "device_idle_share",
               "max_memory_allocated_bytes")


def dense_parent(parent: str) -> dict:
    """The dense route's shapes (this tree's `DENSE_PARENT_CODE`, run in
    each tree by its own chip_smoke.py, package and build: the parent's
    K1/K2 at a causal band, this tree's dense causal pair) and the r4
    LM's training step (profile_train) in another checkout and in this
    one (`parent_runs`): every shape's forward and backward times from
    each run, keyed by direction and shape, and each run's step."""
    runs, steps = {}, []
    for run, (shapes, step) in parent_runs(
            parent, "--dense-parent", [["-c", DENSE_PARENT_CODE], R4_STEP]):
        for label, text in labelled_lines(shapes):
            if not label.startswith(("K1 dense", "K2 dense", "dense fwd",
                                     "dense bwd")):
                continue
            row = json.loads(text)
            way = "fwd" if label.startswith(("K1", "dense fwd")) else "bwd"
            runs.setdefault(f"{way} {row['shape']}", []).append(
                {"run": run, **{k: row[k] for k in DENSE_COMPARED
                                if k in row}})
        result = json.loads(step.strip().splitlines()[-1])
        steps.append({"run": run, **{k: result[k] for k in R4_COMPARED},
                      "top_kernels": result["top_kernels"][:6]})
    for key, rows in runs.items():
        print(f"dense-parent {key} " + json.dumps(rows), flush=True)
    print("dense-parent r4-step " + json.dumps(steps), flush=True)
    return {"shapes": runs, "r4_step": steps}


def main(argv) -> int:
    if argv[:1] == ["--compare"] and len(argv) == 3:
        compare_logs(argv[1], argv[2])
        return 0
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    if argv[:1] == ["--generic-parent"] and len(argv) == 2:
        smi = device_phase()
        generic_parent(argv[1])
        print(json.dumps({"card": smi}), flush=True)
        return 0
    if argv[:1] == ["--dense-parent"] and len(argv) == 2:
        smi = device_phase()
        dense_parent(argv[1])
        print(json.dumps({"card": smi}), flush=True)
        return 0
    if argv and (len(argv) != 2 or argv[0] != "--k4-parent"):
        print("usage: chip_smoke.py [--k4-parent DIR] | --generic-parent "
              "DIR | --dense-parent DIR | --compare BEFORE AFTER",
              file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    with Phase("device"):
        smi = device_phase()
    with Phase("build"):
        build_phase()
        parent = ParentK4(argv[1]) if argv else None
    with Phase("kernels"):
        k1_serve = k1_phase(1, 512, [417], seed=1, iters=200)
        k1_long = k1_phase(4, 4096, [4096, 3001, 1500, 129], seed=2,
                           iters=50)
        # K4 at the serving batch (a row over a cluster of two CTAs), at a
        # 512-token Jacobi window's rows (one CTA a row), its two
        # instantiations against each other, then correctness alone at one
        # row, past the SM count and at a V that is no power of two.
        k4_rows = [k4_phase(t, seed=3 + i, iters=200, parent=parent)
                   for i, t in enumerate((1.0, 0.7))]
        k4_wide = k4_phase(1.0, seed=9, iters=50, n=512, parent=parent)
        k4_mass = k4_phase(1.0, seed=10, iters=50, n=SAMPLE_BATCH,
                           parent=parent)
        # The fused frontier's rows at DECODE_ROWS windows of
        # DECODE_WINDOW.
        k4_frontier = k4_phase(1.0, seed=11, iters=20,
                               n=DECODE_ROWS * DECODE_WINDOW, parent=parent)
        k4_split = k4_instantiations(seed=12, iters=50)
        k4_checks = [
            k4_phase(1.0, seed=30 + 3 * i + j, iters=0, n=n, vocab=v,
                     top_p=top_p, with_noise=with_noise)
            for i, (n, v) in enumerate(((1, 512), (133, 32768), (3, 50000)))
            for j, (with_noise, top_p) in enumerate(
                ((True, 0.9), (False, 0.9), (True, 1e-3)))]
        k1_train = k1_phase(8, 12800, TRAIN_LENGTHS, seed=8, iters=5)
        k2_phase(1, 512, [417], seed=4, iters=0)
        k2_phase(4, 4096, [4096, 3001, 1500, 129], seed=5, iters=0)
        k2_train = k2_phase(8, 12800, TRAIN_LENGTHS, seed=6, iters=5,
                            time_it=True)
        k3, k3b = k3_phase(seed=7)
    with Phase("lm-kernels"):
        lm_k = lm_kernels_phase()
    with Phase("model"):
        model, _, _ = load_run(RUN, device="cuda")
        model_phase(model)
    vocab = model.hparams.vocab_size
    requests = make_requests(
        vocab, prompt_lengths=[0, 127, 0, 200, 300, 0, 416, 150, 0, 255, 0,
                               180],
        max_tokens=[256, 128, 192, 160, 96, 64, 64, 256, 128, 200, 96, 160],
        seed=7)
    with Phase("serve"):
        stats = serve_phase(model, requests, before_traffic=reset_counts)
        counts = read_counts()
        check_counts("serve", counts, {"swa_fwd": None,
                                       "nucleus_select": None})
        print("serve " + json.dumps({**stats, "launches": counts,
                                     "card": smi}), flush=True)
        del model
    with Phase("train"):
        train_counts = train_phase(
            lambda kernels, dtype: build_training(
                RUN, "cuda", 1, use_kernels=kernels, dtype=dtype)[:3],
            {"swa_fwd": 6, "swa_bwd": 6, "tied_ce_fwd": 1,
             "tied_ce_bwd": 1})["launches"]
    with Phase("remat"):
        remat = remat_phase(smi)
    with Phase("kernels-h4"):
        k5_serve, k5b_serve = k5_phase(1, 512, [417], seed=12, iters=200)
        k5_long, k5b_long = k5_phase(4, 4096, [4096, 3001, 1500, 129],
                                     seed=13, iters=50)
        k5_train, k5b_train = k5_phase(8, 12800, TRAIN_LENGTHS, seed=14,
                                       iters=5)
    with Phase("model-h4"):
        model = bench_model()
        model_bench_phase(model)
    with Phase("serve-h4"):
        stats = serve_phase(model, requests, before_traffic=reset_counts)
        h4_counts = read_counts()
        check_counts("serve-h4", h4_counts, {"swa_fwd_packed": None,
                                             "nucleus_select": None})
        print("serve-h4 " + json.dumps({**stats, "launches": h4_counts,
                                        "card": smi}), flush=True)
        del model
    with Phase("train-h4"):
        h4_train_counts = train_phase(
            lambda kernels, dtype: bench_model(kernels, dtype, train=True),
            {"swa_fwd_packed": 6, "swa_bwd_packed": 6, "tied_ce_fwd": 1,
             "tied_ce_bwd": 1}, name="train-h4")["launches"]
    with Phase("kernels-generic"):
        generic = generic_phase()
    with Phase("kernels-hm128"):
        hm128 = hm128_phase()
    with Phase("model-h2"):
        model = bench_model(heads=2)
        model_bench_phase(model, heads=2)
    with Phase("serve-h2"):
        stats = serve_phase(model, requests, before_traffic=reset_counts)
        h2_counts = read_counts()
        check_counts("serve-h2", h2_counts, {"swa_fwd_generic": None,
                                             "nucleus_select": None})
        print("serve-h2 " + json.dumps({**stats, "launches": h2_counts,
                                        "card": smi}), flush=True)
        del model
    with Phase("train-h2"):
        h2_train_counts = train_phase(
            lambda kernels, dtype: bench_model(kernels, dtype, train=True,
                                            heads=2),
            {"swa_fwd_generic": 6, "swa_bwd_generic": 6, "tied_ce_fwd": 1,
             "tied_ce_bwd": 1}, name="train-h2")["launches"]
    shard = SP_SEQ // SP
    with Phase("kernels-sp"):
        k6 = k6_phase(1, shard, shard, [shard + 128], [128], 2, seed=15,
                      time_it=True)
        k6_square = k6_phase(1, shard, 0, [shard], [128], 2, seed=16,
                             time_it=True)
        k6_phase(4, 4096, 8192, [4224, 3000, 129, 0], [128, 77, 128, 0], 2,
                 seed=17)
        k6_phase(4, 4096, 0, [4096, 2000, 1, 0], [128, 128, 128, 0], 2,
                 seed=18)
        for window, seed in ((1, 19), (3, 20)):
            k6_phase(1, 1024, 1024, [(window - 1) * 128 + 1024], [128],
                     window, seed=seed, h=2)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_fit_") as tmp:
        fit_logs = Path(tmp) / "sparse-vae-logs"
        with Phase("fit"):
            fit_counts = fit_r5_phase(smi, log_root=fit_logs)["launches"]
        with Phase("fit-pg19"):
            pg19_counts = fit_pg19_phase(smi)["launches"]
        with Phase("eval"):
            eval_counts = eval_phase(RUN, EVAL_LENGTHS, EVAL_SAMPLES,
                                     EVAL_ITERS, smi, "eval",
                                     default_lengths=TRAIN_LENGTHS
                                     )["launches"]
        with Phase("eval-pg19"):
            eval_pg19_counts = eval_phase(
                PG19_RUN, PG19_EVAL_LENGTHS, PG19_EVAL_SAMPLES,
                PG19_EVAL_ITERS, smi, "eval-pg19")["launches"]
        with Phase("dreg"):
            dreg_counts = dreg_phase(smi)["launches"]
        with Phase("test-entry"):
            test_counts = test_entry_phase(smi, fit_logs)["launches"]
    with Phase("lm-serve"):
        lm_serve_counts = lm_serve_phase(smi)["launches"]
    with Phase("lm-train"):
        lm_train = lm_train_phase(smi)
    lm_train_counts = {name: sum(lm_train[run]["launches"][name]
                                 for run in (LM_RUN, LM_GEOMETRY))
                       for name in lm_serve_counts}
    with Phase("lm-options"):
        lm_options = lm_options_phase(smi)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_lm_") as tmp:
        lm_logs = Path(tmp) / "sparse-vae-logs"
        with Phase("lm-fit"):
            lm_fit_counts = lm_fit_phase(smi, lm_logs)["launches"]
        with Phase("lm-test-entry"):
            lm_test_counts = lm_test_entry_phase(smi, lm_logs)["launches"]
    with Phase("sample"):
        sample_stats = sampling_phase(smi, "sample", "transformer-vae", RUN,
                                      SAMPLE_BATCH, SAMPLE_DOCS,
                                      profiled=True)
    with Phase("sample-lm"):
        lm_sample_stats = sampling_phase(smi, "sample-lm", "transformer-lm",
                                         LM_RUN, LM_SAMPLE_BATCH,
                                         LM_SAMPLE_DOCS, profiled=False)
        lm_callback_counts = lm_callback_phase(smi)["launches"]
    with Phase("sample-long"):
        long_stats = sample_long_phase(smi)
    with Phase("decode-r5"):
        decode_r5 = decode_r5_phase(smi)
    with Phase("decode-spec"):
        decode_spec = decode_spec_phase(smi, decode_r5["ar_tokens"],
                                        decode_r5["z"])
    with Phase("decode-lm"):
        decode_lm = decode_lm_phase(smi)
    with Phase("lstm-ops"):
        lstm_ops = lstm_ops_phase(smi)
    with Phase("lstm-train"):
        lstm_train = lstm_train_phase(smi)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_lstm_") as tmp:
        with Phase("lstm-fit"):
            lstm_fit = lstm_fit_phase(smi, Path(tmp) / "sparse-vae-logs")
        with Phase("lstm-sample"):
            lstm_sample = lstm_sample_phase(smi, lstm_fit["archives"])
    with Phase("latent"):
        latent = latent_phase(smi)
    with Phase("moe-train"):
        moe_train = moe_train_phase(smi)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_moe_") as tmp:
        with Phase("moe-fit"):
            moe_fit = moe_fit_phase(smi, Path(tmp) / "sparse-vae-logs",
                                    depth=MOE_FIT_DEPTH)
    with Phase("moe-serve"):
        moe_serve = moe_serve_phase(smi)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_mesh_") as tmp:
        meshes = mesh_phases(smi, Path(tmp))
    sp_stats = meshes["sp-train"]
    sp_counts = sp_stats["launches_by_rank"]
    sp_single = sp_stats["unsharded"]["launches"]
    mesh_tp, mesh_ep, mesh_moe_tp = (meshes[n] for n in (
        "mesh-tp", "mesh-ep", "mesh-moe-tp"))
    mesh_seq, mesh_pipe = meshes["mesh-seq"], meshes["mesh-pipe"]
    mesh_fit, seq_fit = meshes["seq-fit"]
    lstm_counts = {"lstm-ops": lstm_ops["launches"],
                   "lstm-train": lstm_train["launches"],
                   "lstm-fit": lstm_fit["launches"],
                   "lstm-sample": lstm_sample["launches"]}
    sample_counts = {
        "sample": sample_stats["lockstep"]["launches"],
        "sample-continuous": sample_stats["continuous"]["launches"],
        "sample-lm": lm_sample_stats["lockstep"]["launches"],
        "sample-lm-continuous": lm_sample_stats["continuous"]["launches"],
        "lm-callback": lm_callback_counts,
        "sample-long": long_stats["launches"]}

    def sp_sum(name):
        return sp_single[name] + sum(c[name] for c in sp_counts)

    def mesh_sum(stats, name):
        """A mesh phase's launches of one kernel, summed over its ranks."""
        return sum(c[name] for c in stats["launches_by_rank"])

    def mesh_paths(name):
        return {path: mesh_sum(stats, name) for path, stats in (
            ("mesh-tp", mesh_tp), ("mesh-ep", mesh_ep),
            ("mesh-moe-tp", mesh_moe_tp), ("mesh-fit", mesh_fit),
            *((f"mesh-seq {part}", st) for part, st in mesh_seq.items()
              if isinstance(st, dict) and "launches_by_rank" in st),
            ("seq-fit", seq_fit),
            *((f"mesh-pipe {part}", st) for part, st in mesh_pipe.items()))}

    def fit_paths(name):
        """The launches of the trainer-loop and evaluation paths."""
        return {"fit": fit_counts[name], "fit-pg19": pg19_counts[name],
                "eval": eval_counts[name], "eval-pg19": eval_pg19_counts[name],
                "dreg": dreg_counts[name], "test-entry": test_counts[name]}

    def lm_paths(name):
        """The launches of the Transformer LM's paths, the MoE LM's
        included."""
        return {"lm-serve": lm_serve_counts[name],
                "lm-train": lm_train_counts[name],
                "lm-fit": lm_fit_counts[name],
                "lm-test-entry": lm_test_counts[name],
                "lm-callback": lm_callback_counts[name],
                "decode-lm": decode_lm["launches"][name],
                **{path: stats["launches"][name] for path, stats in (
                    ("moe-train", moe_train), ("moe-fit", moe_fit),
                    ("moe-serve", moe_serve))},
                **mesh_paths(name)}

    def decode_paths(name):
        """The launches of the parallel and speculative decoding paths, of
        the LSTM family's (none launches a kernel) and of the latent
        tooling's."""
        return {**{path: stats["launches"][name] for path, stats in (
            ("decode-r5", decode_r5), ("decode-spec", decode_spec),
            ("decode-lm", decode_lm), ("latent", latent))},
            **{path: c[name] for path, c in lstm_counts.items()}}

    def remat_paths(name):
        """The remat phase's launches (step 1 of each of its runs) and
        the lm-options phase's (its 3 steps and the generic Transformer's
        forward)."""
        return {"remat": sum(r["launches_per_step"][name]
                             for r in remat["runs"]),
                "lm-options": lm_options["launches"][name]
                + lm_options["transformer"]["launches"][name]}

    def lm_row(name, counter, source, replaces, row, extra):
        by_path = lm_paths(counter)
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": sum(by_path.values()),
                "launches_by_path": by_path,
                **{k: row[k] for k in ("max_abs_err", "ms", "device_ms",
                                       "plain_ms", "bound_ms", "bound_by",
                                       "library_ms", "shape")},
                **extra}

    def causal_row(name, counter, source, half):
        """The dense causal pair's row: its launches on every path that
        runs the dense route (the LM family's, the remat and lm-options
        phases', the dense Dh 128 layer's), timed at the r4 geometry's
        full rows, with the ragged, serving and Dh 128 shapes beside."""
        by_path = {**lm_paths(counter), **remat_paths(counter),
                   "hm128-layers": hm128["layers"]["launches"][counter]}
        row = lm_k[f"{half}_full"]
        keys = ("shape", "max_abs_err", "ms", "device_ms", "plain_ms",
                "bound_ms", "bound_by", "library_ms")
        return {"name": name, "route": "cuda", "source": source,
                "replaces": "sparse_vae_tpu/ops/attention.py:472",
                "replaces_note": "the JAX library's Pallas flash_attention "
                                 "(causal), called there",
                "wrapper": "sparse_vae_tpu_torch/ops/causal_kernel.py (the "
                           "dense causal route of ops/attention.py at "
                           "head-major Dh 64 and 128)",
                "launches": sum(by_path.values()),
                "launches_by_path": by_path,
                **{k: row[k] for k in keys},
                "library": row["library"],
                **({"parts_device_ms": row["parts_device_ms"]}
                   if half == "bwd" else {}),
                "shapes": {
                    "ragged": {k: lm_k[f"{half}_ragged"][k] for k in keys},
                    "serve": {k: lm_k[f"{half}_serve"][k] for k in keys},
                    "dh128": {k: hm128["dense"][half == "bwd"][k]
                              for k in keys}}}

    def timed(row):
        return {k: row[k] for k in ("max_abs_err", "ms", "plain_ms",
                                    "bound_ms", "bound_by", "library_ms",
                                    "shape")}

    def smaller(*rows):
        return [{k: r[k] for k in ("shape", "lengths", "max_abs_err", "ms",
                                   "device_ms", "plain_ms", "bound_ms",
                                   "library_ms")}
                for r in rows]

    def brief(row, prefix=""):
        """A timed row's shape, error, times and bound (a K6 row's
        backward under its bwd_ keys)."""
        keys = ("max_abs_err", "ms", "device_ms", "plain_ms", "bound_ms",
                "bound_by", "library_ms")
        return {**{k: row[k] for k in ("shape", "layout", "head_dim",
                                       "block", "causal", "lengths")
                   if k in row},
                **{k: row[prefix + k] for k in keys}}

    def generic_shapes(half: int):
        """Every kernels-generic shape's forward (half 0) or backward
        (half 1) row."""
        out = {}
        for tag, rows in generic.items():
            if tag == "k6_dh256":
                out[tag] = brief(rows, "bwd_" if half else "")
            else:
                out[tag] = brief(rows[half])
        return out

    k4_paths = {"serve": counts["nucleus_select"],
                "serve-h4": h4_counts["nucleus_select"],
                "serve-h2": h2_counts["nucleus_select"],
                "lm-serve": lm_serve_counts["nucleus_select"],
                "moe-serve": moe_serve["launches"]["nucleus_select"],
                **{path: c["nucleus_select"]
                   for path, c in sample_counts.items()},
                **decode_paths("nucleus_select")}
    kernels = [
        {"name": "swa_fwd", "route": "cuda",
         "source": "sparse_vae_tpu_torch/csrc/swa_fwd.cu",
         "replaces": "sparse_vae_tpu/ops/pallas_kernels.py:152",
         "launches": counts["swa_fwd"] + train_counts["swa_fwd"]
         + sp_sum("swa_fwd") + sum(fit_paths("swa_fwd").values())
         + sum(decode_paths("swa_fwd").values())
         + sum(mesh_paths("swa_fwd").values())
         + sum(remat_paths("swa_fwd").values()),
         "launches_by_path": {"serve": counts["swa_fwd"],
                              "train": train_counts["swa_fwd"],
                              **remat_paths("swa_fwd"),
                              "sp-train": sp_sum("swa_fwd"),
                              **fit_paths("swa_fwd"),
                              **decode_paths("swa_fwd"),
                              **mesh_paths("swa_fwd")},
         **{k: k1_serve[k] for k in ("max_abs_err", "ms", "device_ms",
                                     "plain_ms", "bound_ms", "bound_by",
                                     "library_ms")},
         "shape": k1_serve["shape"],
         "long": {k: k1_long[k] for k in ("shape", "max_abs_err", "ms",
                                          "device_ms", "plain_ms",
                                          "bound_ms", "library_ms")},
         "train": {k: k1_train[k] for k in ("shape", "max_abs_err", "ms",
                                            "device_ms", "plain_ms",
                                            "bound_ms", "bound_by",
                                            "library_ms")}},
        {"name": "nucleus_select", "route": "cuda",
         "source": "sparse_vae_tpu_torch/csrc/nucleus_select.cu",
         "replaces": "sparse_vae_tpu/ops/pallas_select.py:128",
         "launches": sum(k4_paths.values()),
         "launches_by_path": k4_paths,
         **{k: k4_rows[0][k] for k in ("max_abs_err", "ms", "device_ms",
                                       "plain_ms", "bound_ms", "bound_by",
                                       "library_ms")},
         "shape": k4_rows[0]["shape"],
         "ulp_flip_rows": sum(r["ulp_flip_rows"] for r in (
             *k4_rows, k4_wide, k4_mass, k4_frontier, *k4_checks)),
         "bit_identical": all(r["bit_identical"] for r in (
             *k4_rows, k4_wide, k4_mass, k4_frontier, *k4_checks)),
         "temperature_0.7": {k: k4_rows[1][k] for k in (
             "max_abs_err", "ms", "device_ms", "plain_ms")},
         "rows_512": {k: k4_wide[k] for k in (
             "shape", "max_abs_err", "ms", "device_ms", "plain_ms",
             "bound_ms", "bound_by", "library_ms")},
         "rows_1000": {k: k4_mass[k] for k in (
             "shape", "max_abs_err", "ms", "device_ms", "plain_ms",
             "bound_ms", "bound_by", "library_ms")},
         f"rows_{DECODE_ROWS * DECODE_WINDOW}": {k: k4_frontier[k] for k in (
             "shape", "max_abs_err", "ms", "device_ms", "plain_ms",
             "bound_ms", "bound_by", "library_ms")},
         "r5_logits_1000": sample_stats["k4_on_logits"],
         "sampled_steps_held": {
             "sample": sample_stats["k4_held"],
             "sample-lm": lm_sample_stats["k4_held"],
             **{f"decode-r5 {k}": v
                for k, v in decode_r5["k4_held"].items()},
             "decode-lm": decode_lm["sampled_fused"]["k4_held"],
             "latent": latent["reconstruct"]["k4_held"]},
         "parent": None if parent is None else {
             name: {k: r[k] for k in ("parent_ms", "parent_device_ms",
                                      "pccp")}
             for name, r in (("t1.0", k4_rows[0]), ("t0.7", k4_rows[1]),
                             ("rows_512", k4_wide),
                             ("rows_1000", k4_mass),
                             (f"rows_{DECODE_ROWS * DECODE_WINDOW}",
                              k4_frontier))},
         "checks": [{k: r[k] for k in ("shape", "noise", "top_p",
                                       "ulp_flip_rows")}
                    for r in k4_checks],
         "instantiations": k4_split},
        {"name": "swa_bwd", "route": "cuda",
         "source": "sparse_vae_tpu_torch/csrc/swa_bwd.cu",
         "replaces": "sparse_vae_tpu/ops/pallas_kernels.py:337",
         "launches": train_counts["swa_bwd"] + sp_sum("swa_bwd")
         + sum(fit_paths("swa_bwd").values())
         + sum(mesh_paths("swa_bwd").values())
         + sum(remat_paths("swa_bwd").values()),
         "launches_by_path": {"train": train_counts["swa_bwd"],
                              **remat_paths("swa_bwd"),
                              "sp-train": sp_sum("swa_bwd"),
                              **fit_paths("swa_bwd"),
                              **mesh_paths("swa_bwd")},
         **timed(k2_train), **{k: k2_train[k] for k in (
             "device_ms", "parts_device_ms", "bit_identical")}},
        {"name": "tied_ce_fwd", "route": "cuda",
         "source": "sparse_vae_tpu_torch/csrc/tied_ce.cu",
         "replaces": "sparse_vae_tpu/ops/pallas_ce.py:143",
         "launches": train_counts["tied_ce_fwd"]
         + h4_train_counts["tied_ce_fwd"] + h2_train_counts["tied_ce_fwd"]
         + sp_sum("tied_ce_fwd")
         + sum(fit_paths("tied_ce_fwd").values())
         + sum(lm_paths("tied_ce_fwd").values())
         + sum(remat_paths("tied_ce_fwd").values()),
         "launches_by_path": {"train": train_counts["tied_ce_fwd"],
                              **remat_paths("tied_ce_fwd"),
                              "train-h4": h4_train_counts["tied_ce_fwd"],
                              "train-h2": h2_train_counts["tied_ce_fwd"],
                              "sp-train": sp_sum("tied_ce_fwd"),
                              **fit_paths("tied_ce_fwd"),
                              **lm_paths("tied_ce_fwd")},
         "instantiation": "D = 512",
         **timed(k3), **{k: k3[k] for k in (
             "device_ms", "bit_identical", "vocab_splits")}},
        {"name": "tied_ce_bwd", "route": "cuda",
         "source": "sparse_vae_tpu_torch/csrc/tied_ce_bwd.cu",
         "replaces": "sparse_vae_tpu/ops/pallas_ce.py:177",
         "launches": train_counts["tied_ce_bwd"]
         + h4_train_counts["tied_ce_bwd"] + h2_train_counts["tied_ce_bwd"]
         + sp_sum("tied_ce_bwd")
         + sum(fit_paths("tied_ce_bwd").values())
         + sum(lm_paths("tied_ce_bwd").values())
         + sum(remat_paths("tied_ce_bwd").values()),
         "launches_by_path": {"train": train_counts["tied_ce_bwd"],
                              **remat_paths("tied_ce_bwd"),
                              "train-h4": h4_train_counts["tied_ce_bwd"],
                              "train-h2": h2_train_counts["tied_ce_bwd"],
                              "sp-train": sp_sum("tied_ce_bwd"),
                              **fit_paths("tied_ce_bwd"),
                              **lm_paths("tied_ce_bwd")},
         "instantiation": "D = 512",
         **timed(k3b), **{k: k3b[k] for k in (
             "device_ms", "parts_device_ms", "chunk_tokens",
             "bit_identical", "checks")}},
        {"name": "swa_fwd_packed", "route": "cuda",
         "source": "sparse_vae_tpu_torch/csrc/swa_fwd.cu",
         "replaces": "sparse_vae_tpu/ops/pallas_kernels.py:590",
         "launches": h4_counts["swa_fwd_packed"]
         + h4_train_counts["swa_fwd_packed"],
         "launches_by_path": {
             "serve-h4": h4_counts["swa_fwd_packed"],
             "train-h4": h4_train_counts["swa_fwd_packed"]},
         **timed(k5_train), "device_ms": k5_train["device_ms"],
         "smaller": smaller(k5_serve, k5_long)},
        {"name": "swa_bwd_packed", "route": "cuda",
         "source": "sparse_vae_tpu_torch/csrc/swa_bwd.cu",
         "replaces": "sparse_vae_tpu/ops/pallas_kernels.py:788",
         "launches": h4_train_counts["swa_bwd_packed"],
         "launches_by_path": {
             "train-h4": h4_train_counts["swa_bwd_packed"]},
         **timed(k5b_train), **{k: k5b_train[k] for k in (
             "device_ms", "parts_device_ms", "bit_identical")},
         "smaller": smaller(k5b_serve, k5b_long)},
        {"name": "sp_windowed_attention", "route": "cuda",
         "source": "sparse_vae_tpu_torch/csrc/swa_fwd.cu",
         "wrapper": "sparse_vae_tpu_torch/ops/sp_kernel.py",
         "replaces": "sparse_vae_tpu/ops/pallas_kernels.py:1031",
         "launches": sp_sum("sp_windowed_attention")
         + sum(mesh_paths("sp_windowed_attention").values()),
         "launches_by_rank": {"sp-train": [
             c["sp_windowed_attention"] for c in sp_counts]},
         "launches_by_path": {"sp-train": sp_sum("sp_windowed_attention"),
                              **mesh_paths("sp_windowed_attention")},
         **timed(k6), "device_ms": k6["device_ms"],
         "k1_device_ms": k6["k1_device_ms"],
         "square": {k: k6_square[k] for k in (
             "shape", "max_abs_err", "ms", "device_ms", "k1_device_ms",
             "plain_ms", "bound_ms", "bound_by", "library_ms")}},
        {"name": "sp_windowed_attention_bwd", "route": "cuda",
         "source": "sparse_vae_tpu_torch/csrc/swa_bwd.cu",
         "wrapper": "sparse_vae_tpu_torch/ops/sp_kernel.py",
         "replaces": "sparse_vae_tpu/ops/pallas_kernels.py:1057",
         "launches": sp_sum("sp_windowed_attention_bwd")
         + sum(mesh_paths("sp_windowed_attention_bwd").values()),
         "launches_by_rank": {"sp-train": [
             c["sp_windowed_attention_bwd"] for c in sp_counts]},
         "launches_by_path": {
             "sp-train": sp_sum("sp_windowed_attention_bwd"),
             **mesh_paths("sp_windowed_attention_bwd")},
         "shape": k6["shape"], "max_abs_err": k6["bwd_max_abs_err"],
         "ms": k6["bwd_ms"], "device_ms": k6["bwd_device_ms"],
         "k2_device_ms": k6["bwd_k2_device_ms"],
         "parts_device_ms": k6["bwd_parts_device_ms"],
         "bit_identical": k6["bwd_bit_identical"],
         "plain_ms": k6["bwd_plain_ms"],
         "bound_ms": k6["bwd_bound_ms"], "bound_by": k6["bwd_bound_by"],
         "library_ms": k6["bwd_library_ms"],
         "square": {"shape": k6_square["shape"],
                    "max_abs_err": k6_square["bwd_max_abs_err"],
                    "ms": k6_square["bwd_ms"],
                    "device_ms": k6_square["bwd_device_ms"],
                    "k2_device_ms": k6_square["bwd_k2_device_ms"],
                    "plain_ms": k6_square["bwd_plain_ms"],
                    "bound_ms": k6_square["bwd_bound_ms"],
                    "bound_by": k6_square["bwd_bound_by"],
                    "library_ms": k6_square["bwd_library_ms"]}},
        {"name": "swa_fwd_generic", "route": "cuda",
         "source": "sparse_vae_tpu_torch/csrc/swa_generic.cu",
         "replaces": "sparse_vae_tpu/ops/pallas_kernels.py:590",
         "also_replaces": ["sparse_vae_tpu/ops/pallas_kernels.py:152",
                           "sparse_vae_tpu/ops/pallas_kernels.py:1031"],
         "instantiation": "packed Dh 256 on the path; Dh % 8 == 0 up to "
                          "512 and blocks that are multiples of 128",
         "launches": h2_counts["swa_fwd_generic"]
         + h2_train_counts["swa_fwd_generic"],
         "launches_by_path": {
             "serve-h2": h2_counts["swa_fwd_generic"],
             "train-h2": h2_train_counts["swa_fwd_generic"]},
         **brief(generic["h2_train"][0]),
         "shapes": generic_shapes(0)},
        {"name": "swa_bwd_generic", "route": "cuda",
         "source": "sparse_vae_tpu_torch/csrc/swa_generic.cu",
         "replaces": "sparse_vae_tpu/ops/pallas_kernels.py:788",
         "also_replaces": ["sparse_vae_tpu/ops/pallas_kernels.py:337",
                           "sparse_vae_tpu/ops/pallas_kernels.py:1057"],
         "launches": h2_train_counts["swa_bwd_generic"],
         "launches_by_path": {
             "train-h2": h2_train_counts["swa_bwd_generic"]},
         **brief(generic["h2_train"][1]),
         "parts_device_ms": generic["h2_train"][1]["parts_device_ms"],
         "dkv_parts_device_ms":
             generic["h2_train"][1]["dkv_parts_device_ms"],
         "shapes": generic_shapes(1)},
        {"name": "swa_fwd_hm128", "route": "cuda",
         "source": "sparse_vae_tpu_torch/csrc/swa_fwd.cu",
         "replaces": "sparse_vae_tpu/ops/pallas_kernels.py:152",
         "instantiation": "head-major Dh 128 (swa_fwd_kernel<128, false, "
                          "*>)",
         "launches": hm128["layers"]["launches"]["swa_fwd_hm128"],
         "launches_by_path": {
             "hm128-layers": hm128["layers"]["launches"]["swa_fwd_hm128"]},
         **brief(hm128["train"][0]),
         "shapes": {"k6": brief(hm128["k6"])}},
        {"name": "swa_bwd_hm128", "route": "cuda",
         "source": "sparse_vae_tpu_torch/csrc/swa_bwd.cu",
         "replaces": "sparse_vae_tpu/ops/pallas_kernels.py:337",
         "instantiation": "head-major Dh 128",
         "launches": hm128["layers"]["launches"]["swa_bwd_hm128"],
         "launches_by_path": {
             "hm128-layers": hm128["layers"]["launches"]["swa_bwd_hm128"]},
         **brief(hm128["train"][1]),
         "parts_device_ms": hm128["train"][1]["parts_device_ms"],
         "shapes": {"k6": brief(hm128["k6"], "bwd_")}},
        causal_row("causal_fwd", "swa_fwd_dense",
                   "sparse_vae_tpu_torch/csrc/causal_fwd.cu", "fwd"),
        causal_row("causal_bwd", "swa_bwd_dense",
                   "sparse_vae_tpu_torch/csrc/causal_bwd.cu", "bwd"),
        lm_row("tied_ce_fwd", "tied_ce_fwd_d256",
               "sparse_vae_tpu_torch/csrc/tied_ce.cu",
               "sparse_vae_tpu/ops/pallas_ce.py:143", lm_k["k3"], {
                   "instantiation": "D = 256",
                   "vocab_splits": lm_k["k3"]["vocab_splits"]}),
        lm_row("tied_ce_bwd", "tied_ce_bwd_d256",
               "sparse_vae_tpu_torch/csrc/tied_ce_bwd.cu",
               "sparse_vae_tpu/ops/pallas_ce.py:177", lm_k["k3b"], {
                   "instantiation": "D = 256",
                   "parts_device_ms": lm_k["k3b"]["parts_device_ms"],
                   "checks": lm_k["k3b"]["checks"]}),
    ]
    print(f"total {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
