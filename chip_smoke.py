#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py
    python3 chip_smoke.py --cards 4    # the four-card run of the parallel layer alone

Run from the root of a checkout on a machine with a CUDA card and
``nvcc``. It imports nothing of JAX. Phases, each of which exits non-zero
on failure:

1. device: requires CUDA, prints the card's name and power limit, turns
   TF32 off for matmuls and convolutions;
2. build: compiles the five CUDA sources from ``csrc/``, one
   nvcc each, started together (always anew: an earlier run's libraries
   are removed first), and prints ptxas' registers and spills; each scan
   kernel's instances (fp32, bf16) with their registers, spills, shared
   memory a block and the ``SHFL`` and ``MUFU`` instructions in their SASS;
3. kernel against plain: ``selective_scan_fwd`` against the plain loop on
   the card at the medmamba stage shapes (batch 2) and two ragged ones
   (DG 24, below a block's 64 channels, and DG 80, above them and not a
   multiple), fp32 and bf16, softplus on and off; gate:
   max|y_k - y_p| / max|y_p| <= 5e-4, and the same gate on the chunk-entry
   states ``hck`` the forward writes for training; a second run of the
   kernel must give y and ``hck`` bit for bit. Then both are timed at the
   serving batch 64 beside the kernel's bound;
4. serving: the full-width medmamba ``classify`` (image 224, staging 256,
   bf16 compute, random weights from seed 0) answers 16 concurrent requests
   through ``MicroBatcher``; the answers are checked, the launch counters
   must show 14 forward launches per dispatched batch and no backward
   launch, the same batch through the plain scan must agree, and each of
   the 14 scans of one forward of that batch must agree with the plain
   loop on its own inputs; then classify is timed at batch 64;
5. backward kernel against plain: ``selective_scan_bwd`` against
   ``_scan_tm_plain_bwd`` at the shapes of phase 3; gate: each of the 7
   gradients at max|g_k - g_p| / max|g_p| <= 5e-4, and a second run must
   give all 7 bit for bit (no atomics). Then the forward (with ``hck``) and
   the backward are timed at batch 64, bf16, beside the backward's bound;
6. training: the stage-2 CE train step of full-width medmamba (``amp``,
   AdamW at the config defaults, cosine schedule) on device-resident uint8
   batches: 2 warm-up and 5 timed steps at batch 64 with finite loss and
   grad norm and exactly 14 forward and 14 backward launches per step;
   the 14 scans of one more step recorded with their dy, each backward
   held against the plain backward on its own inputs at 5e-4; then, at
   batch 8, 2 steps with the kernels against 2 steps with the plain scans
   from the same state (loss and grad norm within one bf16 ulp, 2^-8,
   relative). Prints ms per step, train img/s, peak device memory and the
   scan kernels' ms per step;
7. flash kernel against plain: first each instance of the forward that
   phase 2 built (at hd 32, 64, 128: the tensor-core body in its bf16 and
   its fp16 instance, which bf16 and fp16 run with and without residuals,
   and the 3xTF32 body, which fp32 runs), with ptxas' registers and
   spills, its shared memory a block and the ``HMMA`` instructions in its
   SASS (``cuobjdump -sass``); every instance, fp32's too, must hold some,
   or the phase fails. Then
   ``flash_attn_fwd`` against the plain
   (einsum) interior at h = 12, hd = 64, batch 2: T = 197 unmasked; T = 256
   with a prefix, a non-prefix, a one-key and an all-masked key row; the
   trimmed text context 224; a ragged 77; and hd 32 and 128; fp32, bf16
   and fp16; each case as serving calls it (no residuals) and as training
   calls it (with residuals); gate max|o_k - o_p| / max|o_p| <= 5e-4
   (fp32) and 2e-2 (bf16 and fp16), and the all-masked row must be the mean
   of v. Then, at batch 64 in bf16 and in fp16, the kernel, the plain
   interior and ``F.scaled_dot_product_attention`` (the library yardstick,
   never on the path) are timed at the ViT shape (T 197) and the BERT shape
   (T 256, masks of tokenized report-like text) beside the bound, and the
   training forward's o is held against the plain interior there too;
8. CLIP serving: full-width BiomedCLIP (ViT-B/16 + the 12-layer BERT, bf16
   compute, ``attn_impl="flash"``, random weights from seed 0) answers 16
   concurrent ``image_embed`` and 16 concurrent ``text_embed`` requests
   through two ``MicroBatcher``s; the embeddings must be finite unit
   vectors, the counters must show 12 flash launches per dispatched batch
   and no scan launch, every one on the tensor cores (the wrapper counts
   each body's launches apart), and the ``attn_impl="einsum"`` model on the same
   weights must agree within 2e-2; the 24 interiors of one image and one
   text forward are each held against the plain interior at the bf16
   gate; the VSSM-towered CLIP's ``image_embed`` must make 14 scan
   launches and no flash launch, its ``text_embed`` 12 flash launches;
   then image/s and texts/s at batch 64, flash and einsum;
9. flash backward kernels against plain: first each instance of the two
   backward kernels, as phase 7 lists the forward's (a bf16 or fp16
   instance, or an fp32 dk/dv or dq instance, without ``HMMA`` fails). Then
   ``flash_attn_bwd_dq`` and
   ``flash_attn_bwd_dkv`` against ``attention_plain_bwd`` at the shapes of
   phase 7 (the one-key and the all-masked row beside a non-prefix row,
   since their own dq and dk vanish), fp32 on the 3xTF32 dk/dv and dq
   bodies, and bf16
   and fp16 on the tensor-core bodies, each gradient at
   max|g_k - g_p| / max|g_p| <= 5e-4 (fp32) and 2e-2 (bf16 and fp16: the
   plain backward rounds p, dp and ds to the type, the kernels round p once
   for dv and carry ds as two terms of the type; in bf16 and fp16 each case
   is held against the plain backward in the type, a row with one valid key
   left out because its dq and dk vanish and the rounding plain backward
   leaves noise there, and against the fp32 plain backward on the same
   inputs, every row); the forward's residuals m and l against the plain
   ones at 5e-4; dk and dv of a masked key exactly 0 from every row that has
   a valid key, dq and dk exactly 0 for a row with none; two runs
   bit-identical. Then fp16's range: a cotangent carrying the 2^16 loss
   scale whose fp16 rounding overflows in two rows; dq, dk and dv of the
   kernels must be non-finite exactly where the plain backward's are (some
   of each), nothing clamped. Then, at batch 64 at the ViT and BERT shapes,
   in bf16 and fp16 (tensor cores) and fp32 (3xTF32 forward, dk/dv and
   dq), the forward with residuals and both backward kernels are timed
   beside their bounds (fp32's beside the 3xTF32 bound and the fp32 FMA
   one), the
   plain forward and backward, and the forward (with its residuals, as
   training calls it) and backward of ``F.scaled_dot_product_attention`` in
   the same type;
10. CLIP training: the stage-1 contrastive step of full-width BiomedCLIP
   (``amp``, ``attn_impl="flash"``, batch 64, device-resident uint8 images
   at staging 256, HashTokenizer tokens of report-like text, AdamW with
   clipping at 1.0): 2 warm-up and 5 timed steps with finite loss and grad
   norm, the first loss within [3, 6] (ln 64 = 4.16 at random init),
   ``logit_scale`` within [1, 100], exactly 24 forward, 24 dk/dv and 24 dq
   launches a step and no scan launch, every one on the tensor cores;
   the 24 interiors of one more step recorded with their ``do``, each
   forward's o held against the plain interior at the bf16 gate and each
   backward held against the fp32 plain
   backward on its own bf16 inputs and kept result at the bf16 gate (the
   bf16 plain backward, which recomputes the result, is printed beside it:
   where a row's keys are nearly alike, dq is a small remainder of terms
   that cancel and one bf16 rounding of rowsum(o * do) is of its size);
   the same step with ``attn_impl="einsum"`` for its time and peak memory.
   At batch 8 (``clip_step_check``, seed 1): from S_0, the init, and S_1,
   the state after the kernel step, a step with the kernels, one with the
   plain interiors and one with the kernel forward and the fp32 plain
   backward on its kept o: (a) the loss with the kernels within 2^-7
   relative of the plain step's, (b) the grad norm within 2^-7 of the
   mixed step's, which sees the same o and di, so that only the backward
   kernels differ, and (c) the grad norm against the plain step's, printed
   and not gated (one rounding of o moves di, and at random init dq is a
   small remainder of its size: PERF.md, Findings). One fp32 step under the
   same gates runs the fp32 bodies (24 + 24 + 24 launches, every one
   counted under ``cuda_cores``, the key that names the fp32 body); one
   step with ``accum_freq=2`` and
   ``grad_checkpointing``
   (144 forward launches: 2 micro-batches x 24 in the no-grad bank pass, and
   x 24 x 2 in the graded pass, whose checkpoints run each forward again;
   48 dk/dv and 48 dq, every one on the tensor cores); one step of the
   ``medmamba`` CLIP (14 + 14 scan
   launches, 12 + 12 + 12 flash launches). Prints ms per step, pairs/s,
   peak memory with flash and with einsum, and the flash kernels' ms per
   step. ``python3 chip_smoke.py --clip-check-seeds 1 2 3 4 [--src DIR]``
   runs only the batch-8 check, at those seeds, on the package under
   ``DIR`` (another tree's ``src/``), and prints its readings;
11. ceiling kernel against plain, then the roofline: ``vpu_chain`` with
   c = 0.5, d = 0 and with c = 1, d = 1 at rounds 1 to 4 must give
   x * 2^(-16 rounds) and x + 16 rounds bit for bit (every step ran, on a
   ragged element count); the exp chain at rounds = 1 must agree with 16
   plain steps and disagree with 15 at 1e-5 of the largest entry (a longer
   exp chain sits on its fixed point and shows nothing); at the roofline
   tool's constants and rounds = 64, at the tool's size and the ragged one,
   the FMA chain within 1e-5 of the plain chain that rounds once a step
   (``fused=True``, the rounding of ``fmaf``) and within 2e-4 of the one
   that rounds the product and the sum apart, the exp chain within 1e-5 of
   ``torch.exp``. Then ``scan_roofline.measure`` runs once (the kernel's
   main path: its launches are counted): the FMA, exp and HBM ceilings,
   each as a share of its data-sheet figure at the SM clock read under
   load (above 105% fails), and the scan kernels at batch 32; a
   ``roofline`` JSON line gives them and, for the scan kernels, the bound
   from the measured ceilings beside the one from the data sheet;
12. a stage-1 epoch through ``pipeline.step``: full-width BiomedCLIP,
   ``amp``, ``attn_impl="flash"``, batch 64, ``SyntheticIsicDataset`` with
   ``HashTokenizer`` (256 train samples = 4 steps, 128 validation samples),
   ``checkpoint_steps=2``: 24 + 24 + 24 flash launches in each train step,
   24 forward and no backward launches in each eval batch, finite losses
   (the contrastive validation loss within [3, 6]), the step checkpoint and
   its sidecar on disk after batch 2 and gone after ``finalize``, the epoch
   and stage-latest checkpoints there. Then exact resume: a fresh state
   loaded from the step checkpoint and run from ``start_batch=2`` must end
   with parameters, moments and step equal bit for bit to the uninterrupted
   run's. Prints an ``epoch_stage1`` JSON line: ms a step and pairs/s (the
   loop's last logged window), the loop's data and batch meters over the
   epoch, the loader's seconds a batch alone, eval rows/s, peak memory, and
   the seconds and MB/s of a checkpoint save and load;
13. a stage-2 epoch: ``ClipClassifier`` over that CLIP, loaded with
   ``load_params_only`` from phase 12's stage-latest checkpoint and frozen
   through ``freeze_submodule_mask``, class-weighted CE, batch 64, 4 steps,
   then ``evaluate``: 24 flash forward launches a step and no backward
   launch, every ``clip.*`` parameter bit-identical after the epoch, the
   head moved, ``val_loss`` finite and ``partial_auc`` within [0, 0.2] (the
   area above 80% TPR), and the validation probabilities within 2e-2 of the
   ``attn_impl="einsum"`` model on the same weights. Prints an
   ``epoch_stage2`` JSON line. Checkpoints go under ``tempfile.mkdtemp()``
   and are removed at the end. Phases 12-13 take their flags from
   ``config.parse_args`` (checked against the values they run at) and their
   run record from ``config.RunState``;
14. the CLI: ``mamba_clip_tpu_torch.cli.main.main`` in this process, with
   SKILL.md's Drive flags (192 train and 64 validation samples, batch 64,
   ``amp``, 1 epoch) and ``--attn-impl flash``, every count set to 0 just
   before each run and read just after: (a) full-width BiomedCLIP from seed
   1 written as a converted ``.npz`` (Flax keys and layouts, numpy alone)
   and loaded into seed 2's model with ``load_torch_clip``, ``image_embed``
   of a batch-64 staging batch bit for bit; (b) stage 1 with ``--pretrained``
   that file and ``--tokenizer hash``, no ``--name``: ``Model parameters:
   195.71M``, the load logged, 3 steps of 24 + 24 + 24 flash launches, all
   on the tensor cores, 24 forward launches and no backward one an eval
   batch, the first loss within [3, 6], ``params.txt``, ``results.jsonl``,
   ``stage_1_epoch_1``, ``stage_1_epoch_latest``; (c) stage 2 with
   ``--name``, which finds (b)'s run itself: 24 + 0 + 0 a step, every
   ``clip.*`` parameter of its latest checkpoint bit-identical to (b)'s,
   ``partial_auc`` within [0, 0.2]; (d) (c) again with ``--resume latest``:
   no step, no backward launch, ``val_loss`` and ``partial_auc`` equal to
   (c)'s row bit for bit; (e) ``--model-stage-1 medmamba`` (128 train
   samples) with ``--resume latest`` and nothing to resume: its log line,
   ``Model parameters: 8.53M``, 14 + 14 scan launches a step, 14 forward
   an eval batch; (f) ``--precision bogus``, a reused ``--name`` and
   ``--stage 2 --resume latest`` in an empty logs dir, each its exception
   message for message and no launch. Prints a ``cli`` JSON line (each
   run's wall seconds, the loop's ms a step, pairs/s or img/s, eval rows/s,
   save seconds, beside phases 12 and 13's ms a step);
15. serving artifacts and the HTTP host, every count set to 0 just before
   each call and read just after: (a) full-width BiomedCLIP (seed 0,
   ``amp``, ``attn_impl="flash"``) exported with ``export_serving`` raw and
   with ``compress_weights``, and full-width medmamba ``classify`` raw,
   into ``tempfile.mkdtemp()``; each artifact's bytes and its export and
   ``load_serving(..., device="cuda")`` seconds; (b) the loaded
   ``image_embed``, ``text_embed`` and ``classify`` of a batch of 64 bit
   for bit equal to ``make_serving_fns`` in this process on the same
   weights, 12 flash forward launches a call on the tensor cores (14 scan
   forward launches for ``classify``) and no other; the compressed
   artifact's int8 values and scales equal to ``compress_params`` of the
   raw weights, its outputs bit for bit those of the in-process model given
   the decompressed weights, its lowest cosine to the raw artifact's
   embeddings above 0.999; (c) ``serve_http.make_server`` over each raw
   artifact, ``serve_forever`` in a thread: ``/healthz``; 16 JPEG bodies
   (PIL-encoded, of distinct kinds) for ``/embed_image`` and ``/classify``
   and 16 JSON texts of distinct openings for ``/embed_text``, each row's
   answer computed directly at every batch shape the batcher dispatches (1,
   2, 4, 8, 16); gates: no two rows share an answer, and the shapes move an
   answer at most 5e-3 (embeddings) or 2e-2 (probabilities); with
   ``max_batch=1`` every answer bit for bit the direct call of its row; with
   the MicroBatcher (``max_batch=16``), closed-loop clients at concurrency
   1, 4 and 16 for 2 s each, every answer a 200, bit for bit its own row's
   answer at one of those shapes (so that an answer taken from another row
   fails) and within that bound of its direct call, 12 (or 14) launches
   times the batcher's batches; an unknown path gives JAX's 404 message, a
   malformed body (bad JSON, a truncated JPEG) a 400; the servers shut
   down and the directories removed; (d) prints a ``serving_http`` JSON
   line (per endpoint: the batch shapes' largest move, the closest rows'
   distance, and per concurrency p50, p95 and p99 ms, requests/s, requests
   and padded rows a batch and the largest distance to the direct call;
   the artifacts' bytes and seconds; whether ``fastimage`` builds here and
   PIL imports, the host's two JPEG decoders);
16. the recipe on real files: behind a ``find_spec("PIL")`` check (without
   PIL the phase says what it skipped and fails), writes an ISIC-2024
   layout in a temp dir (``train-metadata.csv``: ``synthetic_metadata(640,
   16)``; a label-free ``test-metadata.csv`` of 64 rows; 704 1024-px JPEGs
   in ``train-image/image``; both CSVs with the csv module) and runs the
   CLI's main() over it with phase 14's flags less ``--synthetic-data``,
   ``--attn-impl flash`` and ``--workers 4`` at batch 64: (a) stage 1 with
   ``--undersample 320 --add-remaining-samples --cache-staging``, 2
   epochs; (b) stage 2 from it, 1 epoch; (c) ``--is-test --stage 2
   --resume latest`` on (b)'s run. Gates: the flash launches of phase 14 a
   step and a batch (24 + 24 + 24 a stage-1 step, 24 a stage-2 step, 24 an
   eval batch), all on the tensor cores; finite losses; the splits each
   run built equal to what ``get_metadata`` -> ``undersample_data`` give
   for the CSV (64 rows for the test split); every square read from the
   staging cache (stage 1's epoch 2 and second evaluation, all of stage 2)
   bit for bit the decode of the same id, and stage 2 decoding none;
   ``submission.csv`` the 64 test ids in order with probabilities in [0,
   1]. Prints a ``real_data`` JSON line: each run's wall seconds, the
   loop's ``data:`` and ``batch:`` meters and ms a step for each epoch
   (JPEG decode, then the cache) beside phases 12-14's synthetic ones,
   decodes and cache reads, eval rows/s, ``get_metadata`` seconds, and the
   train loader alone's ms a batch decoding JPEGs and from the cache;
17. the native int8 modes (``--quant``), every count set to 0 just before
   each driven call and read just after: (a) the seven int8 dots of
   ``ops/qdot.py`` on the same fp32 inputs on the card and on the CPU, at
   the contrastive step's shapes (the ViT's qkv Dense, 64 x 197 rows of
   768 -> 2304; its attention, 64 x 12 heads, T 197, hd 64): the int8
   operands and int32 accumulators equal bit for bit, the outputs and
   gradients within rel 1e-6 (the serve dot's gradients, fp32 GEMMs over
   dequantized operands, 1e-5); (b) full-width medmamba ``classify``
   under ``int8_serve`` at batch 64 (14 scan forward launches a call),
   its probabilities within 2e-2 of the unquantized bf16 model's on the
   same weights and not equal to them, and both timed; (c) the
   contrastive step of full-width BiomedCLIP at batch 64 under
   ``int8_fast`` and ``int8_delayed`` with ``attn_impl="flash"`` (24 + 24
   + 24 flash launches a step, all on the tensor cores; the delayed mode
   first ``calibrate_quant``, 24 forward launches) and
   ``int8_fast_attn`` and ``int8_delayed_attn`` with the einsum interior
   (no flash launch): 2 + 3 steps each, finite losses (the first within
   [3, 6]), the delayed state moved by the steps and not by an eval
   forward, ms a step beside phase 10's amp steps; (d) the medmamba
   classifier step under ``int8_delayed`` through ``train_one_epoch``
   over three batches: ``calibrate_quant`` once, at step 0, 14 x 4 scan
   forward and 14 x 3 backward launches, then one step with every int32
   accumulator's largest magnitude recorded; (e) ``export_serving --quant
   int8_serve --compress-weights`` of medmamba, then ``load_serving``: the
   stored int8 values and scales the int8_serve dot's quantization of
   the weights on the card, ``classify`` of 64 images bit for bit
   ``make_serving_fns``'s; (f) the CLI's ``main()`` with phase 14's flags
   and ``--model-stage-1 medmamba --quant int8_delayed``: 14 scan forward
   launches for the init batch, 14 for ``calibrate_quant``, 2 steps of 14
   + 14, an eval batch of 14, and 62 delayed scales in the checkpoint.
   Prints a ``quant`` JSON line;
18. the low-precision parameter policies (``--precision``), every count set
   to 0 just before each driven call and read just after: (a) the
   contrastive step of full-width BiomedCLIP at batch 64 with the flash
   interior under ``pure_bf16``, ``fp16`` and ``pure_fp16`` (``--eps
   1e-4``): 1 warm-up and 3 timed steps each, 24 + 24 + 24 flash launches a
   step on the tensor cores (the fp16 instances under the fp16 policies),
   finite losses (the first within [3, 6]), a finite grad norm for every
   step the dynamic loss scale did not skip and some step taken, the
   parameters and moments in JAX's types (parameters in the policy's type,
   moments too but fp32 under the fp16 policies); ms a step and the peak
   memory beside phase 10's amp step; (b) the medmamba step under
   ``pure_bf16`` and ``pure_fp16`` through both scan kernels (14 + 14 a
   step), the same type gates and BatchNorm's statistics fp32; (c) the CLI's
   ``main()`` with phase 14's flags and ``--precision pure_bf16``: stage 1
   (3 steps of 24 + 24 + 24), stage 2 finding it (24 + 0 + 0), stage 2 with
   ``--resume latest`` (its metrics equal stage 2's row bit for bit), every
   checkpoint's parameters and moments bf16; (d) stage 1's checkpoint
   through ``export_serving`` raw and ``--compress-weights``, then
   ``load_serving``: bf16 parameters, ``image_embed`` and ``text_embed`` of
   64 rows bit for bit ``make_serving_fns`` on the same state (the
   compressed one given the decompressed weights), 12 flash launches a
   call. Prints a ``precision`` JSON line;
19. the aqt modes (``--quant int8`` and ``int8_fwd``), every count set to
   0 just before each driven call and read just after: (a) the dots of
   ``ops/aqt.py`` (the forward, ``int8``'s two backward dots and
   ``int8_fwd``'s unquantized backward) on the same fp32 inputs on the card
   and on the CPU at the ViT's qkv Dense (64 x 197 rows of 768 -> 2304):
   the int8 operands and int32 accumulators equal bit for bit, the outputs
   within rel 1e-6 (int8_fwd's backward, fp32 GEMMs summed in another
   order on each device, 1e-5); (b) the contrastive step of full-width
   BiomedCLIP at batch 64, amp, ``attn_impl="flash"``, under each mode: 2 +
   3 steps, 24 + 24 + 24 flash launches a step on the tensor cores, finite
   losses (the first within [3, 6]), ms a step beside phase 10's amp step;
   (c) the full-width medmamba step under each mode: 1 + 3 steps, 14 + 14
   scan launches a step, ms beside phase 6's; (d) the CLI's Drive recipe
   under ``--quant int8``: stage 1 (2 steps of 24 + 24 + 24) and stage 2
   finding it (2 steps of 24 + 0 + 0). Prints an ``aqt`` JSON line;
20. the data axis: two gloo ranks, each a process of its own on the one
   card (NCCL refuses two ranks on one device), run the full-width
   contrastive step with flash at 32 rows a rank from the same weights and
   seeds as one process at 64 rows, with ``--local-loss`` off and on: the
   ranks' losses and parameters identical, the losses and a parameter
   digest (every 997th entry of each leaf) after 2 steps within 2^-7 of
   one process's (amp; the digest relative to its largest entry), 24 +
   24 + 24 flash launches a rank and a step on the tensor cores; ms a step
   and the collectives' ms (two ranks share one card: not a scaling
   number); that gloo takes CUDA tensors for all_reduce, broadcast and
   all_gather as they are (the port hands it the card's tensors, so a
   refusal fails the phase). The one process runs in a one-rank NCCL
   world, which also runs the collective helpers and ``broadcast_object``
   on the card's tensors. Prints a ``data_axis`` JSON line;
21. hyperparameter search: (a) the CLI's ``main()`` with
   ``--hyperparameter-tuning --hyperparameter-strategy asha`` over
   full-width medmamba (``--synthetic-data``, ``amp``, image 224, 2 trials,
   2 epochs, batch 64, 128 train and 64 validation samples): one trial
   pruned at epoch 1, the winner's history 2 entries and the pruned one's
   1, a finite ``val_loss``, 6 steps of 14 + 14 scan launches and 3
   evaluations of 14 forward launches, each trial-epoch timed; (b) a
   ``TrialRunner`` of the same flags steps one epoch (2 x (14 + 14) + 14)
   and saves; a fresh one restores it: parameters, buffers, moments, count,
   step and epoch bit for bit; (c) ``--hyperparameter-strategy optuna`` and
   ``ray``: where ``find_spec`` finds no package, an ``ImportError`` that
   names it and no launch; where it finds one, the phase says so and runs
   its search (1 trial, 1 epoch). Prints an ``hpo`` JSON line;
22. the utilities, every count set to 0 just before each run and read just
   after: (a) behind a ``find_spec("fsspec")`` check, the CLI on the
   medmamba classifier (1 epoch, 2 steps of 14 + 14, an evaluation of 14)
   with ``--remote-sync file://<temp dir>`` every second; once its epoch
   checkpoint is mirrored byte for byte, the local checkpoints are deleted
   and ``--resume latest`` of the same name must log the remote one,
   evaluate it without a step (14 launches) and give the first run's
   metrics bit for bit; without fsspec, the run must raise ``remote sync
   startup validation failed`` with a logged line naming fsspec, and the
   phase says which branch ran; (b) ``--report-to wandb`` runs to its end
   with one warning where wandb is not installed (an installed one runs
   with ``WANDB_MODE=disabled``); (c) ``profile_step`` traces 3 steps of the
   bench's full-width flash contrastive step at context 256 (after 3
   warm-up steps): its
   attribution table printed, the hand-written class 72 kernels a step,
   the flash counters 24 + 24 + 24 a traced step and no scan, the classes
   summing to the profiler's device total within 1e-3. Prints a
   ``utilities`` JSON line;
23. the VSSM decoder at full width, mirroring medmamba's encoder:
   ``VSSLayerUp(upsample=True)`` from 7x7x512 to 256, 128 and 64 channels
   (depths 8, 2, 2) and ``FinalPatchExpand2D(dim_scale=4)`` to
   224x224x16, batch 8, amp, random weights from seed 0, training mode:
   one forward and backward makes 12 forward and 12 backward scan
   launches; each recorded scan's output and its 7 gradients are held
   against the plain loop on its own inputs at 5e-4; ms forward and ms
   forward + backward. Prints a ``decoder`` JSON line;
24. the fsdp and model axes: two gloo ranks sharing the card run the
   full-width contrastive step with flash (amp) from the same weights and
   seeds as one process at 64 rows, at (fsdp 2), 32 rows a rank, and at
   (model 2), 64 rows on both: the ranks' losses and gathered parameter
   digest identical, both within 2^-7 of one process's after 2 steps, 24 +
   24 + 24 flash launches a rank and a step on the tensor cores; the state
   bytes a rank against one process's, ms a step, the collectives' ms (two
   ranks on one card: not a scaling number), the peak a rank, and whether
   gloo takes the card's tensors for a reduce-scatter (the port's
   ``reduce_scatter_`` path by backend is printed). Prints a ``mesh_axes``
   JSON line;
25. the rest of the parallel layer: (a) two gloo ranks sharing the card
   run ``sharded_selective_scan_tm`` at medmamba's first stage (B 64, G 4,
   L 3136 split 1568 + 1568, DG 64, N 16, fp32, seeded): y and the 7
   gradients (the replicated A, D and bias after their sum, bit for bit
   alike on both ranks) within 5e-4 of one process's unsharded scan (kernel
   1 forward, kernel 2 under autograd), one forward and one backward scan
   launch a rank, 4 permutes (host-staged: gloo and the card's tensors); ms
   and the peak a rank; (b) the same two ranks run BiomedCLIP's 12 visual
   ``EncoderBlock``s as 2 GPipe stages of 6 (amp, flash, M 4, B 32, T 197)
   against the 12 blocks in sequence in this process, on the same 4
   microbatches and on the whole batch at once: the output and the
   stages' gradient digest within 2^-7 of both, 30 flash forward, 30
   dk/dv and 30 dq launches a rank on the tensor cores (5 ticks x 6
   blocks), ms a step and the bubble share 1/5; (c) medmamba artifacts at S = 2 (both replicas
   on the card) and S = 1 from seed 0: ``classify`` at batch 64 bit for bit
   S = 1's on each 32-row slice (28 scan launches), a batch of 63 raises,
   ``serve_http.make_server`` refuses S = 2 on this one-card host with JAX's
   message. Prints ``sharded_scan_gpipe`` and ``sharded_serving`` lines;
26. ``--quant`` under the model axis and per-layer gathering on the fsdp
   axis: two gloo ranks sharing the card run full-width BiomedCLIP's
   contrastive step (amp, flash) at (model 2) under ``int8_fast`` and aqt
   ``int8`` and the medmamba classifier's at (model 2) under ``int8_fast``
   (16 global rows: every column-parallel output crosses the host), and
   BiomedCLIP at (fsdp 2) with per-layer gathering (64 rows), 2 steps
   each, each against one process on the card with the same seeds and
   ``quant``: the ranks' losses and gathered digest identical, both within
   2^-7 of one process's, 24 + 24 + 24 flash (14 + 14 scan) launches a
   rank and a step on the tensor cores; ms a step, the collectives of the
   second step by kind and bytes (``count_collectives``), the peak and the
   state a rank against one process's. Prints a ``quant_mesh_axes`` line;
27. the tools (``flash_sweep``, ``parity_harness``, ``quant_parity``,
   ``measure_report_tokens``, ``benchmark_e2e``), each through its module's
   entry: ``flash_sweep`` times one interior's forward + backward at B 64,
   h 12, T 256, hd 64, bf16 (einsum, the flash path, SDPA), then one flash
   call must hold o, dq, dk and dv within 2e-2 of the einsum interior on the
   same inputs with exactly one forward-with-residuals, one dk/dv and one
   dq launch on the tensor cores; ``parity_harness`` default and
   ``--stage2`` on the card must PASS their own gates, and
   ``run_quant_stage1`` at a reduced step count (in the line) must give
   finite losses, a last loss below the first and a pAUC in [0, 0.2] in
   each mode; ``quant_parity``'s small CLIP in every mode at a reduced step
   count and ``--full-width``'s four curves at 3 steps, every loss finite;
   ``measure_report_tokens`` at 2,000 rows and 3 draws, its largest length
   at most ``report_token_upper_bound``'s; ``benchmark_e2e --layout jpeg``
   over a few hundred 256-px JPEGs at batch 64, the CLI's exit 0 and both
   epochs' img/s finite and positive; ``bench.main`` at 1 warm-up and 2
   timed steps and no secondary, at JAX's defaults (``int8_delayed``,
   einsum, context 224) and at ``BENCH_QUANT= BENCH_ATTN=flash``: one JSON
   line each with JAX's keys and a finite, positive value, its kernel check
   passed (1 + 1 scan launches, and 2 + 2 + 2 flash under flash), 24 + 24
   + 24 flash launches a step under flash and none under einsum. Each
   part's seconds; a ``tools`` JSON line;
28. prints the kernels line (twelve entries: the two scan kernels, the
   roofline's chain kernel, and each flash kernel as three entries, one a
   body and type: ``flash_attn_fwd``, ``flash_attn_bwd_dkv`` and
   ``flash_attn_bwd_dq`` on the tensor cores, bf16, whose launches come
   from the main path, ``..._fp16`` on the tensor cores, whose launches come
   from phase 18's fp16 steps, and ``..._cuda_cores``, fp32 (3xTF32 on the
   tensor cores in all three), whose
   launches come from phase 10's fp32 step; the main path's launches include phases
   14, 15, 16, 17 and 18's; a body launched no time fails. Each flash
   entry is timed at the towers' shapes in its type beside the plain
   version and the library's, with its bound from the data sheet and from
   the ceilings phase 11 measured, its shares of both, and its instances;
   the forward's tensor-core entries are serving's pair, their training
   launches under ``training``; each scan entry with its instances; the
   launches include phases 19-27's, those of phases 20 and 24-26's rank
   processes counted there), then the device line last.

``--cards 4`` runs only the four-card run (it fails on fewer than 4
cards): four NCCL ranks, one a card, run the full-width contrastive step
at 64 rows a batch shard at (data 4), (fsdp 4), (data 2, fsdp 2) and
(data 2, model 2) (and (data 4) at 32 rows, the global batch of (data 2,
model 2)), the same two again under ``--quant int8_fast``, 3 warm-up and
5 timed steps each, and the medmamba classifier step at (data 2, fsdp 2):
the ranks alike bit for bit, the sharded shapes' losses and digest within
2^-7 of (data 4) at the same global batch and ``quant``, 24 + 24 + 24
flash (14 + 14 scan) launches a rank and a step; for each shape ms a
step, the collectives' ms and by kind, the peak and the state bytes a
rank, and the (fsdp 4) peak a rank on a line of its own. Prints a
``mesh_axes_cards`` JSON line. ``--mesh-cases NAME ...`` runs only those
cases and ends there (a copy of this script beside another tree's
``src/`` measures that tree's package). Then: the sharded scan over four NCCL ranks
at phase 25's shapes (L 4 x 784) and GPipe of the 12 ViT blocks as 4
stages of 3 at M = 4 and M = 8, under phase 25's gates against one card's
unsharded scan and sequential blocks (a ``sharded_scan_gpipe_cards``
line); ``bench_scaling.main`` (``--devices 4 --model flagship --precision
amp --batch-per-device 64 --warmup 3 --steps 5``) with each rung's
collectives by kind, count and MB (a ``scaling`` line); medmamba ``classify`` and BiomedCLIP
``image_embed`` artifacts at S = 1, 2 and 4, replica i on card i: at
batch 256 each 64-row slice bit for bit the S = 1 artifact's, rows/s at 64
rows a card, and ``serve_http`` over the S = 4 ``classify`` artifact at 1
and 16 clients (a ``sharded_serving`` line); then the device line.

Phases 1-10 run at the depth and iteration counts they had before phases
11-13 were added.
"""

from __future__ import annotations

import argparse
import functools
import gc
import importlib.util
import json
import logging
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

GATE_REL = 5e-4          # the gate bench.py put on the Pallas kernel
PROBS_ATOL = 2e-2        # kernel vs plain scan, end to end, bf16 activations
# a batched HTTP answer against the direct call of its row: a batch shape of
# its own moves bf16 sums. An L2-normalised 512-d embedding's elements are
# about 0.04; 5e-3 is three times phase 8's flash-against-einsum distance
# (1.6e-3 and 1.8e-3 on the H100), a larger change than a batch shape.
SERVE_BATCHED_ATOL = {"image_embed": 5e-3, "text_embed": 5e-3, "classify": PROBS_ATOL}
TRAIN_REL = 2.0**-8      # kernel vs plain scan, train step loss and grad norm: one bf16 ulp
# flash kernel vs plain interior: fp32 as GATE_REL; bf16 also covers the plain
# interior rounding the scores and the normalized probabilities to bf16, and
# fp16 is held to bf16's gate (its roundings are eight times finer)
ATTN_GATE = {"fp32": GATE_REL, "bf16": 2e-2, "fp16": 2e-2}
# the sources under csrc/; flash_attn_bwd holds the dk/dv and the dq kernel
KERNELS = ("selective_scan_fwd", "selective_scan_bwd", "flash_attn_fwd", "flash_attn_bwd",
           "vpu_chain")
CHAIN_GATE = 1e-5        # the chain kernel vs its plain version, of the largest entry
CHAIN_UNFUSED_GATE = 2e-4  # fmaf vs a multiply and an add that round apart, 1024 steps
CLIP_TRAIN_REL = 2.0**-7  # kernel vs plain interiors, CLIP train step loss and grad norm
# phase 17: an int8 dot on the card against the CPU on the same inputs (its
# int8 operands and int32 accumulators equal); the serve dot's gradients are
# fp32 GEMMs over dequantized operands whose sums run in another order on
# each device (2.4e-6 measured on the H100 at the step's shapes)
DOT_REL = 1e-6
SERVE_GRAD_REL = 1e-5
GRAD_NAMES = ("du", "ddelta", "dA", "dB", "dC", "dD", "dbias")
STAGES = [(3136, 64), (784, 128), (196, 256), (49, 512)]  # (L, DG) per medmamba stage
BLOCKS_PER_STAGE = [2, 2, 8, 2]
# DG below a kernel block's 64 channels, and above them and not a multiple
RAGGED = [(300, 24), (300, 80)]
REPORTS = [
    "Dermoscopy of a pigmented lesion on the upper back of a 45 year old male.",
    "Lesion: left forearm, diameter 6.2 mm; border irregular, two colours, asymmetric. "
    "History of melanoma in the family; atypical network, blue-white veil, regression "
    "structures and dotted vessels; no ulceration; follow-up in 3 months advised.",
    "Benign-appearing nevus.",
    "Female, 71. Scalp. Ulcerated nodule, 11 mm, rapid growth over 3 months. ",
]


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def say(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi(query: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def scan_inputs(Bsz, L, DG, dtype, softplus=True, seed=0, G=4, N=16):
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    r = lambda *s: torch.randn(*s, generator=g, device="cuda")  # noqa: E731
    delta = r(Bsz, G, L, DG) * 0.5
    if not softplus:
        delta = delta.abs()  # a raw step size is positive
    u = r(Bsz, G, L, DG).to(dtype)
    A = -torch.exp(r(G * DG, N) * 0.5)
    B = r(Bsz, G, L, N).to(dtype)
    C = r(Bsz, G, L, N).to(dtype)
    D = r(G * DG) if softplus else None
    bias = r(G * DG) * 0.1 - 2.0 if softplus else None
    return u, delta.to(dtype), A, B, C, D, bias


def rel_errs(got, want):
    """max|g - w| / max|w| and max|g - w| of each pair."""
    out = []
    for g, w in zip(got, want):
        abs_err = float((g.float() - w.float()).abs().max())
        out.append((abs_err / max(float(w.float().abs().max()), 1e-30), abs_err))
    return out


def clip_step_check(seed: int, precision: str = "amp", steps: int = 2, counted=None):
    """The flash path in the stage-1 contrastive step of full-width
    BiomedCLIP at batch 8 against the plain interiors, each part gated
    where it is well posed. S_0 is the init from ``seed``, S_(i+1) the state
    after the kernel step from S_i; from every S_i three steps run:

    - "kernel": the flash kernels, forward and backward, as training runs;
    - "plain": the plain interior and its backward;
    - "mixed": the kernel forward, then ``attention_plain_bwd`` in fp32 on
      the kept result o.

    (a) the kernel step's loss against the plain step's: the loss does not
    pass through di = rowsum(o * do). (b) the kernel step's grad norm against
    the mixed step's: both see the same o and so the same di, and only the
    backward kernels differ. (c) the kernel step's grad norm against the
    plain step's, printed and not gated: at random init dq is a small
    remainder of terms that cancel, and one bf16 rounding of o moves di,
    and so the grad norm, by more than 2^-7 (PERF.md, Findings).

    ``counted``: (reset, read), called around each kernel step; the reads
    come back with the readings. Returns one dict a step."""
    import torch

    from mamba_clip_tpu_torch.models import vit as vit_mod
    from mamba_clip_tpu_torch.ops.flash_attn import attention_plain_bwd, flash_attn_fwd
    from mamba_clip_tpu_torch.optim import AdamState
    from mamba_clip_tpu_torch.profile_train import clip_train_setup
    from mamba_clip_tpu_torch.train import TrainState

    class KernelFwdPlainBwd(torch.autograd.Function):
        @staticmethod
        def forward(ctx, q, k, v, key_mask, sm):
            out = flash_attn_fwd(q, k, v, key_mask, sm_scale=sm, with_residuals=True)[0]
            ctx.sm = sm
            ctx.save_for_backward(q, k, v, key_mask, out)
            return out

        @staticmethod
        def backward(ctx, do):
            q, k, v, key_mask, out = ctx.saved_tensors
            mask = None if key_mask is None else key_mask[:, None, None, :]
            grads = attention_plain_bwd(q.float(), k.float(), v.float(), mask, do.float(),
                                        ctx.sm, o=out.float())
            return (*(g.to(q.dtype) for g in grads), None, None)

    interior = vit_mod.flash_attention_interior

    def mixed(q, k, v, pad_mask=None, *, sm_scale, impl=None):
        B, T = q.shape[:2]
        key_mask = None if pad_mask is None else pad_mask.reshape(B, T).contiguous()
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        return KernelFwdPlainBwd.apply(q, k, v, key_mask, sm_scale)

    interiors = {"plain": functools.partial(interior, impl="plain"), "mixed": mixed,
                 "kernel": functools.partial(interior, impl="cuda")}
    kw = {} if precision == "amp" else {"precision": precision}
    st, fn, bs = clip_train_setup(8, seed=seed, **kw)
    model = st.model

    def restore(snap):
        step, params, count, mu, nu = snap
        model.load_state_dict(params)
        return TrainState(step=step, model=model, opt_state=AdamState(
            count, {k: t.clone() for k, t in mu.items()}, {k: t.clone() for k, t in nu.items()}))

    readings = []
    for i in range(steps):
        snap = (st.step, {k: t.clone() for k, t in model.state_dict().items()},
                st.opt_state.count, st.opt_state.mu, st.opt_state.nu)
        got, counts = {}, None
        for name in ("plain", "mixed", "kernel"):  # the kernel step's state goes on
            vit_mod.flash_attention_interior = interiors[name]
            try:
                if name == "kernel" and counted is not None:
                    counted[0]()
                new, m = fn(restore(snap), bs[i % 2], 0)
                got[name] = (float(m["loss"]), float(m["grad_norm"]))
                if name == "kernel" and counted is not None:
                    counts = counted[1]()
            finally:
                vit_mod.flash_attention_interior = interior
        st = new
        (lk, gk), (lp, gp), (_, gm) = got["kernel"], got["plain"], got["mixed"]
        rl, rg, rc = abs(lk - lp) / abs(lp), abs(gk - gm) / abs(gm), abs(gk - gp) / abs(gp)
        finite = all(math.isfinite(x) for pair in got.values() for x in pair)
        readings.append({
            "seed": seed, "precision": precision, "step": i, "loss_kernel": lk,
            "loss_plain": lp, "loss_rel": rl, "grad_norm_kernel": gk, "grad_norm_mixed": gm,
            "grad_norm_rel": rg, "grad_norm_plain": gp, "grad_norm_vs_plain_rel": rc,
            "counts": counts,
            "ok": bool(finite and rl <= CLIP_TRAIN_REL and rg <= CLIP_TRAIN_REL)})
    del st, fn, bs, model, snap, new
    torch.cuda.empty_cache()
    return readings


def say_clip_step(r: dict) -> None:
    say(f"clip step check seed {r['seed']} {r['precision']} step {r['step']}: (a) loss kernel "
        f"{r['loss_kernel']:.6f} plain {r['loss_plain']:.6f} (rel {r['loss_rel']:.2e}); (b) "
        f"grad_norm kernel {r['grad_norm_kernel']:.6f} kernel forward + fp32 plain backward "
        f"{r['grad_norm_mixed']:.6f} (rel {r['grad_norm_rel']:.2e}); gate {CLIP_TRAIN_REL:g}: "
        f"{'ok' if r['ok'] else 'FAIL'}; (c, not gated) grad_norm plain "
        f"{r['grad_norm_plain']:.6f} (rel {r['grad_norm_vs_plain_rel']:.2e}: di from a "
        "differently rounded o moves dq, a small remainder, at its own size)")


def clip_check_only(seeds, src: Path) -> None:
    """``--clip-check-seeds``: only the batch-8 check, at each seed, on the
    package under ``src``; the readings as one JSON line. Exits 0 whether
    or not a seed passes: it reports."""
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke test runs on the card only")
    sys.path.insert(0, str(src))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = nvidia_smi("name,power.limit")
    say(card)
    readings = []
    for seed in seeds:
        for r in clip_step_check(seed):
            say_clip_step(r)
            readings.append(r)
    say(json.dumps({"clip_step_check": readings, "src": str(src), "card": card}))


class LogLines(logging.Handler):
    """The messages of a logger while this handler is installed."""

    def __init__(self):
        super().__init__()
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())


def observe_cli(pipeline_mod, read_counts, read_bodies):
    """Wrap, in ``pipeline_mod`` (the port's pipeline), the two step
    factories, ``evaluate`` and ``save_checkpoint`` with recorders, and
    install a log handler. Returns (record, undo): each train step's kernel
    launches, flash bodies and loss, each evaluation's seconds and launches,
    each save's seconds, and the log lines. The wrappers observe; the calls
    they wrap are the CLI's own."""
    import torch

    rec = {"steps": [], "evals": [], "saves": [], "lines": LogLines()}
    names = ("make_clip_train_step", "make_classifier_train_step", "evaluate",
             "save_checkpoint")
    orig = {n: getattr(pipeline_mod, n) for n in names}

    def counted(fn, into, **extra):
        c0, b0 = read_counts(), read_bodies()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        into.append({"s": time.perf_counter() - t0,
                     "launches": {k: v - c0[k] for k, v in read_counts().items()},
                     "bodies": {k: {b: n - b0[k][b] for b, n in v.items()}
                                for k, v in read_bodies().items()}, **extra})
        return out

    def factory(make):
        def made(*a, **k):
            fn = make(*a, **k)

            def step(state, batch, seed):
                out = counted(lambda: fn(state, batch, seed), rec["steps"])
                rec["steps"][-1]["loss"] = float(out[1]["loss"])
                return out
            step.calibrate_quant = fn.calibrate_quant  # the loop's first-batch hook
            return step
        return made

    def evaluate(*a, **k):
        return counted(lambda: orig["evaluate"](*a, **k), rec["evals"])

    def save(*a, **k):
        t0 = time.perf_counter()
        out = orig["save_checkpoint"](*a, **k)
        rec["saves"].append(time.perf_counter() - t0)
        return out

    root = logging.getLogger("mamba_clip_tpu_torch")
    root.addHandler(rec["lines"])
    pipeline_mod.make_clip_train_step = factory(orig["make_clip_train_step"])
    pipeline_mod.make_classifier_train_step = factory(orig["make_classifier_train_step"])
    pipeline_mod.evaluate = evaluate
    pipeline_mod.save_checkpoint = save

    def undo():
        for n, f in orig.items():
            setattr(pipeline_mod, n, f)
        root.removeHandler(rec["lines"])
    return rec, undo


def run_cli(counters, what, argv, raises=None):
    """``cli.main.main(argv)`` with every count set to 0 just before and read
    just after, observed by ``observe_cli``; with ``raises``, the exception
    it must raise. ``counters``: (reset_counts, read_counts, flash_bodies)."""
    import torch

    from mamba_clip_tpu_torch import pipeline as port_pipeline
    from mamba_clip_tpu_torch.cli.main import main as cli_main

    reset_counts, read_counts, flash_bodies = counters
    gc.collect()
    torch.cuda.empty_cache()
    reset_counts()
    rec, undo = observe_cli(port_pipeline, read_counts, flash_bodies)
    t0 = time.perf_counter()
    try:
        rec["metrics"] = cli_main(argv)
        if raises is not None:
            fail(f"cli {what}: returned {rec['metrics']} where it must raise {raises}")
    except Exception as e:  # a probe's exception is its result; any other fails
        if raises is None or not isinstance(e, raises):
            fail(f"cli {what}: {type(e).__name__}: {e}")
        rec["error"] = f"{type(e).__name__}: {e}"
    finally:
        undo()
    torch.cuda.synchronize()
    rec["wall_s"] = time.perf_counter() - t0
    rec["total"], rec["total_bodies"] = read_counts(), flash_bodies()
    rec["lines"] = rec["lines"].lines
    say(f"cli {what}: {rec['wall_s']:.1f} s, {len(rec['steps'])} steps, launches a "
        f"step {[st['launches'] for st in rec['steps']]}, evaluations "
        f"{[ev['launches'] for ev in rec['evals']]}, in all {rec['total']}; saves "
        f"{[round(x, 2) for x in rec['saves']]} s; "
        f"{rec.get('metrics', rec.get('error'))}")
    return rec


def check_cli_steps(rec, what, n, want_step, want_eval, eval_batches):
    """The gates on a CLI run's launches: ``n`` train steps, each launching
    exactly ``want_step``; every evaluation ``eval_batches`` batches of
    ``want_eval``; every flash launch on the tensor cores; finite losses."""
    import numpy as np

    no_launch = {k: 0 for k in rec["total"]}
    steps = [st["launches"] for st in rec["steps"]]
    if len(steps) != n or any(st != {**no_launch, **want_step} for st in steps):
        fail(f"cli {what}: launches a step {steps}, expected {n} x {want_step}")
    if not rec["evals"]:
        fail(f"cli {what}: no evaluation")
    want = {**no_launch, **{k: v * eval_batches for k, v in want_eval.items()}}
    for ev in rec["evals"]:
        if ev["launches"] != want:
            fail(f"cli {what}: an evaluation launched {ev['launches']}, expected "
                 f"{eval_batches} x {want_eval}")
    tc = [st["bodies"] for st in rec["steps"]] + [ev["bodies"] for ev in rec["evals"]]
    if any(b["cuda_cores"] for by in tc for b in by.values()):
        fail(f"cli {what}: a flash launch on the fp32 body: {tc}")
    if not all(np.isfinite(st["loss"]) for st in rec["steps"]):
        fail(f"cli {what}: losses {[st['loss'] for st in rec['steps']]}")


def cli_phase(card, reset_counts, read_counts, flash_bodies):
    """Phase 14: the CLI's main() drives (a) a converted checkpoint written
    and loaded, (b) stage 1 from it, (c) stage 2 finding (b)'s run, (d) (c)
    resumed, (e) the medmamba classifier, (f) the error probes, each with its
    gates. Every count is set to 0 just before each run and read just after.
    Returns (the ``cli`` line's fields, the launches of the runs (b)-(e) by
    counter, their flash launches by body)."""
    import numpy as np
    import torch

    from mamba_clip_tpu_torch.checkpoint import load_torch_clip
    from mamba_clip_tpu_torch.convert import write_converted_npz
    from mamba_clip_tpu_torch.serving import make_serving_fns
    from mamba_clip_tpu_torch.utils.precision import _POLICIES

    no_launch = {k: 0 for k in read_counts()}
    counters = (reset_counts, read_counts, flash_bodies)
    cli_work = tempfile.mkdtemp(prefix="chip_smoke_cli_")
    try:
        logs = os.path.join(cli_work, "logs")
        drive = ["--synthetic-data", "--train-num-samples", "192", "--val-num-samples", "64",
                 "--batch-size", "64", "--epochs", "1", "--warmup", "2", "--lr", "1e-4",
                 "--precision", "amp", "--save-most-recent", "--log-every-n-steps", "1",
                 "--grad-clip-norm", "1.0", "--attn-impl", "flash", "--logs", logs]

        def cli_run(what, argv, raises=None):
            return run_cli(counters, what, argv, raises)

        def has_line(rec, line, what):
            if line not in rec["lines"]:
                fail(f"cli {what}: no log line {line!r} among {rec['lines'][:40]}")

        def check_steps(rec, what, n, want_step, want_eval):
            # 64 validation samples: one batch of 64
            check_cli_steps(rec, what, n, want_step, want_eval, eval_batches=1)

        # (a) a converted checkpoint: full-width BiomedCLIP from seed 1 written as the
        # .npz of tools/convert_weights.py with numpy alone, loaded into seed 2's model
        kw = dict(is_clip=True, attn_impl="flash")
        model_a, fns_a, _ = make_serving_fns(
            "biomedclip", generator=torch.Generator().manual_seed(1), **kw)
        npz = os.path.join(cli_work, "biomedclip_converted.npz")
        t0 = time.perf_counter()
        write_converted_npz(model_a, npz)
        npz_write_s = time.perf_counter() - t0
        npz_bytes = os.path.getsize(npz)
        model_b, _, _ = make_serving_fns(
            "biomedclip", generator=torch.Generator().manual_seed(2), **kw)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        load_torch_clip(npz, model_b)
        torch.cuda.synchronize()
        npz_load_s = time.perf_counter() - t0
        stage_u8 = torch.from_numpy(np.random.RandomState(3).randint(
            0, 256, (64, 256, 256, 3), dtype=np.uint8)).to("cuda")
        emb_a = fns_a["image_embed"](model_a, stage_u8)
        emb_b = fns_a["image_embed"](model_b, stage_u8)
        converted_diff = float((emb_a - emb_b).abs().max())
        say(f"cli converted checkpoint: {npz_bytes} bytes written in {npz_write_s:.2f} s, "
            f"loaded in {npz_load_s:.2f} s; image_embed of a batch-64 staging batch, seed 2 "
            f"loaded against seed 1: max |diff| {converted_diff}")
        if not torch.equal(emb_a, emb_b):
            fail(f"cli: the converted checkpoint's image_embed differs by {converted_diff}")
        del model_a, model_b, fns_a, emb_a, emb_b, stage_u8

        # (b) stage 1 from the converted weights, the run named by the CLI
        s1 = cli_run("stage 1", drive + ["--stage", "1", "--pretrained", npz,
                                         "--tokenizer", "hash"])
        has_line(s1, "Model parameters: 195.71M", "stage 1")
        has_line(s1, f"Loaded pretrained CLIP weights from {npz}", "stage 1")
        check_steps(s1, "stage 1", 3, {"fwd": 24, "dkv": 24, "dq": 24}, {"fwd": 24})
        if not 3.0 <= s1["steps"][0]["loss"] <= 6.0:
            fail(f"cli stage 1: first loss {s1['steps'][0]['loss']} outside [3, 6] "
                 "(ln 64 = 4.159)")
        (s1_name,) = os.listdir(logs)
        s1_dir = os.path.join(logs, s1_name)
        s1_files = sorted(os.listdir(os.path.join(s1_dir, "checkpoints")))
        if not os.path.isfile(os.path.join(s1_dir, "params.txt")) or s1_files != [
                "results.jsonl", "stage_1_epoch_1", "stage_1_epoch_latest"]:
            fail(f"cli stage 1: {s1_name} holds {os.listdir(s1_dir)}, checkpoints {s1_files}")

        # (c) stage 2, which finds stage 1's run by itself
        s2_argv = drive + ["--stage", "2", "--name", "s2", "--tokenizer", "hash"]
        s2 = cli_run("stage 2", s2_argv)
        s1_latest = os.path.join(s1_dir, "checkpoints", "stage_1_epoch_latest")
        has_line(s2, f"Loaded stage-1 weights from {s1_latest}", "stage 2")
        check_steps(s2, "stage 2", 3, {"fwd": 24}, {"fwd": 24})
        s2_dir = os.path.join(logs, "s2", "checkpoints")
        p1 = torch.load(os.path.join(s1_latest, "state.pt"), weights_only=True)["params"]
        p2 = torch.load(os.path.join(s2_dir, "stage_2_epoch_latest", "state.pt"),
                        weights_only=True)["params"]
        moved = [k for k, v in p1.items() if not torch.equal(p2[f"clip.{k}"], v)]
        if moved or not any(k.startswith("fc") for k in p2):
            fail(f"cli stage 2: {len(moved)} clip.* parameters differ from stage 1's: "
                 f"{moved[:5]}")
        del p1, p2
        pauc2 = s2["metrics"].get("partial_auc", float("nan"))
        if not (np.isfinite(s2["metrics"]["val_loss"]) and 0.0 <= pauc2 <= 0.2):
            fail(f"cli stage 2: metrics {s2['metrics']}")
        s2_files = sorted(os.listdir(s2_dir))
        if s2_files != ["results.jsonl", "stage_2_epoch_1", "stage_2_epoch_latest"]:
            fail(f"cli stage 2: checkpoints {s2_files}")

        # (d) the finished stage-2 run resumed: it evaluates the restored state
        with open(os.path.join(s2_dir, "results.jsonl")) as f:
            row = [json.loads(line) for line in f][-1]
        rs = cli_run("stage 2 --resume latest", s2_argv + ["--resume", "latest"])
        has_line(rs, "Resuming from latest checkpoint: "
                 f"{os.path.join(s2_dir, 'stage_2_epoch_1')}", "resume")
        resume_diff = {k: abs(rs["metrics"][k] - row[k]) for k in ("val_loss", "partial_auc")}
        say(f"cli resume: val_loss and partial_auc against stage 2's last row: {resume_diff}")
        if rs["total"]["dkv"] or rs["total"]["dq"] or any(resume_diff.values()):
            fail(f"cli resume: launches {rs['total']}, metrics {rs['metrics']} against {row}")
        check_steps(rs, "resume", 0, {}, {"fwd": 24})

        # (e) the medmamba classifier (CE), which is also SKILL.md's third probe:
        # --resume latest with nothing to resume from logs its line and runs
        mm_argv = drive + ["--model-stage-1", "medmamba", "--train-num-samples", "128",
                           "--name", "mm"]
        mm = cli_run("medmamba", mm_argv + ["--resume", "latest"])
        has_line(mm, "Model parameters: 8.53M", "medmamba")
        has_line(mm, "No latest checkpoint found; starting fresh.", "medmamba")
        check_steps(mm, "medmamba", 2, {"scan_fwd": 14, "scan_bwd": 14}, {"scan_fwd": 14})

        # (f) the other error probes, message for message
        probes = {}
        for what, argv, exc, want in (
                ("--precision bogus", drive + ["--precision", "bogus"], ValueError,
                 f"ValueError: unknown precision 'bogus'; one of {sorted(_POLICIES)}"),
                ("a reused --name", mm_argv, FileExistsError,
                 "FileExistsError: Experiment mm already exists; use --name or --resume."),
                ("--stage 2 --resume latest, empty logs",
                 drive[:-1] + [os.path.join(cli_work, "empty"), "--stage", "2", "--resume",
                               "latest", "--tokenizer", "hash"], FileNotFoundError,
                 "FileNotFoundError: stage 2 has nothing to start from")):
            rec = cli_run(what, argv, raises=exc)
            if not rec["error"].startswith(want) or rec["total"] != no_launch:
                fail(f"cli probe {what}: {rec['error']!r} (launches {rec['total']}), "
                     f"expected {want!r}")
            probes[what] = rec["error"]
    finally:
        shutil.rmtree(cli_work, ignore_errors=True)

    runs = {"stage1": s1, "stage2": s2, "resume": rs, "medmamba": mm}
    launches = {k: sum(r["total"][k] for r in runs.values()) for k in no_launch}
    bodies = {k: {b: sum(r["total_bodies"][k][b] for r in runs.values())
                  for b in ("tensor_cores", "cuda_cores")} for k in ("fwd", "dkv", "dq")}

    def summary(rec, per):
        # the loop's batch meter, one logged step a line
        ms = [1e3 * float(m.group(1)) for m in
              (re.search(r" batch: ([0-9.]+)s", line) for line in rec["lines"]) if m]
        out = {"wall_s": rec["wall_s"], "steps": len(rec["steps"]), "batch_ms_by_step": ms,
               "save_s": rec["saves"], "eval_rows_per_s": [64 / ev["s"] for ev in rec["evals"]],
               "launches_per_step": rec["steps"][0]["launches"] if rec["steps"] else None,
               "launches_per_eval_batch": rec["evals"][0]["launches"],
               "metrics": rec["metrics"]}
        if ms:
            out.update(ms_per_step=ms[-1], first_loss=rec["steps"][0]["loss"],
                       **{per: 64e3 / ms[-1]})
        return out

    line = {"card": card,
            "converted": {"npz_bytes": npz_bytes, "write_s": npz_write_s,
                          "load_s": npz_load_s, "image_embed_max_abs_diff": converted_diff},
            "stage1": summary(s1, "pairs_per_s"), "stage2": summary(s2, "img_per_s"),
            "resume": {**summary(rs, "img_per_s"), "diff_to_stage2_row": resume_diff},
            "medmamba": summary(mm, "img_per_s"), "probes": probes, "launches": launches}
    return line, launches, bodies


def http_request(srv, method, path, body=None):
    """(status, body) of one request to ``srv`` over loopback."""
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", srv.server_address[1], timeout=120)
    try:
        conn.request(method, path, body=body)
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


def http_load(srv, path, bodies, cands, clients, seconds, tol, exact_buckets):
    """Closed-loop clients on ``srv`` for ``seconds``, each with one request
    outstanding, client j posting ``bodies[(j + k) % n]`` as its k-th.
    ``cands[i]`` maps a batch shape to body i's answer when the entry point
    is called on its row repeated to that shape. Every answer must be a 200,
    bit for bit ``cands[i][b]`` for some ``b`` in ``exact_buckets`` (so that
    an answer taken from another row cannot pass, the rows' candidates being
    pairwise different) and within ``tol`` of ``cands[i][1]``, the direct
    call of its row, or the phase fails. Returns the latency percentiles,
    requests, requests/s and the largest distance to the direct call."""
    import http.client

    import numpy as np

    key = {"/embed_image": "embedding", "/embed_text": "embeddings", "/classify": "probs"}[path]
    lats, bad, errs = [], [], [0.0]
    deadline = time.monotonic() + seconds

    def client(j):
        conn = http.client.HTTPConnection("127.0.0.1", srv.server_address[1], timeout=120)
        k = 0
        try:
            while time.monotonic() < deadline:
                i = (j + k) % len(bodies)
                k += 1
                t0 = time.perf_counter()
                conn.request("POST", path, body=bodies[i])
                resp = conn.getresponse()
                body = resp.read()
                dt = time.perf_counter() - t0
                if resp.status != 200:
                    bad.append(f"{resp.status}: {body[:300]!r}")
                    continue
                direct = cands[i][1]
                got = np.asarray(json.loads(body)[key], np.float32).reshape(direct.shape)
                err = float(np.abs(got - direct).max())
                errs.append(err)
                if not err <= tol:
                    bad.append(f"body {i}: off its direct call by {err:.3e} (bound {tol:g})")
                if not any(np.array_equal(got, cands[i][b]) for b in exact_buckets):
                    bad.append(f"body {i}: not bit for bit its row's answer at any batch "
                               f"shape of {list(exact_buckets)} (off the direct call by "
                               f"{err:.3e})")
                lats.append(dt)
        except Exception as e:  # reported below; the phase fails
            bad.append(f"client {j}: {e!r}")
        finally:
            conn.close()

    threads = [threading.Thread(target=client, args=(j,)) for j in range(clients)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=seconds + 150)
    wall = time.perf_counter() - t0
    if bad or any(t.is_alive() for t in threads) or not lats:
        fail(f"http {path} at concurrency {clients}: {len(bad)} bad answers, first "
             f"{bad[:3]}, {len(lats)} good; largest distance to the direct call "
             f"{max(errs):.3e}")
    ms = 1e3 * np.asarray(lats)
    return {"clients": clients, "requests": len(lats), "wall_s": wall,
            "req_per_s": len(lats) / wall, "p50_ms": float(np.percentile(ms, 50)),
            "p95_ms": float(np.percentile(ms, 95)), "p99_ms": float(np.percentile(ms, 99)),
            "max_abs_err_to_direct": max(errs)}


def jpeg_rows(n, size, seed):
    """``n`` JPEG bodies (PIL, quality 90) of ``size``-square images that
    differ in kind as well as colour: a flat colour, stripes of a period of
    their own, noise of an amplitude of its own around a colour, a disc of
    a radius of its own. A random-weight model maps noise squares to nearly
    one answer; these keep the rows' answers apart."""
    import io

    import numpy as np

    try:
        from PIL import Image
    except ImportError:
        fail("phase 15 posts JPEG bodies, and PIL, which encodes them, does not import")
    rs = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:size, 0:size]
    bodies = []
    for i in range(n):
        c = rs.randint(0, 256, 3)
        kind = i % 4
        if kind == 0:
            img = np.broadcast_to(c, (size, size, 3))
        elif kind == 1:
            m = ((xx // (2 + 3 * i)) % 2)[..., None]
            img = c * m + (255 - c) * (1 - m)
        elif kind == 2:
            img = c + rs.normal(0, 10 + 10 * i, (size, size, 3))
        else:
            r = size * (0.1 + 0.05 * i)
            m = (((xx - size / 2) ** 2 + (yy - size / 2) ** 2) < r * r)[..., None]
            img = c * m + (255 - c) * (1 - m)
        buf = io.BytesIO()
        Image.fromarray(np.clip(img, 0, 255).astype(np.uint8)).save(buf, format="JPEG",
                                                                     quality=90)
        bodies.append(buf.getvalue())
    return bodies


def serving_phase(card, reset_counts, read_counts, flash_bodies):
    """Phase 15: export and load serving artifacts, then serve them over
    HTTP, each gate as the module docstring says. Every count is set to 0
    just before each call of a loaded artifact (directly or through a
    server) and read just after. Returns (the ``serving_http`` line's
    fields, those calls' launches by counter, their flash launches by
    body)."""
    import numpy as np
    import torch

    from mamba_clip_tpu_torch.data import fastimage
    from mamba_clip_tpu_torch.data.tokenizer import HashTokenizer
    from mamba_clip_tpu_torch.serve import MicroBatcher, _bucket
    from mamba_clip_tpu_torch.serve_http import make_server, warm_buckets
    from mamba_clip_tpu_torch.serving import (compress_params, decompress_params,
                                              export_serving, load_serving, make_serving_fns)

    total = {k: 0 for k in read_counts()}
    total_bodies = {k: {"tensor_cores": 0, "cuda_cores": 0} for k in ("fwd", "dkv", "dq")}

    def counted(fn):
        """``fn()`` with every count set to 0 just before and read just after."""
        reset_counts()
        out = fn()
        torch.cuda.synchronize()
        return out, read_counts(), flash_bodies()

    def check(what, entry, n, counts, bodies):
        """``n`` dispatches of ``entry``: 12 flash forwards each on the tensor
        cores (14 scan forwards for ``classify``) and nothing else. Adds the
        counts to the phase's."""
        want = {k: 0 for k in counts}
        want["scan_fwd" if entry == "classify" else "fwd"] = (
            (14 if entry == "classify" else 12) * n)
        want_bodies = {k: {"tensor_cores": want[k], "cuda_cores": 0} for k in total_bodies}
        if counts != want or bodies != want_bodies:
            fail(f"serving {what}: launches {counts}, by body {bodies}; expected {want} "
                 f"for {n} dispatches of {entry}")
        for k in total:
            total[k] += counts[k]
        for k, by in bodies.items():
            for body, c in by.items():
                total_bodies[k][body] += c

    def call(what, entry, fn):
        out, counts, bodies = counted(fn)
        check(what, entry, 1, counts, bodies)
        return out

    work = tempfile.mkdtemp(prefix="chip_smoke_serving_")
    servers = []
    try:
        clip_kw = dict(is_clip=True, precision="amp")  # an artifact runs the flash interior
        clip, cfns, cmeta = make_serving_fns(
            "biomedclip", device="cuda", generator=torch.Generator().manual_seed(0),
            attn_impl="flash", **clip_kw)
        mm, mfns, mmeta = make_serving_fns(
            "medmamba", precision="amp", device="cuda", generator=torch.Generator().manual_seed(0))
        inproc = {"image_embed": lambda x: cfns["image_embed"](clip, x),
                  "text_embed": lambda x: cfns["text_embed"](clip, x),
                  "classify": lambda x: mfns["classify"](mm, x)}

        # (a) export and load
        arts = {}
        for name, model_name, model, kw, compress in (
                ("clip_raw", "biomedclip", clip, clip_kw, False),
                ("clip_int8", "biomedclip", clip, clip_kw, True),
                ("medmamba_raw", "medmamba", mm, dict(precision="amp"), False)):
            out = os.path.join(work, name)
            t0 = time.perf_counter()
            man = export_serving(out, model_name, variables=model.state_dict(),
                                 compress_weights=compress, **kw)
            export_s = time.perf_counter() - t0
            nbytes = sum(os.path.getsize(os.path.join(out, f)) for f in os.listdir(out)
                         if os.path.isfile(os.path.join(out, f)))
            t0 = time.perf_counter()
            served = load_serving(out, device="cuda")
            torch.cuda.synchronize()
            load_s = time.perf_counter() - t0
            arts[name] = {"dir": out, "served": served, "bytes": nbytes,
                          "params_bytes": os.path.getsize(os.path.join(out, "params.pt")),
                          "export_s": export_s, "load_s": load_s, "weights": man["weights"],
                          "parameters": sum(p.numel() for p in model.parameters())}
            say(f"serving artifact {name}: {nbytes} B ({arts[name]['params_bytes']} B of "
                f"weights, {man['weights']}), exported in {export_s:.3f} s, loaded onto the "
                f"card in {load_s:.3f} s; entry points {sorted(man['entry_points'])}")

        # (b) loaded against in-process, batch 64
        rs = np.random.RandomState(10)
        S, Sm = cmeta["staging_size"], mmeta["staging_size"]
        texts = [REPORTS[i % len(REPORTS)] * (1 + i % 5) for i in range(64)]
        inputs = {
            "image_embed": torch.from_numpy(
                rs.randint(0, 256, (64, S, S, 3), dtype=np.uint8)).cuda(),
            "text_embed": torch.from_numpy(
                HashTokenizer(context_length=cmeta["context_length"])(texts)).cuda(),
            "classify": torch.from_numpy(
                rs.randint(0, 256, (64, Sm, Sm, 3), dtype=np.uint8)).cuda()}
        for name, x in inputs.items():  # first calls: cuBLAS set-up, not counted
            inproc[name](x)
        raw_out = {}
        for art, names in (("clip_raw", ("image_embed", "text_embed")),
                           ("medmamba_raw", ("classify",))):
            for name in names:
                got = call(f"{art} {name}", name,
                           lambda: arts[art]["served"][name](inputs[name]))
                want = inproc[name](inputs[name])
                if not torch.equal(got, want):
                    fail(f"{art} {name}: the loaded artifact differs from make_serving_fns "
                         f"by {float((got - want).abs().max()):.3e}")
                if not torch.isfinite(got).all() or got.shape[0] != 64:
                    fail(f"{art} {name}: bad output {tuple(got.shape)}")
                raw_out[name] = got
        stored = torch.load(os.path.join(arts["clip_int8"]["dir"], "params.pt"),
                            weights_only=True)
        again = compress_params(clip.state_dict(), clip)
        if stored.keys() != again.keys() or not all(torch.equal(stored[k], again[k].cpu())
                                                     for k in stored):
            fail("the compressed artifact's tensors differ from compress_params of the "
                 "raw weights")
        n_int8 = sum(1 for k in stored if k.endswith(".__int8_cols__"))
        clip.load_state_dict(decompress_params(stored))  # the in-process model, decompressed
        cos = {}
        for name in ("image_embed", "text_embed"):
            got = call(f"clip_int8 {name}", name,
                       lambda: arts["clip_int8"]["served"][name](inputs[name]))
            want = inproc[name](inputs[name])
            if not torch.equal(got, want):
                fail(f"clip_int8 {name}: differs from the in-process model given the "
                     f"decompressed weights by {float((got - want).abs().max()):.3e}")
            cos[name] = float((got * raw_out[name]).sum(-1).min())
        say(f"serving: the loaded artifacts bit for bit equal to make_serving_fns "
            f"(image_embed, text_embed, classify at batch 64); {n_int8} int8 tensors equal "
            f"to compress_params; lowest cosine compressed to raw {cos} (bound 0.999)")
        if not all(c > 0.999 for c in cos.values()):
            fail(f"the compressed artifact's embeddings: lowest cosine {cos}, bound 0.999")
        del clip, mm, cfns, mfns, inproc, stored, again, raw_out, inputs
        for a in arts.values():
            a.pop("served")
        gc.collect()
        torch.cuda.empty_cache()

        # (c) the HTTP host over each raw artifact: one request a device
        # call, and the MicroBatcher at its default max_batch
        hosts = {}
        for art in ("clip_raw", "medmamba_raw"):
            for max_batch in (1, 16):
                srv = make_server(arts[art]["dir"], port=0, host="127.0.0.1",
                                  max_batch=max_batch, device="cuda")
                threading.Thread(target=srv.serve_forever, daemon=True).start()
                servers.append(srv)
                hosts[art, max_batch] = srv
                status, body = http_request(srv, "GET", "/healthz")
                health = json.loads(body) if status == 200 else {}
                if health.get("status") != "ok" or health["manifest"]["weights"] != "raw":
                    fail(f"/healthz of {art} (max_batch {max_batch}): {status} {body[:300]!r}")
        # 16 JPEG bodies an image endpoint, 16 texts of distinct openings
        pools = {"image_embed": jpeg_rows(16, S, 11), "classify": jpeg_rows(16, Sm, 12),
                 "text_embed": [json.dumps({"texts": [f"Case {i}. {t}"]}).encode()
                                for i, t in enumerate(texts[:16])]}
        shapes = sorted({_bucket(1 << k) for k in range(5)})  # the batcher's, up to 16
        endpoints = {}
        for name, path, art in (("image_embed", "/embed_image", "clip_raw"),
                                ("text_embed", "/embed_text", "clip_raw"),
                                ("classify", "/classify", "medmamba_raw")):
            one, many = hosts[art, 1], hosts[art, 16]
            tol = SERVE_BATCHED_ATOL[name]

            def row_of(body, srv=one, name=name):
                """The entry point's input row of one request body, as the host makes it."""
                if name == "text_embed":
                    return np.asarray(srv.served["tokenize"](json.loads(body)["texts"]))
                return srv.decode(body)[None]

            # each body's answer at every batch shape the batcher dispatches:
            # its row repeated to that shape, the first row's answer kept
            cands = []
            for body in pools[name]:
                x = row_of(body)
                by_shape = {}
                for b in shapes:
                    out = call(f"{name} direct call at batch {b}", name,
                               lambda x=x, b=b: one.served[name](np.repeat(x, b, axis=0)))
                    by_shape[b] = out[:1].cpu().numpy()
                    if name != "text_embed":  # an image's answer is its row; texts' a list
                        by_shape[b] = by_shape[b][0]
                cands.append(by_shape)
            shape_noise = max(float(np.abs(c[b] - c[1]).max()) for c in cands for b in shapes)
            apart = min(float(np.abs(ci[1] - cj[1]).max())
                        for i, ci in enumerate(cands) for cj in cands[:i])
            shared = [(i, j) for i, ci in enumerate(cands) for j, cj in enumerate(cands[:i])
                      if any(np.array_equal(ci[b], cj[c]) for b in shapes for c in shapes)]
            say(f"http {path}: 16 rows; their answers at batch {shapes} lie within "
                f"{shape_noise:.3e} of the direct call (bound {tol:g}); the closest two rows' "
                f"direct answers {apart:.3e} apart; rows sharing an answer: {shared}")
            if shared or not shape_noise <= tol:
                fail(f"http {path}: rows {shared} share an answer, or the batch shapes move an "
                     f"answer by {shape_noise:.3e} (bound {tol:g}): a request answered from "
                     "another row could pass")
            # one request a device call: bit for bit the direct call of its row
            r, counts, bodies = counted(
                lambda: http_load(one, path, pools[name], cands, 1, 1.0, 0.0, (1,)))
            check(f"{name} max_batch=1", name, r["requests"], counts, bodies)
            res = {"max_batch_1": r, "batch_shape_noise": shape_noise,
                   "closest_rows_apart": apart}
            # the MicroBatcher: each bucket shape once, then 1, 4 and 16 clients
            mb = many.batchers[name]
            warm = ([json.loads(pools[name][0])["texts"][0]] if name == "text_embed"
                    else pools[name][0])
            n_shapes, counts, bodies = counted(lambda: warm_buckets(many, name, warm, 16))
            check(f"{name} warm_buckets", name, n_shapes, counts, bodies)
            for clients in (1, 4, 16):
                r0, b0, k0 = mb.requests, mb.batches, len(mb.batch_rows)
                r, counts, bodies = counted(lambda: http_load(
                    many, path, pools[name], cands, clients, 2.0, tol, shapes))
                n_batches = mb.batches - b0
                check(f"{name} at concurrency {clients}", name, n_batches, counts, bodies)
                if mb.requests - r0 != r["requests"]:
                    fail(f"{name}: the batcher answered {mb.requests - r0} requests, the "
                         f"clients counted {r['requests']}")
                r.update(batches=n_batches, requests_per_batch=r["requests"] / n_batches,
                         padded_rows_per_batch=float(np.mean(mb.batch_rows[k0:])))
                res[f"c{clients}"] = r
                say(f"http {path} clients={clients}: {r['req_per_s']:.1f} req/s, p50 "
                    f"{r['p50_ms']:.2f} p95 {r['p95_ms']:.2f} p99 {r['p99_ms']:.2f} ms, "
                    f"{r['requests_per_batch']:.2f} requests a batch ({n_batches} batches); "
                    f"every answer a 200, bit for bit its row's at a batch shape, at most "
                    f"{r['max_abs_err_to_direct']:.3e} off its direct call (bound {tol:g})")
            say(f"http {path} max_batch=1: {res['max_batch_1']['requests']} requests, p50 "
                f"{res['max_batch_1']['p50_ms']:.2f} ms, each bit for bit its direct call")
            endpoints[name] = res

        # JAX's 404 message for an unknown path; a malformed body is a 400
        srv = hosts["clip_raw", 16]
        probes = {}
        for what, method, path, body, code, want in (
                ("unknown POST", "POST", "/classify", pools["image_embed"][0], 404,
                 "no handler for POST /classify (entry points: ['image_embed', "
                 "'text_embed'])"),
                ("unknown GET", "GET", "/nope", None, 404, "no handler for GET /nope"),
                ("malformed JSON", "POST", "/embed_text", b"not json", 400, None),
                ("truncated JPEG", "POST", "/embed_image", pools["image_embed"][0][:200],
                 400, None)):
            (status, out), counts, bodies = counted(
                lambda: http_request(srv, method, path, body))
            check(what, "image_embed", 0, counts, bodies)
            err = json.loads(out).get("error", "")
            if status != code or (want is not None and err != want) or not err:
                fail(f"http {what}: {status} {out[:300]!r}, expected {code} {want!r}")
            probes[what] = f"{status} {err}"
        say(f"http probes: {probes}")

        for srv in servers:
            srv.shutdown()
            srv.server_close()
        stuck = [name for srv in servers for name, b in srv.batchers.items()
                 if isinstance(b, MicroBatcher) and (b._thread.is_alive()
                                                     or b._completer.is_alive())]
        servers = []
        if stuck:
            fail(f"the batchers of {stuck} still run after server_close")
    finally:
        for srv in servers:
            srv.shutdown()
            srv.server_close()
        shutil.rmtree(work, ignore_errors=True)

    line = {"card": card,
            "artifacts": {name: {k: a[k] for k in ("bytes", "params_bytes", "weights",
                                                   "parameters", "export_s", "load_s")}
                          for name, a in arts.items()},
            "int8_tensors": n_int8, "lowest_cosine_int8_to_raw": cos,
            "fastimage_available": fastimage.available(),
            "pil_available": importlib.util.find_spec("PIL") is not None, "payload": "jpeg",
            "max_batch": 16, "max_delay_ms": 5.0, "endpoints": endpoints, "probes": probes,
            "launches": total}
    return line, total, total_bodies


def write_isic_layout(data_dir, n_train, n_test, side, seed):
    """An ISIC-2024 layout under ``data_dir``: ``train-metadata.csv``
    (``synthetic_metadata(n_train, seed)``), a label-free
    ``test-metadata.csv`` of ``n_test`` rows with ids of their own, and
    ``train-image/image/<isic_id>.jpg`` for every id: ``side``-square JPEGs
    (PIL, quality 92) of a smooth field, bicubic from a 4 x 4 grid, with
    noise of +-3 levels, written by 8 threads. Both CSVs are written with
    the csv module (``write_csv``, pandas' ``to_csv`` text). Returns (the
    test ids, the JPEGs' sizes in bytes)."""
    import io

    import numpy as np
    from PIL import Image

    from mamba_clip_tpu_torch.data.dataset import ColumnTable, synthetic_metadata
    from mamba_clip_tpu_torch.data.metadata import write_csv

    img_dir = os.path.join(data_dir, "train-image", "image")
    os.makedirs(img_dir)
    train = synthetic_metadata(n_train, seed)
    write_csv(train, os.path.join(data_dir, "train-metadata.csv"))
    rows = synthetic_metadata(n_test, seed + 1)
    test_ids = [f"ISIC_9{i:06d}" for i in range(n_test)]
    write_csv(ColumnTable({"isic_id": test_ids, **{
        c: rows[c] for c in rows.columns if c not in ("isic_id", "target")}}),
        os.path.join(data_dir, "test-metadata.csv"))
    ids = list(train["isic_id"]) + test_ids

    def write(k):
        rng = np.random.default_rng((seed, k))
        grid = Image.fromarray(rng.integers(0, 256, (4, 4, 3), dtype=np.uint8))
        field = np.asarray(grid.resize((side, side), Image.BICUBIC), np.int16)
        noisy = field + rng.integers(-3, 4, (side, side, 3), dtype=np.int16)
        buf = io.BytesIO()
        Image.fromarray(np.clip(noisy, 0, 255).astype(np.uint8)).save(buf, format="JPEG",
                                                                       quality=92)
        with open(os.path.join(img_dir, f"{ids[k]}.jpg"), "wb") as f:
            f.write(buf.getvalue())
        return len(buf.getvalue())

    with ThreadPoolExecutor(8) as pool:
        sizes = list(pool.map(write, range(len(ids))))
    return test_ids, sizes


def real_data_phase(card, reset_counts, read_counts, flash_bodies, synthetic):
    """Phase 16: the README's recipe on files in the ISIC-2024 layout
    (``write_isic_layout``: 640 train rows, 64 label-free test rows, 1024-px
    JPEGs) through the CLI's main(), full-width BiomedCLIP under
    ``--attn-impl flash`` at batch 64, ``--workers 4``: (a) stage 1,
    ``--undersample 320 --add-remaining-samples --cache-staging``, 2 epochs
    (the first decodes the JPEGs, the second reads the staging cache);
    (b) stage 2 from (a)'s run, 1 epoch; (c) ``--is-test --stage 2
    --resume latest`` on (b)'s run, which writes ``submission.csv``. Gates
    as the module docstring says. ``synthetic``: phases 12-14's figures,
    printed beside this phase's. Returns (the ``real_data`` line's fields,
    the runs' launches by counter, their flash launches by body)."""
    import csv
    import hashlib

    import numpy as np

    from mamba_clip_tpu_torch import pipeline as port_pipeline
    from mamba_clip_tpu_torch.config import parse_args
    from mamba_clip_tpu_torch.data.dataset import IsicChallengeDataset
    from mamba_clip_tpu_torch.data.loader import get_data
    from mamba_clip_tpu_torch.data.metadata import get_metadata, undersample_data
    from mamba_clip_tpu_torch.data.tokenizer import HashTokenizer

    if importlib.util.find_spec("PIL") is None:
        say("real data: SKIPPED: phase 16 writes and decodes JPEGs with PIL, which is not "
            "installed; the ISIC recipe did not run")
        fail("phase 16 (the recipe on real files) cannot run without PIL")
    counters = (reset_counts, read_counts, flash_bodies)
    work = tempfile.mkdtemp(prefix="chip_smoke_real_")
    try:
        data_dir = os.path.join(work, "isic")
        t0 = time.perf_counter()
        test_ids, sizes = write_isic_layout(data_dir, 640, 64, 1024, seed=16)
        write_s = time.perf_counter() - t0
        say(f"real data: wrote {len(sizes)} 1024-px JPEGs (quality 92), mean "
            f"{np.mean(sizes):.0f} bytes (min {min(sizes)}, max {max(sizes)}), and both "
            f"CSVs in {write_s:.1f} s")
        base = ["--data-path", f"{data_dir}/", "--batch-size", "64", "--workers", "4",
                "--warmup", "2", "--lr", "1e-4", "--precision", "amp", "--save-most-recent",
                "--save-frequency", "0", "--log-every-n-steps", "1", "--grad-clip-norm", "1.0",
                "--attn-impl", "flash", "--tokenizer", "hash", "--undersample", "320",
                "--add-remaining-samples", "--cache-staging", os.path.join(work, "cache"),
                "--logs", os.path.join(work, "logs")]
        argv = {"stage1": base + ["--stage", "1", "--epochs", "2"],
                "stage2": base + ["--stage", "2", "--epochs", "1", "--name", "s2"],
                "is_test": base + ["--stage", "2", "--epochs", "1", "--name", "s2",
                                   "--is-test", "--resume", "latest"]}
        # the splits the port's metadata layer gives for these flags
        args = parse_args(argv["stage1"])
        train_md, val_md, _ = get_metadata(args)
        train_md, val_md = undersample_data(args, train_md, val_md)
        want_sizes = {"train": len(train_md), "val": len(val_md)}

        # observers, as observe_cli's: get_metadata's seconds, the splits
        # get_data made, and each staging square decoded or read from the cache
        seen = {"metadata_s": [], "splits": [], "decoded": {}, "hits": [], "decode_s": []}
        lock = threading.Lock()
        orig = {"get_metadata": port_pipeline.get_metadata, "get_data": port_pipeline.get_data,
                "load": IsicChallengeDataset._load_image}

        def timed_metadata(*a, **k):
            t0 = time.perf_counter()
            out = orig["get_metadata"](*a, **k)
            seen["metadata_s"].append(time.perf_counter() - t0)
            return out

        def sized_data(*a, **k):
            out = orig["get_data"](*a, **k)
            seen["splits"].append({s: len(d.loader.dataset) for s, d in out.items()})
            return out

        def load(self, isic_id, idx=None):
            hit = self.cache is not None and idx is not None and bool(self.cache.done[idx])
            t0 = time.perf_counter()
            out = orig["load"](self, isic_id, idx)
            dt = time.perf_counter() - t0
            digest = hashlib.sha1(np.ascontiguousarray(out)).hexdigest()
            with lock:
                if hit:
                    seen["hits"].append(((self.is_train, isic_id), digest))
                else:
                    seen["decoded"][(self.is_train, isic_id)] = digest
                    seen["decode_s"].append(dt)
            return out

        port_pipeline.get_metadata, port_pipeline.get_data = timed_metadata, sized_data
        IsicChallengeDataset._load_image = load
        runs = {}
        try:
            for name in ("stage1", "stage2", "is_test"):
                n_hits, n_dec = len(seen["hits"]), len(seen["decode_s"])
                runs[name] = run_cli(counters, f"real data {name}", argv[name])
                hits = seen["hits"][n_hits:]
                runs[name]["hits"] = {"train": sum(1 for (tr, _), _ in hits if tr),
                                      "eval": sum(1 for (tr, _), _ in hits if not tr)}
                runs[name]["decodes"] = len(seen["decode_s"]) - n_dec
                runs[name]["decode_ms"] = 1e3 * float(np.mean(seen["decode_s"][n_dec:] or [0]))
        finally:
            port_pipeline.get_metadata, port_pipeline.get_data = (orig["get_metadata"],
                                                                  orig["get_data"])
            IsicChallengeDataset._load_image = orig["load"]

        # gates: the launches of phase 14 a step and a batch, on the tensor cores
        n_val_batches = -(-want_sizes["val"] // 64)
        check_cli_steps(runs["stage1"], "real data stage 1", 2 * (want_sizes["train"] // 64),
                        {"fwd": 24, "dkv": 24, "dq": 24}, {"fwd": 24}, n_val_batches)
        check_cli_steps(runs["stage2"], "real data stage 2", want_sizes["train"] // 64,
                        {"fwd": 24}, {"fwd": 24}, n_val_batches)
        check_cli_steps(runs["is_test"], "real data --is-test", 0, {}, {"fwd": 24}, 1)
        # the splits each run built
        splits = seen["splits"]
        if splits != [want_sizes, want_sizes, {"test": 64}]:
            fail(f"real data: the runs built splits {splits}; get_metadata -> "
                 f"undersample_data give {want_sizes} and the test CSV 64 rows")
        # epoch 2 (and stage 2) read the squares epoch 1 decoded, bit for bit.
        # Each epoch draws (train // 64) * 64 of the train rows, so at least
        # twice that less the split's size were drawn in both epochs; the
        # second evaluation reads every validation square from the cache.
        wrong = [key for key, d in seen["hits"] if seen["decoded"].get(key) != d]
        hits1 = runs["stage1"]["hits"]
        drawn = (want_sizes["train"] // 64) * 64
        if (wrong or hits1["train"] < 2 * drawn - want_sizes["train"]
                or hits1["eval"] != want_sizes["val"] or runs["stage2"]["decodes"]):
            fail(f"real data: {len(wrong)} cached squares differ from (or were never) their "
                 f"decodes, e.g. {wrong[:3]}; stage 1 read {hits1} from the cache (at least "
                 f"{2 * drawn - want_sizes['train']} train, {want_sizes['val']} eval); stage 2 "
                 f"decoded {runs['stage2']['decodes']} again")
        # submission.csv: the 64 test ids in order, probabilities in [0, 1]
        sub_path = os.path.join(work, "logs", "s2", "checkpoints", "submission.csv")
        with open(sub_path, newline="") as f:
            sub = list(csv.reader(f))
        probs = [float(p) for _, p in sub[1:]]
        if (sub[0] != ["isic_id", "target"] or [r[0] for r in sub[1:]] != test_ids
                or not all(0.0 <= p <= 1.0 for p in probs)):
            fail(f"real data: submission.csv holds {len(sub) - 1} rows, header {sub[0]}, "
                 f"first {sub[1:3]}; expected the 64 test ids in order with probabilities "
                 "in [0, 1]")
        if runs["is_test"]["metrics"].get("num_samples") != 64:
            fail(f"real data --is-test: metrics {runs['is_test']['metrics']}")

        # the train loader alone, as stage 1 builds it, over one epoch's
        # batches twice: decoding the JPEGs (and filling a new cache), then
        # reading that cache
        info = get_data(args.replace(cache_staging=os.path.join(work, "cache_alone")),
                        train_metadata=train_md, val_metadata=val_md,
                        tokenizer=HashTokenizer(), staging_size=256)["train"]
        loader_ms = {}
        for source in ("jpeg_decode", "staging_cache"):
            info.set_epoch(0)
            t0 = time.perf_counter()
            n = sum(1 for _ in info.loader)
            loader_ms[source] = 1e3 * (time.perf_counter() - t0) / n
        say(f"real data: the train loader alone, {n} batches of 64 at --workers 4: "
            f"{loader_ms['jpeg_decode']:.1f} ms a batch decoding JPEGs, "
            f"{loader_ms['staging_cache']:.1f} ms from the staging cache")
    finally:
        shutil.rmtree(work, ignore_errors=True)

    def meters(rec):
        """The loop's meters by epoch: the batch meter of each step, the
        data meter (the epoch's mean wait for a batch) at its last step."""
        out = {}
        for line in rec["lines"]:
            m = re.match(r"Train Epoch: (\d+) .* data: ([0-9.]+)s batch: ([0-9.]+)s", line)
            if m:
                ep = out.setdefault(int(m.group(1)), {"batch_ms_by_step": []})
                ep["batch_ms_by_step"].append(1e3 * float(m.group(3)))
                ep["data_s"] = float(m.group(2))
        for ep in out.values():
            ms = ep["batch_ms_by_step"]
            ep.update(ms_per_step=ms[-1], ms_per_step_after_first=float(np.mean(ms[1:] or ms)))
        return out

    rows = {"stage1": want_sizes["val"], "stage2": want_sizes["val"], "is_test": 64}
    line = {"card": card, "jpeg_bytes_mean": float(np.mean(sizes)), "jpegs": len(sizes),
            "write_s": write_s, "splits": want_sizes, "get_metadata_s": seen["metadata_s"],
            "loader_alone_ms_per_batch": loader_ms, "synthetic": synthetic}
    for name, rec in runs.items():
        line[name] = {
            "wall_s": rec["wall_s"], "steps": len(rec["steps"]),
            "epochs": meters(rec), "decodes": rec["decodes"], "cache_reads": rec["hits"],
            "decode_ms_per_img_in_loop": rec["decode_ms"],
            "eval_s": [ev["s"] for ev in rec["evals"]],
            "eval_rows_per_s": [rows[name] / ev["s"] for ev in rec["evals"]],
            "save_s": rec["saves"], "metrics": rec["metrics"],
            "losses": [st["loss"] for st in rec["steps"]]}
    launches = {k: sum(r["total"][k] for r in runs.values()) for k in runs["stage1"]["total"]}
    bodies = {k: {b: sum(r["total_bodies"][k][b] for r in runs.values())
                  for b in ("tensor_cores", "cuda_cores")} for k in ("fwd", "dkv", "dq")}
    return line, launches, bodies


def _dot_internals(name, xs, g):
    """The int8 operands and int32 accumulators of the dot ``name`` on the
    inputs ``xs`` and the cotangent ``g``, by the port's own helpers, on
    their device: {what: tensor}."""
    from mamba_clip_tpu_torch.ops import qdot as q

    out = {}
    if name in ("dense", "delayed", "serve"):
        lhs, rhs = xs[0], xs[1]
        if name == "dense":
            sl, sr = q._absmax_scale(lhs), q._absmax_scale(rhs)
        elif name == "delayed":
            sl, sr = xs[2], xs[3]
        else:
            sl, sr = q._absmax_scale(lhs), q._absmax_scale_cols(rhs)
        ql, qr = q._quantize(lhs, sl), q._quantize(rhs, sr)
        out.update(lhs8=ql, rhs8=qr, lhs_scale=sl, rhs_scale=sr, acc=q._dense_acc(ql, qr))
        if name != "serve":
            qg = q._quantize(g, q._absmax_scale(g))
            out.update(g8=qg, dlhs_acc=q._dense_dlhs_acc(qg, qr),
                       drhs_acc=q._dense_drhs_acc(ql, qg))
        return out
    if name in ("qk", "qk_delayed"):
        if name == "qk":
            (a8, _), (b8, _) = q._q8_bh(xs[0], 2), q._q8_bh(xs[1], 2)
        else:
            a8, b8 = q._quantize(xs[0], xs[2]), q._quantize(xs[1], xs[3])
        g8, _ = q._q8_bh(g, 1)
        out.update(acc=q._ei32("bqhd,bkhd->bhqk", a8, b8),
                   dq_acc=q._ei32("bhqk,bkhd->bqhd", g8, b8),
                   dk_acc=q._ei32("bhqk,bqhd->bkhd", g8, a8))
    else:
        if name == "pv":
            (a8, _), (b8, _) = q._q8_bh(xs[0], 1), q._q8_bh(xs[1], 2)
        else:
            a8, b8 = q._quantize_probs(xs[0]), q._quantize(xs[1], xs[2])
        g8, _ = q._q8_bh(g, 2)
        out.update(acc=q._ei32("bhqk,bkhd->bqhd", a8, b8),
                   dp_acc=q._ei32("bqhd,bkhd->bhqk", g8, b8),
                   dv_acc=q._ei32("bhqk,bqhd->bkhd", a8, g8))
    out.update(a8=a8, b8=b8, g8=g8)
    return out


def quant_phase(card, reset_counts, read_counts, flash_bodies, amp):
    """Phase 17: the native int8 modes, each gate as the module docstring
    says. ``amp``: the unquantized yardsticks of this run (phase 6's
    medmamba step, phase 10's contrastive steps with flash and with the
    einsum interior, in ms). Every count is set to 0 just before each
    driven call and read just after. Returns (the ``quant`` line's fields,
    those calls' launches by counter, their flash launches by body)."""
    from types import SimpleNamespace

    import numpy as np
    import torch

    from mamba_clip_tpu_torch import export_serving as export_cli
    from mamba_clip_tpu_torch.ops import qdot
    from mamba_clip_tpu_torch.profile_train import clip_train_setup, medmamba_train_setup
    from mamba_clip_tpu_torch.serving import load_serving, make_serving_fns, serve_kernels
    from mamba_clip_tpu_torch.train import train_one_epoch

    total = {k: 0 for k in read_counts()}
    total_bodies = {k: {"tensor_cores": 0, "cuda_cores": 0} for k in ("fwd", "dkv", "dq")}
    line = {"card": card}

    def counted(what, fn, want):
        """``fn()`` with every count set to 0 just before and read just after;
        fails unless the launches are ``want`` (the flash ones all on the
        tensor cores); adds them to the phase's."""
        reset_counts()
        out = fn()
        torch.cuda.synchronize()
        counts, bodies = read_counts(), flash_bodies()
        full = {k: want.get(k, 0) for k in counts}
        want_bodies = {k: {"tensor_cores": full[k], "cuda_cores": 0} for k in total_bodies}
        if counts != full or bodies != want_bodies:
            fail(f"quant {what}: launches {counts}, by body {bodies}; expected {full}")
        for k in total:
            total[k] += counts[k]
        for k, by in bodies.items():
            for body, c in by.items():
                total_bodies[k][body] += c
        return out

    # (a) the seven dots, the same inputs on the card and on the CPU, at the
    # contrastive step's shapes: the ViT's qkv Dense (64 x 197 rows of 768 ->
    # 2304) and its attention (64 x 12 heads, T 197, hd 64), fp32
    gen = torch.Generator().manual_seed(17)
    B, T, H, HD, D = 64, 197, 12, 64, 768

    def n(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen) * scale

    def probs(*shape):
        return torch.softmax(n(*shape, scale=2.0), dim=-1)

    def stale(x, f, dims=None):
        """A delayed scale: f times x's absmax (per head with ``dims``) / 127."""
        a = x.abs().amax() if dims is None else x.abs().amax(dim=dims).reshape(1, 1, -1, 1)
        return (f * a / 127.0).float()

    q_, k_, v_ = n(B, T, H, HD), n(B, T, H, HD), n(B, T, H, HD)
    lhs, rhs = n(B, T, D), n(D, 3 * D, scale=0.03)
    cases = {
        "int8_dense_dot": ("dense", qdot.int8_dense_dot, [lhs, rhs], n(B, T, 3 * D)),
        "int8_delayed_dot": ("delayed", qdot.int8_delayed_dot,
                             [lhs, rhs, stale(lhs, 0.8), stale(rhs, 1.2)], n(B, T, 3 * D)),
        "int8_serve_dot": ("serve", qdot.int8_serve_dot, [lhs, rhs], n(B, T, 3 * D)),
        "int8_qk_dot": ("qk", qdot.int8_qk_dot, [q_, k_], n(B, H, T, T)),
        "int8_pv_dot": ("pv", qdot.int8_pv_dot, [probs(B, H, T, T), v_], n(B, T, H, HD)),
        "int8_qk_dot_delayed": ("qk_delayed", qdot.int8_qk_dot_delayed,
                                [q_, k_, stale(q_, 0.7, (0, 1, 3)), stale(k_, 1.1, (0, 1, 3))],
                                n(B, H, T, T)),
        "int8_pv_dot_delayed": ("pv_delayed", qdot.int8_pv_dot_delayed,
                                [probs(B, H, T, T), v_, stale(v_, 0.9, (0, 1, 3))],
                                n(B, T, H, HD)),
    }
    dots = {}
    for fname, (kind, fn, xs, g) in cases.items():
        res = {}
        for dev in ("cpu", "cuda"):
            args = [x.detach().to(dev).requires_grad_(i < 2) for i, x in enumerate(xs)]
            out = fn(*args)
            out.backward(g.to(dev))
            with torch.no_grad():
                ints = _dot_internals(kind, [a.detach() for a in args], g.to(dev))
            res[dev] = ([out.detach().cpu(), args[0].grad.cpu(), args[1].grad.cpu()],
                        {k: t.cpu() for k, t in ints.items()})
        (f_c, i_c), (f_g, i_g) = res["cpu"], res["cuda"]
        unequal = [k for k in i_c if not torch.equal(i_c[k], i_g[k])]
        rels = [float((a - b).abs().max() / b.abs().max()) for a, b in zip(f_g, f_c)]
        # the serve dot's backward is two fp32 GEMMs over dequantized
        # operands, summed in another order on each device
        bounds = [DOT_REL] + [SERVE_GRAD_REL if kind == "serve" else DOT_REL] * 2
        ok = not unequal and all(r <= b for r, b in zip(rels, bounds))
        int_max = max(int(t.abs().max()) for k, t in i_c.items() if t.dtype == torch.int32)
        dots[fname] = {"int8_and_int32_equal": not unequal, "rel_out": rels[0],
                       "rel_grads": rels[1:], "max_abs_int32": int_max,
                       "bit_equal": [torch.equal(a, b) for a, b in zip(f_g, f_c)]}
        say(f"quant dot {fname}: int8 operands and int32 accumulators "
            f"{'equal' if not unequal else 'DIFFER: ' + str(unequal)} ({sorted(i_c)}); out "
            f"rel {rels[0]:.2e}, grads rel {rels[1]:.2e} {rels[2]:.2e} (bounds {bounds}); "
            f"largest |int32| {int_max} {'ok' if ok else 'FAIL'}")
        if not ok:
            fail(f"quant dot {fname}: the card's result differs from the CPU's: int8/int32 "
                 f"unequal {unequal}, rel errs {rels} against {bounds}")
    line["dots"] = dots
    del cases, q_, k_, v_, lhs, rhs

    # (b) classify of full-width medmamba under int8_serve, against the
    # unquantized model on the same weights
    S = 256
    rs = np.random.RandomState(17)
    x64 = torch.from_numpy(rs.randint(0, 256, (64, S, S, 3), dtype=np.uint8)).cuda()
    mq, fq, _ = make_serving_fns("medmamba", quant="int8_serve", precision="amp",
                                 device="cuda", generator=torch.Generator().manual_seed(0))
    mf, ff, _ = make_serving_fns("medmamba", precision="amp", device="cuda",
                                 generator=torch.Generator().manual_seed(0))
    fq["classify"](mq, x64)  # first calls: cuBLAS set-up, not counted
    ff["classify"](mf, x64)
    p_q = counted("classify int8_serve", lambda: fq["classify"](mq, x64), {"scan_fwd": 14})
    p_f = counted("classify amp", lambda: ff["classify"](mf, x64), {"scan_fwd": 14})
    diff = float((p_q - p_f).abs().max())
    ms_q = cuda_ms(lambda: fq["classify"](mq, x64), 10)
    ms_f = cuda_ms(lambda: ff["classify"](mf, x64), 10)
    line["classify"] = {"batch": 64, "int8_serve_ms": ms_q, "amp_ms": ms_f,
                        "ratio": ms_q / ms_f, "max_abs_probs_int8_vs_bf16": diff,
                        "quantized_dots": sum(1 for m in mq.modules()
                                              if qdot.injected(m) is not None)}
    say(f"quant classify int8_serve: {ms_q:.3f} ms a call at batch 64 against {ms_f:.3f} ms "
        f"unquantized ({ms_q / ms_f:.2f}x); probs within {diff:.3e} of the bf16 model's "
        f"(bound {PROBS_ATOL:g}); 14 scan forward launches a call")
    if not torch.isfinite(p_q).all() or not 0.0 < diff <= PROBS_ATOL:
        fail(f"classify under int8_serve: probs {diff:.3e} from the unquantized model's "
             f"(must be above 0 and at most {PROBS_ATOL:g})")
    del mq, mf, fq, ff

    # (c) the contrastive step of full-width BiomedCLIP: int8_fast and
    # int8_delayed with the flash interior, the _attn modes with the einsum
    # interior; 2 warm-up and 3 timed steps each
    steps_line = {}
    for quant, impl in (("int8_fast", "flash"), ("int8_delayed", "flash"),
                        ("int8_fast_attn", "einsum"), ("int8_delayed_attn", "einsum")):
        gc.collect()
        torch.cuda.empty_cache()
        state, step_fn, batches = clip_train_setup(64, attn_impl=impl, quant=quant)
        model = state.model
        torch.cuda.reset_peak_memory_stats()
        per = {"fwd": 24, "dkv": 24, "dq": 24} if impl == "flash" else {}
        scales = qdot.delayed_scales(model)
        if scales:  # the first batch of a fresh run (train_one_epoch's hook)
            state = counted(f"{quant} calibrate_quant",
                            lambda: step_fn.calibrate_quant(state, batches[0], 0),
                            {"fwd": 24} if impl == "flash" else {})
        metrics = []

        def run(st, k):
            for i in range(k):
                st, m = step_fn(st, batches[i % 2], 0)
                metrics.append(m)
            return st

        state = counted(f"{quant} 2 steps", lambda: run(state, 2),
                        {k: 2 * c for k, c in per.items()})
        before = {k: v.clone() for k, v in scales.items()}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state = counted(f"{quant} 3 timed steps", lambda: run(state, 3),
                        {k: 3 * c for k, c in per.items()})
        ms = (time.perf_counter() - t0) / 3 * 1e3
        losses = [float(m["loss"]) for m in metrics]
        if not all(np.isfinite(x) for x in losses) or not 3.0 <= losses[0] <= 6.0:
            fail(f"{quant} steps: losses {losses} (the first within [3, 6])")
        moved = sum(not torch.equal(v, before[k]) for k, v in scales.items())
        if scales and moved == 0:
            fail(f"{quant}: the steps moved no delayed scale")
        if scales:
            model.eval()
            after = {k: v.clone() for k, v in scales.items()}

            def eval_forward():
                with torch.inference_mode():
                    return model.encode_image(torch.zeros(4, 224, 224, 3, dtype=torch.bfloat16,
                                                          device="cuda"))

            counted(f"{quant} eval forward", eval_forward, {"fwd": 12} if impl == "flash" else {})
            if any(not torch.equal(v, after[k]) for k, v in scales.items()):
                fail(f"{quant}: an eval forward wrote a delayed scale")
        ref = amp["clip_flash_ms"] if impl == "flash" else amp["clip_einsum_ms"]
        steps_line[quant] = {"attn_impl": impl, "ms_per_step": ms, "amp_ms_per_step": ref,
                             "ratio": ms / ref, "losses": losses,
                             "delayed_scales": len(scales), "moved_by_the_steps": moved,
                             "peak_bytes": torch.cuda.max_memory_allocated()}
        say(f"quant clip step {quant} ({impl}): {ms:.2f} ms a step against amp {ref:.2f} "
            f"({ms / ref:.2f}x); losses {[round(x, 5) for x in losses]}; "
            f"{moved} of {len(scales)} delayed scales moved by the steps, none by an eval "
            "forward")
        del state, step_fn, batches, model, scales, metrics
    line["clip_steps"] = steps_line

    # (d) the medmamba classifier step under int8_delayed through
    # train_one_epoch: calibrated once, on the first batch; then the largest
    # |int32 accumulator| of one step's Dense dots
    gc.collect()
    torch.cuda.empty_cache()
    state, step_fn, _ = medmamba_train_setup(64, quant="int8_delayed")
    calib = []
    real_calib = step_fn.calibrate_quant

    def spy(st, b, seed):
        calib.append(st.step)
        return real_calib(st, b, seed)

    step_fn.calibrate_quant = spy
    rs = np.random.RandomState(18)
    host_batches = [{"image": rs.randint(0, 256, (64, S, S, 3), dtype=np.uint8),
                     "target": rs.randint(0, 2, (64,))} for _ in range(3)]

    class Loader:
        num_batches, num_samples, start_batch = 3, 192, 0

        def __iter__(self):
            return iter(host_batches)

    data = {"train": SimpleNamespace(loader=Loader(), set_epoch=lambda e: None)}
    loop = SimpleNamespace(checkpoint_steps=0, log_every_n_steps=1)
    meters = {}
    state = counted("medmamba int8_delayed epoch", lambda: train_one_epoch(
        step_fn, state, data, 0, loop, 0, device="cuda", meters=meters),
        {"scan_fwd": 14 * 4, "scan_bwd": 14 * 3})
    if calib != [0]:
        fail(f"calibrate_quant ran at steps {calib}, expected once, at step 0")
    loss = meters["last_metrics"]["loss"]
    if not np.isfinite(loss):
        fail(f"medmamba int8_delayed: loss {loss}")
    acc_max = {}
    real_mm = qdot.int_mm

    def probe(a8, b8):
        acc = real_mm(a8, b8)
        key = f"{tuple(a8.shape)}x{tuple(b8.shape)}"
        acc_max[key] = max(acc_max.get(key, 0), int(acc.abs().max()))
        return acc

    batch = {k: torch.from_numpy(v).cuda() for k, v in host_batches[0].items()}
    qdot.int_mm = probe
    try:
        state = counted("medmamba int8_delayed probed step",
                        lambda: step_fn(state, batch, 0)[0], {"scan_fwd": 14, "scan_bwd": 14})
    finally:
        qdot.int_mm = real_mm
    largest = max(acc_max.values())
    where = max(acc_max, key=acc_max.get)
    line["medmamba_step"] = {"ms_per_step_loop": 1e3 * meters["batch_time_last"],
                             "amp_ms_per_step": amp["medmamba_ms"],
                             "calibrations": calib, "loss_last": loss,
                             "largest_abs_int32": largest, "largest_at": where,
                             "int32_limit": 2**31 - 1, "largest_abs_int32_by_shape": acc_max}
    say(f"quant medmamba int8_delayed: calibrate_quant once, at step {calib[0]}; the loop's "
        f"last step {1e3 * meters['batch_time_last']:.2f} ms (amp step {amp['medmamba_ms']:.2f}); "
        f"largest |int32 accumulator| of a step's Dense products ({len(acc_max)} shapes) "
        f"{largest} at {where} ({largest / 2**31:.2e} of 2^31)")
    del state, step_fn, batch, host_batches

    # (e) export_serving --quant int8_serve --compress-weights, load_serving:
    # classify bit for bit make_serving_fns's on the card
    work = tempfile.mkdtemp(prefix="chip_smoke_quant_")
    try:
        out = os.path.join(work, "medmamba_int8_serve")
        man = export_cli.main(["--out", out, "--model", "medmamba", "--quant", "int8_serve",
                               "--compress-weights"])
        served = load_serving(out, device="cuda")
        mq, fq, _ = make_serving_fns("medmamba", quant="int8_serve", precision="amp",
                                     device="cuda", generator=torch.Generator().manual_seed(0))
        stored = torch.load(os.path.join(out, "params.pt"), weights_only=True)
        kernels = serve_kernels(mq)
        n_int8 = sum(1 for k in stored if k.endswith(".__int8_cols__"))
        # the loaded weights requantize on the card to the stored values
        weights = dict(mq.named_parameters())
        for key in kernels:
            if f"{key}.__int8_cols__" in stored:
                rhs = weights[key].detach().bfloat16().t()
                sr = qdot._absmax_scale_cols(rhs)
                if not (torch.equal(qdot._quantize(rhs, sr).t().cpu(),
                                    stored[f"{key}.__int8_cols__"])
                        and torch.equal(sr.cpu(), stored[f"{key}.__int8_cols__.scale"][:, 0])):
                    fail(f"the int8_serve artifact's {key} is not the dot's quantization on "
                         "the card")
        fq["classify"](mq, x64)
        got = counted("loaded int8_serve classify", lambda: served["classify"](x64),
                      {"scan_fwd": 14})
        want = counted("in-process int8_serve classify", lambda: fq["classify"](mq, x64),
                       {"scan_fwd": 14})
        if not torch.equal(got, want):
            fail(f"the compressed int8_serve artifact's classify differs from "
                 f"make_serving_fns by {float((got - want).abs().max()):.3e}")
        line["artifact"] = {"manifest_quant": man["quant"], "weights": man["weights"],
                            "int8_tensors": n_int8, "served_kernels": len(kernels),
                            "bytes": os.path.getsize(os.path.join(out, "params.pt"))}
        say(f"quant artifact: medmamba int8_serve compressed ({n_int8} int8 tensors, "
            f"{len(kernels)} kernels of int8_serve dots); the stored values are the dot's "
            "quantization on the card; classify of 64 images bit for bit make_serving_fns's")
        del served, mq, fq, stored

        # (f) the CLI: medmamba under --quant int8_delayed, phase 14's Drive
        # flags: the init batch (14 scan forwards), calibrate_quant (14), 2
        # steps of 14 + 14, one eval batch of 14; the checkpoint holds the
        # delayed state
        logs = os.path.join(work, "logs")
        argv = ["--synthetic-data", "--train-num-samples", "128", "--val-num-samples", "64",
                "--batch-size", "64", "--epochs", "1", "--warmup", "2", "--lr", "1e-4",
                "--precision", "amp", "--save-most-recent", "--log-every-n-steps", "1",
                "--grad-clip-norm", "1.0", "--logs", logs, "--model-stage-1", "medmamba",
                "--name", "quant", "--quant", "int8_delayed"]
        rec = run_cli((reset_counts, read_counts, flash_bodies), "medmamba --quant int8_delayed",
                      argv)
        check_cli_steps(rec, "medmamba --quant int8_delayed", 2,
                        {"scan_fwd": 14, "scan_bwd": 14}, {"scan_fwd": 14}, eval_batches=1)
        want = {k: 0 for k in rec["total"]}
        want.update(scan_fwd=14 * 5, scan_bwd=14 * 2)
        if rec["total"] != want:
            fail(f"cli --quant int8_delayed: launches {rec['total']}, expected {want}")
        for k in total:
            total[k] += rec["total"][k]
        saved = torch.load(os.path.join(logs, "quant", "checkpoints", "stage_1_epoch_latest",
                                        "state.pt"), weights_only=True)
        if len(saved.get("quant_stats", {})) != 62:  # 31 Denses x (lhs, rhs)
            fail(f"cli --quant int8_delayed: the checkpoint holds "
                 f"{len(saved.get('quant_stats', {}))} delayed scales, expected 62")
        line["cli"] = {"wall_s": rec["wall_s"], "launches": rec["total"],
                       "losses": [st["loss"] for st in rec["steps"]],
                       "val_loss": rec["metrics"]["val_loss"], "quant_stats": 62}
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return line, total, total_bodies


def precision_phase(card, reset_counts, read_counts, flash_bodies, amp):
    """Phase 18: the low-precision parameter policies at full width, each
    gate as the module docstring says. ``amp``: this run's amp yardsticks
    (phase 10's contrastive step with flash and phase 6's medmamba step: ms
    a step and peak bytes). Every count is set to 0 just before each driven
    call and read just after. Returns (the ``precision`` line's fields, those
    calls' launches by counter, their flash launches by body, and the
    tensor-core launches of the fp16 runs alone by flash kernel)."""
    import numpy as np
    import torch

    from mamba_clip_tpu_torch import export_serving as export_cli
    from mamba_clip_tpu_torch.checkpoint import load_params_only
    from mamba_clip_tpu_torch.profile_embed import report_tokens
    from mamba_clip_tpu_torch.profile_train import clip_train_setup, medmamba_train_setup
    from mamba_clip_tpu_torch.serving import decompress_params, load_serving, make_serving_fns
    from mamba_clip_tpu_torch.utils.precision import get_policy

    total = {k: 0 for k in read_counts()}
    total_bodies = {k: {"tensor_cores": 0, "cuda_cores": 0} for k in ("fwd", "dkv", "dq")}
    fp16_launches = {k: 0 for k in ("fwd", "dkv", "dq")}
    line = {"card": card}

    def add(counts, bodies, fp16):
        for k in total:
            total[k] += counts[k]
        for k, by in bodies.items():
            for body, c in by.items():
                total_bodies[k][body] += c
            if fp16:
                fp16_launches[k] += by["tensor_cores"]

    def counted(what, fn, want, fp16=False):
        """``fn()`` with every count set to 0 just before and read just after;
        fails unless the launches are ``want``, every flash one on the
        tensor cores; adds them to the phase's (and, ``fp16``, to the fp16
        instances')."""
        reset_counts()
        out = fn()
        torch.cuda.synchronize()
        counts, bodies = read_counts(), flash_bodies()
        full = {k: want.get(k, 0) for k in counts}
        want_bodies = {k: {"tensor_cores": full[k], "cuda_cores": 0} for k in total_bodies}
        if counts != full or bodies != want_bodies:
            fail(f"precision {what}: launches {counts}, by body {bodies}; expected {full}")
        add(counts, bodies, fp16)
        return out

    def types(state):
        """The types of the parameters, the first and the second moments."""
        opt = state.opt_state
        return tuple(sorted({str(t.dtype).replace("torch.", "") for t in ts}) for ts in (
            list(state.model.parameters()), opt.mu.values(), opt.nu.values()))

    def want_types(precision):
        """What JAX's optimizer keeps under ``precision``: parameters in the
        policy's type; moments too, but fp32 where the gradients are unscaled
        by the fp32 loss scale (the fp16 policies)."""
        policy = get_policy(precision)
        param = str(policy.param_dtype).replace("torch.", "")
        moment = "float32" if policy.dynamic_loss_scale else param
        return [param], [moment], [moment]

    def run_steps(what, state, step_fn, batches, n, per, fp16):
        metrics = []

        def run():
            st = state
            for i in range(n):
                st, m = step_fn(st, batches[i % 2], 0)
                metrics.append({k: (float(v) if not isinstance(v, (int, float)) else v)
                                for k, v in m.items()})
            return st

        return counted(what, run, {k: n * c for k, c in per.items()}, fp16), metrics

    def check_steps(what, metrics, dynamic):
        """Finite losses; a finite grad norm on every step that was taken
        (under the dynamic scale a step whose gradients overflowed is
        skipped, its norm non-finite, and the scale halves); some step
        taken."""
        for i, m in enumerate(metrics):
            skipped = dynamic and m.get("skipped_steps", 0) == 1
            if not np.isfinite(m["loss"]) or not (skipped or np.isfinite(m["grad_norm"])):
                fail(f"precision {what} step {i}: {m}")
        if dynamic and all(m.get("skipped_steps", 0) for m in metrics):
            fail(f"precision {what}: every step skipped ({metrics})")

    # (a) full-width BiomedCLIP contrastive steps, batch 64, the flash
    # interior: 1 warm-up and 3 timed steps a policy
    clip_line = {}
    for precision in ("pure_bf16", "fp16", "pure_fp16"):
        gc.collect()
        torch.cuda.empty_cache()
        extra = {"eps": 1e-4} if precision == "pure_fp16" else {}
        before = torch.cuda.memory_allocated()
        state, step_fn, batches = clip_train_setup(64, precision=precision, **extra)
        fp16 = get_policy(precision).compute_dtype == torch.float16
        dynamic = get_policy(precision).dynamic_loss_scale
        per = {"fwd": 24, "dkv": 24, "dq": 24}
        state, warm = run_steps(f"{precision} clip warm-up", state, step_fn, batches, 1, per, fp16)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        state, timed = run_steps(f"{precision} clip timed", state, step_fn, batches, 3, per, fp16)
        ms = (time.perf_counter() - t0) / 3 * 1e3
        peak = torch.cuda.max_memory_allocated()
        metrics = warm + timed
        check_steps(f"{precision} clip", metrics, dynamic)
        if not 3.0 <= metrics[0]["loss"] <= 6.0:
            fail(f"precision {precision} clip: first loss {metrics[0]['loss']} outside [3, 6]")
        got_types = types(state)
        if list(got_types) != list(want_types(precision)):
            fail(f"precision {precision} clip: parameter and moment types {got_types}, "
                 f"expected {want_types(precision)}")
        clip_line[precision] = {
            "ms_per_step": ms, "amp_ms_per_step": amp["clip_ms"], "ratio": ms / amp["clip_ms"],
            "max_memory_allocated": peak, "amp_max_memory_allocated": amp["clip_peak"],
            # what was allocated before the model was built, here and in phase 10
            "allocated_before": before, "amp_allocated_before": amp["clip_before"],
            "losses": [m["loss"] for m in metrics],
            "grad_norms": [m["grad_norm"] for m in metrics],
            "skipped_steps": [m.get("skipped_steps", 0) for m in metrics],
            "loss_scale": [m.get("loss_scale") for m in metrics],
            "flash_tensor_core_launches_per_step": per, "types": got_types,
            "flash_instances": "fp16" if fp16 else "bf16"}
        say(f"precision clip {precision}: {ms:.2f} ms a step against amp {amp['clip_ms']:.2f} "
            f"({ms / amp['clip_ms']:.2f}x), peak {peak / 2**30:.2f} GiB ({before / 2**30:.2f} "
            f"before the model) against amp {amp['clip_peak'] / 2**30:.2f} "
            f"({amp['clip_before'] / 2**30:.2f}); losses {[round(m['loss'], 5) for m in metrics]}; "
            f"skipped {clip_line[precision]['skipped_steps']}; types {got_types}; 24 + 24 + 24 "
            f"flash launches a step on the tensor cores ({'fp16' if fp16 else 'bf16'})")
        del state, step_fn, batches
    line["clip_steps"] = clip_line

    # (b) the full-width medmamba step through both scan kernels
    mm_line = {}
    for precision in ("pure_bf16", "pure_fp16"):
        gc.collect()
        torch.cuda.empty_cache()
        extra = {"eps": 1e-4} if precision == "pure_fp16" else {}
        before = torch.cuda.memory_allocated()
        state, step_fn, batches = medmamba_train_setup(64, precision=precision, **extra)
        per = {"scan_fwd": 14, "scan_bwd": 14}
        state, warm = run_steps(f"{precision} medmamba warm-up", state, step_fn, batches, 1,
                                per, False)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        state, timed = run_steps(f"{precision} medmamba timed", state, step_fn, batches, 2,
                                 per, False)
        ms = (time.perf_counter() - t0) / 2 * 1e3
        metrics = warm + timed
        check_steps(f"{precision} medmamba", metrics, get_policy(precision).dynamic_loss_scale)
        got_types = types(state)
        stats = {str(b.dtype) for b in state.model.buffers() if b.is_floating_point()}
        if list(got_types) != list(want_types(precision)) or stats != {"torch.float32"}:
            fail(f"precision {precision} medmamba: types {got_types}, BatchNorm statistics "
                 f"{stats}; expected {want_types(precision)} and float32")
        mm_line[precision] = {
            "ms_per_step": ms, "amp_ms_per_step": amp["medmamba_ms"],
            "max_memory_allocated": torch.cuda.max_memory_allocated(),
            "amp_max_memory_allocated": amp["medmamba_peak"],
            "allocated_before": before, "amp_allocated_before": amp["medmamba_before"],
            "losses": [m["loss"] for m in metrics],
            "skipped_steps": [m.get("skipped_steps", 0) for m in metrics],
            "types": got_types, "scan_launches_per_step": per}
        say(f"precision medmamba {precision}: {ms:.2f} ms a step against amp "
            f"{amp['medmamba_ms']:.2f}; losses {[round(m['loss'], 5) for m in metrics]}; "
            f"types {got_types}, BatchNorm statistics float32; 14 + 14 scan launches a step")
        del state, step_fn, batches
    line["medmamba_steps"] = mm_line

    # (c) the CLI with phase 14's flags under --precision pure_bf16: stage 1,
    # stage 2 finding it, and stage 2 resumed; (d) stage 1's checkpoint
    # exported raw and compressed, loaded and served against make_serving_fns
    work = tempfile.mkdtemp(prefix="chip_smoke_precision_")
    counters = (reset_counts, read_counts, flash_bodies)
    try:
        logs = os.path.join(work, "logs")
        drive = ["--synthetic-data", "--train-num-samples", "192", "--val-num-samples", "64",
                 "--batch-size", "64", "--epochs", "1", "--warmup", "2", "--lr", "1e-4",
                 "--precision", "pure_bf16", "--save-most-recent", "--log-every-n-steps", "1",
                 "--grad-clip-norm", "1.0", "--attn-impl", "flash", "--logs", logs,
                 "--tokenizer", "hash"]
        cli = {}
        s1 = run_cli(counters, "pure_bf16 stage 1", drive + ["--stage", "1"])
        check_cli_steps(s1, "pure_bf16 stage 1", 3, {"fwd": 24, "dkv": 24, "dq": 24},
                        {"fwd": 24}, eval_batches=1)
        (s1_name,) = os.listdir(logs)
        s1_latest = os.path.join(logs, s1_name, "checkpoints", "stage_1_epoch_latest")
        s2_argv = drive + ["--stage", "2", "--name", "s2"]
        s2 = run_cli(counters, "pure_bf16 stage 2", s2_argv)
        check_cli_steps(s2, "pure_bf16 stage 2", 3, {"fwd": 24}, {"fwd": 24}, eval_batches=1)
        s2_dir = os.path.join(logs, "s2", "checkpoints")
        with open(os.path.join(s2_dir, "results.jsonl")) as f:
            row = [json.loads(x) for x in f][-1]
        rs = run_cli(counters, "pure_bf16 stage 2 --resume latest", s2_argv + ["--resume",
                                                                              "latest"])
        check_cli_steps(rs, "pure_bf16 resume", 0, {}, {"fwd": 24}, eval_batches=1)
        resume_diff = {k: abs(rs["metrics"][k] - row[k]) for k in ("val_loss", "partial_auc")}
        saved = {}
        for tag, path in (("stage1", s1_latest),
                          ("stage2", os.path.join(s2_dir, "stage_2_epoch_latest"))):
            st = torch.load(os.path.join(path, "state.pt"), weights_only=True)
            saved[tag] = [sorted({str(t.dtype) for t in st[part].values()})
                          for part in ("params",)] + [
                sorted({str(t.dtype) for t in st["opt_state"][m].values()}) for m in ("mu", "nu")]
        if any(resume_diff.values()) or any(
                v != [["torch.bfloat16"]] * 3 for v in saved.values()):
            fail(f"precision cli: the resume's metrics {rs['metrics']} against {row}, the "
                 f"checkpoints' types {saved}")
        for rec in (s1, s2, rs):
            add(rec["total"], rec["total_bodies"], False)
        cli = {"stage1_wall_s": s1["wall_s"], "stage2_wall_s": s2["wall_s"],
               "resume_wall_s": rs["wall_s"],
               "stage1_losses": [st["loss"] for st in s1["steps"]],
               "stage2_metrics": s2["metrics"], "resume_diff_to_stage2_row": resume_diff,
               "checkpoint_types": saved}
        say(f"precision cli pure_bf16: stage 1 {s1['wall_s']:.1f} s, stage 2 "
            f"{s2['wall_s']:.1f} s, the resume's metrics equal stage 2's row bit for bit; "
            f"checkpoints {saved}")
        line["cli"] = cli

        # (d) export_serving of stage 1's checkpoint, raw and compressed
        rs_img = np.random.RandomState(181)
        x64 = torch.from_numpy(rs_img.randint(0, 256, (64, 256, 256, 3), dtype=np.uint8)).cuda()
        toks = torch.from_numpy(report_tokens(64, seed=18)).cuda()
        ref, fns, _ = make_serving_fns("biomedclip", is_clip=True, attn_impl="flash",
                                       precision="pure_bf16", device="cuda")
        get_policy("pure_bf16").cast_params(ref)
        load_params_only(s1_latest, ref)
        art = {}
        for compress in (False, True):
            out = os.path.join(work, f"artifact_{int(compress)}")
            man = export_cli.main(["--out", out, "--model", "biomedclip", "--checkpoint",
                                   s1_latest, "--precision", "pure_bf16"]
                                  + (["--compress-weights"] if compress else []))
            served = load_serving(out, device="cuda")
            stored = torch.load(os.path.join(out, "params.pt"), weights_only=True)
            model = ref
            if compress:
                model, _, _ = make_serving_fns("biomedclip", is_clip=True, attn_impl="flash",
                                               precision="pure_bf16", device="cuda")
                model.load_state_dict({k: v.cuda() for k, v in
                                       decompress_params(stored).items()}, assign=True)
                model.eval()
            p_types = sorted({str(t.dtype) for t in served["image_embed"].args[0].parameters()})
            if man["precision"] != "pure_bf16" or p_types != ["torch.bfloat16"]:
                fail(f"precision artifact: manifest precision {man['precision']}, loaded "
                     f"parameter types {p_types}")
            diffs = {}
            for name, x in (("image_embed", x64), ("text_embed", toks)):
                fns[name](model, x)
                got = counted(f"loaded {name}", lambda: served[name](x), {"fwd": 12})
                want = counted(f"in-process {name}", lambda: fns[name](model, x), {"fwd": 12})
                diffs[name] = float((got - want).abs().max())
                if not torch.equal(got, want):
                    fail(f"precision artifact ({'compressed' if compress else 'raw'}) {name} "
                         f"differs from make_serving_fns by {diffs[name]:.3e}")
            art["compressed" if compress else "raw"] = {
                "bytes": os.path.getsize(os.path.join(out, "params.pt")),
                "weights": man["weights"], "parameter_types": p_types,
                "int8_tensors": sum(k.endswith(".__int8_cols__") for k in stored)}
            del served, stored
        say(f"precision artifact: stage 1's pure_bf16 checkpoint exported raw "
            f"({art['raw']['bytes']} bytes) and compressed ({art['compressed']['bytes']} bytes), "
            f"loaded with bf16 parameters; image_embed and text_embed of 64 rows bit for bit "
            f"make_serving_fns's, 12 flash launches a call")
        line["artifact"] = art
    finally:
        shutil.rmtree(work, ignore_errors=True)
    line["fp16_flash_launches"] = fp16_launches
    return line, total, total_bodies, fp16_launches


def aqt_phase(card, reset_counts, read_counts, flash_bodies, amp):
    """Phase 19: the aqt modes (``--quant int8`` and ``int8_fwd``), each gate
    as the module docstring says. ``amp``: this run's unquantized yardsticks
    (phase 10's contrastive step with flash, phase 6's medmamba step, in
    ms). Every count is set to 0 just before each driven call and read just
    after. Returns (the ``aqt`` line's fields, those calls' launches by
    counter, their flash launches by body)."""
    import numpy as np
    import torch

    from mamba_clip_tpu_torch.ops import aqt
    from mamba_clip_tpu_torch.profile_train import clip_train_setup, medmamba_train_setup

    total = {k: 0 for k in read_counts()}
    total_bodies = {k: {"tensor_cores": 0, "cuda_cores": 0} for k in ("fwd", "dkv", "dq")}
    line = {"card": card}

    def counted(what, fn, want):
        """``fn()`` between a reset and a read of every count; fails unless
        the launches are ``want``, the flash ones all on the tensor cores."""
        reset_counts()
        out = fn()
        torch.cuda.synchronize()
        counts, bodies = read_counts(), flash_bodies()
        full = {k: want.get(k, 0) for k in counts}
        want_bodies = {k: {"tensor_cores": full[k], "cuda_cores": 0} for k in total_bodies}
        if counts != full or bodies != want_bodies:
            fail(f"aqt {what}: launches {counts}, by body {bodies}; expected {full}")
        for k in total:
            total[k] += counts[k]
        for k, by in bodies.items():
            for body, c in by.items():
                total_bodies[k][body] += c
        return out

    # (a) the dots at the ViT qkv Dense's shape (64 x 197 rows of 768 -> 2304),
    # the same fp32 inputs on the card and on the CPU
    gen = torch.Generator().manual_seed(19)
    lhs = torch.randn(64, 197, 768, generator=gen)
    rhs = torch.randn(768, 2304, generator=gen) * 0.03
    g = torch.randn(64, 197, 2304, generator=gen)
    res = {}
    for dev in ("cpu", "cuda"):
        a, b, c = lhs.to(dev), rhs.to(dev), g.to(dev)
        out, ql, sl, qr, sr = aqt.fwd_dot(a, b)
        acc = aqt.int_mm(ql.reshape(-1, 768), qr)
        dl, qgl, accl = aqt.dlhs_dot(c, qr, sr)
        dr, qgr, accr = aqt.drhs_dot(c, ql, sl)
        fl = aqt.aqt_int8_fwd_dot(a.clone().requires_grad_(), b.clone().requires_grad_())
        al, bl = a.clone().requires_grad_(), b.clone().requires_grad_()
        aqt.aqt_int8_fwd_dot(al, bl).backward(c)
        res[dev] = ({"lhs8": ql, "rhs8": qr, "acc": acc, "dlhs_g8": qgl, "dlhs_acc": accl,
                     "drhs_g8": qgr, "drhs_acc": accr},
                    {"out": out, "dlhs": dl, "drhs": dr, "fwd_only_out": fl.detach(),
                     "fwd_only_dlhs": al.grad, "fwd_only_drhs": bl.grad})
        res[dev] = tuple({k: t.detach().cpu() for k, t in d.items()} for d in res[dev])
    (ic, fc), (ig, fg) = res["cpu"], res["cuda"]
    unequal = [k for k in ic if not torch.equal(ic[k], ig[k])]
    rels = {k: float((fg[k] - fc[k]).abs().max() / fc[k].abs().max()) for k in fc}
    # int8_fwd's backward: two fp32 GEMMs, summed in another order on each
    # device; everything else is the same roundings on both
    bounds = {k: SERVE_GRAD_REL if k.startswith("fwd_only_d") else DOT_REL for k in fc}
    bad = [k for k in rels if rels[k] > bounds[k]]
    line["dots"] = {"int8_and_int32_equal": not unequal, "rel": rels, "bounds": bounds,
                    "bit_equal": {k: torch.equal(fc[k], fg[k]) for k in fc},
                    "max_abs_int32": max(int(ic[k].abs().max()) for k in ic
                                         if ic[k].dtype == torch.int32)}
    say(f"aqt dots at 64 x 197 x 768 -> 2304: int8 operands and int32 accumulators "
        f"{'equal' if not unequal else 'DIFFER: ' + str(unequal)} ({sorted(ic)}); rel "
        + ", ".join(f"{k} {v:.2e}" for k, v in rels.items()))
    if unequal or bad:
        fail(f"aqt dots: the card differs from the CPU: int8/int32 {unequal}, rel {rels} "
             f"against {bounds}")
    del lhs, rhs, g, res, ic, fc, ig, fg

    # (b) the contrastive step of full-width BiomedCLIP, amp, flash
    per = {"fwd": 24, "dkv": 24, "dq": 24}
    steps_line = {}
    for quant in ("int8", "int8_fwd"):
        gc.collect()
        torch.cuda.empty_cache()
        state, step_fn, batches = clip_train_setup(64, quant=quant)
        metrics = []

        def run(st, k):
            for i in range(k):
                st, m = step_fn(st, batches[i % 2], 0)
                metrics.append(m)
            return st

        torch.cuda.reset_peak_memory_stats()
        state = counted(f"clip {quant} 2 steps", lambda: run(state, 2),
                        {k: 2 * c for k, c in per.items()})
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state = counted(f"clip {quant} 3 timed steps", lambda: run(state, 3),
                        {k: 3 * c for k, c in per.items()})
        ms = (time.perf_counter() - t0) / 3 * 1e3
        losses = [float(m["loss"]) for m in metrics]
        gn = [float(m["grad_norm"]) for m in metrics]
        if not all(np.isfinite(x) for x in losses + gn) or not 3.0 <= losses[0] <= 6.0:
            fail(f"aqt clip {quant}: losses {losses}, grad norms {gn} (the first loss "
                 "within [3, 6])")
        dots = sum(1 for m in state.model.modules() if isinstance(m, aqt._DenseDotGeneral))
        steps_line[quant] = {"ms_per_step": ms, "amp_ms_per_step": amp["clip_flash_ms"],
                             "ratio": ms / amp["clip_flash_ms"], "losses": losses,
                             "grad_norms": gn, "aqt_dots": dots,
                             "peak_bytes": torch.cuda.max_memory_allocated()}
        say(f"aqt clip step {quant} (flash): {ms:.2f} ms a step against amp "
            f"{amp['clip_flash_ms']:.2f} ({ms / amp['clip_flash_ms']:.2f}x); {dots} aqt dots; "
            f"losses {[round(x, 5) for x in losses]}; 24 + 24 + 24 flash launches a step")
        del state, step_fn, batches, metrics
    line["clip_steps"] = steps_line

    # (c) the medmamba classifier step
    mm_line = {}
    for quant in ("int8", "int8_fwd"):
        gc.collect()
        torch.cuda.empty_cache()
        state, step_fn, batches = medmamba_train_setup(64, quant=quant)
        metrics = []

        def run_mm(st, k):
            for i in range(k):
                st, m = step_fn(st, batches[i % 2], 0)
                metrics.append(m)
            return st

        state = counted(f"medmamba {quant} warm-up", lambda: run_mm(state, 1),
                        {"scan_fwd": 14, "scan_bwd": 14})
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state = counted(f"medmamba {quant} 3 timed steps", lambda: run_mm(state, 3),
                        {"scan_fwd": 42, "scan_bwd": 42})
        ms = (time.perf_counter() - t0) / 3 * 1e3
        losses = [float(m["loss"]) for m in metrics]
        if not all(np.isfinite(x) for x in losses):
            fail(f"aqt medmamba {quant}: losses {losses}")
        mm_line[quant] = {"ms_per_step": ms, "amp_ms_per_step": amp["medmamba_ms"],
                          "ratio": ms / amp["medmamba_ms"], "losses": losses}
        say(f"aqt medmamba step {quant}: {ms:.2f} ms a step against amp "
            f"{amp['medmamba_ms']:.2f} ({ms / amp['medmamba_ms']:.2f}x); losses "
            f"{[round(x, 5) for x in losses]}; 14 + 14 scan launches a step")
        del state, step_fn, batches, metrics
    line["medmamba_steps"] = mm_line

    # (d) the CLI's Drive recipe under --quant int8, both stages
    work = tempfile.mkdtemp(prefix="chip_smoke_aqt_")
    try:
        logs = os.path.join(work, "logs")
        drive = ["--synthetic-data", "--train-num-samples", "128", "--val-num-samples", "64",
                 "--batch-size", "64", "--epochs", "1", "--warmup", "2", "--lr", "1e-4",
                 "--precision", "amp", "--log-every-n-steps", "1", "--grad-clip-norm", "1.0",
                 "--attn-impl", "flash", "--logs", logs, "--tokenizer", "hash",
                 "--quant", "int8"]
        counters = (reset_counts, read_counts, flash_bodies)
        s1 = run_cli(counters, "stage 1 --quant int8", drive + ["--stage", "1"])
        check_cli_steps(s1, "stage 1 --quant int8", 2, per, {"fwd": 24}, eval_batches=1)
        s2 = run_cli(counters, "stage 2 --quant int8", drive + ["--stage", "2", "--name", "s2"])
        check_cli_steps(s2, "stage 2 --quant int8", 2, {"fwd": 24}, {"fwd": 24},
                        eval_batches=1)
        for rec in (s1, s2):
            for k in total:
                total[k] += rec["total"][k]
            for k, by in rec["total_bodies"].items():
                for body, c in by.items():
                    total_bodies[k][body] += c
        line["cli"] = {"stage1_wall_s": s1["wall_s"], "stage2_wall_s": s2["wall_s"],
                       "stage1_losses": [st["loss"] for st in s1["steps"]],
                       "stage2_losses": [st["loss"] for st in s2["steps"]],
                       "stage1_val_loss": s1["metrics"]["val_loss"],
                       "stage2_partial_auc": s2["metrics"]["partial_auc"]}
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return line, total, total_bodies


def _axis_rank(rank, world, port, backend, modes, q):
    """One rank of phase 20, in a process of its own on the one card: the
    contrastive step over the data axis (``--local-loss`` off and on) at 32
    rows a rank, its collectives timed apart, and which collectives the
    backend takes CUDA tensors for as they are. Puts (rank, result, error)
    on ``q``."""
    import traceback

    try:
        sys.path.insert(0, str(SRC))
        logging.disable(logging.INFO)
        import numpy as np
        import torch
        import torch.distributed as dist

        from mamba_clip_tpu_torch.ops.flash_attn import (flash_attn_bwd_dkv, flash_attn_bwd_dq,
                                                         flash_attn_fwd)
        from mamba_clip_tpu_torch.parallel import collectives as coll
        from mamba_clip_tpu_torch.parallel.mesh import create_mesh
        from mamba_clip_tpu_torch.profile_train import clip_train_setup

        torch.cuda.set_device(0)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                                world_size=world)
        out = {"backend": backend}
        # does the backend take CUDA tensors as they are?
        raw = {}
        for name, fn in (("all_reduce", lambda t: dist.all_reduce(t)),
                         ("broadcast", lambda t: dist.broadcast(t, src=0)),
                         ("all_gather", lambda t: dist.all_gather(
                             [torch.empty_like(t) for _ in range(world)], t))):
            try:
                fn(torch.ones(4, device="cuda"))
                torch.cuda.synchronize()
                raw[name] = True
            except Exception as e:  # the answer is the finding
                raw[name] = f"{type(e).__name__}: {str(e)[:120]}"
        out["cuda_tensors_taken"] = raw
        mesh = create_mesh()
        wrappers = {"fwd": flash_attn_fwd, "dkv": flash_attn_bwd_dkv, "dq": flash_attn_bwd_dq}
        per_rank = 64 // world
        for local in modes:
            state, step_fn, batches = clip_train_setup(64, mesh=mesh, local_loss=local)
            mine = [{k: v[rank * per_rank:(rank + 1) * per_rank] for k, v in b.items()}
                    for b in batches]
            losses, gns = [], []
            for w in wrappers.values():
                w.launches = 0
                for body in w.launches_by_body:
                    w.launches_by_body[body] = 0
            for i in range(2):
                state, m = step_fn(state, mine[i], 0)
                losses.append(float(m["loss"]))
                gns.append(float(m["grad_norm"]))
            torch.cuda.synchronize()
            counts = {k: w.launches for k, w in wrappers.items()}
            bodies = {k: dict(w.launches_by_body) for k, w in wrappers.items()}
            digest = param_digest(state.model)
            # one timed step, then one with every collective timed apart
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, _ = step_fn(state, mine[0], 0)
            torch.cuda.synchronize()
            step_ms = (time.perf_counter() - t0) * 1e3
            spent = {"ms": 0.0, "calls": 0}
            real = {n: getattr(coll, n) for n in ("all_reduce_", "all_gather_")}

            def timed(fn):
                def wrapped(*a, **kw):
                    torch.cuda.synchronize()
                    t = time.perf_counter()
                    r = fn(*a, **kw)
                    torch.cuda.synchronize()
                    spent["ms"] += (time.perf_counter() - t) * 1e3
                    spent["calls"] += 1
                    return r
                return wrapped

            for n, f in real.items():
                setattr(coll, n, timed(f))
            try:
                state, _ = step_fn(state, mine[1], 0)
            finally:
                for n, f in real.items():
                    setattr(coll, n, f)
            torch.cuda.synchronize()
            out[local] = {"losses": losses, "grad_norms": gns, "digest": digest,
                          "counts": counts, "bodies": bodies, "ms_per_step": step_ms,
                          "collectives_ms": spent["ms"], "collective_calls": spent["calls"]}
            del state, step_fn, batches, mine
            gc.collect()
            torch.cuda.empty_cache()
        dist.destroy_process_group()
        q.put((rank, out, None))
    except BaseException:
        q.put((rank, None, traceback.format_exc()))


def param_digest(model, stride: int = 997):
    """Every ``stride``-th entry of each parameter, in fp32, as one numpy
    vector: what phases 20 and 24 compare across ranks and with one process.
    A sharded model's parameters are gathered first (a collective: every
    rank of its mesh calls it)."""
    import torch

    from mamba_clip_tpu_torch.parallel.sharding import full_params

    with torch.no_grad():
        return torch.cat([p.detach().float().flatten()[::stride]
                          for p in full_params(model).values()]).cpu().numpy()


def state_bytes(state) -> int:
    """The bytes a rank holds between steps: its parameters (shards where
    sharded), buffers and AdamW moments."""
    model = state.model
    tensors = [*model.parameters(), *model.buffers(), *state.opt_state.mu.values(),
               *state.opt_state.nu.values()]
    return sum(t.numel() * t.element_size() for t in tensors)


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_ranks(world, backend, modes=(False, True), timeout=600, target=None):
    """``target`` (``_axis_rank`` by default) on ``world`` processes
    (spawned, on a free local port), each joined with a timeout of its own;
    their results by rank. ``modes`` is what the target takes after the
    backend."""
    import multiprocessing as mp

    port = free_port()
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    procs = [ctx.Process(target=target or _axis_rank, args=(r, world, port, backend, modes, q))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    out, errs = {}, []
    try:
        for _ in range(world):
            rank, res, err = q.get(timeout=max(deadline - time.monotonic(), 1.0))
            if err:
                errs.append(f"rank {rank}: {err}")
            out[rank] = res
    except Exception as e:
        errs.append(f"{type(e).__name__}: {e}")
    finally:
        for p in procs:
            p.join(timeout=max(deadline - time.monotonic(), 1.0))
            if p.is_alive():
                p.kill()
                p.join()
    if errs:
        fail(f"{backend} ranks: " + "\n".join(errs))
    return [out[r] for r in range(world)]


def axis_phase(card):
    """Phase 20: the data axis, as the module docstring says. Returns (the
    ``data_axis`` line's fields, the two-rank steps' flash launches by
    kernel (both ranks), by body)."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from mamba_clip_tpu_torch.parallel import collectives as coll
    from mamba_clip_tpu_torch.parallel.mesh import broadcast_object, create_mesh
    from mamba_clip_tpu_torch.profile_train import clip_train_setup

    line = {"card": card, "note": "two gloo ranks share one card: not a scaling number"}
    gate = CLIP_TRAIN_REL
    # one process at 64 rows, from the same weights and seeds, the reference
    # of both (in one process --local-loss changes nothing); it runs in a
    # one-rank NCCL world, which also takes the collective helpers on the
    # card's tensors
    gc.collect()
    torch.cuda.empty_cache()
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{free_port()}", rank=0,
                            world_size=1)
    try:
        mesh = create_mesh()
        state, step_fn, batches = clip_train_setup(64, mesh=mesh)
        losses = []
        for i in range(2):
            state, m = step_fn(state, batches[i], 0)
            losses.append(float(m["loss"]))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step_fn(state, batches[0], 0)
        torch.cuda.synchronize()
        one = {"losses": losses, "ms_per_step": (time.perf_counter() - t0) * 1e3,
               "digest": param_digest(state.model)}
        t = torch.arange(6, device="cuda", dtype=torch.float32)
        coll.all_reduce_(t)
        g = coll.all_gather_(t, 1)
        helpers = (torch.equal(g[0], t) and broadcast_object("rank 0's") == "rank 0's"
                   and dist.get_backend() == "nccl")
    finally:
        dist.destroy_process_group()
    del state, step_fn, batches
    if not helpers or not all(np.isfinite(one["losses"])):
        fail(f"nccl one-rank world: helpers {helpers}, losses {one['losses']}")
    line["nccl_one_rank"] = {"losses": one["losses"], "ms_per_step": one["ms_per_step"]}
    say(f"data axis: one NCCL rank: losses {one['losses']}, {one['ms_per_step']:.1f} ms a "
        "step; the collective helpers through nccl on the card's tensors")
    gc.collect()
    torch.cuda.empty_cache()
    ranks = run_ranks(2, "gloo")
    launches = {k: 0 for k in ("fwd", "dkv", "dq")}
    bodies = {k: {"tensor_cores": 0, "cuda_cores": 0} for k in launches}
    for local in (False, True):
        r0, r1 = ranks[0][local], ranks[1][local]
        ref = one
        # amp: bf16 activations whose sums run in another order over two
        # ranks (the gathered features, the all-reduced gradients)
        loss_rel = max(abs(a - b) / abs(b) for a, b in zip(r0["losses"], ref["losses"]))
        dig = [float(np.abs(r0["digest"] - ref["digest"]).max() / np.abs(ref["digest"]).max())]
        same = (np.array_equal(r0["digest"], r1["digest"])
                and r0["losses"] == r1["losses"])
        want = {k: 2 * 24 for k in launches}
        for r in (r0, r1):
            if r["counts"] != want or any(r["bodies"][k]["cuda_cores"] for k in launches):
                fail(f"data axis local_loss={local}: a rank launched {r['counts']} "
                     f"({r['bodies']}), expected {want} on the tensor cores")
            for k in launches:
                launches[k] += r["counts"][k]
                for body, c in r["bodies"][k].items():
                    bodies[k][body] += c
        line[f"local_loss_{local}"] = {
            "losses_two_ranks": r0["losses"], "losses_one_process": ref["losses"],
            "loss_rel": loss_rel, "digest_rel_max": max(dig), "ranks_identical": same,
            "ms_per_step_two_ranks": [r0["ms_per_step"], r1["ms_per_step"]],
            "ms_per_step_one_process": ref["ms_per_step"],
            "collectives_ms_per_step": [r0["collectives_ms"], r1["collectives_ms"]],
            "collective_calls_per_step": r0["collective_calls"]}
        say(f"data axis local_loss={local}: 2 gloo ranks x 32 against one process x 64: "
            f"losses {[round(x, 5) for x in r0['losses']]} / "
            f"{[round(x, 5) for x in ref['losses']]} (rel {loss_rel:.2e}), parameter "
            f"digest rel {max(dig):.2e}, ranks identical {same}; {r0['ms_per_step']:.1f} ms a "
            f"step a rank ({r0['collectives_ms']:.1f} ms of it in {r0['collective_calls']} "
            f"collectives) against {ref['ms_per_step']:.1f} ms in one process")
        if not same or loss_rel > gate or max(dig) > gate:
            fail(f"data axis local_loss={local}: loss rel {loss_rel:.2e}, digest rel "
                 f"{max(dig):.2e} (bound 2^-7), ranks identical {same}")
    taken = line["gloo_cuda_tensors_taken"] = ranks[0]["cuda_tensors_taken"]
    if any(v is not True for v in taken.values()):
        fail(f"gloo refused CUDA tensors: {taken}")
    say(f"data axis: gloo takes CUDA tensors as they are: {taken} "
        "(the port hands gloo the card's tensors)")
    return line, launches, bodies


def _mesh_case(case, rank):
    """One case of phase 24, 26 or of the four-card run on this rank: the contrastive (or the
    medmamba classifier) step at full width on ``case["shape"]`` = (data,
    fsdp, model) over the rows of the rank's batch index, from the weights
    and batches of seed 0 (``case["setup"]``: more arguments of the setup,
    a ``quant`` mode); 2 steps whose losses, launches and gathered
    parameter digest are kept, the second timed and its collectives
    counted by kind; warm-up steps to ``case["warm"]``, ``case["timed"]``
    timed steps (none: the second step's time stands), then, unless
    ``case["time_collectives"]`` is False, one step with every collective
    timed apart. Returns its readings."""
    import torch
    import torch.distributed as dist

    from mamba_clip_tpu_torch.ops.flash_attn import (flash_attn_bwd_dkv, flash_attn_bwd_dq,
                                                     flash_attn_fwd)
    from mamba_clip_tpu_torch.ops.selective_scan import selective_scan_bwd, selective_scan_fwd
    from mamba_clip_tpu_torch.parallel import collectives as coll
    from mamba_clip_tpu_torch.parallel import sharding
    from mamba_clip_tpu_torch.parallel.mesh import MeshSpec, create_mesh
    from mamba_clip_tpu_torch.profile_train import clip_train_setup, medmamba_train_setup

    mesh = create_mesh(MeshSpec(*case["shape"]))
    setup = clip_train_setup if case["kind"] == "clip" else medmamba_train_setup
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    state, step_fn, batches = setup(case["global"], mesh=mesh, **case.get("setup", {}))
    ax = mesh.axis()
    per = case["global"] // ax.world
    mine = [{k: v[ax.rank * per:(ax.rank + 1) * per] for k, v in b.items()} for b in batches]
    wrappers = {"fwd": flash_attn_fwd, "dkv": flash_attn_bwd_dkv, "dq": flash_attn_bwd_dq,
                "scan_fwd": selective_scan_fwd, "scan_bwd": selective_scan_bwd}
    for w in wrappers.values():
        w.launches = 0
        for body in getattr(w, "launches_by_body", {}):
            w.launches_by_body[body] = 0
    losses, gns = [], []
    state, m = step_fn(state, mine[0], 0)
    losses.append(float(m["loss"]))
    gns.append(float(m["grad_norm"]))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with coll.count_collectives() as by_kind:
        state, m = step_fn(state, mine[1], 0)
        losses.append(float(m["loss"]))
        gns.append(float(m["grad_norm"]))
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3
    counts = {k: w.launches for k, w in wrappers.items()}
    bodies = {k: dict(w.launches_by_body) for k, w in wrappers.items()
              if hasattr(w, "launches_by_body")}
    digest = param_digest(state.model)
    held = state_bytes(state)
    for i in range(2, case["warm"]):
        state, _ = step_fn(state, mine[i % 2], 0)
    torch.cuda.synchronize()
    if case["timed"]:
        t0 = time.perf_counter()
        for i in range(case["timed"]):
            state, m = step_fn(state, mine[i % 2], 0)
        float(m["loss"])
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) * 1e3 / case["timed"]
    spent = {"ms": None, "calls": None}
    if case.get("time_collectives", True):
        spent = {"ms": 0.0, "calls": 0}

    def timed(fn):
        def wrapped(*a, **kw):
            torch.cuda.synchronize()
            t = time.perf_counter()
            r = fn(*a, **kw)
            torch.cuda.synchronize()
            spent["ms"] += (time.perf_counter() - t) * 1e3
            spent["calls"] += 1
            return r
        return wrapped

    real = [(mod, n, getattr(mod, n)) for mod, names in (
        (coll, ("all_reduce_", "all_gather_", "reduce_scatter_")),
        (sharding, ("all_reduce_", "all_gather_", "reduce_scatter_"))) for n in names]
    if spent["ms"] is not None:
        for mod, n, f in real:
            setattr(mod, n, timed(f))
        try:
            state, _ = step_fn(state, mine[0], 0)
            torch.cuda.synchronize()
        finally:
            for mod, n, f in real:
                setattr(mod, n, f)
    out = {"shape": list(case["shape"]), "global_rows": case["global"], "rows": per,
           "losses": losses, "grad_norms": gns, "digest": digest, "counts": counts,
           "bodies": bodies, "state_bytes": held, "ms_per_step": step_ms,
           "collectives_ms_per_step": spent["ms"], "collective_calls_per_step": spent["calls"],
           "collectives_by_kind": {k: dict(v) for k, v in by_kind.items()},
           "peak_bytes": torch.cuda.max_memory_allocated(),
           "reduce_scatter": dist.get_backend(mesh.groups["fsdp"]) if mesh.fsdp > 1 else None}
    del state, step_fn, batches, mine
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _mesh_rank(rank, world, port, backend, cases, q):
    """One rank of phase 24 (gloo, every rank on card 0) or of the four-card
    run (nccl, rank r on card r): each case of ``cases`` in turn
    (``_mesh_case``); under gloo first whether it takes the card's tensors
    for a reduce-scatter. Puts (rank, result, error) on ``q``."""
    import traceback

    try:
        sys.path.insert(0, str(SRC))
        logging.disable(logging.INFO)
        import torch
        import torch.distributed as dist

        from mamba_clip_tpu_torch.ops import cuda_build

        torch.cuda.set_device(rank if backend == "nccl" else 0)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        for k in ("selective_scan_fwd", "selective_scan_bwd", "flash_attn_fwd",
                  "flash_attn_bwd"):
            cuda_build.load(k)
        dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                                world_size=world)
        out = {"backend": backend, "card": torch.cuda.current_device()}
        if backend == "gloo":
            try:  # the answer is the finding
                t = torch.ones(2 * world, device="cuda")
                got = torch.empty(2, device="cuda")
                dist.reduce_scatter_tensor(got, t)
                torch.cuda.synchronize()
                out["gloo_reduce_scatter_cuda"] = bool(torch.all(got == world))
            except Exception as e:
                out["gloo_reduce_scatter_cuda"] = f"{type(e).__name__}: {str(e)[:160]}"
        for case in cases:
            out[case["name"]] = _mesh_case(case, rank)
        dist.destroy_process_group()
        q.put((rank, out, None))
    except BaseException:
        q.put((rank, None, traceback.format_exc()))


def _mesh_gates(what, ranks, ref, want, gate=None):
    """Fails unless the ranks agree bit for bit (losses and gathered digest),
    each launched ``want`` (the first 2 steps; flash on the tensor cores),
    and, with a reference, the losses and digest are within 2^-7 of it.
    Returns (loss rel, digest rel)."""
    import numpy as np

    gate = gate or CLIP_TRAIN_REL
    r0 = ranks[0]
    for r in ranks:
        if r["losses"] != r0["losses"] or not np.array_equal(r["digest"], r0["digest"]):
            fail(f"{what}: the ranks differ: losses {[x['losses'] for x in ranks]}")
        counts = {k: r["counts"][k] for k in want}
        if counts != want or any(by["cuda_cores"] for by in r["bodies"].values()):
            fail(f"{what}: a rank launched {r['counts']} ({r['bodies']}), expected {want} "
                 "with every flash launch on the tensor cores")
        if not all(math.isfinite(x) for x in r["losses"] + r["grad_norms"]):
            fail(f"{what}: non-finite losses {r['losses']} or grad norms {r['grad_norms']}")
    if ref is None:
        return None, None
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(r0["losses"], ref["losses"]))
    dig = float(np.abs(r0["digest"] - ref["digest"]).max() / np.abs(ref["digest"]).max())
    if loss_rel > gate or dig > gate:
        fail(f"{what}: losses {r0['losses']} against {ref['losses']} (rel {loss_rel:.2e}), "
             f"digest rel {dig:.2e} (bound 2^-7)")
    return loss_rel, dig


def _mesh_row(r, ranks):
    """The printed readings of one case: rank 0's, and every rank's ms,
    collectives' ms and peak."""
    return {"shape": r["shape"], "global_rows": r["global_rows"], "rows_a_rank": r["rows"],
            "losses": r["losses"], "grad_norms": r["grad_norms"],
            "ms_per_step": [x["ms_per_step"] for x in ranks],
            "collectives_ms_per_step": [x["collectives_ms_per_step"] for x in ranks],
            "collective_calls_per_step": r["collective_calls_per_step"],
            "peak_bytes": [x["peak_bytes"] for x in ranks],
            "state_bytes": [x["state_bytes"] for x in ranks],
            "reduce_scatter_backend": r["reduce_scatter"]}


def one_process(setup, rows, **kw):
    """One process's run of a phase 24/26 reference on the card: 2 steps of
    ``setup(rows, **kw)``, then a third timed; its losses, parameter digest,
    ms a step, state bytes and peak."""
    import torch

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    state, step_fn, batches = setup(rows, **kw)
    losses = []
    for i in range(2):
        state, m = step_fn(state, batches[i], 0)
        losses.append(float(m["loss"]))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, m = step_fn(state, batches[0], 0)
    float(m["loss"])
    torch.cuda.synchronize()
    one = {"losses": losses, "digest": param_digest(state.model),
           "ms_per_step": (time.perf_counter() - t0) * 1e3,
           "state_bytes": state_bytes(state),
           "peak_bytes": torch.cuda.max_memory_allocated()}
    del state, step_fn, batches
    gc.collect()
    torch.cuda.empty_cache()
    return one


def mesh_phase(card):
    """Phase 24: the fsdp and model axes on two gloo ranks sharing the card,
    against one process at 64 rows. Returns (the ``mesh_axes`` line's
    fields, the ranks' flash launches by body, the one process's
    readings)."""
    import torch

    from mamba_clip_tpu_torch.profile_train import clip_train_setup

    line = {"card": card, "note": "two gloo ranks share one card: not a scaling number"}
    one = one_process(clip_train_setup, 64)
    line["one_process"] = {k: v for k, v in one.items() if k != "digest"}
    cases = [{"name": "fsdp2", "kind": "clip", "shape": (1, 2, 1), "global": 64, "warm": 2,
              "timed": 1},
             {"name": "model2", "kind": "clip", "shape": (1, 1, 2), "global": 64, "warm": 2,
              "timed": 1}]
    ranks = run_ranks(2, "gloo", cases, target=_mesh_rank)
    want = {"fwd": 48, "dkv": 48, "dq": 48}
    bodies = {k: {"tensor_cores": 0, "cuda_cores": 0} for k in want}
    for case in cases:
        rs = [r[case["name"]] for r in ranks]
        loss_rel, dig = _mesh_gates(f"mesh {case['name']}", rs, one, want)
        for r in rs:
            for k in want:
                for body, c in r["bodies"][k].items():
                    bodies[k][body] += c
        row = _mesh_row(rs[0], rs)
        row.update(loss_rel=loss_rel, digest_rel_max=dig,
                   state_bytes_share=rs[0]["state_bytes"] / one["state_bytes"])
        line[case["name"]] = row
        say(f"mesh {case['name']} {case['shape']}: 2 gloo ranks x {rs[0]['rows']} rows against "
            f"one process x 64: losses {[round(x, 5) for x in rs[0]['losses']]} / "
            f"{[round(x, 5) for x in one['losses']]} (rel {loss_rel:.2e}), digest rel "
            f"{dig:.2e}, ranks identical; state {rs[0]['state_bytes'] / 1e9:.3f} GB a rank "
            f"against {one['state_bytes'] / 1e9:.3f} GB; {rs[0]['ms_per_step']:.1f} ms a step "
            f"a rank ({rs[0]['collectives_ms_per_step']:.1f} ms in "
            f"{rs[0]['collective_calls_per_step']} collectives) against "
            f"{one['ms_per_step']:.1f} ms in one process; peak "
            f"{rs[0]['peak_bytes'] / 1e9:.2f} GB a rank; reduce-scatter through "
            f"{rs[0]['reduce_scatter']}")
    line["gloo_reduce_scatter_cuda"] = ranks[0]["gloo_reduce_scatter_cuda"]
    say(f"mesh: gloo's reduce_scatter on the card's tensors: "
        f"{line['gloo_reduce_scatter_cuda']}")
    return line, bodies, one


# the quant cases of phase 26 (model 2): global rows (two gloo ranks sharing
# one card move every column-parallel output through the host: phase 24's
# (model 2) at 64 rows takes about 9 s a step), setup arguments and launches
# a rank in its 2 steps
QUANT_MESH_ROWS = 16
QUANT_MESH_CASES = [
    ("clip_int8_fast_model2", "clip", {"quant": "int8_fast"}),
    ("clip_aqt_int8_model2", "clip", {"quant": "int8"}),
    ("medmamba_int8_fast_model2", "cls", {"quant": "int8_fast"}),
]
FLASH_2_STEPS = {"fwd": 48, "dkv": 48, "dq": 48}
SCAN_2_STEPS = {"scan_fwd": 28, "scan_bwd": 28}


def quant_mesh_phase(card, one_fsdp):
    """Phase 26: ``--quant`` under the model axis and per-layer gathering on
    the fsdp axis, on two gloo ranks sharing the card, each case against
    one process on the card (``one_fsdp``: phase 24's, the fsdp case's).
    Returns (the ``quant_mesh_axes`` line's fields, the ranks' flash
    launches by body, their scan launches)."""
    from mamba_clip_tpu_torch.profile_train import clip_train_setup, medmamba_train_setup

    line = {"card": card, "note": "two gloo ranks share one card: not a scaling number",
            "rows_quant_cases": QUANT_MESH_ROWS}
    refs = {name: one_process(clip_train_setup if kind == "clip" else medmamba_train_setup,
                              QUANT_MESH_ROWS, **setup)
            for name, kind, setup in QUANT_MESH_CASES}
    refs["clip_fsdp2_per_layer"] = one_fsdp
    cases = [{"name": name, "kind": kind, "shape": (1, 1, 2), "global": QUANT_MESH_ROWS,
              "warm": 2, "timed": 0, "time_collectives": False, "setup": setup}
             for name, kind, setup in QUANT_MESH_CASES]
    cases.append({"name": "clip_fsdp2_per_layer", "kind": "clip", "shape": (1, 2, 1),
                  "global": 64, "warm": 2, "timed": 0, "time_collectives": False})
    ranks = run_ranks(2, "gloo", cases, target=_mesh_rank)
    bodies = {k: {"tensor_cores": 0, "cuda_cores": 0} for k in FLASH_2_STEPS}
    scans = {k: 0 for k in SCAN_2_STEPS}
    for case in cases:
        name = case["name"]
        rs = [r[name] for r in ranks]
        want = FLASH_2_STEPS if case["kind"] == "clip" else SCAN_2_STEPS
        ref = refs[name]
        loss_rel, dig = _mesh_gates(f"phase 26 {name}", rs, ref, want)
        for r in rs:
            for k, by in r["bodies"].items():
                if k in bodies:
                    for body, c in by.items():
                        bodies[k][body] += c
            for k in scans:
                scans[k] += r["counts"][k]
        row = {"shape": rs[0]["shape"], "setup": case.get("setup", {}),
               "global_rows": rs[0]["global_rows"], "rows_a_rank": rs[0]["rows"],
               "losses": rs[0]["losses"], "losses_one_process": ref["losses"],
               "loss_rel": loss_rel, "digest_rel_max": dig,
               "ms_per_step": [x["ms_per_step"] for x in rs],
               "ms_per_step_one_process": ref["ms_per_step"],
               "collectives_by_kind": rs[0]["collectives_by_kind"],
               "peak_bytes": [x["peak_bytes"] for x in rs],
               "peak_bytes_one_process": ref["peak_bytes"],
               "state_bytes": [x["state_bytes"] for x in rs],
               "state_bytes_one_process": ref["state_bytes"],
               "launches_a_rank": {k: rs[0]["counts"][k] for k in want}}
        line[name] = row
        kinds = ", ".join(f"{k} x{v['count']} ({v['bytes'] / 1e6:.1f} MB)"
                          for k, v in sorted(row["collectives_by_kind"].items()))
        say(f"phase 26 {name} {case['shape']} {case.get('setup', {})}: 2 gloo ranks x "
            f"{rs[0]['rows']} rows against one process x {case['global']}: losses "
            f"{[round(x, 5) for x in rs[0]['losses']]} / {[round(x, 5) for x in ref['losses']]} "
            f"(rel {loss_rel:.2e}), digest rel {dig:.2e}, ranks identical; "
            f"{rs[0]['ms_per_step']:.1f} ms a step a rank against {ref['ms_per_step']:.1f}; "
            f"a step's collectives: {kinds}; peak {rs[0]['peak_bytes'] / 1e9:.2f} GB a rank "
            f"against {ref['peak_bytes'] / 1e9:.2f} GB; state {rs[0]['state_bytes'] / 1e9:.3f} "
            f"GB a rank against {ref['state_bytes'] / 1e9:.3f} GB")
    return line, bodies, scans


# ---------------------------------------------------------------------------
# phase 25 and the four-card run's additions: the sequence-parallel scan,
# GPipe and data-sharded serving
# ---------------------------------------------------------------------------


SP_SCAN = {"B": 64, "G": 4, "L": 3136, "DG": 64, "N": 16}  # medmamba's first stage
PIPE = {"batch": 32, "tokens": 197}                        # BiomedCLIP's ViT at 224
PIPE_BLOCKS = 12


def vit_blocks(dev, seed=0):
    """BiomedCLIP's 12 visual ``EncoderBlock``s (amp: bf16 compute, fp32
    parameters; the flash interior), random weights from ``seed``: a template
    block on ``dev`` and the 12 blocks' parameters by name, on ``dev``."""
    import torch

    from mamba_clip_tpu_torch.models.clip import resolve_gelu_approx
    from mamba_clip_tpu_torch.models.vit import VisionTransformer

    # build_clip("biomedclip")'s visual tower, made first from its generator
    bf16 = torch.bfloat16
    visual = VisionTransformer(image_size=224, embed_dim=512,
                               gelu_approx=resolve_gelu_approx("auto", bf16), dtype=bf16,
                               attn_flash=True, generator=torch.Generator().manual_seed(seed))
    blocks = [getattr(visual, f"block{i}") for i in range(PIPE_BLOCKS)]
    params = [{k: t.detach().to(dev) for k, t in b.named_parameters()} for b in blocks]
    return blocks[0].to(dev), params


def pipe_inputs(dev, shape, seed=25):
    """The pipelined blocks' input (bf16, as the ViT's blocks take it) and the
    loss's weights at ``shape`` (batch, tokens), from ``seed``."""
    import torch

    g = torch.Generator(device=dev).manual_seed(seed)
    size = (shape["batch"], shape["tokens"], 768)
    x = torch.randn(*size, generator=g, device=dev).to(torch.bfloat16)
    w = torch.randn(*size, generator=g, device=dev)
    return x, w


def grad_digest(tensors, stride: int = 997):
    """Every ``stride``-th entry of each tensor's gradient, in fp32, as one
    numpy vector."""
    import torch

    return torch.cat([t.grad.float().flatten()[::stride] for t in tensors]).cpu().numpy()


def _sp_scan(rank, world, dev, shp):
    """(a) The sharded scan on this rank: its slice of one seeded sequence
    against one process's unsharded scan (kernel 1 forward, kernel 2 under
    autograd) on the whole of it, y and the 7 gradients (the replicated A, D
    and bias after their sum); the launches, permutes and peak of the
    counted run, then ms a forward and backward, sharded and not."""
    import torch

    from mamba_clip_tpu_torch.ops.selective_scan import (selective_scan_bwd, selective_scan_fwd,
                                                         selective_scan_tm)
    from mamba_clip_tpu_torch.ops.sharded_scan import sharded_selective_scan_tm
    from mamba_clip_tpu_torch.parallel.collectives import count_collectives, permute_path

    Bsz, G, L, DG, N = (shp[k] for k in ("B", "G", "L", "DG", "N"))
    g = torch.Generator(device=dev).manual_seed(25)
    r = lambda *s: torch.randn(*s, generator=g, device=dev)  # noqa: E731
    full = (r(Bsz, G, L, DG), r(Bsz, G, L, DG) * 0.5, -torch.exp(r(G * DG, N) * 0.5),
            r(Bsz, G, L, N), r(Bsz, G, L, N), r(G * DG), r(G * DG) * 0.1 - 2.0)
    w = r(Bsz, G, L, DG)
    n = L // world
    sl = slice(rank * n, (rank + 1) * n)
    seq = (0, 1, 3, 4)  # u, delta, B, C: split over L; A, D, bias whole

    def unsharded():
        leaves = [t.clone().requires_grad_(True) for t in full]
        y = selective_scan_tm(*leaves, delta_softplus=True)
        (y * w).sum().backward()
        return [y.detach()] + [t.grad for t in leaves]

    def sharded(colls=None):
        leaves = [(t[:, :, sl] if i in seq else t).clone().requires_grad_(True)
                  for i, t in enumerate(full)]
        with count_collectives() as fwd:
            y = sharded_selective_scan_tm(*leaves, delta_softplus=True)
        with count_collectives() as bwd:
            (y * w[:, :, sl]).sum().backward()
        if colls is not None:
            colls.update(forward=fwd, backward=bwd)
        return [y.detach()] + [t.grad for t in leaves]

    ref = unsharded()
    want = [t[:, :, sl] if i in (0, 1, 2, 4, 5) else t for i, t in enumerate(ref)]
    del ref
    if dev.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated() if dev.type == "cuda" else 0
    selective_scan_fwd.launches = selective_scan_bwd.launches = 0
    colls = {}
    got = sharded(colls)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    launches = {"scan_fwd": selective_scan_fwd.launches, "scan_bwd": selective_scan_bwd.launches}
    peak = torch.cuda.max_memory_allocated() if dev.type == "cuda" else 0
    errs = rel_errs(got, want)
    out = {"launches": launches, "collectives": colls, "peak_bytes": peak,
           "peak_above_inputs_bytes": peak - held,
           "errs": dict(zip(("y",) + GRAD_NAMES, errs)),
           "replicated": [got[i].cpu().numpy() for i in (3, 6, 7)],  # dA, dD, dbias
           "permute_path": permute_path(full[0], None)}
    del got, want
    if dev.type == "cuda":
        out["ms"] = cuda_ms(sharded, iters=3, warmup=1)
        out["ms_unsharded"] = cuda_ms(unsharded, iters=3, warmup=1)
    return out


def _sp_pipe(rank, world, dev, M, shape):
    """(b) GPipe of the 12 blocks as ``world`` stages on this rank, ``M``
    microbatches, at ``shape``: one counted forward and backward (its flash launches,
    output, gradient digest of this stage's blocks), then ms a step."""
    import torch

    from mamba_clip_tpu_torch.ops.flash_attn import (flash_attn_bwd_dkv, flash_attn_bwd_dq,
                                                     flash_attn_fwd)
    from mamba_clip_tpu_torch.parallel.pipeline import pipeline_apply, stack_stages

    template, params = vit_blocks(dev)
    k = PIPE_BLOCKS // world
    mine = params[rank * k:(rank + 1) * k]
    for p in mine:
        for t in p.values():
            t.requires_grad_(True)
    x, w = pipe_inputs(dev, shape)

    def stage(p, h):
        for j in range(k):
            h = torch.func.functional_call(template, p[f"sub{j}"], (h,))
        return h

    def step():
        for p in mine:
            for t in p.values():
                t.grad = None
        stacked = stack_stages([{f"sub{j}": mine[j] for j in range(k)}])
        out = pipeline_apply(stage, stacked, x, microbatches=M)
        (out.float() * w).sum().backward()
        return out.detach()

    wrappers = {"fwd": flash_attn_fwd, "dkv": flash_attn_bwd_dkv, "dq": flash_attn_bwd_dq}
    for wr in wrappers.values():
        wr.launches = 0
        for body in wr.launches_by_body:
            wr.launches_by_body[body] = 0
    out = step()
    if dev.type == "cuda":
        torch.cuda.synchronize()
    res = {"M": M, "launches": {n: wr.launches for n, wr in wrappers.items()},
           "bodies": {n: dict(wr.launches_by_body) for n, wr in wrappers.items()},
           "digest": grad_digest([t for p in mine for t in p.values()]),
           "out_digest": out.float().flatten()[::97].cpu().numpy()}
    if rank == 0:
        res["out"] = out.float().cpu().numpy()
    if dev.type == "cuda":
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(2):
            step()
        torch.cuda.synchronize()
        res["ms_per_step"] = (time.perf_counter() - t0) * 1e3 / 2
    return res


def _sp_rank(rank, world, port, backend, cfg, q):
    """One rank of phase 25 (gloo, both ranks on card 0) or of the four-card
    run (nccl, rank r on card r), or of a CPU rehearsal (gloo, ``cfg["device"]``
    "cpu"): the sharded scan at ``cfg["scan"]``, then GPipe at each M of
    ``cfg["pipe_m"]`` and ``cfg["pipe"]``. Puts (rank, result, error) on
    ``q``."""
    import traceback

    try:
        sys.path.insert(0, str(SRC))
        logging.disable(logging.INFO)
        import torch
        import torch.distributed as dist

        from mamba_clip_tpu_torch.parallel.collectives import all_reduce_

        if cfg["device"] == "cuda":
            from mamba_clip_tpu_torch.ops import cuda_build

            card = rank if backend == "nccl" else 0
            torch.cuda.set_device(card)
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
            for k in ("selective_scan_fwd", "selective_scan_bwd", "flash_attn_fwd",
                      "flash_attn_bwd"):
                cuda_build.load(k)
            dev = torch.device("cuda", card)
        else:
            torch.set_num_threads(1)
            dev = torch.device("cpu")
        dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                                world_size=world)
        # every rank's first collective together (nccl makes its communicator)
        all_reduce_(torch.zeros(1, device=dev))
        out = {"backend": backend, "scan": _sp_scan(rank, world, dev, cfg["scan"]),
               "pipe": [_sp_pipe(rank, world, dev, M, cfg["pipe"]) for M in cfg["pipe_m"]]}
        dist.destroy_process_group()
        q.put((rank, out, None))
    except Exception:
        q.put((rank, None, traceback.format_exc()))


def pipe_reference(dev, shape, microbatches):
    """The 12 blocks in sequence on one device, with the weights, input and
    loss of ``_sp_pipe`` at ``shape``: for each M of ``microbatches``, the
    microbatches through the blocks in turn and one backward of their loss
    (the sums and roundings of the pipeline's ticks, without its schedule),
    and the whole batch at once (M = 1): the output, the gradient digest (the
    blocks in order) and ms a forward and backward. By M."""
    import torch

    template, params = vit_blocks(dev)
    leaves = [t for p in params for t in p.values()]
    for t in leaves:
        t.requires_grad_(True)
    x, w = pipe_inputs(dev, shape)

    def step(M):
        for t in leaves:
            t.grad = None
        outs = []
        for xm in x.chunk(M):
            h = xm
            for p in params:
                h = torch.func.functional_call(template, p, (h,))
            outs.append(h)
        out = torch.cat(outs)
        (out.float() * w).sum().backward()
        return out.detach()

    refs = {}
    for M in sorted(set(microbatches) | {1}):
        out = step(M)
        refs[M] = {"out": out.float().cpu().numpy(), "digest": grad_digest(leaves)}
        if dev.type == "cuda":
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(2):
                step(M)
            torch.cuda.synchronize()
            refs[M]["ms_per_step"] = (time.perf_counter() - t0) * 1e3 / 2
    del params, template, leaves
    return refs


def sp_gates(what, ranks, world, pipe_ref, cfg):
    """Fails unless (a) every rank's y and 7 gradients are within the scan's
    gate of the unsharded scan, the replicated gradients bit for bit alike
    on every rank, one forward and one backward scan launch a rank (none
    on the CPU), 2 (ceil(log2 S) + 1) permutes; and (b) for each M, the
    ranks' outputs alike, the output and the stages' gradient digest within
    2^-7 of the same microbatches through the blocks in sequence and of the
    whole batch at once (the first isolates the schedule: microbatching
    alone moves the digest by bf16 roundings), (M + S - 1)·12/S flash
    launches of each kernel a rank on the tensor cores. Returns the line's
    fields and the ranks' launches (scan by counter, flash by body)."""
    import numpy as np

    on_card = cfg["device"] == "cuda"

    from mamba_clip_tpu_torch.ops.sharded_scan import carry_rounds

    line = {}
    scan_launches = {"scan_fwd": 0, "scan_bwd": 0}
    flash = {n: {"tensor_cores": 0, "cuda_cores": 0} for n in ("fwd", "dkv", "dq")}
    # (a)
    want = {"scan_fwd": 1, "scan_bwd": 1} if on_card else {"scan_fwd": 0, "scan_bwd": 0}
    n_perm = 2 * carry_rounds(world)
    sc = cfg["scan"]
    shard_bytes = sc["B"] * sc["G"] * sc["DG"] * sc["N"] * 4  # an (A_s, h_s) half, fp32
    for r, rank in enumerate(ranks):
        s = rank["scan"]
        worst = max(e[0] for e in s["errs"].values())
        if worst > GATE_REL:
            fail(f"{what} sharded scan rank {r}: {s['errs']} (gate {GATE_REL:g})")
        if s["launches"] != want:
            fail(f"{what} sharded scan rank {r}: launches {s['launches']}, expected {want}: one "
                 "selective_scan_tm forward and its backward on the rank's slice")
        perm = s["collectives"]["forward"]
        if perm != {"collective-permute": {"count": n_perm, "bytes": n_perm * shard_bytes}}:
            fail(f"{what} sharded scan rank {r}: the forward's collectives {perm}, expected "
                 f"{n_perm} permutes of {shard_bytes} bytes")
        for a, b in zip(s["replicated"], ranks[0]["scan"]["replicated"]):
            if not np.array_equal(a, b):
                fail(f"{what} sharded scan: the replicated gradients differ between ranks 0 "
                     f"and {r}")
        for key, c in s["launches"].items():
            scan_launches[key] += c
    s0 = ranks[0]["scan"]
    line["sharded_scan"] = {
        "shape": cfg["scan"], "ranks": world, "rows_per_rank_L": cfg["scan"]["L"] // world,
        "max_rel_err": max(max(e[0] for e in r["scan"]["errs"].values()) for r in ranks),
        "errs_rank0": {k: {"rel": e[0], "abs": e[1]} for k, e in s0["errs"].items()},
        "launches_per_rank": s0["launches"], "collectives_rank0": s0["collectives"],
        "permute_path": s0["permute_path"],
        "ms": [r["scan"].get("ms") for r in ranks],
        "ms_unsharded": [r["scan"].get("ms_unsharded") for r in ranks],
        "peak_bytes": [r["scan"]["peak_bytes"] for r in ranks],
        "peak_above_inputs_bytes": [r["scan"]["peak_above_inputs_bytes"] for r in ranks]}
    say(f"{what} sharded scan: {world} ranks x L {cfg['scan']['L'] // world}: y and 7 gradients "
        f"within {line['sharded_scan']['max_rel_err']:.2e} of one process's unsharded scan "
        f"(gate {GATE_REL:g}), the replicated dA, dD, dbias alike on every rank; "
        f"{s0['launches']} launches a rank, {n_perm} permutes "
        f"({s0['collectives']}) through the {s0['permute_path']} path; ms a forward and "
        f"backward {line['sharded_scan']['ms']} (unsharded on one process "
        f"{line['sharded_scan']['ms_unsharded']}), peak "
        f"{[round(b / 1e9, 2) for b in line['sharded_scan']['peak_bytes']]} GB a rank")
    # (b)
    k = PIPE_BLOCKS // world
    for i, r0 in enumerate(ranks[0]["pipe"]):
        M = r0["M"]
        T = M + world - 1
        want = ({n: T * k for n in flash} if on_card else {n: 0 for n in flash})
        for r, rank in enumerate(ranks):
            p = rank["pipe"][i]
            if p["launches"] != want or any(by["cuda_cores"] for by in p["bodies"].values()):
                fail(f"{what} GPipe M={M} rank {r}: flash launches {p['launches']} "
                     f"({p['bodies']}), expected {want} on the tensor cores")
            if not np.array_equal(p["out_digest"], r0["out_digest"]):
                fail(f"{what} GPipe M={M}: the output differs between ranks 0 and {r}")
            for n in flash:
                for body, c in p["bodies"][n].items():
                    flash[n][body] += c
        dig = np.concatenate([rank["pipe"][i]["digest"] for rank in ranks])

        def rels(ref):
            return (float(np.abs(r0["out"] - ref["out"]).max() / np.abs(ref["out"]).max()),
                    float(np.abs(dig - ref["digest"]).max() / np.abs(ref["digest"]).max()))

        out_rel, dig_rel = rels(pipe_ref[M])
        whole_out_rel, whole_dig_rel = rels(pipe_ref[1])
        if max(out_rel, dig_rel, whole_out_rel, whole_dig_rel) > CLIP_TRAIN_REL:
            fail(f"{what} GPipe M={M}: output rel {out_rel:.2e}, gradient digest rel "
                 f"{dig_rel:.2e} against the same microbatches through the blocks in sequence, "
                 f"{whole_out_rel:.2e} and {whole_dig_rel:.2e} against the whole batch at once "
                 "(bound 2^-7)")
        row = {"stages": world, "blocks_per_stage": k, "microbatches": M, "ticks": T,
               "bubble_share": (world - 1) / T, "out_rel": out_rel, "grad_digest_rel": dig_rel,
               "whole_batch_out_rel": whole_out_rel,
               "whole_batch_grad_digest_rel": whole_dig_rel,
               "flash_launches_per_rank": want,
               "ms_per_step": [rank["pipe"][i].get("ms_per_step") for rank in ranks],
               "ms_per_step_sequential": pipe_ref[M].get("ms_per_step"),
               "ms_per_step_sequential_whole_batch": pipe_ref[1].get("ms_per_step")}
        line[f"gpipe_m{M}"] = row
        say(f"{what} GPipe: 12 ViT blocks as {world} stages of {k}, M={M}, B "
            f"{cfg['pipe']['batch']}: output rel {out_rel:.2e}, gradient digest rel "
            f"{dig_rel:.2e} against the same microbatches through the blocks in sequence, "
            f"{whole_out_rel:.2e} and {whole_dig_rel:.2e} against the whole batch at once "
            f"(bound 2^-7); {want} flash launches a rank; ms a step "
            f"{row['ms_per_step']} against {row['ms_per_step_sequential']} in sequence "
            f"({row['ms_per_step_sequential_whole_batch']} the whole batch); bubble "
            f"{row['bubble_share']:.3f}")
    return line, scan_launches, flash


SHARDED_REFUSAL = ("artifact exported with data_shards={s} but this host has {n} device(s); "
                   "export with --data-shards 1 for this host (or serve on a {s}-device host)")


def export_sharded(tmp, model_name, shards):
    """``{S: artifact dir}`` of ``model_name`` (amp, random weights from seed
    0) at each S of ``shards``, one weights file's contents for all."""
    from mamba_clip_tpu_torch.serving import export_serving

    dirs = {}
    for S in shards:
        dirs[S] = os.path.join(tmp, f"{model_name}_s{S}")
        export_serving(dirs[S], model_name, data_shards=S)
    return dirs


def sync_cards():
    import torch

    for i in range(torch.cuda.device_count()):
        torch.cuda.synchronize(i)


def rows_per_s(fn, x, iters=5, warmup=2):
    """rows/s of ``fn(x)`` (every card synchronised around the timed calls)."""
    for _ in range(warmup):
        fn(x)
    sync_cards()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn(x)
    sync_cards()
    return x.shape[0] * iters / (time.perf_counter() - t0)


def sharded_serving_phase(card, tally):
    """Phase 25 (c): a medmamba artifact at S = 2 (both replicas on card 0)
    and at S = 1 from the same seed: ``classify`` at batch 64 bit for bit the
    S = 1 artifact's on each 32-row slice, 2 x 14 scan launches; a batch of
    63 raises; ``serve_http.make_server`` refuses S = 2 on this one-card
    host with JAX's message. Returns the ``sharded_serving`` line's fields."""
    import numpy as np
    import torch

    from mamba_clip_tpu_torch.serve_http import make_server
    from mamba_clip_tpu_torch.serving import load_serving

    tmp = tempfile.mkdtemp(prefix="sharded_serving_")
    try:
        dirs = export_sharded(tmp, "medmamba", (1, 2))
        one = load_serving(dirs[1], device="cuda")["classify"]
        two = load_serving(dirs[2], devices=["cuda:0", "cuda:0"])["classify"]
        x = np.random.RandomState(25).randint(0, 256, (64, 256, 256, 3)).astype(np.uint8)
        got = tally("S=2 classify at batch 64", lambda: two(x), {"scan_fwd": 28})
        want = torch.cat([one(x[i * 32:(i + 1) * 32]) for i in range(2)])
        if not torch.equal(got, want):
            fail(f"phase 25 sharded serving: S=2 classify differs from S=1's on its slices by "
                 f"{float((got - want).abs().max()):.3e}")
        try:
            two(x[:63])
            fail("phase 25 sharded serving: a batch of 63 did not raise at data_shards=2")
        except ValueError as e:
            if "data_shards=2" not in str(e):
                fail(f"phase 25 sharded serving: a batch of 63 raised {e!r}")
            msg63 = str(e)
        want_msg = SHARDED_REFUSAL.format(s=2, n=torch.cuda.device_count())
        try:
            make_server(dirs[2], port=0, device="cuda").server_close()
            fail("phase 25 sharded serving: make_server took a data_shards=2 artifact on a "
                 "one-card host")
        except ValueError as e:
            if str(e) != want_msg:
                fail(f"phase 25 sharded serving: make_server raised {str(e)!r}, JAX's message "
                     f"is {want_msg!r}")
        line = {"card": card, "model": "medmamba classify", "batch": 64,
                "s2_equals_s1_per_slice": True, "launches_s2_batch64": {"scan_fwd": 28},
                "batch63": msg63, "make_server_refusal": want_msg,
                "rows_per_s_s1": rows_per_s(one, x), "rows_per_s_s2_one_card": rows_per_s(two, x),
                "note": "S = 2 on one card: both replicas share it, not a scaling number"}
        say(f"sharded serving: medmamba classify at S=2 (both replicas on card 0) equals S=1 "
            f"on each 32-row slice bit for bit, 28 scan launches at batch 64; batch 63 raises "
            f"({msg63}); make_server refuses S=2 here with JAX's message; "
            f"{line['rows_per_s_s1']:.1f} rows/s at S=1, {line['rows_per_s_s2_one_card']:.1f} "
            "at S=2 on one card")
        return line
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def sp_phase(card, counters):
    """Phase 25: (a) the sharded scan and (b) GPipe on two gloo ranks sharing
    the card, against one process; (c) data-sharded serving. Returns the
    lines' fields, the launches of the main path by counter and the flash
    launches by body (the ranks' counted in the ranks)."""
    import torch

    gc.collect()
    torch.cuda.empty_cache()
    cfg = {"device": "cuda", "scan": SP_SCAN, "pipe": PIPE, "pipe_m": (4,)}
    pipe_ref = pipe_reference(torch.device("cuda"), PIPE, cfg["pipe_m"])
    gc.collect()
    torch.cuda.empty_cache()
    ranks = run_ranks(2, "gloo", cfg, target=_sp_rank)
    line, scan_launches, flash = sp_gates("phase 25", ranks, 2, pipe_ref, cfg)
    line["card"] = card
    line["note"] = "two gloo ranks share one card: not a scaling number"
    tally = LaunchTally(counters, "phase 25")
    serving = sharded_serving_phase(card, tally)
    launches = {k: tally.total.get(k, 0) + scan_launches.get(k, 0) for k in tally.total}
    for n, by in flash.items():
        launches[n] += by["tensor_cores"] + by["cuda_cores"]
    return line, serving, launches, flash


def cards_serving(card, cards):
    """The four-card run's data-sharded serving: medmamba ``classify`` and
    BiomedCLIP ``image_embed`` artifacts at S = 1, 2 and 4 from one seed,
    replica i on card i. At batch 64·S each 64-row slice must equal the S = 1
    artifact on it bit for bit; rows/s at S = 1, 2, 4 at 64 rows a card; then
    ``serve_http`` over the S = 4 ``classify`` artifact at 1 and 16 clients,
    every answer a 200, bit for bit its row's answer at a batch shape the
    batcher dispatches and within 2e-2 of its direct call on the S = 1
    artifact (at 1 client the shape is 4, one row a card: its direct call bit
    for bit). Returns the fields of the four-card run's ``sharded_serving``
    line."""
    import numpy as np
    import torch

    from mamba_clip_tpu_torch.serve import _bucket
    from mamba_clip_tpu_torch.serve_http import make_server, warm_buckets
    from mamba_clip_tpu_torch.serving import load_serving

    line = {"card": card, "cards": cards}
    tmp = tempfile.mkdtemp(prefix="sharded_serving_cards_")
    shards = (1, 2, cards)
    try:
        for model, entry in (("medmamba", "classify"), ("biomedclip", "image_embed")):
            dirs = export_sharded(tmp, model, shards)
            loaded = {S: load_serving(dirs[S])[entry] for S in shards}
            x = np.random.RandomState(26).randint(0, 256, (64 * cards, 256, 256, 3)).astype(
                np.uint8)
            got = loaded[cards](x)
            want = torch.cat([loaded[1](x[i * 64:(i + 1) * 64]) for i in range(cards)])
            if got.device != torch.device("cuda", 0) or not torch.equal(got, want):
                fail(f"{cards} cards sharded serving {model} {entry}: S={cards} differs from "
                     f"S=1 on its 64-row slices ({got.device})")
            rates = {f"S{S}": rows_per_s(loaded[S], x[:64 * S]) for S in shards}
            line[f"{model}_{entry}"] = {"s_equals_s1_per_slice": True, "rows_per_s": rates,
                                        "rows_per_card": 64}
            say(f"{cards} cards sharded serving {model} {entry}: S={cards} at batch "
                f"{64 * cards} equals S=1 on each 64-row slice bit for bit; rows/s at 64 a "
                f"card: " + ", ".join(f"{k} {v:.1f}" for k, v in rates.items()))
            if model == "medmamba":
                srv = make_server(dirs[cards], port=0, max_batch=16, max_delay_ms=5.0)
                threading.Thread(target=srv.serve_forever, daemon=True).start()
                try:
                    bodies = jpeg_rows(16, 512, seed=27)
                    shapes = sorted({_bucket(1 << k, cards) for k in range(5)})
                    cands = []
                    for body in bodies:
                        row = srv.decode(body)[None]
                        by = {b: srv.served[entry](np.repeat(row, b, axis=0))[0].cpu().numpy()
                              for b in shapes}
                        by[1] = loaded[1](row)[0].cpu().numpy()
                        cands.append(by)
                    if not all(np.array_equal(c[cards], c[1]) for c in cands):
                        fail(f"{cards} cards http: a row's answer at batch {cards} (one row a "
                             "card) differs from its direct call")
                    warm_buckets(srv, entry, bodies[0], 16)
                    http = {}
                    for clients in (1, 16):
                        exact = (cards,) if clients == 1 else tuple(shapes)
                        http[f"c{clients}"] = r = http_load(
                            srv, "/classify", bodies, cands, clients, 2.0,
                            0.0 if clients == 1 else PROBS_ATOL, exact)
                        say(f"{cards} cards http /classify S={cards} clients={clients}: "
                            f"{r['req_per_s']:.1f} req/s, p50 {r['p50_ms']:.2f} p95 "
                            f"{r['p95_ms']:.2f} p99 {r['p99_ms']:.2f} ms; every answer a 200, "
                            f"bit for bit its row's at a batch shape of {list(exact)}, at most "
                            f"{r['max_abs_err_to_direct']:.3e} off its direct call")
                    line["http_classify"] = http
                finally:
                    srv.shutdown()
                    srv.server_close()
            del loaded
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return line


def cards_scaling(card, cards):
    """``bench_scaling.main`` over the data ladder at full width (BiomedCLIP,
    amp, flash, 64 rows a card). Returns the ``scaling`` line's fields: each
    rung's ms a step and img/s, its efficiencies, and its collectives by
    kind, count and MB."""
    from mamba_clip_tpu_torch import bench_scaling

    out = bench_scaling.main(["--devices", str(cards), "--model", "flagship", "--precision",
                              "amp", "--batch-per-device", "64", "--warmup", "3", "--steps",
                              "5", "--timeout", "300"])
    rows = [{"mesh": r["mesh"], "global_batch": r["global_batch"], "step_ms": r["step_ms"],
             "step_ms_ranks": r["step_ms_ranks"], "img_per_s": r["img_per_s"],
             "weak_scaling_efficiency": r["weak_scaling_efficiency"],
             "work_normalized_efficiency": r["work_normalized_efficiency"],
             "loss": r["loss"],
             "collectives": {k: {"count": v["count"], "MB": v["bytes"] / 1e6}
                             for k, v in r["collectives"].items()}} for r in out["rows"]]
    return {"card": card, "cards": cards, "args": {"model": "flagship", "precision": "amp",
                                                    "batch_per_device": 64,
                                                    "image_size": out["image_size"],
                                                    "warmup": 3, "steps": 5},
            "device": out["device"], "rows": rows}


def cards_sp(card, cards):
    """The sharded scan over ``cards`` NCCL ranks at phase 25's shapes (L split
    ``cards`` ways) and GPipe of the 12 blocks as ``cards`` stages at M = 4 and
    8, against one card's unsharded scan and sequential blocks. Returns the
    line's fields."""
    import torch

    cfg = {"device": "cuda", "scan": SP_SCAN, "pipe": PIPE, "pipe_m": (4, 8)}
    pipe_ref = pipe_reference(torch.device("cuda", 0), PIPE, cfg["pipe_m"])
    gc.collect()
    torch.cuda.empty_cache()
    ranks = run_ranks(cards, "nccl", cfg, target=_sp_rank, timeout=600)
    line, _, _ = sp_gates(f"{cards} cards", ranks, cards, pipe_ref, cfg)
    line["card"] = card
    return line


def cards_main(cards: int, only=None) -> None:
    """The four-card run alone (``--cards 4``): four NCCL ranks, one a card, run the
    full-width contrastive step at 64 rows a batch shard at (data 4), (fsdp
    4), (data 2, fsdp 2) and (data 2, model 2), and the medmamba classifier
    step at (data 2, fsdp 2); then the sharded scan and GPipe over four NCCL
    ranks, the scaling bench and data-sharded serving; fails on fewer
    cards."""
    try:
        import torch
    except ImportError as e:
        fail(f"cannot import {e.name}")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke test runs on the card only")
    if torch.cuda.device_count() < cards:
        fail(f"--cards {cards}: {torch.cuda.device_count()} card(s) here")
    sys.path.insert(0, str(SRC))
    from mamba_clip_tpu_torch.ops import cuda_build

    card = nvidia_smi("name,power.limit")
    say(card)
    say(f"torch {torch.__version__} cuda {torch.version.cuda}; {torch.cuda.device_count()} cards")
    built = ("selective_scan_fwd", "selective_scan_bwd", "flash_attn_fwd", "flash_attn_bwd")
    t0 = time.time()
    for k in built:
        cuda_build.library_path(k).unlink(missing_ok=True)
    with ThreadPoolExecutor(len(built)) as pool:
        for f in [pool.submit(cuda_build.build, k) for k in built]:
            f.result()
    say(f"build: {', '.join(built)} in {time.time() - t0:.1f} s")

    def clip(name, shape, rows, **setup):
        return {"name": name, "kind": "clip", "shape": shape,
                "global": rows * shape[0] * shape[1], "warm": 3, "timed": 5, "setup": setup}

    cases = [clip("data4", (4, 1, 1), 64), clip("fsdp4", (1, 4, 1), 64),
             clip("data2_fsdp2", (2, 2, 1), 64), clip("data4_128", (4, 1, 1), 32),
             clip("data2_model2", (2, 1, 2), 64),
             clip("data4_128_int8_fast", (4, 1, 1), 32, quant="int8_fast"),
             clip("data2_model2_int8_fast", (2, 1, 2), 64, quant="int8_fast"),
             {"name": "medmamba_data2_fsdp2", "kind": "cls", "shape": (2, 2, 1),
              "global": 256, "warm": 3, "timed": 5}]
    t0 = time.perf_counter()
    if only:
        cases = [c for c in cases if c["name"] in only]
        if len(cases) != len(set(only)):
            fail(f"--mesh-cases {only}: not all among the four-card cases")
    ran = {c["name"] for c in cases}
    ranks = run_ranks(cards, "nccl", cases, target=_mesh_rank, timeout=700)
    line = {"card": card, "cards": cards, "backend": "nccl"}
    flash = {"fwd": 48, "dkv": 48, "dq": 48}
    for case, ref in (("data4", None), ("fsdp4", "data4"), ("data2_fsdp2", "data4"),
                      ("data4_128", None), ("data2_model2", "data4_128"),
                      ("data4_128_int8_fast", None),
                      ("data2_model2_int8_fast", "data4_128_int8_fast"),
                      ("medmamba_data2_fsdp2", None)):
        if case not in ran:
            continue
        ref = ref if ref in ran else None
        rs = [r[case] for r in ranks]
        want = flash if case.startswith(("data", "fsdp")) else {"scan_fwd": 28,
                                                                 "scan_bwd": 28}
        loss_rel, dig = _mesh_gates(f"{cards} cards {case}", rs,
                                    ranks[0][ref] if ref else None, want)
        row = _mesh_row(rs[0], rs)
        row.update(reference=ref, loss_rel=loss_rel, digest_rel_max=dig)
        line[case] = row
        say(f"{cards} cards {case} {rs[0]['shape']}: {rs[0]['rows']} rows a batch shard, "
            f"{rs[0]['global_rows']} global; losses {[round(x, 5) for x in rs[0]['losses']]}"
            + (f" against {ref}'s (rel {loss_rel:.2e}, digest rel {dig:.2e})" if ref else "")
            + f"; ms a step {[round(x['ms_per_step'], 1) for x in rs]}, collectives "
            f"{[round(x['collectives_ms_per_step'], 1) for x in rs]} ms in "
            f"{rs[0]['collective_calls_per_step']} calls; peak "
            f"{[round(x['peak_bytes'] / 1e9, 2) for x in rs]} GB; state "
            f"{[round(x['state_bytes'] / 1e9, 3) for x in rs]} GB a rank")
    if "fsdp4" in line:
        fsdp = line["fsdp4"]
        line["fsdp4_peak_bytes"] = fsdp["peak_bytes"]
        say(f"{cards} cards (fsdp 4): peak {[round(x / 1e9, 3) for x in fsdp['peak_bytes']]} GB "
            f"a rank, state {fsdp['state_bytes'][0] / 1e9:.3f} GB a rank (package {SRC})"
            + (f"; (data 4): peak {[round(x / 1e9, 3) for x in line['data4']['peak_bytes']]} "
               f"GB, state {line['data4']['state_bytes'][0] / 1e9:.3f} GB"
               if "data4" in line else ""))
    line["phase_s"] = time.perf_counter() - t0
    say(json.dumps({"mesh_axes_cards": line}))
    if only:
        say(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return
    # the sequence-parallel scan and GPipe over the cards' NCCL ranks
    t0 = time.perf_counter()
    sp = cards_sp(card, cards)
    sp["phase_s"] = time.perf_counter() - t0
    say(json.dumps({"sharded_scan_gpipe_cards": sp}))
    # the scaling bench over the data ladder, then data-sharded serving
    t0 = time.perf_counter()
    scaling = cards_scaling(card, cards)
    scaling["phase_s"] = time.perf_counter() - t0
    for r in scaling["rows"]:
        say(f"scaling {r['mesh']}: {r['step_ms']:.1f} ms a step ({r['step_ms_ranks']}), "
            f"{r['img_per_s']:.1f} img/s, weak-scaling efficiency "
            f"{r['weak_scaling_efficiency']:.3f}, collectives "
            + (", ".join(f"{k} x{v['count']} ({v['MB']:.2f} MB)"
                         for k, v in sorted(r["collectives"].items())) or "none"))
    say(json.dumps({"scaling": scaling}))
    t0 = time.perf_counter()
    serving = cards_serving(card, cards)
    serving["phase_s"] = time.perf_counter() - t0
    say(json.dumps({"sharded_serving": serving}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


class LaunchTally:
    """Every count set to 0 just before a driven call and read just after,
    with the launches it must make; the totals over the calls, by counter
    and by flash body."""

    def __init__(self, counters, phase):
        self.reset, self.read, self.bodies = counters
        self.phase = phase
        self.total = {k: 0 for k in self.read()}
        self.total_bodies = {k: {"tensor_cores": 0, "cuda_cores": 0}
                             for k in ("fwd", "dkv", "dq")}

    def add(self, counts, bodies):
        for k in self.total:
            self.total[k] += counts[k]
        for k, by in bodies.items():
            for body, c in by.items():
                self.total_bodies[k][body] += c

    def __call__(self, what, fn, want, check=None):
        """``fn()``; fails unless its launches are ``want`` plus ``check`` (0
        for a counter not named), every flash launch on the tensor cores.
        ``check``: the launches ``fn`` makes to compare a kernel with its
        plain version, left out of the totals."""
        import torch

        check = check or {}
        self.reset()
        out = fn()
        torch.cuda.synchronize()
        counts, bodies = self.read(), self.bodies()
        full = {k: want.get(k, 0) + check.get(k, 0) for k in counts}
        if counts != full or any(by["cuda_cores"] for by in bodies.values()):
            fail(f"{self.phase} {what}: launches {counts}, by body {bodies}; expected {full} "
                 "on the tensor cores")
        self.add({k: n - check.get(k, 0) for k, n in counts.items()},
                 {k: dict(by, tensor_cores=by["tensor_cores"] - check.get(k, 0))
                  for k, by in bodies.items()})
        return out


def hpo_phase(card, reset_counts, read_counts, flash_bodies):
    """Phase 21: the native ASHA search through the CLI at full width, a
    TrialRunner's save and restore, and the optuna and ray gates, each gate
    as the module docstring says. Returns (the ``hpo`` line's fields, the
    launches by counter, the flash launches by body)."""
    import numpy as np
    import torch

    from mamba_clip_tpu_torch import eval as eval_mod
    from mamba_clip_tpu_torch.config import parse_args
    from mamba_clip_tpu_torch.integrations import runner as runner_mod

    counters = (reset_counts, read_counts, flash_bodies)
    tally = LaunchTally(counters, "hpo")
    logs = tempfile.mkdtemp(prefix="chip_smoke_hpo_")
    flags = ["--synthetic-data", "--model", "medmamba", "--precision", "amp",
             "--training-iterations", "2", "--epochs", "2", "--batch-size", "64",
             "--train-num-samples", "128", "--val-num-samples", "64", "--workers", "4",
             "--log-every-n-steps", "1", "--logs", logs, "--seed", "0"]
    asha = ["--hyperparameter-tuning", "--hyperparameter-strategy", "asha"] + flags
    per_step = {"scan_fwd": 14, "scan_bwd": 14}
    line = {"card": card}
    try:
        # (a) the search through the CLI: the trial-epochs timed, each
        # evaluation's launches recorded (TrialRunner.step calls eval.evaluate)
        epochs, evals = [], []
        orig_step, orig_eval = runner_mod.TrialRunner.step, eval_mod.evaluate

        def timed_step(self):
            t0 = time.perf_counter()
            out = orig_step(self)
            torch.cuda.synchronize()
            epochs.append({"trial": self.trial_id, "s": time.perf_counter() - t0})
            return out

        def counted_eval(*a, **k):
            c0 = read_counts()
            out = orig_eval(*a, **k)
            torch.cuda.synchronize()
            evals.append({k_: v - c0[k_] for k_, v in read_counts().items()})
            return out

        runner_mod.TrialRunner.step, eval_mod.evaluate = timed_step, counted_eval
        try:
            rec = run_cli(counters, "asha", asha)
        finally:
            runner_mod.TrialRunner.step, eval_mod.evaluate = orig_step, orig_eval
        tally.add(rec["total"], rec["total_bodies"])
        result = rec["metrics"]
        best, pruned = result["best_trial"], result["pruned"]
        hist = result["history"]
        if len(pruned) != 1 or best == pruned[0] or len(hist[best]) != 2 \
                or len(hist[pruned[0]]) != 1:
            fail(f"hpo asha: best {best}, pruned {pruned}, history lengths "
                 f"{[len(h) for h in hist]}; expected one trial pruned at epoch 1 and the "
                 "winner trained 2 epochs")
        if not np.isfinite(result["best_metrics"]["val_loss"]):
            fail(f"hpo asha: best metrics {result['best_metrics']}")
        no_launch = {k: 0 for k in rec["total"]}
        steps = [st["launches"] for st in rec["steps"]]
        # 3 trial-epochs of 2 steps (128 samples at batch 64), each followed
        # by an evaluation of 1 batch
        if len(steps) != 6 or any(st != {**no_launch, **per_step} for st in steps):
            fail(f"hpo asha: launches a step {steps}, expected 6 x {per_step}")
        if len(evals) != 3 or any(ev != {**no_launch, "scan_fwd": 14} for ev in evals):
            fail(f"hpo asha: launches an evaluation {evals}, expected 3 x 14 forward")
        want_total = {**no_launch, "scan_fwd": 6 * 14 + 3 * 14, "scan_bwd": 6 * 14}
        if rec["total"] != want_total:
            fail(f"hpo asha: launches {rec['total']}, expected {want_total}")
        line["asha"] = {
            "wall_s": rec["wall_s"], "best_trial": best, "pruned": pruned,
            "val_loss": [[float(m["val_loss"]) for m in h] for h in hist],
            "trial_epoch_ms": [1e3 * e["s"] for e in epochs],
            "ms_per_step": [1e3 * st["s"] for st in rec["steps"]],
            "launches": rec["total"]}
        say(f"hpo asha: {rec['wall_s']:.1f} s, trial {best} best, {pruned} pruned; trial-epochs "
            f"{[round(1e3 * e['s'], 1) for e in epochs]} ms; val_loss {line['asha']['val_loss']}")

        # (b) a TrialRunner saves after one epoch; a fresh one restores it
        args = parse_args(flags)
        r1 = runner_mod.TrialRunner(args, trial_id=0)
        tally("TrialRunner.step", r1.step, {"scan_fwd": 2 * 14 + 14, "scan_bwd": 2 * 14})
        path = r1.save(tempfile.mkdtemp(prefix="trial_", dir=logs))
        r2 = runner_mod.TrialRunner(args, trial_id=0)
        r2.restore(path)
        a, b = r1.model.state_dict(), r2.model.state_dict()
        s1, s2 = r1.params["state"], r2.params["state"]
        same = (a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)
                and all(torch.equal(v, s2.opt_state.mu[k]) and
                        torch.equal(s1.opt_state.nu[k], s2.opt_state.nu[k])
                        for k, v in s1.opt_state.mu.items()))
        if not (same and r2.epoch == r1.epoch == 1 and s2.step == s1.step == 2
                and s2.opt_state.count == s1.opt_state.count):
            fail(f"hpo TrialRunner: the restore differs (bit for bit: {same}, epoch "
                 f"{r2.epoch}, step {s2.step})")
        line["trial_runner_restore_bit_for_bit"] = True
        say(f"hpo TrialRunner: saved after epoch 1 ({path}) and restored bit for bit")
        del r1, r2, s1, s2, a, b

        # (c) the optuna and ray strategies: their gates, or their search
        line["gates"] = {}
        for name in ("optuna", "ray"):
            argv = ["--hyperparameter-tuning", "--hyperparameter-strategy", name] + flags
            if importlib.util.find_spec(name) is None:
                rec = run_cli(counters, name, argv, raises=ImportError)
                if f"{name}" not in rec["error"] or rec["total"] != no_launch:
                    fail(f"hpo {name}: {rec['error']} does not name the package, or launched "
                         f"{rec['total']}")
                line["gates"][name] = rec["error"]
                say(f"hpo {name}: not installed here; the strategy raises {rec['error']}")
            else:
                say(f"hpo {name}: installed here; running its search")
                rec = run_cli(counters, name,
                              argv + ["--training-iterations", "1", "--epochs", "1"])
                tally.add(rec["total"], rec["total_bodies"])
                line["gates"][name] = f"ran: {rec['metrics']}"
    finally:
        shutil.rmtree(logs, ignore_errors=True)
    return line, tally.total, tally.total_bodies


def utilities_phase(card, reset_counts, read_counts, flash_bodies):
    """Phase 22: ``--remote-sync`` then ``--resume latest`` from the remote
    copy, ``--report-to wandb``, and ``profile_step`` on the flash
    contrastive step, each gate as the module docstring says. Returns (the
    ``utilities`` line's fields, the launches by counter, the flash
    launches by body)."""
    import numpy as np
    import torch

    from mamba_clip_tpu_torch.checkpoint import RemoteSyncThread
    from mamba_clip_tpu_torch.profile_step import profile_step
    from mamba_clip_tpu_torch.utils.profiling import HAND_WRITTEN, classify_op

    counters = (reset_counts, read_counts, flash_bodies)
    tally = LaunchTally(counters, "utilities")
    logs = tempfile.mkdtemp(prefix="chip_smoke_util_")
    flags = ["--synthetic-data", "--model-stage-1", "medmamba", "--precision", "amp",
             "--batch-size", "64", "--epochs", "1", "--train-num-samples", "128",
             "--val-num-samples", "64", "--workers", "4", "--logs", logs,
             "--log-every-n-steps", "1"]
    step = {"scan_fwd": 14, "scan_bwd": 14}
    line = {"card": card}

    def stop_sync_threads():
        for t in threading.enumerate():
            if isinstance(t, RemoteSyncThread):
                t.stop()
                t.join(timeout=30)

    try:
        # (a) the remote sync, behind fsspec
        remote = os.path.join(logs, "remote")
        sync = ["--name", "sync", "--remote-sync", f"file://{remote}"]
        if importlib.util.find_spec("fsspec") is None:
            rec = run_cli(counters, "remote sync without fsspec", flags + sync,
                          raises=RuntimeError)
            named = [ln for ln in rec["lines"] if "fsspec" in ln]
            if "remote sync startup validation failed" not in rec["error"] or not named:
                fail(f"utilities remote sync: {rec['error']}; no line names fsspec")
            line["remote_sync"] = {"branch": "no fsspec", "error": rec["error"],
                                   "logged": named}
            say(f"utilities remote sync: fsspec is not installed here; {rec['error']}, "
                f"logged {named}")
        else:
            try:
                rec1 = run_cli(counters, "remote sync", flags + sync + [
                    "--remote-sync-frequency", "1"])
                check_cli_steps(rec1, "remote sync", 2, step, {"scan_fwd": 14}, 1)
                tally.add(rec1["total"], rec1["total_bodies"])
                ckpts = os.path.join(logs, "sync", "checkpoints")
                local = os.path.join(ckpts, "stage_1_epoch_1", "state.pt")
                mirror = os.path.join(remote, "sync", "checkpoints", "stage_1_epoch_1",
                                      "state.pt")
                t0 = time.perf_counter()
                while time.perf_counter() - t0 < 120 and not (
                        os.path.exists(mirror)
                        and os.path.getsize(mirror) == os.path.getsize(local)):
                    time.sleep(0.2)
                stop_sync_threads()
                wait_s = time.perf_counter() - t0
                with open(local, "rb") as f, open(mirror, "rb") as g:
                    if f.read() != g.read():
                        fail("utilities remote sync: the mirrored checkpoint differs")
                for n in os.listdir(ckpts):
                    if n.startswith("stage_1_epoch"):
                        shutil.rmtree(os.path.join(ckpts, n))
                rec2 = run_cli(counters, "resume latest from the remote copy",
                               flags + sync + ["--resume", "latest"])
                want = f"Resuming from latest checkpoint: file://{remote}/sync/checkpoints/" \
                       "stage_1_epoch_1"
                if want not in rec2["lines"] or rec2["steps"] \
                        or rec2["total"] != {**{k: 0 for k in rec2["total"]}, "scan_fwd": 14}:
                    fail(f"utilities remote resume: {len(rec2['steps'])} steps, launches "
                         f"{rec2['total']}, '{want}' logged: {want in rec2['lines']}")
                if rec2["metrics"] != rec1["metrics"]:
                    fail(f"utilities remote resume: metrics {rec2['metrics']} against the "
                         f"run that wrote the checkpoint {rec1['metrics']}")
                tally.add(rec2["total"], rec2["total_bodies"])
            finally:
                stop_sync_threads()
            line["remote_sync"] = {"branch": "fsspec", "run_s": rec1["wall_s"],
                                   "mirror_wait_s": wait_s, "resume_s": rec2["wall_s"],
                                   "metrics_bit_for_bit": True}
            say(f"utilities remote sync: run {rec1['wall_s']:.1f} s, checkpoint mirrored "
                f"{wait_s:.1f} s after it, resumed from file://{remote}: the metrics bit "
                "for bit")

        # (b) --report-to wandb: one warning where wandb is not installed (a
        # wandb that is installed runs with WANDB_MODE=disabled: no network)
        has_wandb = importlib.util.find_spec("wandb") is not None
        mode = os.environ.get("WANDB_MODE")
        if has_wandb:
            os.environ["WANDB_MODE"] = "disabled"
        try:
            rec = run_cli(counters, "report to wandb", flags + ["--report-to", "wandb"])
        finally:
            if has_wandb and mode is None:
                del os.environ["WANDB_MODE"]
            elif has_wandb:
                os.environ["WANDB_MODE"] = mode
        check_cli_steps(rec, "report to wandb", 2, step, {"scan_fwd": 14}, 1)
        tally.add(rec["total"], rec["total_bodies"])
        warned = [ln for ln in rec["lines"] if "wandb" in ln]
        if not has_wandb and warned != ["wandb requested via --report-to but not installed"]:
            fail(f"utilities wandb: warnings {warned}, expected one")
        line["wandb"] = {"installed": has_wandb, "warnings": warned, "wall_s": rec["wall_s"]}
        say(f"utilities wandb: installed {has_wandb}; ran in {rec['wall_s']:.1f} s; {warned}")

        # (c) profile_step on the flash contrastive step of full-width BiomedCLIP
        gc.collect()
        torch.cuda.empty_cache()
        steps = 3
        # 3 warm-up steps and the traced ones
        r = tally("profile_step", lambda: profile_step("biomedclip", 64, "amp", "flash",
                                                       steps=steps, top=12, text_ctx=256),
                  {"fwd": 24 * (3 + steps), "dkv": 24 * (3 + steps), "dq": 24 * (3 + steps)})
        say(r["table"])
        want = {"selective_scan_fwd": 0, "selective_scan_bwd": 0, "flash_attn_fwd": 24 * steps,
                "flash_attn_bwd_dkv": 24 * steps, "flash_attn_bwd_dq": 24 * steps}
        total_ms = sum(ms for _, ms, _ in r["rows"])
        if r["launches"] != want or r["hand_written_per_step"] != 72:
            fail(f"profile_step: the hand-written class has {r['hand_written_per_step']} "
                 f"kernels a step, the counters {r['launches']}; expected 72 and {want}")
        if abs(total_ms - r["device_ms_per_step"]) > 1e-3 * r["device_ms_per_step"] \
                or not np.isfinite(r["loss"]):
            fail(f"profile_step: the classes sum to {total_ms} ms a step, the trace's device "
                 f"total is {r['device_ms_per_step']} ms (loss {r['loss']})")
        other = sorted(((us / steps / 1e3, n) for n, us in r["times"].items()
                        if classify_op(n) == "other"), reverse=True)[:8]
        say("profile_step: the costliest kernels of class other: "
            + "; ".join(f"{ms:.3f} ms {n[:90]}" for ms, n in other))
        line["profile_step"] = {
            "rows": [[c, ms, n] for c, ms, n in r["rows"]], "other_kernels": other,
            "device_ms_per_step": r["device_ms_per_step"], "classes_ms": total_ms,
            "wall_ms_per_step_traced": r["wall_ms_per_step"], "hand_written": HAND_WRITTEN,
            "hand_written_per_step": r["hand_written_per_step"], "loss": r["loss"]}
    finally:
        shutil.rmtree(logs, ignore_errors=True)
    return line, tally.total, tally.total_bodies


def decoder_phase(card, reset_counts, read_counts, flash_bodies):
    """Phase 23: the VSSM decoder at full width, each gate as the module
    docstring says. Returns (the ``decoder`` line's fields, the launches by
    counter, the flash launches by body)."""
    import torch

    from mamba_clip_tpu_torch.models import vssm
    from mamba_clip_tpu_torch.ops.selective_scan import (_scan_tm_plain, _scan_tm_plain_bwd,
                                                         selective_scan_bwd,
                                                         selective_scan_fwd)

    tally = LaunchTally((reset_counts, read_counts, flash_bodies), "decoder")
    g = torch.Generator().manual_seed(0)
    cdt = torch.bfloat16  # amp: fp32 parameters, bf16 compute
    decoder = torch.nn.Sequential(
        vssm.VSSLayerUp(256, 8, upsample=True, dtype=cdt, generator=g),
        vssm.VSSLayerUp(128, 2, upsample=True, dtype=cdt, generator=g),
        vssm.VSSLayerUp(64, 2, upsample=True, dtype=cdt, generator=g),
        vssm.FinalPatchExpand2D(64, dim_scale=4, dtype=cdt, generator=g),
    ).cuda().train()
    n_params = sum(p.numel() for p in decoder.parameters())
    gen = torch.Generator(device="cuda").manual_seed(1)
    x = torch.randn(8, 7, 7, 512, generator=gen, device="cuda")
    w = torch.randn(8, 224, 224, 16, generator=gen, device="cuda")

    calls = []
    scan = vssm.selective_scan_tm

    def recording_scan(u, delta, A, B, C, D=None, delta_bias=None, delta_softplus=False,
                       impl=None):
        y = scan(u, delta, A, B, C, D, delta_bias, delta_softplus, impl)
        rec = {"args": [t.detach().contiguous() for t in (u, delta, A, B, C, D, delta_bias)],
               "softplus": delta_softplus, "y": y.detach()}
        y.register_hook(lambda g_: rec.update(dy=g_.detach().float().contiguous()))
        calls.append(rec)
        return y

    def fwd_bwd():
        xi = x.clone().requires_grad_(True)
        out = decoder(xi)
        (out.float() * w).sum().backward()
        return out, xi.grad

    vssm.selective_scan_tm = recording_scan
    try:
        out, dx = tally("forward and backward", fwd_bwd, {"scan_fwd": 12, "scan_bwd": 12})
    finally:
        vssm.selective_scan_tm = scan
    if tuple(out.shape) != (8, 224, 224, 16) or not torch.isfinite(out).all() \
            or not torch.isfinite(dx).all():
        fail(f"decoder: output {tuple(out.shape)}, finite {bool(torch.isfinite(out).all())}, "
             f"input gradient finite {bool(torch.isfinite(dx).all())}")
    if len(calls) != 12 or any("dy" not in c for c in calls):
        fail(f"decoder: {len(calls)} scans with {sum('dy' in c for c in calls)} gradients, "
             "expected 12")
    worst_f = worst_b = 0.0
    shapes = []
    for c in calls:
        u, delta, A, B, C, D, bias = c["args"]
        args = (u, delta, A.float().contiguous(), B, C, D.float(), bias.float())
        with torch.no_grad():
            y_p, hck_p = _scan_tm_plain(*args, c["softplus"], return_hck=True)
        (rel_f, _), = rel_errs([c["y"]], [y_p])
        _, hck = selective_scan_fwd(*args, c["softplus"], with_hck=True)
        g_k = selective_scan_bwd(*args, c["softplus"], c["dy"], hck)
        g_p = _scan_tm_plain_bwd(*args, c["softplus"], c["dy"], hck_p)
        rel_b = max(r for r, _ in rel_errs(g_k, g_p))
        shapes.append([u.shape[0], u.shape[2], u.shape[3], str(u.dtype)])
        say(f"decoder scan B={u.shape[0]} L={u.shape[2]} DG={u.shape[3]} {u.dtype}: forward "
            f"rel_err {rel_f:.2e}, backward {rel_b:.2e} "
            f"{'ok' if max(rel_f, rel_b) <= GATE_REL else 'FAIL'}")
        if not max(rel_f, rel_b) <= GATE_REL:
            fail(f"decoder: a scan disagrees with the plain loop on its own inputs: forward "
                 f"{rel_f:.3e}, backward {rel_b:.3e}")
        worst_f, worst_b = max(worst_f, rel_f), max(worst_b, rel_b)
    del calls, out, dx

    def forward():
        with torch.no_grad():
            decoder(x)

    def forward_backward():
        decoder.zero_grad(set_to_none=True)
        out = decoder(x)
        (out.float() * w).sum().backward()

    ms_f = cuda_ms(forward, 5)
    ms_fb = cuda_ms(forward_backward, 5)
    line = {"card": card, "parameters": n_params, "batch": 8, "input": [8, 7, 7, 512],
            "output": [8, 224, 224, 16], "scan_shapes": shapes,
            "scan_fwd_max_rel_err": worst_f, "scan_bwd_max_rel_err": worst_b,
            "ms_forward": ms_f, "ms_forward_backward": ms_fb}
    say(f"decoder: {n_params / 1e6:.2f} M parameters, batch 8, 7x7x512 -> 224x224x16: "
        f"forward {ms_f:.2f} ms, forward + backward {ms_fb:.2f} ms on {card}")
    return line, tally.total, tally.total_bodies


# phase 27: reduced depths of the tools (the full 600-step --quant-stage1 and
# the 40-step --full-width run in a call of their own; PERF.md)
TOOLS_QS1_STEPS = 30
TOOLS_QP_STEPS = 3
TOOLS_FULL_WIDTH_STEPS = 3
TOOLS_E2E = {"n": 384, "src_px": 256, "batch": 64, "workers": 4}
# the bench at reduced depth, its one recipe a run; JAX's keys of each line
TOOLS_BENCH = {"BENCH_WARMUP": "1", "BENCH_STEPS": "2", "BENCH_SECONDARY": ""}
BENCH_KEYS = ["metric", "value", "unit", "vs_baseline", "baseline_img_s",
              "vs_baseline_conservative", "baseline_conservative_img_s"]
BENCH_RUNS = (("defaults", {}, BENCH_KEYS + ["quant", "text_context"]),
              ("flash", {"BENCH_QUANT": "", "BENCH_ATTN": "flash"},
               BENCH_KEYS + ["attn_impl", "text_context"]))


def run_bench(env: dict) -> tuple:
    """``bench.main()`` on the card under the ``BENCH_*`` variables of
    ``env`` (the others unset), the process environment restored after;
    returns (its JSON line, every line it printed on stdout, and on
    stderr)."""
    import contextlib
    import io

    from mamba_clip_tpu_torch import bench

    saved = {k: v for k, v in os.environ.items() if k.startswith("BENCH_")}
    for k in saved:
        del os.environ[k]
    os.environ.update(env)
    out, err = io.StringIO(), io.StringIO()
    try:
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            line = bench.main([])
    finally:
        for k in [k for k in os.environ if k.startswith("BENCH_")]:
            del os.environ[k]
        os.environ.update(saved)
    return line, out.getvalue().splitlines(), err.getvalue().splitlines()


def tools_phase(card, reset_counts, read_counts, flash_bodies):
    """Phase 27: the tools through their modules' entries, each gate as the
    module docstring says. Returns (the ``tools`` line's fields, the
    launches by counter, the flash launches by body)."""
    import numpy as np
    import torch

    from mamba_clip_tpu_torch import (benchmark_e2e, flash_sweep, measure_report_tokens,
                                      parity_harness, quant_parity)

    tally = LaunchTally((reset_counts, read_counts, flash_bodies), "tools")
    line = {"card": card}
    t0 = time.perf_counter()

    # flash_sweep: the three rows timed, then one flash call held against the
    # einsum interior on the same inputs, its launches counted
    sweep = flash_sweep.sweep("cuda")
    q, k, v, w = flash_sweep.inputs(flash_sweep.SHAPE, torch.bfloat16, "cuda")
    ref = flash_sweep.fwd_bwd("einsum", q, k, v, w)
    got = tally("flash_sweep flash call",
                lambda: flash_sweep.fwd_bwd("flash", q, k, v, w, impl="cuda"),
                {"fwd": 1, "dkv": 1, "dq": 1})
    errs = {name: float((g.float() - p.float()).abs().max() / p.float().abs().max())
            for name, g, p in zip(("o", "loss", "dq", "dk", "dv"), got, ref) if name != "loss"}
    sweep.update(max_rel_err=errs, flash_over_sdpa=sweep["flash_ms"] / sweep["sdpa_ms"],
                 flash_over_einsum=sweep["flash_ms"] / sweep["einsum_ms"])
    say(f"tools flash_sweep B=64 h=12 T=256 hd=64 bf16 ({sweep['flash_tiles']}): einsum "
        f"{sweep['einsum_ms']:.3f} ms, flash {sweep['flash_ms']:.3f} ms, sdpa "
        f"{sweep['sdpa_ms']:.3f} ms fwd+bwd; flash against einsum: " +
        ", ".join(f"{n} {e:.2e}" for n, e in errs.items()))
    if not all(e <= ATTN_GATE["bf16"] for e in errs.values()):
        fail(f"tools flash_sweep: the flash path disagrees with the einsum interior: {errs}")
    del q, k, v, w, ref, got
    line["flash_sweep"] = sweep
    line["flash_sweep_s"] = time.perf_counter() - t0

    # parity_harness: the default mode and --stage2 on the card under the
    # tool's own gates, then --quant-stage1 at a reduced step count
    t1 = time.perf_counter()
    ph = {}
    for name, argv in (("default", []), ("stage2", ["--stage2"])):
        r, ok, _ = tally(f"parity_harness {name}",
                         lambda argv=argv: parity_harness.run_mode(argv + ["--device", "cuda"]),
                         {})
        say(f"tools parity_harness {name}: {json.dumps(r)} PARITY: {'PASS' if ok else 'FAIL'}")
        if not ok:
            fail(f"tools parity_harness {name}: FAIL under the tool's gate: {r}")
        ph[name] = r
    qs1 = tally("parity_harness --quant-stage1",
                lambda: parity_harness.run_quant_stage1(steps=TOOLS_QS1_STEPS, device="cuda"),
                {})
    for mode, rec in qs1["modes"].items():
        finite = all(np.isfinite(rec[k]) for k in
                     ("stage1_first_loss", "stage1_final_loss", "head_final_loss", "pauc"))
        if not (finite and rec["stage1_final_loss"] < rec["stage1_first_loss"]
                and 0.0 <= rec["pauc"] <= 0.2):
            fail(f"tools parity_harness --quant-stage1 at {TOOLS_QS1_STEPS} steps, {mode}: "
                 f"{rec} (finite losses, the last below the first, pAUC in [0, 0.2])")
    qs1["tool_gate_pass"] = parity_harness.quant_stage1_passes(qs1)
    say(f"tools parity_harness --quant-stage1 at {TOOLS_QS1_STEPS} steps: {json.dumps(qs1)}")
    ph["quant_stage1"] = qs1
    line["parity_harness"] = ph
    line["parity_harness_s"] = time.perf_counter() - t1

    # quant_parity: the small CLIP in every mode, then --full-width
    t2 = time.perf_counter()
    curves, qp = tally("quant_parity", lambda: quant_parity.tiny(TOOLS_QP_STEPS, "cuda"), {})
    bad = {n: c for n, c in curves.items() if not np.all(np.isfinite(c))}
    if bad:
        fail(f"tools quant_parity at {TOOLS_QP_STEPS} steps: non-finite losses {bad}")
    say(f"tools quant_parity at {TOOLS_QP_STEPS} steps: {json.dumps(qp)}")
    t3 = time.perf_counter()
    fw = tally("quant_parity --full-width",
               lambda: quant_parity.full_width(TOOLS_FULL_WIDTH_STEPS, "cuda"), {})
    if not all(np.isfinite(v) for c in fw.values() if isinstance(c, dict) for v in c.values()):
        fail(f"tools quant_parity --full-width: non-finite {fw}")
    say(f"tools quant_parity --full-width at {TOOLS_FULL_WIDTH_STEPS} steps: {json.dumps(fw)}")
    line["quant_parity"] = {"tiny": qp, "full_width": fw, "tiny_s": t3 - t2,
                            "full_width_s": time.perf_counter() - t3}

    # measure_report_tokens at the JAX tool's defaults
    t4 = time.perf_counter()
    rt = measure_report_tokens.measure(2000, 3, 0)
    if not rt["observed"]["max"] <= rt["exact_upper_bound"]["max"]:
        fail(f"tools measure_report_tokens: the largest length {rt['observed']['max']} is above "
             f"report_token_upper_bound's {rt['exact_upper_bound']['max']}")
    say(f"tools measure_report_tokens: {json.dumps(rt)}")
    line["report_tokens"] = rt
    line["report_tokens_s"] = time.perf_counter() - t4

    # benchmark_e2e over the JPEG layout: the port's CLI in a process of its
    # own (its launches are that process's)
    t5 = time.perf_counter()
    e2e = benchmark_e2e.run(TOOLS_E2E["n"], TOOLS_E2E["src_px"], TOOLS_E2E["batch"],
                            TOOLS_E2E["workers"], False, layout="jpeg", device="cuda")
    rates = (e2e["epoch1_img_s"], e2e["epoch2_img_s"])
    if not all(np.isfinite(r) and r > 0 for r in rates):
        fail(f"tools benchmark_e2e --layout jpeg: epoch rates {rates} (finite, positive)")
    say(f"tools benchmark_e2e --layout jpeg: {json.dumps(e2e)}")
    line["benchmark_e2e"] = dict(e2e, layout="jpeg")
    line["benchmark_e2e_s"] = time.perf_counter() - t5

    # the bench through bench.main: its kernel check (the scans, and the
    # flash kernels at T 197 and 224 under flash), then the step; the flash
    # run's 24 + 24 + 24 launches a step count on the main path, the check's
    # do not
    line["bench"] = {}
    steps = int(TOOLS_BENCH["BENCH_WARMUP"]) + int(TOOLS_BENCH["BENCH_STEPS"])
    for name, env, keys in BENCH_RUNS:
        t6 = time.perf_counter()
        flash = env.get("BENCH_ATTN") == "flash"
        want = {k: 24 * steps for k in ("fwd", "dkv", "dq")} if flash else {}
        check = dict({"scan_fwd": 1, "scan_bwd": 1},
                     **({k: 2 for k in ("fwd", "dkv", "dq")} if flash else {}))
        out, printed, notes = tally(f"bench {name}",
                                    lambda env=env: run_bench({**TOOLS_BENCH, **env}),
                                    want, check=check)
        say(f"tools bench {name}: {printed}; stderr {notes}")
        if (len(printed) != 1 or json.loads(printed[0]) != out or list(out) != keys
                or out["metric"] != "stage1_contrastive_images_per_sec_per_chip"
                or not (np.isfinite(out["value"]) and out["value"] > 0)):
            fail(f"tools bench {name}: printed {printed}; expected one JSON line with the keys "
                 f"{keys} and a finite, positive value")
        line["bench"][name] = dict(out, env=env, stderr=notes,
                                   seconds=time.perf_counter() - t6)
    line["reduced"] = {"quant_stage1_steps": TOOLS_QS1_STEPS,
                       "quant_parity_steps": TOOLS_QP_STEPS,
                       "full_width_steps": TOOLS_FULL_WIDTH_STEPS,
                       "benchmark_e2e": TOOLS_E2E, "bench": TOOLS_BENCH}
    return line, tally.total, tally.total_bodies


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="Smoke test of the PyTorch/CUDA port on one card.")
    ap.add_argument("--clip-check-seeds", type=int, nargs="+", default=None,
                    help="run only phase 10's batch-8 check, at these seeds")
    ap.add_argument("--src", default=str(SRC),
                    help="with --clip-check-seeds: the src/ directory whose package is checked")
    ap.add_argument("--cards", type=int, default=1,
                    help="4: run only the four-card run of the parallel layer (NCCL, one rank "
                         "a card); it fails on fewer cards")
    ap.add_argument("--mesh-cases", nargs="+", default=None,
                    help="with --cards 4: run only these mesh cases (e.g. fsdp4), nothing else; "
                         "a copy of this script beside another tree's src/ runs that tree's "
                         "package")
    args = ap.parse_args(argv)
    if args.clip_check_seeds is not None:
        return clip_check_only(args.clip_check_seeds, Path(args.src).resolve())
    if args.cards not in (1, 4):
        fail(f"--cards {args.cards}: 1 (every phase on one card) or 4 (the four-card run)")
    if not (SRC / "mamba_clip_tpu_torch").is_dir():
        fail(f"{SRC / 'mamba_clip_tpu_torch'} not found: run from a checkout of the repository")
    if args.cards == 4:
        return cards_main(args.cards, args.mesh_cases)
    try:
        import numpy as np
        import torch
    except ImportError as e:
        fail(f"cannot import {e.name}")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke test runs on the card only")
    sys.path.insert(0, str(SRC))
    import torch.nn.functional as F

    from mamba_clip_tpu_torch.data.tokenizer import HashTokenizer
    from mamba_clip_tpu_torch.models import vit as vit_mod
    from mamba_clip_tpu_torch.ops import cuda_build
    from mamba_clip_tpu_torch.models import build_clip
    from mamba_clip_tpu_torch.ops.flash_attn import (
        attention_plain, attention_plain_bwd, flash_attention_interior, flash_attn_bwd_dkv,
        flash_attn_bwd_dq, flash_attn_fwd)
    from mamba_clip_tpu_torch.profile_embed import report_tokens
    from mamba_clip_tpu_torch.ops.selective_scan import (
        CHUNK, _scan_tm_plain, _scan_tm_plain_bwd, selective_scan_bwd, selective_scan_fwd,
        selective_scan_tm)
    from mamba_clip_tpu_torch.serve import MicroBatcher
    from mamba_clip_tpu_torch.serving import make_serving_fns
    from mamba_clip_tpu_torch.models import build_classifier, vssm
    from mamba_clip_tpu_torch.profile_train import (CLIP_TOTAL_STEPS, CLIP_TRAIN_ARGS,
                                                    TRAIN_ARGS, clip_train_setup,
                                                    medmamba_train_setup)
    from mamba_clip_tpu_torch import pipeline as port_pipeline
    from mamba_clip_tpu_torch.config import RunState, parse_args
    from mamba_clip_tpu_torch import scan_roofline
    from mamba_clip_tpu_torch.checkpoint import (load_checkpoint, load_params_only,
                                                 parse_step_checkpoint, save_checkpoint,
                                                 validate_step_resume)
    from mamba_clip_tpu_torch.data.loader import device_prefetch, get_data
    from mamba_clip_tpu_torch.data.preprocess_cfg import get_transform_config
    from mamba_clip_tpu_torch.eval import evaluate, make_eval_step
    from mamba_clip_tpu_torch.models import ClipClassifier
    from mamba_clip_tpu_torch.ops.vpu_chain import vpu_chain, vpu_chain_plain
    from mamba_clip_tpu_torch.optim import build_optimizer, freeze_submodule_mask
    from mamba_clip_tpu_torch.roofline import (FP32_FLOPS, HBM_BYTES_PER_S, TF32_TC_FLOPS,
                                               attn_bound, scan_bound, scan_bwd_bound,
                                               sfu_peak)
    from mamba_clip_tpu_torch.schedules import create_schedule
    from mamba_clip_tpu_torch.train import (create_train_state, make_classifier_train_step,
                                            make_clip_train_step, train_one_epoch)
    from mamba_clip_tpu_torch.utils.precision import get_policy

    # 1. device
    card = nvidia_smi("name,power.limit")
    say(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    say(f"torch {torch.__version__} cuda {torch.version.cuda}; "
        f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")
    props = torch.cuda.get_device_properties(0)
    max_clk_mhz = float(nvidia_smi("clocks.max.sm").split()[0])
    sfu_rate = sfu_peak(props.multi_processor_count, max_clk_mhz)
    say(f"{props.multi_processor_count} SMs, max SM clock {max_clk_mhz:.0f} MHz: "
        f"exp peak {sfu_rate:.4g}/s; fp32 peak {FP32_FLOPS:.3g} FLOP/s and HBM "
        f"{HBM_BYTES_PER_S:.3g} B/s (H100 SXM data sheet)")

    # 2. build: one nvcc per source, all started together, always anew (phase 7
    # reads ptxas' report of this build)
    for k in KERNELS:
        cuda_build.library_path(k).unlink(missing_ok=True)
    t0 = time.time()
    with ThreadPoolExecutor(len(KERNELS)) as pool:
        for f in [pool.submit(cuda_build.build, k) for k in KERNELS]:
            f.result()
    for k in KERNELS:
        cuda_build.load(k)
    say(f"build: {', '.join(KERNELS)} in {time.time() - t0:.1f} s")
    for k in KERNELS:
        say(f"  {cuda_build.library_path(k).name}")
        for line in cuda_build.build_logs.get(k, "").splitlines():
            if "registers" in line or "spill" in line:
                say(f"  ptxas {k}: {line.strip()}")
    # each scan instance: ptxas' registers and spills, its shared memory a
    # block (the backward's static B/C buffers and its dynamic rest), and the
    # shuffles and special-function instructions in its SASS
    bwd_dyn_smem = cuda_build.load("selective_scan_bwd").selective_scan_bwd_smem_bytes()
    scan_instances = {}
    for k in ("selective_scan_fwd", "selective_scan_bwd"):
        scan_instances[k] = {}
        sass = {op: cuda_build.sass_counts(cuda_build.library_path(k), op)
                for op in ("SHFL", "MUFU")}
        for mangled, rep in cuda_build.ptxas_report(cuda_build.build_logs.get(k, "")).items():
            inst = re.search(rf"{k}_kernelI(f|13__nv_bfloat16)E", mangled)
            if inst is None:
                continue
            name = f"{k} {'fp32' if inst.group(1) == 'f' else 'bf16'}"
            scan_instances[k][name] = {
                "registers": rep["registers"], "spill_stores": rep["spill_stores"],
                "spill_loads": rep["spill_loads"],
                "smem_bytes": rep["static_smem"] + (bwd_dyn_smem if k.endswith("bwd") else 0),
                "shfl": sass["SHFL"].get(mangled, 0), "mufu": sass["MUFU"].get(mangled, 0)}
        for name, inst in sorted(scan_instances[k].items()):
            say(f"{name}: {inst['registers']} registers, spills {inst['spill_stores']}/"
                f"{inst['spill_loads']} bytes, {inst['smem_bytes']} B shared memory a block, "
                f"{inst['shfl']} SHFL and {inst['mufu']} MUFU in its SASS")
        if len(scan_instances[k]) != 2:
            fail(f"{k}: expected 2 instances (fp32, bf16), got {sorted(scan_instances[k])}")

    # 3. kernel against plain
    def compare(Bsz, L, DG, dtype, softplus, iters_k, iters_p, seed=0):
        args = scan_inputs(Bsz, L, DG, dtype, softplus, seed)
        with torch.inference_mode():
            y_k = selective_scan_tm(*args, softplus, impl="cuda")
            y_p = selective_scan_tm(*args, softplus, impl="plain")
            torch.cuda.synchronize()
            if not torch.isfinite(y_p).all():
                fail(f"plain scan not finite at B={Bsz} L={L} DG={DG}")
            abs_err = float((y_k - y_p).abs().max())
            rel = abs_err / float(y_p.abs().max())
            ms_k = cuda_ms(lambda: selective_scan_tm(*args, softplus, impl="cuda"), iters_k)
            ms_p = cuda_ms(lambda: selective_scan_tm(*args, softplus, impl="plain"),
                           iters_p, warmup=1)
        with torch.enable_grad():  # the training forward: y and hck
            full = [t if t is not None else torch.zeros(args[2].shape[0], device="cuda")
                    for t in args]
            y_h, hck_k = selective_scan_fwd(*full, softplus, with_hck=True)
            y_h2, hck_k2 = selective_scan_fwd(*full, softplus, with_hck=True)
            _, hck_p = _scan_tm_plain(*full, softplus, return_hck=True)
            torch.cuda.synchronize()
        (rel_h, abs_h), = rel_errs([hck_k], [hck_p])
        same = torch.equal(y_h, y_h2) and torch.equal(hck_k, hck_k2)
        name = {torch.float32: "fp32", torch.bfloat16: "bf16"}[dtype]
        ok = rel <= GATE_REL and rel_h <= GATE_REL and same
        say(f"scan B={Bsz} G=4 L={L} DG={DG} {name} softplus={softplus}: "
            f"rel_err {rel:.3e} abs_err {abs_err:.3e} hck rel_err {rel_h:.3e} "
            f"{'bit-identical' if same else 'two runs DIFFER'} "
            f"kernel {ms_k:.4f} ms plain {ms_p:.3f} ms {'ok' if ok else 'FAIL'}")
        if not ok:
            fail(f"selective_scan_fwd disagrees with the plain scan: rel err {rel:.3e}, "
                 f"hck rel err {rel_h:.3e}, two runs bit-identical: {same}")
        return max(rel, rel_h), max(abs_err, abs_h), ms_k, ms_p

    worst_rel = worst_abs = 0.0
    for L, DG in STAGES + RAGGED:
        for dtype in (torch.float32, torch.bfloat16):
            rel, abs_err, _, _ = compare(2, L, DG, dtype, True, 20, 2)
            worst_rel, worst_abs = max(worst_rel, rel), max(worst_abs, abs_err)
    for L, DG in RAGGED:
        for dtype in (torch.float32, torch.bfloat16):
            rel, abs_err, _, _ = compare(2, L, DG, dtype, False, 20, 2)
            worst_rel, worst_abs = max(worst_rel, rel), max(worst_abs, abs_err)

    # at the serving batch (64) and type (bf16): one forward = 14 launches
    fwd_k = fwd_p = fwd_bound = 0.0
    bound_terms = {"bytes": 0.0, "operations": 0.0}
    shapes = []
    for (L, DG), nblk in zip(STAGES, BLOCKS_PER_STAGE):
        rel, abs_err, ms_k, ms_p = compare(64, L, DG, torch.bfloat16, True, 10, 1)
        worst_rel, worst_abs = max(worst_rel, rel), max(worst_abs, abs_err)
        bound = scan_bound(64, L, DG, 2, sfu_rate)
        fwd_k += nblk * ms_k
        fwd_p += nblk * ms_p
        fwd_bound += nblk * bound["bound_ms"]
        bound_terms[bound["bound_by"]] += nblk * bound["bound_ms"]
        shapes.append({"B": 64, "G": 4, "L": L, "DG": DG, "dtype": "bf16",
                       "launches_per_forward": nblk, "ms": ms_k, "plain_ms": ms_p,
                       **bound, "max_rel_err": rel})
    say(json.dumps({"selective_scan_fwd_shapes": shapes, "card": card}))

    # 4. serving
    gen = torch.Generator().manual_seed(0)
    model, fns, meta = make_serving_fns(
        "medmamba", precision="amp", image_size=224, device="cuda", generator=gen)
    classify = fns["classify"]
    plain_model = build_classifier("medmamba", dtype=torch.bfloat16, scan_impl="plain")
    plain_model.load_state_dict(model.state_dict())
    plain_model = plain_model.to("cuda").eval()
    n_params = sum(p.numel() for p in model.parameters())
    say(f"serving: medmamba {n_params / 1e6:.2f} M parameters, staging "
        f"{meta['staging_size']}, image {meta['image_size']}, precision {meta['precision']}")

    rs = np.random.RandomState(0)
    S = meta["staging_size"]
    requests = [rs.randint(0, 256, (1, S, S, 3), dtype=np.uint8) for _ in range(16)]
    classify(model, requests[0])  # first call: cuDNN/cuBLAS set-up, not counted
    torch.cuda.synchronize()
    answers = [None] * 16
    errors = []
    barrier = threading.Barrier(16)

    def client(i):
        try:
            barrier.wait(timeout=60)
            answers[i] = mb(requests[i])
        except Exception as e:  # reported below; the phase fails
            errors.append(f"request {i}: {e!r}")

    selective_scan_fwd.launches = selective_scan_bwd.launches = 0
    mb = MicroBatcher(lambda x: classify(model, x), max_batch=16, max_delay_ms=100.0)
    t0 = time.time()
    threads = [threading.Thread(target=client, args=(i,)) for i in range(16)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    mb.close()
    wall = time.time() - t0
    launches, serve_bwd = selective_scan_fwd.launches, selective_scan_bwd.launches
    if errors or any(t.is_alive() for t in threads):
        fail(f"serving: {errors or 'a request did not finish'}")
    say(f"serving: {mb.requests} requests in {mb.batches} batches "
        f"(padded rows {mb.batch_rows}) in {wall:.3f} s; selective_scan_fwd launches {launches}")
    for i, a in enumerate(answers):
        if a is None or a.shape != (1, 2) or not np.isfinite(a).all():
            fail(f"answer {i} is {a!r}")
        if abs(float(a.sum()) - 1.0) > 1e-5:
            fail(f"answer {i} sums to {float(a.sum())}")
    if mb.requests != 16:
        fail(f"MicroBatcher answered {mb.requests} of 16 requests")
    if launches != 14 * mb.batches or serve_bwd != 0:
        fail(f"{launches} forward and {serve_bwd} backward launches for {mb.batches} "
             "batches, expected 14 forward and no backward each")
    batch = np.concatenate(requests)
    got = np.concatenate(answers)
    want = classify(plain_model, batch).cpu().numpy()
    diff = float(np.abs(got - want).max())
    say(f"serving: max |probs(kernel) - probs(plain scan)| = {diff:.3e} "
        f"(bound {PROBS_ATOL:g}: bf16 activations around an fp32 scan)")
    if diff > PROBS_ATOL:
        fail(f"serving probabilities differ from the plain scan by {diff:.3e}")

    # At random init the SS2D branches move the probabilities by a few 1e-3
    # at most, so the check above cannot see a wrong scan. Hold each of the
    # 14 scans of one forward of the served batch, on its own inputs,
    # against the plain loop.
    calls = []
    scan = vssm.selective_scan_tm

    def recording_scan(*args, **kw):
        y = scan(*args, **kw)
        calls.append((args, kw, y))
        return y

    vssm.selective_scan_tm = recording_scan
    try:
        classify(model, batch)
    finally:
        vssm.selective_scan_tm = scan
    if len(calls) != 14:
        fail(f"one forward made {len(calls)} scan calls, expected 14")
    for args, kw, y_k in calls:
        with torch.inference_mode():
            y_p = scan(*args, **{**kw, "impl": "plain"})
        abs_err = float((y_k - y_p).abs().max())
        rel = abs_err / float(y_p.abs().max())
        Bsz, G, L, DG = args[0].shape
        say(f"serving scan B={Bsz} L={L} DG={DG} {args[0].dtype}: rel_err {rel:.3e} "
            f"abs_err {abs_err:.3e} {'ok' if rel <= GATE_REL else 'FAIL'}")
        if not rel <= GATE_REL:
            fail(f"selective_scan_fwd disagrees with the plain scan on the served "
                 f"batch's inputs: rel err {rel:.3e}")
        worst_rel, worst_abs = max(worst_rel, rel), max(worst_abs, abs_err)

    x64 = torch.from_numpy(rs.randint(0, 256, (64, S, S, 3), dtype=np.uint8)).cuda()
    iters = 10
    classify(model, x64)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        out = classify(model, x64)
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / iters
    if out.shape != (64, 2) or not torch.isfinite(out).all():
        fail("classify at batch 64 gave a bad result")
    say(f"serving: classify bs 64 on device-resident uint8: {dt * 1e3:.2f} ms/batch, "
        f"{64 / dt:.1f} img/s on {card}")

    # 5. backward kernel against plain
    def bwd_args(Bsz, L, DG, dtype, softplus, seed=0):
        u, delta, A, B, C, D, bias = scan_inputs(Bsz, L, DG, dtype, softplus, seed)
        zeros = torch.zeros(A.shape[0], device="cuda")
        args = (u, delta, A, B, C, zeros if D is None else D, zeros if bias is None else bias)
        g = torch.Generator(device="cuda").manual_seed(seed + 1)
        dy = torch.randn(u.shape, generator=g, device="cuda")
        return args, dy

    def compare_bwd(Bsz, L, DG, dtype, softplus, seed=0):
        args, dy = bwd_args(Bsz, L, DG, dtype, softplus, seed)
        _, hck = selective_scan_fwd(*args, softplus, with_hck=True)
        g_k = selective_scan_bwd(*args, softplus, dy, hck)
        g_k2 = selective_scan_bwd(*args, softplus, dy, hck)
        _, hck_p = _scan_tm_plain(*args, softplus, return_hck=True)
        g_p = _scan_tm_plain_bwd(*args, softplus, dy, hck_p)
        torch.cuda.synchronize()
        errs = rel_errs(g_k, g_p)
        same = all(torch.equal(a, b) for a, b in zip(g_k, g_k2))
        name = {torch.float32: "fp32", torch.bfloat16: "bf16"}[dtype]
        ok = all(r <= GATE_REL for r, _ in errs) and same
        say(f"scan bwd B={Bsz} G=4 L={L} DG={DG} {name} softplus={softplus}: "
            + " ".join(f"{n} {r:.2e}" for n, (r, _) in zip(GRAD_NAMES, errs))
            + (" bit-identical" if same else " two runs DIFFER") + (" ok" if ok else " FAIL"))
        if not ok:
            fail("selective_scan_bwd disagrees with the plain backward, or with itself "
                 f"(two runs bit-identical: {same})")
        return max(r for r, _ in errs), max(a for _, a in errs)

    bwd_rel = bwd_abs = 0.0
    for L, DG in STAGES + RAGGED:
        for dtype in (torch.float32, torch.bfloat16):
            r, a = compare_bwd(2, L, DG, dtype, True)
            bwd_rel, bwd_abs = max(bwd_rel, r), max(bwd_abs, a)
    for L, DG in RAGGED:
        for dtype in (torch.float32, torch.bfloat16):
            r, a = compare_bwd(2, L, DG, dtype, False)
            bwd_rel, bwd_abs = max(bwd_rel, r), max(bwd_abs, a)

    # at the training batch (64) and type (bf16): one step = 14 launches each
    fwd_hck_step = bwd_k_step = bwd_p_step = bwd_bound_step = 0.0
    bwd_terms = {"bytes": 0.0, "operations": 0.0}
    bwd_shapes = []
    for (L, DG), nblk in zip(STAGES, BLOCKS_PER_STAGE):
        args, dy = bwd_args(64, L, DG, torch.bfloat16, True)
        _, hck = selective_scan_fwd(*args, True, with_hck=True)
        ms_f = cuda_ms(lambda: selective_scan_fwd(*args, True, with_hck=True), 10)
        ms_b = cuda_ms(lambda: selective_scan_bwd(*args, True, dy, hck), 10)
        ms_bp = cuda_ms(lambda: _scan_tm_plain_bwd(*args, True, dy, hck), 1, warmup=0)
        bound = scan_bwd_bound(64, L, DG, 2, sfu_rate)
        fwd_hck_step += nblk * ms_f
        bwd_k_step += nblk * ms_b
        bwd_p_step += nblk * ms_bp
        bwd_bound_step += nblk * bound["bound_ms"]
        bwd_terms[bound["bound_by"]] += nblk * bound["bound_ms"]
        bwd_shapes.append({"B": 64, "G": 4, "L": L, "DG": DG, "dtype": "bf16",
                           "launches_per_step": nblk, "fwd_with_hck_ms": ms_f,
                           "hck_bytes": 64 * 4 * (-(-L // CHUNK)) * DG * 16 * 4,
                           "ms": ms_b, "plain_ms": ms_bp, **bound})
        say(f"scan bwd B=64 L={L} DG={DG} bf16: kernel {ms_b:.4f} ms, forward with hck "
            f"{ms_f:.4f} ms, plain backward {ms_bp:.2f} ms, bound {bound['bound_ms']:.4f} ms "
            f"({bound['bound_by']})")
    say(json.dumps({"selective_scan_bwd_shapes": bwd_shapes, "card": card}))

    # 6. training: the stage-2 CE step of full-width medmamba at batch 64
    TB, WARM, TIMED = 64, 2, 5
    mm_before = torch.cuda.memory_allocated()
    state, step_fn, batches = medmamba_train_setup(TB)
    n_params = sum(p.numel() for p in state.model.parameters())
    say(f"training: medmamba {n_params / 1e6:.2f} M parameters, batch {TB}, image 224, "
        f"staging 256, precision amp, AdamW, cosine schedule")

    def check_metrics(m, what):
        loss, gnorm = float(m["loss"]), float(m["grad_norm"])
        if not (np.isfinite(loss) and np.isfinite(gnorm)):
            fail(f"{what}: loss {loss} grad_norm {gnorm}")
        return loss, gnorm

    selective_scan_fwd.launches = selective_scan_bwd.launches = 0
    for i in range(WARM):
        state, m = step_fn(state, batches[i % 2], 0)
        say(f"training: warm-up step {i}: loss {check_metrics(m, 'warm-up')[0]:.5f}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    metrics = []
    for i in range(TIMED):
        state, m = step_fn(state, batches[i % 2], 0)
        metrics.append(m)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / TIMED * 1e3
    train_fwd, train_bwd = selective_scan_fwd.launches, selective_scan_bwd.launches
    peak = torch.cuda.max_memory_allocated()
    for i, m in enumerate(metrics):
        loss, gnorm = check_metrics(m, f"timed step {i}")
        say(f"training: step {WARM + i}: loss {loss:.5f} grad_norm {gnorm:.5f} lr {m['lr']:.3e}")
    steps = WARM + TIMED
    say(f"training: selective_scan_fwd launches {train_fwd}, selective_scan_bwd launches "
        f"{train_bwd} in {steps} steps")
    if train_fwd != 14 * steps or train_bwd != 14 * steps:
        fail(f"{train_fwd} forward and {train_bwd} backward launches in {steps} steps, "
             "expected 14 of each per step")

    # The loss cannot see a wrong scan (PERF.md, Findings): record the
    # 14 scans of one step with their dy and hold each backward against the
    # plain backward on its own inputs.
    calls = []
    scan = vssm.selective_scan_tm

    def recording_scan(u, delta, A, B, C, D=None, delta_bias=None, delta_softplus=False,
                       impl=None):
        y = scan(u, delta, A, B, C, D, delta_bias, delta_softplus, impl)
        rec = {"args": [t.detach().contiguous() for t in (u, delta, A, B, C, D, delta_bias)],
               "softplus": delta_softplus}
        y.register_hook(lambda g: rec.update(dy=g.detach().float().contiguous()))
        calls.append(rec)
        return y

    vssm.selective_scan_tm = recording_scan
    try:
        state, m = step_fn(state, batches[0], 0)
    finally:
        vssm.selective_scan_tm = scan
    check_metrics(m, "recorded step")
    if len(calls) != 14 or any("dy" not in c for c in calls):
        fail(f"one step made {len(calls)} scan calls with "
             f"{sum('dy' in c for c in calls)} gradients, expected 14")
    rec_rel = 0.0
    for c in calls:
        u, delta, A, B, C, D, bias = c["args"]
        args = (u, delta, A.float().contiguous(), B, C, D.float(), bias.float())
        _, hck = selective_scan_fwd(*args, c["softplus"], with_hck=True)
        g_k = selective_scan_bwd(*args, c["softplus"], c["dy"], hck)
        _, hck_p = _scan_tm_plain(*args, c["softplus"], return_hck=True)
        g_p = _scan_tm_plain_bwd(*args, c["softplus"], c["dy"], hck_p)
        errs = rel_errs(g_k, g_p)
        worst = max(r for r, _ in errs)
        say(f"training scan B={u.shape[0]} L={u.shape[2]} DG={u.shape[3]} {u.dtype}: "
            + " ".join(f"{n} {r:.2e}" for n, (r, _) in zip(GRAD_NAMES, errs))
            + (" ok" if worst <= GATE_REL else " FAIL"))
        if not worst <= GATE_REL:
            fail("selective_scan_bwd disagrees with the plain backward on a train "
                 f"step's own inputs: rel err {worst:.3e}")
        rec_rel = max(rec_rel, worst)
        bwd_abs = max(bwd_abs, max(a for _, a in errs))
    bwd_rel = max(bwd_rel, rec_rel)
    del calls

    # kernels against plain scans end to end: 2 steps at batch 8 from one state
    init = {k: v.clone() for k, v in build_classifier(
        "medmamba", dtype=torch.bfloat16,
        generator=torch.Generator().manual_seed(1)).state_dict().items()}
    runs = {}
    for impl in ("cuda", "plain"):
        st, fn, bs = medmamba_train_setup(8, scan_impl=impl, seed=1, model_state=init)
        runs[impl] = []
        for i in range(2):
            st, m = fn(st, bs[i], 0)
            runs[impl].append(check_metrics(m, f"batch-8 step with the {impl} scan"))
        del st, fn, bs
    e2e = 0.0
    for i, ((lk, gk), (lp, gp)) in enumerate(zip(runs["cuda"], runs["plain"])):
        rl, rg = abs(lk - lp) / abs(lp), abs(gk - gp) / abs(gp)
        e2e = max(e2e, rl, rg)
        say(f"training bs 8 step {i}: loss kernel {lk:.6f} plain {lp:.6f} (rel {rl:.2e}); "
            f"grad_norm kernel {gk:.6f} plain {gp:.6f} (rel {rg:.2e})")
    if e2e > TRAIN_REL:
        fail(f"the train step with the kernels differs from the plain scans by {e2e:.3e} "
             f"relative (bound {TRAIN_REL:g}: one bf16 ulp)")
    say(json.dumps({"training": {
        "card": card, "batch": TB, "steps_timed": TIMED, "ms_per_step": step_ms,
        "train_img_per_s": TB / (step_ms / 1e3), "max_memory_allocated_bytes": peak,
        "scan_fwd_with_hck_ms_per_step": fwd_hck_step, "scan_bwd_ms_per_step": bwd_k_step,
        "scan_fwd_launches_per_step": train_fwd / steps,
        "scan_bwd_launches_per_step": train_bwd / steps,
        "recorded_scans_max_rel_err": rec_rel, "bs8_kernel_vs_plain_max_rel": e2e}}))
    say(f"training: {step_ms:.2f} ms/step, {TB / (step_ms / 1e3):.1f} train img/s, peak "
        f"{peak / 2**30:.2f} GiB allocated; scan forward {fwd_hck_step:.3f} ms and backward "
        f"{bwd_k_step:.3f} ms per step, on {card}")

    # 7. flash kernel against plain. First what was built: ptxas' registers,
    # spills and shared memory of each instance of the forward, and the
    # tensor-core instructions in each instance's SASS
    def instances(library, pattern, smem_of, tf32_kernels):
        """Each kernel instance of a built library: ptxas' registers and
        spills, its shared memory a block (the static plus
        ``smem_of(kernel, elem, hd)``, the body's dynamic shared memory or
        None) and the HMMA instructions in its SASS, by "<kernel> <body>
        hd<HD>": the tensor-core body's bf16 and fp16 instances and the fp32
        one, 3xTF32 on the tensor cores for ``tf32_kernels``, else on the
        CUDA cores. Every bf16, fp16 and 3xTF32 instance must hold HMMA."""
        report = cuda_build.ptxas_report(cuda_build.build_logs.get(library, ""))
        hmma = cuda_build.sass_counts(cuda_build.library_path(library), "HMMA")
        types = {"13__nv_bfloat16": "bf16", "6__half": "fp16"}
        out = {}
        for mangled, rep in report.items():
            inst = re.search(pattern, mangled)
            if inst is None:
                continue
            kernel, elem, hd = inst.group(1), types.get(inst.group(2)), int(inst.group(3))
            body = (f"{elem} tensor cores" if elem else
                    "fp32 3xTF32 tensor cores" if kernel in tf32_kernels else "fp32 CUDA cores")
            dyn = smem_of(kernel, elem or "fp32", hd)
            out[f"{kernel} {body} hd{hd}"] = {
                "registers": rep["registers"], "spill_stores": rep["spill_stores"],
                "spill_loads": rep["spill_loads"],
                "smem_bytes": rep["static_smem"] + (dyn or 0),
                "hmma": hmma.get(mangled, 0)}
        for name, inst in sorted(out.items()):
            say(f"{library} {name}: {inst['registers']} registers, spills "
                f"{inst['spill_stores']}/{inst['spill_loads']} bytes, {inst['smem_bytes']} B "
                f"shared memory a block, {inst['hmma']} HMMA")
        for elem in ("bf16", "fp16"):
            tc_hmma = [v["hmma"] for k, v in out.items() if f"{elem} tensor cores" in k]
            if not tc_hmma or len(tc_hmma) * 3 != len(out) or min(tc_hmma) == 0:
                fail(f"{library}: {elem} runs on the tensor cores, so each of its {elem} "
                     f"instances needs HMMA in its SASS, beside one bf16, fp16 and fp32 "
                     f"instance each ({out})")
        tf32_hmma = [v["hmma"] for k, v in out.items() if "3xTF32" in k]
        if len(tf32_hmma) != 3 * len(tf32_kernels) or min(tf32_hmma, default=0) == 0:
            fail(f"{library}: the fp32 bodies of {sorted(tf32_kernels)} take their products "
                 f"on the tensor cores as 3xTF32, so each of their fp32 instances needs HMMA "
                 f"in its SASS ({out})")
        return out

    fwd_lib = cuda_build.load("flash_attn_fwd")
    fwd_instances = instances(
        "flash_attn_fwd", r"(flash_attn_fwd)_(?:tc_)?kernelI(13__nv_bfloat16|6__half)?Li(\d+)E",
        lambda _, elem, hd: (fwd_lib.flash_attn_fwd_f32_smem_bytes(hd) if elem == "fp32"
                             else fwd_lib.flash_attn_fwd_tc_smem_bytes(hd)),
        {"flash_attn_fwd"})
    if len(fwd_instances) != 9:
        fail(f"flash_attn_fwd: expected 9 instances (hd 32, 64, 128 of the tensor-core "
             f"body in bf16 and fp16, and of the 3xTF32 body), got "
             f"{sorted(fwd_instances)}")

    def attn_inputs(Bsz, T, h, hd, dtype, valid=None, seed=0):
        g = torch.Generator(device="cuda").manual_seed(seed)
        q, k, v = (torch.randn(Bsz, T, h, hd, generator=g, device="cuda").to(dtype)
                   for _ in range(3))
        mask = None if valid is None else torch.as_tensor(valid, device="cuda")[:, None, None, :]
        return q, k, v, mask

    def rows(T, *kinds, seed=0):
        """A [len(kinds), T] key mask: ``prefix:n`` keeps the first n keys,
        ``holes`` drops about 40% of the keys at random (the first kept),
        ``one`` keeps key 0 only, ``none`` masks every key."""
        rs = np.random.RandomState(seed)
        out = np.ones((len(kinds), T), bool)
        for i, kind in enumerate(kinds):
            if kind.startswith("prefix:"):
                out[i, int(kind[7:]):] = False
            elif kind == "holes":
                out[i] = rs.rand(T) < 0.6
                out[i, 0] = True
            elif kind == "one":
                out[i, 1:] = False
            elif kind == "none":
                out[i] = False
        return out

    # the two bodies of each flash kernel: the tensor-core body runs bf16 and
    # fp16 (with and without the forward's residuals), the fp32 body fp32
    # (3xTF32 on the tensor cores); each body counts its launches,
    # "cuda_cores" naming the fp32 body, and each type of it keeps its own
    # worst errors ("tensor_cores" bf16, "tensor_cores_fp16", "cuda_cores")
    flash_wrappers = {"fwd": flash_attn_fwd, "dkv": flash_attn_bwd_dkv, "dq": flash_attn_bwd_dq}
    flash_types = ((torch.float32, "fp32"), (torch.bfloat16, "bf16"), (torch.float16, "fp16"))
    VARIANTS = ("tensor_cores", "tensor_cores_fp16", "cuda_cores")

    def body_of(dtype):
        return "cuda_cores" if dtype == torch.float32 else "tensor_cores"

    def variant_of(dtype):
        return {torch.float32: "cuda_cores", torch.bfloat16: "tensor_cores",
                torch.float16: "tensor_cores_fp16"}[dtype]

    def zero_bodies():
        for w in flash_wrappers.values():
            for body in w.launches_by_body:
                w.launches_by_body[body] = 0

    def flash_bodies():
        return {key: dict(w.launches_by_body) for key, w in flash_wrappers.items()}

    attn_worst = {v: 0.0 for v in VARIANTS}
    attn_abs = {v: 0.0 for v in VARIANTS}

    def note_fwd(variant, rel, abs_err):
        attn_worst[variant] = max(attn_worst[variant], rel)
        attn_abs[variant] = max(attn_abs[variant], abs_err)

    cases = [
        (197, 12, 64, None, "ViT, no mask"),
        (256, 12, 64, rows(256, "prefix:180", "holes", seed=1), "prefix + non-prefix"),
        (256, 12, 64, rows(256, "one", "none"), "one valid key + all masked"),
        (224, 12, 64, HashTokenizer(context_length=224)(REPORTS[:2]) != HashTokenizer.PAD,
         "trimmed text context"),
        (77, 12, 64, rows(77, "prefix:50", "holes", seed=2), "ragged"),
        (77, 4, 32, rows(77, "holes", "none", seed=3), "hd 32"),
        (77, 2, 128, rows(77, "prefix:9", "none"), "hd 128"),
    ]
    for T, h, hd, valid, label in cases:
        for dtype, name in flash_types:
            q, k, v, mask = attn_inputs(2, T, h, hd, dtype, valid, seed=T + hd)
            key_mask = None if mask is None else mask.reshape(2, T).contiguous()
            with torch.inference_mode():
                o_p = attention_plain(q, k, v, mask, sm_scale=hd**-0.5)
                # the interior as serving calls it, then the training forward
                o_ks = {False: flash_attention_interior(q, k, v, mask, sm_scale=hd**-0.5,
                                                        impl="cuda"),
                        True: flash_attn_fwd(q, k, v, key_mask, sm_scale=hd**-0.5,
                                             with_residuals=True)[0]}
            torch.cuda.synchronize()
            for with_res, o_k in o_ks.items():
                (rel, abs_err), = rel_errs([o_k], [o_p])
                ok = bool(torch.isfinite(o_k).all()) and rel <= ATTN_GATE[name]
                if valid is not None and not valid[1].any():  # the all-masked row: mean of v
                    (rel_m, _), = rel_errs([o_k[1]], [v[1].float().mean(0).reshape(1, -1)])
                    ok = ok and rel_m <= ATTN_GATE[name]
                body = body_of(dtype)
                say(f"flash B=2 T={T} h={h} hd={hd} {name} ({label}), "
                    f"{'with' if with_res else 'without'} residuals ({body}): rel_err {rel:.3e} "
                    f"abs_err {abs_err:.3e} {'ok' if ok else 'FAIL'}")
                if not ok:
                    fail(f"flash_attn_fwd disagrees with the plain interior at T={T} hd={hd} "
                         f"{name}, {'with' if with_res else 'without'} residuals")
                note_fwd(variant_of(dtype), rel, abs_err)

    # at the serving batch (64) and the towers' types, bf16 (amp, bf16,
    # pure_bf16) and fp16 (fp16, pure_fp16): the ViT and BERT shapes, each
    # beside the plain interior and the library's call in the same type
    attn_shapes_by = {}
    for dtype, name in flash_types[1:]:
        shapes = attn_shapes_by[variant_of(dtype)] = {}
        for tower, T, valid in (("vit", 197, None),
                                ("bert", 256, report_tokens(64) != HashTokenizer.PAD)):
            q, k, v, mask = attn_inputs(64, T, 12, 64, dtype, valid, seed=5)
            sm = 64**-0.5
            qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
            with torch.inference_mode():
                o_k = flash_attention_interior(q, k, v, mask, sm_scale=sm, impl="cuda")
                o_p = attention_plain(q, k, v, mask, sm_scale=sm)
                (rel, abs_err), = rel_errs([o_k], [o_p])
                key_mask = None if mask is None else mask.reshape(64, T).contiguous()
                o_r = flash_attn_fwd(q, k, v, key_mask, sm_scale=sm, with_residuals=True)[0]
                (rel_r, abs_r), = rel_errs([o_r], [o_p])
                ms_k = cuda_ms(lambda: flash_attention_interior(q, k, v, mask, sm_scale=sm,
                                                                impl="cuda"), 20)
                ms_p = cuda_ms(lambda: attention_plain(q, k, v, mask, sm_scale=sm), 20)
                ms_l = cuda_ms(lambda: F.scaled_dot_product_attention(
                    qt, kt, vt, attn_mask=mask, scale=sm), 20)
            if rel > ATTN_GATE[name] or rel_r > ATTN_GATE[name]:
                fail(f"flash_attn_fwd disagrees with the plain interior at the {tower} shape "
                     f"in {name}: rel err {rel:.3e} without residuals, {rel_r:.3e} with them")
            note_fwd(variant_of(dtype), max(rel, rel_r), max(abs_err, abs_r))
            bound = attn_bound(64, T, 12, 64, 2, valid is not None, sfu_rate)
            shapes[tower] = {"B": 64, "T": T, "h": 12, "hd": 64, "dtype": name,
                             "masked": valid is not None, "launches_per_forward": 12,
                             "ms": ms_k, "plain_ms": ms_p, "library_ms": ms_l, **bound,
                             "max_rel_err": rel}
            say(f"flash B=64 T={T} {name} ({tower}): kernel {ms_k:.4f} ms, plain {ms_p:.4f} "
                f"ms, scaled_dot_product_attention {ms_l:.4f} ms, bound "
                f"{bound['bound_ms']:.4f} ms ({bound['bound_by']}), rel_err {rel:.3e}; with "
                f"residuals rel_err {rel_r:.3e}")
            del q, k, v, qt, kt, vt, o_k, o_p, o_r
    attn_shapes = attn_shapes_by["tensor_cores"]
    say(json.dumps({"flash_attn_fwd_shapes": attn_shapes_by, "card": card}))

    # 8. CLIP serving at full width
    clip, cfns, cmeta = make_serving_fns(
        "biomedclip", is_clip=True, attn_impl="flash", precision="amp", device="cuda",
        generator=torch.Generator().manual_seed(0))
    clip_e, efns, _ = make_serving_fns(
        "biomedclip", is_clip=True, attn_impl="einsum", precision="amp", device="cuda",
        generator=torch.Generator().manual_seed(1))
    clip_e.load_state_dict(clip.state_dict())
    n_params = sum(p.numel() for p in clip.parameters())
    say(f"clip serving: biomedclip {n_params / 1e6:.2f} M parameters, image "
        f"{cmeta['image_size']}, staging {cmeta['staging_size']}, context "
        f"{cmeta['context_length']}, precision {cmeta['precision']}, attn_impl flash")
    S = cmeta["staging_size"]
    c_req = {"image_embed": [rs.randint(0, 256, (1, S, S, 3), dtype=np.uint8)
                             for _ in range(16)],
             "text_embed": list(HashTokenizer(context_length=cmeta["context_length"])(
                 [REPORTS[i % len(REPORTS)] * (1 + i % 5) for i in range(16)])[:, None])}
    for name, reqs in c_req.items():  # first calls: cuBLAS set-up, not counted
        cfns[name](clip, reqs[0])
        efns[name](clip_e, reqs[0])
    torch.cuda.synchronize()
    c_ans = {name: [None] * 16 for name in c_req}
    errors = []
    barrier = threading.Barrier(32)

    def clip_client(name, i):
        try:
            barrier.wait(timeout=60)
            c_ans[name][i] = batchers[name](c_req[name][i])
        except Exception as e:  # reported below; the phase fails
            errors.append(f"{name} request {i}: {e!r}")

    selective_scan_fwd.launches = selective_scan_bwd.launches = flash_attn_fwd.launches = 0
    zero_bodies()
    batchers = {name: MicroBatcher(lambda x, f=cfns[name]: f(clip, x), max_batch=16,
                                   max_delay_ms=100.0) for name in c_req}
    t0 = time.time()
    threads = [threading.Thread(target=clip_client, args=(name, i))
               for name in c_req for i in range(16)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    for mb in batchers.values():
        mb.close()
    wall = time.time() - t0
    clip_flash = flash_attn_fwd.launches
    clip_flash_bodies = flash_bodies()
    clip_scans = selective_scan_fwd.launches + selective_scan_bwd.launches
    if errors or any(t.is_alive() for t in threads):
        fail(f"clip serving: {errors or 'a request did not finish'}")
    n_batches = sum(mb.batches for mb in batchers.values())
    say(f"clip serving: {sum(mb.requests for mb in batchers.values())} requests in "
        f"{n_batches} batches (image rows {batchers['image_embed'].batch_rows}, text rows "
        f"{batchers['text_embed'].batch_rows}) in {wall:.3f} s; flash_attn_fwd launches "
        f"{clip_flash}, scan launches {clip_scans}")
    if any(mb.requests != 16 for mb in batchers.values()):
        fail("MicroBatcher did not answer every CLIP request")
    if clip_flash != 12 * n_batches or clip_scans != 0:
        fail(f"{clip_flash} flash and {clip_scans} scan launches for {n_batches} batches, "
             "expected 12 flash launches each and no scan")
    if clip_flash_bodies["fwd"] != {"tensor_cores": clip_flash, "cuda_cores": 0}:
        fail(f"clip serving: the forward's launches by body {clip_flash_bodies}, expected "
             "every one on the tensor cores")
    clip_diff = 0.0
    for name, reqs in c_req.items():
        got = np.concatenate(c_ans[name])
        norms = np.linalg.norm(got, axis=-1)
        if got.shape != (16, 512) or not np.isfinite(got).all() or \
                np.abs(norms - 1.0).max() > 1e-3:
            fail(f"{name}: shape {got.shape}, norms {norms.min():.5f}..{norms.max():.5f}")
        want = efns[name](clip_e, np.concatenate(reqs)).cpu().numpy()
        diff = float(np.abs(got - want).max())
        clip_diff = max(clip_diff, diff)
        say(f"clip serving: {name} norms {norms.min():.6f}..{norms.max():.6f}; max "
            f"|flash - einsum| = {diff:.3e} (bound {PROBS_ATOL:g})")
        if diff > PROBS_ATOL:
            fail(f"{name} with the flash kernel differs from einsum by {diff:.3e}")

    # Hold each of the 24 attention interiors of one image and one text
    # forward, on its own inputs, against the plain interior.
    calls = []
    interior = vit_mod.flash_attention_interior

    def recording_interior(q, k, v, pad_mask=None, *, sm_scale, impl=None):
        o = interior(q, k, v, pad_mask, sm_scale=sm_scale, impl=impl)
        calls.append((q, k, v, pad_mask, sm_scale, o))
        return o

    vit_mod.flash_attention_interior = recording_interior
    try:
        for name, reqs in c_req.items():
            cfns[name](clip, np.concatenate(reqs))
    finally:
        vit_mod.flash_attention_interior = interior
    if len(calls) != 24:
        fail(f"one image and one text forward made {len(calls)} attention calls, expected 24")
    rec_attn = 0.0
    for q, k, v, pad_mask, sm_scale, o_k in calls:
        with torch.inference_mode():
            o_p = attention_plain(q, k, v, pad_mask, sm_scale=sm_scale)
        (rel, abs_err), = rel_errs([o_k], [o_p])
        rec_attn = max(rec_attn, rel)
        note_fwd("tensor_cores", rel, abs_err)
        if not rel <= ATTN_GATE["bf16"]:
            fail(f"flash_attn_fwd disagrees with the plain interior on a served batch's "
                 f"inputs (T={q.shape[1]}): rel err {rel:.3e}")
    say(f"clip serving: the 24 recorded interiors (12 T={calls[0][0].shape[1]}, 12 "
        f"T={calls[-1][0].shape[1]}) agree with the plain interior: worst rel_err "
        f"{rec_attn:.3e} (gate {ATTN_GATE['bf16']:g})")
    del calls

    # the VSSM-towered CLIP: its image tower runs the scan, its text tower flash
    mm_clip, mm_fns, _ = make_serving_fns(
        "medmamba", is_clip=True, attn_impl="flash", precision="amp", device="cuda",
        generator=torch.Generator().manual_seed(2))
    mm_launches, mm_bodies = {}, {}
    for name, reqs in c_req.items():
        selective_scan_fwd.launches = flash_attn_fwd.launches = 0
        zero_bodies()
        out = mm_fns[name](mm_clip, np.concatenate(reqs))
        torch.cuda.synchronize()
        mm_launches[name] = {"scan": selective_scan_fwd.launches, "flash": flash_attn_fwd.launches}
        mm_bodies[name] = flash_bodies()
        if out.shape != (16, 512) or not torch.isfinite(out).all():
            fail(f"medmamba CLIP {name} gave a bad result")
    say(f"clip serving: medmamba CLIP launches {mm_launches}")
    if mm_launches != {"image_embed": {"scan": 14, "flash": 0},
                       "text_embed": {"scan": 0, "flash": 12}}:
        fail("the VSSM-towered CLIP: expected 14 scan launches for image_embed and 12 "
             "flash launches for text_embed")
    del mm_clip

    # rows/s at batch 64 on device-resident input, flash and einsum
    x64 = {"image_embed": torch.from_numpy(
        rs.randint(0, 256, (64, S, S, 3), dtype=np.uint8)).cuda(),
        "text_embed": torch.from_numpy(report_tokens(64, cmeta["context_length"])).cuda()}
    clip_rates = {}
    for impl, fns_, model_ in (("flash", cfns, clip), ("einsum", efns, clip_e)):
        for name, x in x64.items():
            fns_[name](model_, x)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(10):
                out = fns_[name](model_, x)
            torch.cuda.synchronize()
            dt = (time.perf_counter() - t0) / 10
            if out.shape != (64, 512) or not torch.isfinite(out).all():
                fail(f"{name} ({impl}) at batch 64 gave a bad result")
            clip_rates[f"{name}_{impl}_ms"] = dt * 1e3
            clip_rates[f"{name}_{impl}_rows_per_s"] = 64 / dt
            say(f"clip serving: {name} bs 64 attn_impl={impl}: {dt * 1e3:.2f} ms/batch, "
                f"{64 / dt:.1f} {'img' if name == 'image_embed' else 'texts'}/s on {card}")
    say(json.dumps({"clip_serving": {"card": card, "parameters": n_params, **clip_rates,
                                     "flash_launches": clip_flash, "batches": n_batches,
                                     "max_abs_flash_vs_einsum": clip_diff,
                                     "recorded_interiors_max_rel_err": rec_attn,
                                     "medmamba_clip_launches": mm_launches}}))
    del clip, clip_e, cfns, efns, batchers

    # 9. flash backward kernels against the plain backward. First what was
    # built, as phase 7 lists the forward's instances
    bwd_lib = cuda_build.load("flash_attn_bwd")
    bwd_instances = instances(
        "flash_attn_bwd",
        r"(flash_attn_bwd_dkv|flash_attn_bwd_dq)_(?:tc_)?kernelI(13__nv_bfloat16|6__half)?"
        r"Li(\d+)E",
        lambda kernel, elem, hd: (
            bwd_lib.flash_attn_bwd_tc_smem_bytes(int(kernel.endswith("dq")), hd)
            if elem != "fp32" else
            bwd_lib.flash_attn_bwd_dkv_f32_smem_bytes(hd) if kernel.endswith("dkv") else
            bwd_lib.flash_attn_bwd_dq_f32_smem_bytes(hd)),
        {"flash_attn_bwd_dkv", "flash_attn_bwd_dq"})
    if len(bwd_instances) != 18:
        fail(f"flash_attn_bwd: expected 18 instances (dk/dv and dq at hd 32, 64, 128 of the "
             f"tensor-core body in bf16 and fp16 and of the 3xTF32 fp32 body), got "
             f"{sorted(bwd_instances)}")

    def plain_residuals(q, k, mask, sm):
        sc = torch.matmul(q.transpose(1, 2).float(), k.permute(0, 2, 3, 1).float()) * sm
        if mask is not None:
            sc = sc.masked_fill(~mask, -1e9)
        m_p = sc.max(-1).values
        return m_p, torch.exp(sc - m_p[..., None]).sum(-1)

    def flash_bwd_inputs(Bsz, T, h, hd, dtype, valid, seed):
        q, k, v, mask = attn_inputs(Bsz, T, h, hd, dtype, valid, seed=seed)
        g = torch.Generator(device="cuda").manual_seed(seed + 1)
        do = torch.randn(Bsz, T, h * hd, generator=g, device="cuda").to(dtype)
        key_mask = None if mask is None else mask.reshape(Bsz, T).contiguous()
        return q, k, v, mask, key_mask, do

    def flash_bwd(q, k, v, key_mask, do, sm):
        """(dq, dk, dv) by the kernels, as ``FlashAttnFn`` calls them, the
        kernels' other inputs (mask, do, the forward's residuals, di) and the
        forward's result."""
        B_, T_, h_, hd_ = q.shape
        out, m, l = flash_attn_fwd(q, k, v, key_mask, sm_scale=sm, with_residuals=True)
        di = (out.float() * do.float()).view(B_, T_, h_, hd_).sum(-1).transpose(1, 2).contiguous()
        res = (key_mask, do.view(B_, T_, h_, hd_), m, l, di)
        dk, dv = flash_attn_bwd_dkv(q, k, v, *res, sm_scale=sm)
        return (flash_attn_bwd_dq(q, k, v, *res, sm_scale=sm), dk, dv), res, out

    bwd_attn_worst = {key: {v: 0.0 for v in VARIANTS} for key in ("dq", "dkv")}
    bwd_attn_abs = {key: {v: 0.0 for v in VARIANTS} for key in ("dq", "dkv")}

    def note_bwd(errs, variant):
        (r_q, a_q), (r_k, a_k), (r_v, a_v) = errs
        for key, rel, abs_err in (("dq", r_q, a_q), ("dkv", max(r_k, r_v), max(a_k, a_v))):
            bwd_attn_worst[key][variant] = max(bwd_attn_worst[key][variant], rel)
            bwd_attn_abs[key][variant] = max(bwd_attn_abs[key][variant], abs_err)

    bwd_cases = [c if c[4] != "one valid key + all masked" else
                 (256, 12, 64, rows(256, "one", "none", "holes", seed=4),
                  "one valid key + all masked + non-prefix") for c in cases]
    for T, h, hd, valid, label in bwd_cases:
        Bsz = 2 if valid is None else len(valid)
        for dtype, name in flash_types:
            q, k, v, mask, key_mask, do = flash_bwd_inputs(Bsz, T, h, hd, dtype, valid, T + hd)
            sm = hd**-0.5
            g_k, res, _ = flash_bwd(q, k, v, key_mask, do, sm)
            g_k2, _, _ = flash_bwd(q, k, v, key_mask, do, sm)
            g_p = attention_plain_bwd(q, k, v, mask, do, sm)
            m_p, l_p = plain_residuals(q, k, mask, sm)
            torch.cuda.synchronize()
            errs = rel_errs(g_k, g_p)
            if name != "fp32":
                # A row with one valid key has ds = 0: its dq and dk vanish.
                # The bf16 (fp16) plain backward rounds do.v to its type
                # before it takes di off, which leaves rounding noise there,
                # so such rows are left out against it; every row is also
                # held against the fp32 plain backward on the same inputs,
                # whose arithmetic is the kernels'.
                if valid is not None:
                    keep = torch.as_tensor(valid.sum(1) != 1, device="cuda")
                    errs = rel_errs([g[keep] for g in g_k], [g[keep] for g in g_p])
                errs32 = rel_errs(g_k, attention_plain_bwd(q.float(), k.float(), v.float(), mask,
                                                           do.float(), sm))
                errs = [max(a, b) for a, b in zip(errs, errs32)]
            res_err = max(float(((a - b).abs() / b.abs().clamp_min(1.0)).max())
                          for a, b in ((res[2], m_p), (res[3], l_p)))
            same_bits = all(torch.equal(a, b) for a, b in zip(g_k, g_k2))
            zeros_ok = True
            if valid is not None:
                va = torch.as_tensor(valid, device="cuda")
                dead = ~va & va.any(1, keepdim=True)   # masked keys of rows with a valid key
                empty = ~va.any(1)                      # rows with no valid key
                zeros_ok = all(float(g[dead].abs().sum()) == 0.0 for g in g_k[1:]) and \
                    all(float(g[empty].abs().sum()) == 0.0 for g in g_k[:2])
            ok = (all(bool(torch.isfinite(g).all()) for g in g_k)
                  and all(r <= ATTN_GATE[name] for r, _ in errs)
                  and res_err <= GATE_REL and same_bits and zeros_ok)
            say(f"flash bwd B={Bsz} T={T} h={h} hd={hd} {name} ({label}, {body_of(dtype)}): "
                + " ".join(f"{n} {r:.2e}" for n, (r, _) in zip(("dq", "dk", "dv"), errs))
                + f" residuals {res_err:.2e} same_bits {same_bits} exact_zeros {zeros_ok}"
                + (" ok" if ok else " FAIL"))
            if not ok:
                fail(f"the flash backward kernels disagree with the plain backward at T={T} "
                     f"hd={hd} {name}")
            note_bwd(errs, variant_of(dtype))

    # fp16's range: a cotangent that carries the fp16 loss scale (2^16) and
    # whose fp16 rounding overflows in a few entries of two rows. The kernels
    # must pass the inf on, as the plain backward does, and clamp nothing:
    # each gradient non-finite exactly where the plain one is (every dv
    # column the inf rows feed, their own dq rows, every attended key's dk)
    # and finite elsewhere.
    q, k, v, mask, key_mask, _ = flash_bwd_inputs(2, 197, 12, 64, torch.float16, None, 41)
    cot = torch.randn(2, 197, 12 * 64, generator=torch.Generator(device="cuda").manual_seed(42),
                      device="cuda") * 1e-3
    cot[0, 5, :3], cot[1, 100, 64:70] = 2.0, -3.0
    do = (cot * 2.0**16).to(torch.float16)
    g_k, _, out = flash_bwd(q, k, v, None, do, 64**-0.5)
    g_p = attention_plain_bwd(q, k, v, None, do, 64**-0.5, o=out)
    torch.cuda.synchronize()
    overflow = {"do_nonfinite": int((~torch.isfinite(do)).sum())}
    for gname, a, b in zip(("dq", "dk", "dv"), g_k, g_p):
        bad_k, bad_p = ~torch.isfinite(a), ~torch.isfinite(b)
        overflow[gname] = {"kernel_nonfinite": int(bad_k.sum()),
                           "plain_nonfinite": int(bad_p.sum()),
                           "same_entries": bool(torch.equal(bad_k, bad_p))}
    say(f"flash bwd fp16 with an overflowing scaled cotangent: {overflow}")
    if not overflow["do_nonfinite"] or not all(
            overflow[g]["same_entries"] and overflow[g]["kernel_nonfinite"] > 0
            for g in ("dq", "dk", "dv")):
        fail(f"fp16 flash backward: the non-finite cotangent did not reach dq, dk and dv "
             f"where the plain backward's does: {overflow}")
    del q, k, v, do, cot, g_k, g_p, out

    # at the training batch (64), the ViT and BERT shapes: bf16 and fp16 on
    # the tensor cores (training under amp, pure_bf16; fp16, pure_fp16), fp32
    # in 3xTF32 on the tensor cores; each beside the plain forward and
    # backward and the library's, in the same type. The operations of the
    # fp32 bodies are bound by the tensor cores at a third of the TF32 rate
    # (three products a product), printed beside the fp32 FMA bound of the
    # same work.
    tf32_rate, fma_rate = {"tc_rate": TF32_TC_FLOPS / 3}, {"tc_rate": FP32_FLOPS}
    bwd_shapes_attn = {v: {} for v in VARIANTS}
    for dtype, name in flash_types:
        body, itemsize = variant_of(dtype), dtype.itemsize
        fp32 = dtype == torch.float32
        for tower, T, valid in (("vit", 197, None),
                                ("bert", 256, report_tokens(64) != HashTokenizer.PAD)):
            q, k, v, mask, key_mask, do = flash_bwd_inputs(64, T, 12, 64, dtype, valid, 5)
            sm = 64**-0.5
            g_k, res, _ = flash_bwd(q, k, v, key_mask, do, sm)
            errs = rel_errs(g_k, attention_plain_bwd(q, k, v, mask, do, sm))
            if any(r > ATTN_GATE[name] for r, _ in errs):
                fail(f"the flash backward kernels disagree with the plain backward at the "
                     f"{tower} shape in {name}")
            note_bwd(errs, body)
            ms_f = cuda_ms(lambda: flash_attn_fwd(q, k, v, key_mask, sm_scale=sm,
                                                  with_residuals=True), 20)
            with torch.no_grad():
                ms_pf = cuda_ms(lambda: attention_plain(q, k, v, mask, sm_scale=sm), 20)
            ms_kv = cuda_ms(lambda: flash_attn_bwd_dkv(q, k, v, *res, sm_scale=sm), 20)
            ms_q = cuda_ms(lambda: flash_attn_bwd_dq(q, k, v, *res, sm_scale=sm), 20)
            ms_p = cuda_ms(lambda: attention_plain_bwd(q, k, v, mask, do, sm), 10)
            qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_() for t in (q, k, v))
            o_l = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask, scale=sm)
            # the library's forward as training calls it: it keeps its residuals
            ms_lf = cuda_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                                                   scale=sm), 20)
            do_l = do.view(64, T, 12, 64).transpose(1, 2)
            ms_l = cuda_ms(lambda: torch.autograd.grad(o_l, (qt, kt, vt), do_l,
                                                       retain_graph=True), 20)
            masked = valid is not None
            kw_f = dict(stats=2)
            kw_kv = dict(tensors=6, stats=3, products=4)
            b_kv = attn_bound(64, T, 12, 64, itemsize, masked, sfu_rate, **kw_kv,
                              **(tf32_rate if fp32 else {}))
            kw_q = dict(tensors=5, stats=3, products=3)
            b_q = attn_bound(64, T, 12, 64, itemsize, masked, sfu_rate, **kw_q,
                             **(tf32_rate if fp32 else {}))
            b_f = attn_bound(64, T, 12, 64, itemsize, masked, sfu_rate, **kw_f,
                             **(tf32_rate if fp32 else {}))
            fma = {}
            if fp32:  # the same work at the fp32 FMA rate
                for key, kw in (("fwd", kw_f), ("dkv", kw_kv), ("dq", kw_q)):
                    fma[key] = {"fma_bound_ms": attn_bound(64, T, 12, 64, itemsize, masked,
                                                           sfu_rate, **kw, **fma_rate)["bound_ms"]}
            bwd_shapes_attn[body][tower] = {
                "B": 64, "T": T, "h": 12, "hd": 64, "dtype": name, "masked": masked,
                "launches_per_step": 12,
                "fwd": {"ms": ms_f, "plain_ms": ms_pf, "library_ms": ms_lf, **b_f,
                        **fma.get("fwd", {})},
                "dkv": {"ms": ms_kv, **b_kv, **fma.get("dkv", {})},
                "dq": {"ms": ms_q, **b_q, **fma.get("dq", {})},
                "plain_bwd_ms": ms_p, "library_bwd_ms": ms_l,
                "max_rel_err": max(r for r, _ in errs)}
            say(f"flash bwd B=64 T={T} {name} ({tower}, {body}): dk/dv {ms_kv:.4f} ms (bound "
                f"{b_kv['bound_ms']:.4f}, {b_kv['bound_by']}), dq {ms_q:.4f} ms (bound "
                f"{b_q['bound_ms']:.4f}, {b_q['bound_by']}), forward with residuals "
                f"{ms_f:.4f} ms (bound {b_f['bound_ms']:.4f}, plain {ms_pf:.4f}, "
                f"scaled_dot_product_attention {ms_lf:.4f}), plain backward {ms_p:.4f} ms, "
                f"scaled_dot_product_attention backward {ms_l:.4f} ms"
                + (f"; the bounds are 3xTF32's, at the fp32 FMA rate the forward's "
                   f"{fma['fwd']['fma_bound_ms']:.4f}, dk/dv's {fma['dkv']['fma_bound_ms']:.4f} "
                   f"and dq's {fma['dq']['fma_bound_ms']:.4f} ms" if fp32 else ""))
            del q, k, v, do, g_k, res, qt, kt, vt, o_l, do_l
    say(json.dumps({"flash_attn_bwd_shapes": bwd_shapes_attn, "card": card}))
    flash_ms_per_step = {key: sum(12 * sh[key]["ms"]
                                  for sh in bwd_shapes_attn["tensor_cores"].values())
                         for key in ("fwd", "dkv", "dq")}

    # 10. CLIP training: the stage-1 contrastive step of full-width BiomedCLIP
    wrappers = {"fwd": flash_attn_fwd, "dkv": flash_attn_bwd_dkv, "dq": flash_attn_bwd_dq,
                "scan_fwd": selective_scan_fwd, "scan_bwd": selective_scan_bwd}

    def reset_counts():
        for w in wrappers.values():
            w.launches = 0
        zero_bodies()

    def read_counts():
        return {key: w.launches for key, w in wrappers.items()}

    def timed_clip_steps(state, step_fn, batches, what, warm=WARM, timed=TIMED):
        """``warm`` + ``timed`` steps; returns the state, ms per timed step,
        the peak memory of the timed steps and every step's metrics."""
        metrics = []
        for i in range(warm):
            state, m = step_fn(state, batches[i % 2], 0)
            metrics.append(m)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        for i in range(timed):
            state, m = step_fn(state, batches[i % 2], 0)
            metrics.append(m)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) / timed * 1e3
        peak = torch.cuda.max_memory_allocated()
        for i, m in enumerate(metrics):
            loss, gnorm = check_metrics(m, f"{what} step {i}")
            ls_ = float(m["logit_scale"])
            say(f"clip training ({what}): step {i}: loss {loss:.5f} grad_norm {gnorm:.5f} "
                f"logit_scale {ls_:.4f} lr {m['lr']:.3e}")
            if not 1.0 <= ls_ <= 100.0:
                fail(f"{what}: logit_scale {ls_} outside [1, 100]")
        return state, ms, peak, metrics

    torch.cuda.empty_cache()
    base_mem = torch.cuda.memory_allocated()
    state, step_fn, batches = clip_train_setup(TB)
    n_clip = sum(p.numel() for p in state.model.parameters())
    say(f"clip training: biomedclip {n_clip / 1e6:.2f} M parameters, batch {TB}, image 224, "
        f"staging 256, context 256, precision amp, attn_impl flash, AdamW, clipping 1.0; "
        f"{base_mem / 2**20:.0f} MiB allocated before it")
    reset_counts()
    state, clip_ms, clip_peak, metrics = timed_clip_steps(state, step_fn, batches, "flash")
    clip_train = read_counts()
    clip_train_bodies = flash_bodies()
    say(f"clip training: launches in {steps} steps: {clip_train}; by body "
        f"{clip_train_bodies}")
    want = {"fwd": 24 * steps, "dkv": 24 * steps, "dq": 24 * steps, "scan_fwd": 0, "scan_bwd": 0}
    if clip_train != want:
        fail(f"clip training: launches {clip_train}, expected {want}")
    if any(b != {"tensor_cores": 24 * steps, "cuda_cores": 0} for b in clip_train_bodies.values()):
        fail(f"clip training: launches by body {clip_train_bodies}, expected every one on the "
             "tensor cores")
    first_loss = float(metrics[0]["loss"])
    if not 3.0 <= first_loss <= 6.0:
        fail(f"clip training: first loss {first_loss} outside [3, 6] (ln 64 = 4.16)")

    # Hold each of the 24 interiors of one more step, with the do its
    # backward was given, against the plain backward on its own inputs.
    calls = []

    def recording_train_interior(q, k, v, pad_mask=None, *, sm_scale, impl=None):
        o = interior(q, k, v, pad_mask, sm_scale=sm_scale, impl=impl)
        rec = {"q": q.detach(), "k": k.detach(), "v": v.detach(), "mask": pad_mask,
               "sm": sm_scale}
        o.register_hook(lambda g: rec.update(do=g.detach()))
        calls.append(rec)
        return o

    vit_mod.flash_attention_interior = recording_train_interior
    try:
        state, m = step_fn(state, batches[0], 0)
    finally:
        vit_mod.flash_attention_interior = interior
    check_metrics(m, "recorded clip step")
    if len(calls) != 24 or any("do" not in c for c in calls):
        fail(f"one clip step made {len(calls)} attention calls with "
             f"{sum('do' in c for c in calls)} gradients, expected 24")
    # Against the fp32 plain backward on the same bf16 inputs and the same kept
    # result o, whose arithmetic is the kernels'. Beside it, not gated, the
    # bf16 plain backward, which recomputes o: at these inputs the keys of a
    # row are nearly alike, so dq = sum_j ds_j k_j is a small remainder of
    # terms that cancel, and a difference of one bf16 rounding in
    # rowsum(o * do) is of dq's own size.
    rec_bwd = rec_bwd_bf16 = rec_fwd = 0.0
    for c in calls:
        q, k, v = (c[n].contiguous() for n in "qkv")
        B_, T_ = q.shape[:2]
        key_mask = None if c["mask"] is None else c["mask"].reshape(B_, T_).contiguous()
        do = c["do"].contiguous()
        g_k, _, out = flash_bwd(q, k, v, key_mask, do, c["sm"])
        # the forward's own result, held against the plain interior
        with torch.no_grad():
            (rel_o, abs_o), = rel_errs([out], [attention_plain(q, k, v, c["mask"],
                                                               sm_scale=c["sm"])])
        if not rel_o <= ATTN_GATE["bf16"]:
            fail("flash_attn_fwd with residuals disagrees with the plain interior on a train "
                 f"step's own inputs (T={T_}): rel err {rel_o:.3e}")
        rec_fwd = max(rec_fwd, rel_o)
        note_fwd("tensor_cores", rel_o, abs_o)
        errs = rel_errs(g_k, attention_plain_bwd(q.float(), k.float(), v.float(), c["mask"],
                                                 do.float(), c["sm"], o=out.float()))
        errs_bf16 = rel_errs(g_k, attention_plain_bwd(q, k, v, c["mask"], do, c["sm"]))
        errs_o32 = rel_errs(g_k, attention_plain_bwd(q.float(), k.float(), v.float(), c["mask"],
                                                     do.float(), c["sm"]))
        worst = max(r for r, _ in errs)
        say(f"clip training interior T={T_}: against the fp32 plain backward "
            + " ".join(f"{n} {r:.2e}" for n, (r, _) in zip(("dq", "dk", "dv"), errs))
            + "; with the result recomputed in fp32 "
            + " ".join(f"{n} {r:.2e}" for n, (r, _) in zip(("dq", "dk", "dv"), errs_o32))
            + "; against the bf16 plain backward "
            + " ".join(f"{n} {r:.2e}" for n, (r, _) in zip(("dq", "dk", "dv"), errs_bf16)))
        if not worst <= ATTN_GATE["bf16"]:
            fail("the flash backward kernels disagree with the plain backward on a train "
                 f"step's own inputs (T={T_}): rel err {worst:.3e}")
        rec_bwd = max(rec_bwd, worst)
        rec_bwd_bf16 = max(rec_bwd_bf16, max(r for r, _ in errs_bf16))
        note_bwd(errs, "tensor_cores")
    say(f"clip training: the 24 recorded interiors (12 T={calls[0]['q'].shape[1]}, 12 "
        f"T={calls[-1]['q'].shape[1]}) agree with the fp32 plain backward on their own inputs: "
        f"worst rel_err {rec_bwd:.3e} (gate {ATTN_GATE['bf16']:g}); against the bf16 plain "
        f"backward {rec_bwd_bf16:.3e}; their forward's o against the plain interior "
        f"{rec_fwd:.3e}")
    del calls, state, step_fn, c, q, k, v, do, g_k
    torch.cuda.empty_cache()

    # the same step with the einsum interior: its time and its peak memory
    state, step_fn, _ = clip_train_setup(TB, attn_impl="einsum")
    _, einsum_ms, einsum_peak, _ = timed_clip_steps(state, step_fn, batches, "einsum", 1, 2)
    del state, step_fn
    torch.cuda.empty_cache()

    # kernels against plain interiors end to end at batch 8, seed 1, from S_0
    # and S_1, each part gated where it is well posed (clip_step_check)
    clip_check = clip_step_check(1)
    for r in clip_check:
        say_clip_step(r)
    if not all(r["ok"] for r in clip_check):
        fail(f"the clip train step with the kernels differs from the plain interiors beyond "
             f"{CLIP_TRAIN_REL:g}: (a) loss or (b) grad norm, {clip_check}")
    # one fp32 step: the fp32 bodies (3xTF32 forward, dk/dv and dq)
    # through the normal entry point, under the same gates; their main path,
    # so its launches are counted
    fp32_check = clip_step_check(1, precision="fp32", steps=1,
                                 counted=(reset_counts, lambda: (read_counts(), flash_bodies())))
    say_clip_step(fp32_check[0])
    fp32_counts, fp32_bodies = fp32_check[0].pop("counts")
    say(f"clip training bs 8 fp32: launches {fp32_counts}; by body {fp32_bodies}")
    if not fp32_check[0]["ok"]:
        fail(f"the fp32 clip train step with the kernels differs from the plain interiors "
             f"beyond {CLIP_TRAIN_REL:g}: {fp32_check[0]}")
    if (fp32_counts != {"fwd": 24, "dkv": 24, "dq": 24, "scan_fwd": 0, "scan_bwd": 0}
            or any(b != {"tensor_cores": 0, "cuda_cores": 24} for b in fp32_bodies.values())):
        fail(f"the fp32 clip train step: launches {fp32_counts}, by body {fp32_bodies}; "
             "expected 24 + 24 + 24, every one on the fp32 body (counted as cuda_cores)")

    # accum_freq=2 with grad_checkpointing: the bank pass and the recomputes launch too
    st, fn, bs = clip_train_setup(8, seed=1, grad_checkpointing=True, accum_freq=2)
    reset_counts()
    st, m = fn(st, bs[0], 0)
    accum_counts = read_counts()
    accum_bodies = flash_bodies()
    check_metrics(m, "accum_freq=2 checkpointed clip step")
    say(f"clip training bs 8 accum_freq=2 grad_checkpointing: launches {accum_counts}")
    if accum_counts != {"fwd": 144, "dkv": 48, "dq": 48, "scan_fwd": 0, "scan_bwd": 0}:
        fail("accum_freq=2 with grad_checkpointing: expected 144 forward (48 in the bank "
             "pass, 96 in the graded pass and its recomputes), 48 dk/dv and 48 dq launches")
    if any(b["cuda_cores"] for b in accum_bodies.values()):
        fail(f"accum_freq=2 with grad_checkpointing: launches by body {accum_bodies}, "
             "expected every one on the tensor cores")
    del st, fn

    # the VSSM-towered CLIP: scans in the image tower, flash in the text tower
    st, fn, _ = clip_train_setup(8, model_name="medmamba", seed=2)
    reset_counts()
    st, m = fn(st, bs[0], 0)
    mm_train = read_counts()
    mm_train_bodies = flash_bodies()
    check_metrics(m, "medmamba clip step")
    say(f"clip training bs 8 medmamba CLIP: launches {mm_train}")
    if mm_train != {"fwd": 12, "dkv": 12, "dq": 12, "scan_fwd": 14, "scan_bwd": 14}:
        fail("the VSSM-towered CLIP's train step: expected 14 + 14 scan and 12 + 12 + 12 "
             "flash launches")
    del st, fn, bs
    say(json.dumps({"clip_training": {
        "card": card, "parameters": n_clip, "batch": TB, "steps_timed": TIMED,
        "ms_per_step": clip_ms, "pairs_per_s": TB / (clip_ms / 1e3),
        "max_memory_allocated_bytes": clip_peak, "allocated_before_bytes": base_mem,
        "einsum_ms_per_step": einsum_ms, "einsum_pairs_per_s": TB / (einsum_ms / 1e3),
        "einsum_max_memory_allocated_bytes": einsum_peak,
        "flash_kernel_ms_per_step": flash_ms_per_step,
        "launches_per_step": {k: n / steps for k, n in clip_train.items()},
        "first_loss": first_loss, "recorded_interiors_max_rel_err": rec_bwd,
        "recorded_interiors_vs_bf16_plain_max_rel_err": rec_bwd_bf16,
        "recorded_interiors_fwd_max_rel_err": rec_fwd,
        "bs8_check": clip_check, "bs8_fp32_check": fp32_check,
        "bs8_fp32_launches": fp32_counts, "accum2_checkpointed_launches": accum_counts,
        "medmamba_clip_launches": mm_train}}))
    say(f"clip training: {clip_ms:.2f} ms/step, {TB / (clip_ms / 1e3):.1f} pairs/s, peak "
        f"{clip_peak / 2**30:.2f} GiB allocated with flash; einsum {einsum_ms:.2f} ms/step, "
        f"peak {einsum_peak / 2**30:.2f} GiB; flash kernels forward "
        f"{flash_ms_per_step['fwd']:.3f}, dk/dv {flash_ms_per_step['dkv']:.3f}, dq "
        f"{flash_ms_per_step['dq']:.3f} ms per step, on {card}")

    # 11. the ceiling kernel against its plain version, then the roofline tool
    def chain_err(got, want):
        abs_err = float((got - want).abs().max())
        return abs_err / float(want.abs().max()), abs_err

    chain_abs = chain_rel = 0.0
    n_tool = props.multi_processor_count * 2048 * 8   # the tool's size: one full wave
    g11 = torch.Generator(device="cuda").manual_seed(11)
    x_rag = torch.rand(1_000_003, generator=g11, device="cuda") + 0.5   # a ragged count
    x_tool = torch.rand(n_tool, generator=g11, device="cuda")
    ints = (torch.arange(x_rag.numel(), device="cuda") % 1000).float()
    for r in (1, 2, 3, 4):
        # exact step counts: 16 r halvings, 16 r increments
        halves = vpu_chain(x_rag, r, False, 0.5, 0.0)
        incs = vpu_chain(ints, r, False, 1.0, 1.0)
        ok = torch.equal(halves, x_rag * 2.0 ** (-16 * r)) and torch.equal(incs, ints + 16 * r)
        say(f"vpu_chain rounds={r}: x * 2^-{16 * r} and x + {16 * r} bit for bit: "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            fail(f"vpu_chain does not take exactly {16 * r} steps at rounds={r}")
    # the exp chain contracts toward 0.567: only a short chain can show a missing step
    e16 = vpu_chain(x_rag, 1, True)
    rel16, abs16 = chain_err(e16, vpu_chain_plain(x_rag, 1, True))
    rel15, _ = chain_err(e16, vpu_chain_plain(x_rag, 0, True, steps=15))
    say(f"vpu_chain exp rounds=1 (16 steps): rel_err {rel16:.3e} against the plain 16 steps, "
        f"{rel15:.3e} against the plain 15 steps (gate {CHAIN_GATE:g})")
    if not (rel16 <= CHAIN_GATE < rel15):
        fail("the exp chain at 16 steps: the kernel must agree with 16 plain steps and "
             "disagree with 15")
    chain_abs, chain_rel = max(chain_abs, abs16), max(chain_rel, rel16)
    for x, label in ((x_tool, "the tool's size"), (x_rag, "a ragged count")):
        k_fma = vpu_chain(x, 64)
        rel_f, abs_f = chain_err(k_fma, vpu_chain_plain(x, 64, fused=True))
        rel_u, _ = chain_err(k_fma, vpu_chain_plain(x, 64))
        rel_e, abs_e = chain_err(vpu_chain(x, 64, True), vpu_chain_plain(x, 64, True))
        say(f"vpu_chain rounds=64 at the tool's constants, {label} ({x.numel()}): FMA rel_err "
            f"{rel_f:.3e} against the plain chain rounding once a step, {rel_u:.3e} against "
            f"the one rounding twice (gate {CHAIN_UNFUSED_GATE:g}); exp rel_err {rel_e:.3e} "
            f"(gate {CHAIN_GATE:g})")
        if not (rel_f <= CHAIN_GATE and rel_e <= CHAIN_GATE and rel_u <= CHAIN_UNFUSED_GATE):
            fail(f"vpu_chain disagrees with its plain version at rounds=64 on {label}")
        chain_abs, chain_rel = max(chain_abs, abs_f, abs_e), max(chain_rel, rel_f, rel_e)
    torch.cuda.synchronize()

    # the tool's measurement: the main path of this kernel
    vpu_chain.launches = 0
    roof = scan_roofline.measure("cuda")
    chain_launches = vpu_chain.launches
    if chain_launches == 0:
        fail("scan_roofline.measure launched vpu_chain no time")
    chain_ms = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0}
    chain_by = {"bytes": 0.0, "operations": 0.0}
    for key, use_exp in (("fma", False), ("exp", True)):
        c = roof[key]
        steps = c["rounds"] * 16
        plain_ms = cuda_ms(lambda: vpu_chain_plain(x_tool, c["rounds"], use_exp), 1, warmup=0)
        t_ops = (n_tool * steps / sfu_rate if use_exp else n_tool * steps * 2 / FP32_FLOPS)
        t_bytes = 8 * n_tool / HBM_BYTES_PER_S   # x read, the result written, fp32
        bound = 1e3 * max(t_ops, t_bytes)
        chain_by["bytes" if t_bytes >= t_ops else "operations"] += bound
        chain_ms = {"ms": chain_ms["ms"] + c["ms"], "plain_ms": chain_ms["plain_ms"] + plain_ms,
                    "bound_ms": chain_ms["bound_ms"] + bound}
        say(f"vpu_chain {key}: {c['per_s']:.4g}/s, {c['share_of_datasheet_at_clock']:.3f} of "
            f"the data sheet at {c['sm_clock_mhz']:.0f} MHz (read under load: "
            f"{c['clock_read_under_load']}); a launch of {steps} steps {c['ms']:.3f} ms, "
            f"bound {bound:.3f} ms, plain {plain_ms:.1f} ms")
    measured = scan_roofline.measured_rates(roof)
    kw_m = {k: v for k, v in measured.items() if k != "sfu_rate"}
    fwd_bound_m = sum(n * scan_bound(64, L, DG, 2, measured["sfu_rate"], **kw_m)["bound_ms"]
                      for (L, DG), n in zip(STAGES, BLOCKS_PER_STAGE))
    bwd_bound_m = sum(n * scan_bwd_bound(64, L, DG, 2, measured["sfu_rate"], **kw_m)["bound_ms"]
                      for (L, DG), n in zip(STAGES, BLOCKS_PER_STAGE))
    say(json.dumps({"roofline": {
        "card": card,
        "fma_per_s": roof["fma"]["per_s"], "fma_tflops": roof["fma_tflops"],
        "fma_share_of_datasheet_at_clock": roof["fma"]["share_of_datasheet_at_clock"],
        "exp_per_s": roof["exp"]["per_s"],
        "exp_share_of_datasheet_at_clock": roof["exp"]["share_of_datasheet_at_clock"],
        "exp_cost_in_fma_slots": roof["exp_cost_in_fma_slots"],
        "hbm_bytes_per_s": roof["hbm"]["bytes_per_s"],
        "hbm_share_of_datasheet": roof["hbm"]["share_of_datasheet"],
        "sm_clock_mhz": {k: roof[k]["sm_clock_mhz"] for k in ("fma", "exp", "hbm")},
        "clock_read_under_load": {k: roof[k]["clock_read_under_load"]
                                  for k in ("fma", "exp", "hbm")},
        "chain_rounds": {k: roof[k]["rounds"] for k in ("fma", "exp")},
        "chain_launch_ms": {k: roof[k]["ms"] for k in ("fma", "exp")},
        "vpu_chain_launches": chain_launches,
        # per batch-64 medmamba step (14 launches): the kernel's time beside both bounds
        "selective_scan_fwd": {"ms": fwd_k, "bound_ms_datasheet": fwd_bound,
                               "bound_ms_measured": fwd_bound_m},
        "selective_scan_bwd": {"ms": bwd_k_step, "bound_ms_datasheet": bwd_bound_step,
                               "bound_ms_measured": bwd_bound_m},
        "scan_batch32": {label: {k: m[k] for k in (
            "fwd_ms", "fwd_hck_ms", "bwd_ms", "fwdbwd_ms", "bwd_over_fwd",
            "fwd_pct_of_measured_bound", "bwd_pct_of_measured_bound",
            "fwd_pct_of_datasheet_bound", "bwd_pct_of_datasheet_bound")}
            for label, m in roof["scan"].items()}}}))
    del x_rag, x_tool, ints

    # 12. a stage-1 epoch: load, train, evaluate, save, resume
    wrappers["vpu_chain"] = vpu_chain
    EB, N_TRAIN, N_VAL, SEED = 64, 256, 128, 0
    policy = get_policy("amp")
    tcfg_train = get_transform_config(None, 224, is_train=True)
    tcfg_val = get_transform_config(None, 224, is_train=False)
    # the flags as the CLI parses them; the values these phases run at
    loop_flags = dict(
        batch_size=EB, epochs=1, workers=4, seed=SEED, synthetic_data=True, is_test=False,
        train_num_samples=N_TRAIN, val_num_samples=N_VAL, sampling=None, val_frequency=1,
        log_every_n_steps=2, save_frequency=1, delete_previous_checkpoint=False,
        save_most_recent=False, return_best=False, eval_loss=None, hopt_direction="minimize",
        trace=False)
    loop_argv = ["--synthetic-data", "--batch-size", str(EB), "--seed", str(SEED),
                 "--train-num-samples", str(N_TRAIN), "--val-num-samples", str(N_VAL),
                 "--log-every-n-steps", "2"]

    def parsed(argv, want):
        args = parse_args(argv)
        off = {k: (getattr(args, k), v) for k, v in want.items() if getattr(args, k) != v}
        if off:
            fail(f"parse_args({argv}) differs from the flags these phases run at: {off}")
        return args

    args1 = parsed(loop_argv + ["--stage", "1", "--checkpoint-steps", "2", "--grad-clip-norm",
                                "1.0"],
                   {**CLIP_TRAIN_ARGS, **loop_flags, "stage": 1, "checkpoint_steps": 2,
                    "class_weighted_loss": False})
    work = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        def counted(fn, log, before=None):
            """``fn`` as a train step that logs each call's kernel launches."""
            def step(state, batch, seed):
                if before is not None:
                    before(len(log))
                start = read_counts()
                out = fn(state, batch, seed)
                log.append({k: v - start[k] for k, v in read_counts().items()})
                return out
            return step

        def clip_state(seed):
            model = build_clip("biomedclip", image_size=224, dtype=policy.compute_dtype,
                               attn_flash=True,
                               generator=torch.Generator().manual_seed(seed)).to("cuda")
            schedule = create_schedule(args1, CLIP_TOTAL_STEPS)
            tx = build_optimizer(args1, schedule)
            return (create_train_state(model, tx, policy),
                    make_clip_train_step(model, tx, policy, args1, tcfg_train, schedule))

        data1 = get_data(args1, tokenizer=HashTokenizer(context_length=256),
                         staging_size=tcfg_train.staging_size)
        data1["tcfg_val"] = tcfg_val
        state1, step1 = clip_state(0)
        run1 = RunState(checkpoint_path=os.path.join(work, "checkpoints"))
        step_ckpt = os.path.join(run1.checkpoint_path, "stage_1_epoch_0_step_2")
        kept = os.path.join(work, "kept", "stage_1_epoch_0_step_2")
        seen = {}

        def before_step(i):
            # batch 2 is done: its step checkpoint and sidecar must be on disk; keep a
            # hard link for the resume below, finalize() removes the original
            if i == 2:
                seen["dir"] = os.path.isfile(os.path.join(step_ckpt, "state.pt"))
                seen["sidecar"] = os.path.isfile(step_ckpt + ".meta.json")
                if seen["dir"] and seen["sidecar"]:
                    os.makedirs(kept)
                    os.link(os.path.join(step_ckpt, "state.pt"), os.path.join(kept, "state.pt"))
                    shutil.copy(step_ckpt + ".meta.json", kept + ".meta.json")

        log1 = []
        reset_counts()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        metrics1, state1 = port_pipeline.step(
            args1, run1, state1.model, data1,
            {"state": state1, "step_fn": counted(step1, log1, before_step), "policy": policy,
             "start_epoch": 0}, "cuda", SEED, save_prefix="stage_1_", stage=1)
        torch.cuda.synchronize()
        epoch1_s = time.perf_counter() - t0
        peak1 = torch.cuda.max_memory_allocated()
        total1 = read_counts()
        total1_bodies = flash_bodies()
        names = sorted(os.listdir(run1.checkpoint_path))
        say(f"epoch stage 1: {len(log1)} steps, launches a step {log1}; in all {total1}; "
            f"metrics {metrics1}; checkpoints {names}; step checkpoint seen after batch 2: "
            f"{seen}")
        step_want = {"fwd": 24, "dkv": 24, "dq": 24, "scan_fwd": 0, "scan_bwd": 0, "vpu_chain": 0}
        if len(log1) != N_TRAIN // EB or any(c != step_want for c in log1):
            fail(f"stage-1 epoch: launches a step {log1}, expected {N_TRAIN // EB} x {step_want}")
        n_eval = -(-N_VAL // EB)
        if total1 != {**step_want, "fwd": 24 * (len(log1) + n_eval), "dkv": 24 * len(log1),
                      "dq": 24 * len(log1)}:
            fail(f"stage-1 epoch: {total1} launches in all, expected 24 forward an eval batch "
                 "and no backward there")
        if not (seen.get("dir") and seen.get("sidecar")):
            fail("stage-1 epoch: the step checkpoint or its sidecar was missing after batch 2")
        if names != ["results.jsonl", "stage_1_epoch_1", "stage_1_epoch_latest"]:
            fail(f"stage-1 epoch: checkpoint directory holds {names} after finalize")
        if not (metrics1 and np.isfinite(metrics1["val_loss"]) and 3.0 <= metrics1["val_loss"] <= 6.0
                and metrics1["num_samples"] == N_VAL):
            fail(f"stage-1 epoch: eval metrics {metrics1} (the contrastive loss is near ln 64)")
        m1 = run1.meters[0]
        if not all(np.isfinite(v) for v in m1["last_metrics"].values()):
            fail(f"stage-1 epoch: train metrics {m1['last_metrics']}")

        # the loader alone: the rate its threads make batches at with the GIL to themselves
        data1["train"].set_epoch(0)
        t0 = time.perf_counter()
        n_loaded = sum(1 for _ in data1["train"].loader)
        loader_s = (time.perf_counter() - t0) / n_loaded

        # one more evaluation, alone: its launches and its rate
        reset_counts()
        t0 = time.perf_counter()
        again = evaluate(state1.model, state1, data1, 1, args1, policy, tcfg_val, stage=1,
                         device="cuda")
        eval1_s = time.perf_counter() - t0
        eval1 = read_counts()
        if eval1 != {**step_want, "fwd": 24 * n_eval, "dkv": 0, "dq": 0} or \
                abs(again["val_loss"] - metrics1["val_loss"]) > 1e-6 * metrics1["val_loss"]:
            fail(f"stage-1 eval: launches {eval1}, loss {again['val_loss']} against "
                 f"{metrics1['val_loss']}")

        # exact resume: a fresh state from the step checkpoint, run from batch 2
        shutil.rmtree(os.path.join(run1.checkpoint_path, "stage_1_epoch_1"))
        state_r, step_r = clip_state(7)
        t0 = time.perf_counter()
        state_r, start_epoch = load_checkpoint(kept, state_r)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        ckpt_bytes = os.path.getsize(os.path.join(kept, "state.pt"))
        start_batch = parse_step_checkpoint(kept)[1]
        validate_step_resume(kept, EB, num_batches=data1["train"].num_batches)
        if (start_epoch, start_batch, state_r.step, state_r.opt_state.count) != (0, 2, 2, 2):
            fail(f"resume: epoch {start_epoch} batch {start_batch} step {state_r.step}")
        state_r = train_one_epoch(step_r, state_r, data1, 0, args1, SEED, start_batch=2,
                                  device="cuda")
        torch.cuda.synchronize()
        pr, pu = dict(state_r.model.named_parameters()), dict(state1.model.named_parameters())
        differ = [k for k in pu if not torch.equal(pr[k], pu[k])]
        differ += [f"mu/{k}" for k, v in state1.opt_state.mu.items()
                   if not torch.equal(v, state_r.opt_state.mu[k])]
        differ += [f"nu/{k}" for k, v in state1.opt_state.nu.items()
                   if not torch.equal(v, state_r.opt_state.nu[k])]
        same_counts = (state_r.step, state_r.opt_state.count) == (state1.step,
                                                                  state1.opt_state.count)
        say(f"epoch stage 1: resumed from {os.path.basename(kept)} at batch {start_batch}: "
            f"{len(pu)} parameters and 2 x {len(state1.opt_state.mu)} moments, "
            f"{len(differ)} differ from the uninterrupted run; step {state_r.step}")
        if differ or not same_counts:
            fail(f"resume is not exact: {len(differ)} tensors differ, first {differ[:5]}")
        del state_r, step_r, pr

        t0 = time.perf_counter()
        save_checkpoint(run1.checkpoint_path, state1, 1, args1, name="timing")
        save_s = time.perf_counter() - t0
        shutil.rmtree(os.path.join(run1.checkpoint_path, "timing"))
        say(json.dumps({"epoch_stage1": {
            "card": card, "batch": EB, "steps": len(log1), "train_samples": N_TRAIN,
            "val_samples": N_VAL, "workers": args1.workers,
            # the last logged window: one step with no checkpoint save and no warm-up in it
            "ms_per_step": 1e3 * m1["batch_time_last"],
            "pairs_per_s": EB / m1["batch_time_last"],
            # the loop's meters over the epoch; the batch meter holds the first step's
            # warm-up and the step checkpoint's save
            "data_s": m1["data_time_avg"], "batch_s": m1["batch_time_avg"],
            "loader_alone_s_per_batch": loader_s,
            "epoch_with_eval_and_saves_s": epoch1_s,
            "eval_rows_per_s": N_VAL / eval1_s, "val_loss": metrics1["val_loss"],
            "train_metrics_last_step": m1["last_metrics"],
            "max_memory_allocated_bytes": peak1,
            "launches_per_step": log1[0], "launches_per_eval_batch": {
                k: v / n_eval for k, v in eval1.items()},
            "checkpoint_bytes": ckpt_bytes, "save_s": save_s,
            "save_MB_per_s": ckpt_bytes / 1e6 / save_s, "load_s": load_s,
            "load_MB_per_s": ckpt_bytes / 1e6 / load_s, "resume_exact": True}}))

        # 13. a stage-2 epoch: ClipClassifier over the stage-1 CLIP, frozen
        args2 = parsed(loop_argv + ["--stage", "2", "--class-weighted-loss"],
                       {**TRAIN_ARGS, **loop_flags, "stage": 2, "checkpoint_steps": 0,
                        "class_weighted_loss": True})
        data2 = get_data(args2, tokenizer=HashTokenizer(context_length=256),
                         staging_size=tcfg_train.staging_size)
        data2["tcfg_val"] = tcfg_val
        cw = data2["train"].class_weights

        def classifier(attn_flash, seed):
            clip_ = build_clip("biomedclip", image_size=224, dtype=policy.compute_dtype,
                               attn_flash=attn_flash,
                               generator=torch.Generator().manual_seed(seed))
            return ClipClassifier(clip_, num_classes=2,
                                  generator=torch.Generator().manual_seed(seed))

        model2 = classifier(True, 5)
        load_params_only(os.path.join(run1.checkpoint_path, "stage_1_epoch_latest"),
                         model2.clip)
        model2 = model2.to("cuda")
        stage1_params = dict(state1.model.named_parameters())
        if not all(torch.equal(p, stage1_params[k]) for k, p in model2.clip.named_parameters()):
            fail("stage 2: the CLIP loaded from stage_1_epoch_latest differs from stage 1's")
        named2 = dict(model2.named_parameters())
        schedule2 = create_schedule(args2, data2["train"].num_batches * args2.epochs)
        tx2 = build_optimizer(args2, schedule2,
                              trainable_mask=freeze_submodule_mask(named2, ["clip"]))
        state2 = create_train_state(model2, tx2, policy)
        step2 = make_classifier_train_step(model2, tx2, policy, args2, tcfg_train, schedule2,
                                           class_weights=cw, num_classes=2, takes_text=True)
        head0 = {k: p.detach().clone() for k, p in named2.items() if not k.startswith("clip.")}
        run2 = RunState(checkpoint_path=os.path.join(work, "checkpoints2"))
        log2 = []
        reset_counts()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        metrics2, state2 = port_pipeline.step(
            args2, run2, model2, data2,
            {"state": state2, "step_fn": counted(step2, log2), "policy": policy,
             "start_epoch": 0}, "cuda", SEED, save_prefix="stage_2_", stage=2,
            takes_text=True, class_weights=cw)
        torch.cuda.synchronize()
        peak2 = torch.cuda.max_memory_allocated()
        total2 = read_counts()
        total2_bodies = flash_bodies()
        say(f"epoch stage 2: {len(log2)} steps, launches a step {log2}; in all {total2}; "
            f"metrics {metrics2}; moments kept for {sorted(state2.opt_state.mu)}")
        want2 = {**step_want, "dkv": 0, "dq": 0}
        if len(log2) != N_TRAIN // EB or any(c != want2 for c in log2):
            fail(f"stage-2 epoch: launches a step {log2}, expected {want2}")
        if total2 != {**want2, "fwd": 24 * (len(log2) + n_eval)}:
            fail(f"stage-2 epoch: {total2} launches in all")
        moved = [k for k, p in model2.clip.named_parameters()
                 if not torch.equal(p, stage1_params[k])]
        if moved:
            fail(f"stage-2 epoch: {len(moved)} frozen clip.* parameters changed: {moved[:5]}")
        if any(torch.equal(named2[k].detach(), v) for k, v in head0.items()):
            fail("stage-2 epoch: a head parameter did not move")
        pauc = metrics2.get("partial_auc", float("nan"))
        if not (np.isfinite(metrics2["val_loss"]) and np.isfinite(pauc) and 0.0 <= pauc <= 0.2):
            fail(f"stage-2 epoch: metrics {metrics2}: partial_auc must lie in [0, 0.2]")
        m2 = run2.meters[0]
        data2["train"].set_epoch(0)
        t0 = time.perf_counter()
        n_loaded = sum(1 for _ in data2["train"].loader)
        loader2_s = (time.perf_counter() - t0) / n_loaded

        # the same validation probabilities through the einsum interior
        model_e = classifier(False, 6)
        model_e.load_state_dict(model2.state_dict())
        model_e = model_e.to("cuda").eval()
        eval2 = make_eval_step(model2, policy, tcfg_val, stage=2, class_weights=cw)

        def val_probs(model):
            model.eval()
            data2["val"].loader.set_epoch(0)
            return torch.cat([eval2(model, b)[1] for b in
                              device_prefetch(iter(data2["val"].loader), "cuda")])

        t0 = time.perf_counter()
        probs_f = val_probs(model2)
        torch.cuda.synchronize()
        eval2_s = time.perf_counter() - t0
        probs_e = val_probs(model_e)
        diff2 = float((probs_f - probs_e).abs().max())
        say(f"epoch stage 2: max |probs(flash) - probs(einsum)| = {diff2:.3e} over "
            f"{probs_f.shape[0]} validation rows (bound {PROBS_ATOL:g})")
        if probs_f.shape != (N_VAL, 2) or not diff2 <= PROBS_ATOL:
            fail(f"stage-2 probabilities with the flash kernel differ from einsum by {diff2:.3e}")
        say(json.dumps({"epoch_stage2": {
            "card": card, "batch": EB, "steps": len(log2), "workers": args2.workers,
            "ms_per_step": 1e3 * m2["batch_time_last"], "img_per_s": EB / m2["batch_time_last"],
            "data_s": m2["data_time_avg"], "batch_s": m2["batch_time_avg"],
            "loader_alone_s_per_batch": loader2_s,
            "eval_rows_per_s": N_VAL / eval2_s, "val_loss": metrics2["val_loss"],
            "partial_auc": pauc, "val_positives": int(data2["val"].targets.sum()),
            "train_metrics_last_step": m2["last_metrics"],
            "max_memory_allocated_bytes": peak2, "launches_per_step": log2[0],
            "max_abs_flash_vs_einsum_probs": diff2,
            "class_weights": [float(w) for w in cw]}}))
        del model_e, model2, state2, state1
    finally:
        shutil.rmtree(work, ignore_errors=True)

    # 14. the CLI: the two-stage recipe through mamba_clip_tpu_torch.cli.main's
    # main(), in this process, with the Drive recipe's flags and --attn-impl flash
    cli_line, cli_launches, cli_bodies = cli_phase(card, reset_counts, read_counts,
                                                   flash_bodies)
    # phases 12 and 13 in this run: the same step functions, driven from Python
    cli_line.update(phase12_ms_per_step=1e3 * m1["batch_time_last"],
                    phase13_ms_per_step=1e3 * m2["batch_time_last"])
    say(json.dumps({"cli": cli_line}))

    # 15. serving artifacts and the HTTP host: export, load and serve over
    # loopback through mamba_clip_tpu_torch.serve_http
    gc.collect()
    torch.cuda.empty_cache()
    http_line, http_launches, http_bodies = serving_phase(card, reset_counts, read_counts,
                                                          flash_bodies)
    say(json.dumps({"serving_http": http_line}))

    # 16. the recipe on files in the ISIC-2024 layout: JPEG decode, the
    # staging cache and submission.csv, beside phases 12-14's synthetic loops
    gc.collect()
    torch.cuda.empty_cache()
    synthetic = {"phase12_ms_per_step": 1e3 * m1["batch_time_last"],
                 "phase12_data_s": m1["data_time_avg"],
                 "phase13_ms_per_step": 1e3 * m2["batch_time_last"],
                 "phase13_data_s": m2["data_time_avg"],
                 "phase14_stage1_ms_per_step": cli_line["stage1"].get("ms_per_step"),
                 "phase14_stage2_ms_per_step": cli_line["stage2"].get("ms_per_step")}
    real_line, _, real_bodies = real_data_phase(card, reset_counts, read_counts, flash_bodies,
                                                synthetic)
    say(json.dumps({"real_data": real_line}))

    # 17. the native int8 modes: the dots on the card against the CPU, then
    # int8_serve classify, the contrastive and medmamba steps and an
    # int8_serve artifact through the scan and flash kernels
    gc.collect()
    torch.cuda.empty_cache()
    quant_line, quant_launches, quant_bodies = quant_phase(
        card, reset_counts, read_counts, flash_bodies,
        {"medmamba_ms": step_ms, "clip_flash_ms": clip_ms, "clip_einsum_ms": einsum_ms})
    say(json.dumps({"quant": quant_line}))

    # 18. the low-precision parameter policies at full width: the contrastive
    # and medmamba steps, the CLI under pure_bf16 and its checkpoint's
    # artifacts, through the scan kernels and the flash kernels' bf16 and fp16
    # instances
    gc.collect()
    torch.cuda.empty_cache()
    prec_line, prec_launches, prec_bodies, fp16_launches = precision_phase(
        card, reset_counts, read_counts, flash_bodies,
        {"medmamba_ms": step_ms, "medmamba_peak": peak, "medmamba_before": mm_before,
         "clip_ms": clip_ms,
         "clip_peak": clip_peak, "clip_before": base_mem})
    say(json.dumps({"precision": prec_line}))

    # 19. the aqt modes: the dots on the card against the CPU, the contrastive
    # and medmamba steps under int8 and int8_fwd, and the CLI's recipe under
    # --quant int8, through the flash and scan kernels
    gc.collect()
    torch.cuda.empty_cache()
    t19 = time.perf_counter()
    aqt_line, aqt_launches, aqt_bodies = aqt_phase(
        card, reset_counts, read_counts, flash_bodies,
        {"medmamba_ms": step_ms, "clip_flash_ms": clip_ms})
    aqt_line["phase_s"] = time.perf_counter() - t19
    say(json.dumps({"aqt": aqt_line}))

    # 20. the data axis: two gloo ranks on the card against one process, and
    # a one-rank NCCL world in this process (the gloo ranks each a process of
    # its own, their launches counted there)
    gc.collect()
    torch.cuda.empty_cache()
    t20 = time.perf_counter()
    axis_line, _, axis_bodies = axis_phase(card)
    axis_line["phase_s"] = time.perf_counter() - t20
    say(json.dumps({"data_axis": axis_line}))

    # 21. the native ASHA search through the CLI at full width, a TrialRunner's
    # save and restore, and the optuna and ray gates, through the scan kernels
    gc.collect()
    torch.cuda.empty_cache()
    t21 = time.perf_counter()
    hpo_line, hpo_launches, hpo_bodies = hpo_phase(card, reset_counts, read_counts,
                                                   flash_bodies)
    hpo_line["phase_s"] = time.perf_counter() - t21
    say(json.dumps({"hpo": hpo_line}))

    # 22. the utilities: --remote-sync and a resume from the remote copy,
    # --report-to wandb, and profile_step's attribution of the flash
    # contrastive step
    gc.collect()
    torch.cuda.empty_cache()
    t22 = time.perf_counter()
    util_line, util_launches, util_bodies = utilities_phase(card, reset_counts, read_counts,
                                                            flash_bodies)
    util_line["phase_s"] = time.perf_counter() - t22
    say(json.dumps({"utilities": util_line}))

    # 23. the VSSM decoder at full width through both scan kernels
    gc.collect()
    torch.cuda.empty_cache()
    t23 = time.perf_counter()
    dec_line, dec_launches, dec_bodies = decoder_phase(card, reset_counts, read_counts,
                                                       flash_bodies)
    dec_line["phase_s"] = time.perf_counter() - t23
    say(json.dumps({"decoder": dec_line}))

    # 24. the fsdp and model axes: two gloo ranks on the card, (fsdp 2) and
    # (model 2), against one process (their launches counted in the ranks)
    gc.collect()
    torch.cuda.empty_cache()
    t24 = time.perf_counter()
    mesh_line, mesh_bodies, mesh_one = mesh_phase(card)
    mesh_line["phase_s"] = time.perf_counter() - t24
    say(json.dumps({"mesh_axes": mesh_line}))

    # 25. the sequence-parallel scan and GPipe on two gloo ranks on the card
    # (their launches counted in the ranks), and data-sharded serving
    gc.collect()
    torch.cuda.empty_cache()
    t25 = time.perf_counter()
    sp_line, sharded_line, sp_launches, sp_bodies = sp_phase(
        card, (reset_counts, read_counts, flash_bodies))
    sp_line["phase_s"] = time.perf_counter() - t25
    say(json.dumps({"sharded_scan_gpipe": sp_line}))
    say(json.dumps({"sharded_serving": sharded_line}))

    # 26. --quant under the model axis and per-layer gathering on the fsdp
    # axis: two gloo ranks on the card (their launches counted in the ranks)
    gc.collect()
    torch.cuda.empty_cache()
    t26 = time.perf_counter()
    qm_line, qm_bodies, qm_scans = quant_mesh_phase(card, mesh_one)
    qm_line["phase_s"] = time.perf_counter() - t26
    say(json.dumps({"quant_mesh_axes": qm_line}))

    # 27. the tools: flash_sweep (its flash call counted), parity_harness,
    # quant_parity, measure_report_tokens, benchmark_e2e through the CLI and
    # the bench
    gc.collect()
    torch.cuda.empty_cache()
    t27 = time.perf_counter()
    tools_line, _, tools_bodies = tools_phase(card, reset_counts, read_counts, flash_bodies)
    tools_line["phase_s"] = time.perf_counter() - t27
    say(json.dumps({"tools": tools_line}))

    # 28. kernels line, then the device line. Each attention kernel as three
    # entries, one a body and type: the tensor cores in bf16 (what serving and
    # training under amp and pure_bf16 run, its launches from the main path),
    # the tensor cores in fp16 (training under fp16 and pure_fp16, its
    # launches from phase 18's fp16 steps) and the fp32 body (3xTF32 on the
    # tensor cores; its launches from phase 10's fp32 step), each timed at
    # the towers' shapes in its own type (phase 7 serving's forward, phase 9
    # the rest)
    def by_bound(shapes):
        by = {"bytes": 0.0, "operations": 0.0}
        for sh in shapes:
            by[sh["bound_by"]] += sh["bound_ms"]
        return max(by, key=by.get)

    flash_paths = {"clip_serve": clip_flash_bodies, "clip_train": clip_train_bodies,
                   "epoch_stage1": total1_bodies, "epoch_stage2": total2_bodies,
                   "medmamba_clip_text_embed": mm_bodies["text_embed"],
                   "clip_train_accum2_checkpointed": accum_bodies,
                   "medmamba_clip_train": mm_train_bodies, "clip_train_fp32": fp32_bodies,
                   "cli": cli_bodies, "serving_http": http_bodies, "real_data": real_bodies,
                   "quant": quant_bodies, "aqt": aqt_bodies, "data_axis": axis_bodies,
                   "hpo": hpo_bodies, "utilities": util_bodies, "decoder": dec_bodies,
                   "mesh_axes": mesh_bodies, "gpipe": sp_bodies, "quant_mesh_axes": qm_bodies,
                   "tools": tools_bodies,
                   # phase 18's bf16 launches; its fp16 ones are the fp16 entries'
                   "precision": {k: {"tensor_cores": by["tensor_cores"] - fp16_launches[k],
                                     "cuda_cores": by["cuda_cores"]}
                                 for k, by in prec_bodies.items()}}
    main_paths = {"fwd": ("clip_serve", "clip_train", "epoch_stage1", "epoch_stage2", "cli",
                          "serving_http", "real_data", "quant", "precision", "aqt",
                          "data_axis", "utilities", "mesh_axes", "gpipe", "quant_mesh_axes",
                          "tools"),
                  "dkv": ("clip_train", "epoch_stage1", "cli", "real_data", "quant",
                          "precision", "aqt", "data_axis", "utilities", "mesh_axes", "gpipe",
                          "quant_mesh_axes", "tools"),
                  "dq": ("clip_train", "epoch_stage1", "cli", "real_data", "quant",
                         "precision", "aqt", "data_axis", "utilities", "mesh_axes", "gpipe",
                         "quant_mesh_axes", "tools")}
    flash_launches = {key: {"tensor_cores": sum(flash_paths[p][key]["tensor_cores"]
                                                for p in paths),
                            "tensor_cores_fp16": fp16_launches[key],
                            "cuda_cores": fp32_bodies[key]["cuda_cores"]}
                      for key, paths in main_paths.items()}
    if any(n == 0 for by in flash_launches.values() for n in by.values()):
        fail(f"a flash body was launched no time: {flash_launches} (the tensor cores on the "
             "main path in bf16 and in phase 18's fp16 steps, the fp32 body in the fp32 step)")
    # the attention kernels' bounds again from the ceilings phase 11 measured
    # (HBM and exp; the tensor cores' rate, TF32's for the fp32 bodies too,
    # stays the data sheet's)
    attn_m = {"sfu_rate": measured["sfu_rate"], "hbm_rate": measured["hbm_rate"]}
    bound_kw = {"fwd": dict(stats=2), "dkv": dict(tensors=6, stats=3, products=4),
                "dq": dict(tensors=5, stats=3, products=3)}

    def attn_rows(key, body):
        """phase 9's rows of ``key`` in ``body`` with their plain and
        library times (the backward's: one call for dq, dk and dv)"""
        if key == "fwd":
            return [{**sh["fwd"], "T": sh["T"], "masked": sh["masked"]}
                    for sh in bwd_shapes_attn[body].values()]
        return [{**sh[key], "plain_ms": sh["plain_bwd_ms"], "library_ms": sh["library_bwd_ms"],
                 "T": sh["T"], "masked": sh["masked"]} for sh in bwd_shapes_attn[body].values()]

    def attn_times(rows, tc, kw):
        """ms, plain, bound and library ms per 12 + 12 launches at batch 64
        (a train step's, or an image_embed and a text_embed), and the shares
        of the data-sheet and the measured bounds. Not ``tc``: the fp32 body
        in 3xTF32, bound by the tensor cores at a third of the TF32 rate, its
        fp32 FMA bound beside."""
        out = {k: sum(12 * r[k] for r in rows)
               for k in ("ms", "plain_ms", "bound_ms", "library_ms")}
        out["bound_by"] = by_bound(rows)
        if not tc:
            out["fp32_fma_bound_ms"] = sum(12 * r["fma_bound_ms"] for r in rows)
        rate = {} if tc else {"tc_rate": TF32_TC_FLOPS / 3}
        meas = sum(12 * attn_bound(64, r["T"], 12, 64, 2 if tc else 4, r["masked"], **attn_m,
                                   **kw, **rate)["bound_ms"] for r in rows)
        out.update(bound_ms_measured=meas, share_of_bound_datasheet=out["bound_ms"] / out["ms"],
                   share_of_bound_measured=meas / out["ms"])
        return out

    fwd_serving = {v: attn_times(list(attn_shapes_by[v].values()), True, {"stats": 0})
                   for v in ("tensor_cores", "tensor_cores_fp16")}
    bodies_of_entry = {
        "tensor_cores": ("", "bf16 (serving and training under amp, bf16 and pure_bf16), "
                             "mma.sync on the tensor cores", "bf16"),
        "tensor_cores_fp16": ("_fp16", "fp16 (training and evaluation under fp16 and "
                                       "pure_fp16), mma.sync .f16 on the tensor cores", "fp16"),
        "cuda_cores": ("_cuda_cores", "fp32 (training and evaluation under fp32), 3xTF32 "
                                      "mma.sync .tf32 on the tensor cores", "fp32")}
    attn_entries = []
    for key, name, source, replaces in (
            ("fwd", "flash_attn_fwd", "flash_attn_fwd.cu", "src/mamba_clip_tpu/ops/flash_attn.py:75"),
            ("dkv", "flash_attn_bwd_dkv", "flash_attn_bwd.cu",
             "jax/experimental/pallas/ops/tpu/flash_attention.py:796 (reached from "
             "src/mamba_clip_tpu/ops/flash_attn.py:122)"),
            ("dq", "flash_attn_bwd_dq", "flash_attn_bwd.cu",
             "jax/experimental/pallas/ops/tpu/flash_attention.py:1146 (reached from "
             "src/mamba_clip_tpu/ops/flash_attn.py:122)")):
        for body in ("tensor_cores", "tensor_cores_fp16", "cuda_cores"):
            tc = body != "cuda_cores"
            suffix, what, elem = bodies_of_entry[body]
            times = attn_times(attn_rows(key, body), tc, bound_kw[key])
            by_path = ({p: c[key]["tensor_cores" if tc else body] for p, c in flash_paths.items()}
                       if body != "tensor_cores_fp16" else {"precision": fp16_launches[key]})
            entry = {
                "name": f"{name}{suffix}",
                "route": "cuda",
                "source": f"src/mamba_clip_tpu_torch/csrc/{source}",
                "replaces": replaces,
                "body": what,
                "launches": flash_launches[key][body],
                "launches_by_path": by_path,
                "max_abs_err": (attn_abs if key == "fwd" else bwd_attn_abs[key])[body],
                "max_rel_err": (attn_worst if key == "fwd" else bwd_attn_worst[key])[body],
                # the forward's tensor-core entries: an image_embed +
                # text_embed pair (serving, no residuals), their "training"
                # the train step's launches; the rest per train step in
                # their type
                **(fwd_serving[body] if tc and key == "fwd" else times),
                "instances": {n: i for n, i in {**fwd_instances, **bwd_instances}.items()
                              if n.startswith(f"{name} {elem}")},
            }
            if tc and key == "fwd":
                entry["training"] = times
            attn_entries.append(entry)
    say(json.dumps({"kernels": [{
        "name": "selective_scan_fwd",
        "route": "cuda",
        "source": "src/mamba_clip_tpu_torch/csrc/selective_scan_fwd.cu",
        "replaces": "src/mamba_clip_tpu/ops/selective_scan.py:194",
        "launches": (launches + train_fwd + cli_launches["scan_fwd"]
                     + http_launches["scan_fwd"] + quant_launches["scan_fwd"]
                     + prec_launches["scan_fwd"] + aqt_launches["scan_fwd"]
                     + hpo_launches["scan_fwd"] + util_launches["scan_fwd"]
                     + dec_launches["scan_fwd"] + sp_launches["scan_fwd"]
                     + qm_scans["scan_fwd"]),
        "launches_by_path": {"serve": launches, "train": train_fwd, "clip_serve": clip_scans,
                             "medmamba_clip_image_embed": mm_launches["image_embed"]["scan"],
                             "cli": cli_launches["scan_fwd"],
                             "serving_http": http_launches["scan_fwd"],
                             "quant": quant_launches["scan_fwd"],
                             "precision": prec_launches["scan_fwd"],
                             "aqt": aqt_launches["scan_fwd"],
                             "hpo": hpo_launches["scan_fwd"],
                             "utilities": util_launches["scan_fwd"],
                             "decoder": dec_launches["scan_fwd"],
                             "sharded_scan_and_serving": sp_launches["scan_fwd"],
                             "quant_mesh_axes": qm_scans["scan_fwd"]},
        "max_abs_err": worst_abs,
        "max_rel_err": worst_rel,
        "ms": fwd_k,
        "plain_ms": fwd_p,
        "bound_ms": fwd_bound,
        "bound_by": max(bound_terms, key=bound_terms.get),
        "library_ms": None,
        "instances": scan_instances["selective_scan_fwd"],
    }, {
        "name": "selective_scan_bwd",
        "route": "cuda",
        "source": "src/mamba_clip_tpu_torch/csrc/selective_scan_bwd.cu",
        "replaces": "src/mamba_clip_tpu/ops/selective_scan.py:243",
        "launches": (train_bwd + cli_launches["scan_bwd"] + quant_launches["scan_bwd"]
                     + prec_launches["scan_bwd"] + aqt_launches["scan_bwd"]
                     + hpo_launches["scan_bwd"] + util_launches["scan_bwd"]
                     + dec_launches["scan_bwd"] + sp_launches["scan_bwd"]
                     + qm_scans["scan_bwd"]),
        "launches_by_path": {"serve": serve_bwd, "train": train_bwd,
                             "cli": cli_launches["scan_bwd"],
                             "serving_http": http_launches["scan_bwd"],
                             "quant": quant_launches["scan_bwd"],
                             "precision": prec_launches["scan_bwd"],
                             "aqt": aqt_launches["scan_bwd"],
                             "hpo": hpo_launches["scan_bwd"],
                             "utilities": util_launches["scan_bwd"],
                             "decoder": dec_launches["scan_bwd"],
                             "sharded_scan": sp_launches["scan_bwd"],
                             "quant_mesh_axes": qm_scans["scan_bwd"]},
        "max_abs_err": bwd_abs,
        "max_rel_err": bwd_rel,
        "ms": bwd_k_step,
        "plain_ms": bwd_p_step,
        "bound_ms": bwd_bound_step,
        "bound_by": max(bwd_terms, key=bwd_terms.get),
        "library_ms": None,
        "instances": scan_instances["selective_scan_bwd"],
    }] + attn_entries + [{
        "name": "vpu_chain",
        "route": "cuda",
        "source": "src/mamba_clip_tpu_torch/csrc/vpu_chain.cu",
        "replaces": "tools/scan_roofline.py:80",
        "launches": chain_launches,
        "launches_by_path": {"scan_roofline": chain_launches, "epoch_stage1": 0,
                             "cli": cli_launches["vpu_chain"]},
        "max_abs_err": chain_abs,
        "max_rel_err": chain_rel,
        # one FMA launch and one exp launch at the tool's size and rounds
        "ms": chain_ms["ms"],
        "plain_ms": chain_ms["plain_ms"],
        "bound_ms": chain_ms["bound_ms"],
        "bound_by": max(chain_by, key=chain_by.get),
        "library_ms": None,
    }]}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
