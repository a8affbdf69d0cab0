#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA card.

    python3 chip_smoke.py        (from the repo root; needs one CUDA card)

Phases, each printing its own lines; any failure exits non-zero:

1. device  — the card's name and power limit (nvidia-smi) and torch's view;
2. build   — compile ``celebrity_image_denoiser_tpu_torch/csrc`` with nvcc
             for sm_90a (one nvcc per source, started together); registers,
             spills and static shared memory of every kernel from ptxas, and
             which matrix instructions the library holds (``cuobjdump
             -sass``: HGMMA is the bf16 wgmma, IGMMA the s8 one, HMMA and
             IMMA mma.sync), with IGMMA required in K5's and K6's kernels;
             and, for each noise kind, the instructions one chunk must issue
             (the SASS of ``csrc/noise_issue_probe.cu``, built beside the
             library into a library of its own: the blocks on every path
             from entry to exit), for the noise kernel's issue floor;
3. kernels — the wrappers of ``csrc/mma.cuh`` (cp.async, ldmatrix, mma.sync,
             wgmma with its descriptor) through ``csrc/mma_probe.cu``
             against an exact integer product; then every kernel entry point
             against its plain PyTorch version on the card, at every shape
             the U-Net launches at 128² batch 8, at a ragged 132×100 input
             (tiles straddle every edge), at 12×20 (an image smaller than a
             16×16 tile) and at 40×36 (W not a multiple of 8), in f32 and
             bf16, TF32 off; ``upconv2`` and ``upconv1.0`` also with their
             input given as two tensors, the second a cropped strided view
             (in bf16 the kernels read the two through two pointers, in f32
             the wrapper concatenates); K2's narrow f32 body (Cout <= 4)
             for every Cout 1-4 against Cin 3, 10, 16, 64 and 67 at 97×130,
             batch 2 past an 8×32 tile, one short of it, an image smaller
             than a tile in both dimensions (5×20) and one pixel, a zero
             bias and an unaligned input, each launch twice and bit-equal;
             then, as a control, the f32 plain versions with TF32 on must
             fail the f32 check at 128² batch 8;
3b. int8   — the s8 probes against exact integer products: wgmma
             m64n64k32 (A by ldmatrix, K-major B with the 32-byte swizzle by
             descriptor, k = 32..128) and mma.sync m16n8k32 (ldmatrix x4 and
             x2 from the 32-byte swizzled rows); the s8 epilogue's
             quantization for all 65,536 bf16 values of h at 7440 scales
             against the IEEE division on the card;
             the int8 kernels against their plain versions (exact in
             integers): K5 ``conv3x3_s8`` at the U-Net's nine int8 convs
             and K6 ``convt2x2_s8`` at its two transpose convs (batch 256,
             128²), at ragged shapes (odd H and W, a cropped strided second
             input, Cout = 3) and in each output mode — every s8, bf16 and
             f32 output bit equal; K2's s8-out mode (the first conv) within
             one s8 step on ≥ 99.9% (its f32 sums run in another order);
4. serve   — the port's ``ServeState`` on the shipped weights behind the
             stdlib HTTP server on 127.0.0.1; three ``/enhance`` requests
             (256×256, 130×98, 64×64) whose pixels must match the plain-path
             forward on the card within 1 count, and whose kernel launch
             counts must be exactly 4 (double conv) + 2 (single conv) each;
             then 100 more 256×256 requests from one client for p50/p90
             latency;
4b. int8 serve — the s8 skip-storage program on the shipped weights with
             exactly K2 ×1, K5 ×9, K6 ×2 and no K3 per forward, its kernel
             route against its plain route on the card: conv 0 (K2's s8
             mode) within one step, the rest of the program bit-equal from
             the same conv-0 output, and end to end (each route its own
             conv 0) the differing pixels and counts printed and held to
             ≥ 40 dB; then ``ServeState(quantize="int8")`` (the CLI's
             default): the ladder must pick ``int8-s8skip``, three
             ``/enhance`` requests counted ``int8`` with those launch
             counts and ≥ 40 dB of the plain route, and 100 requests for
             p50/p90 latency; phases 4 and 4b end with the quality gate:
             the fixture gain (``serve/quality.py``) of the f32 and the
             int8 server on the shipped weights must reach 70% of the gain
             recorded in ``weights/denoise/meta.json``;
4c. tiling — the f32 and the int8 server (threshold 2048) answer a tall
             4097×1001, a wide 1001×4097 and a 3072×4096 (H×W) request over
             HTTP, labelled ``float+tiled`` / ``int8+tiled``, with exactly
             tiles × (2 K2 + 4 K3) or tiles × (1 K2 + 9 K5 + 2 K6)
             launches, against the same input served untiled on the kernel
             route by a server whose threshold is above it: f32 within 1
             count (the exact share printed), int8 bit-equal; each untiled
             reference held in turn against the plain versions (f32 within
             1 count of the plain forward; int8 as in phase 4b, on the
             served input); the 3072×4096 request timed three times, its
             median and stage split (decode, forward, encode) printed;
4d. micro-batching — ``ServeState(quantize="int8",
             microbatch_window_ms=2, microbatch_max=16)`` warmed at 256² and
             2048² (seconds printed); one 16×2048² batch through the batched
             dispatch (s8 tensors of 4.29e9 elements) bit-equal image by
             image to batch-1 forwards, and the first and last of those
             held against the plain route as in phase 4b; then 32
             concurrent clients × 8 requests of 256² PNGs over HTTP with
             micro-batching off and on, on the int8 and the f32 server:
             requests/s, p50/p90, forwards
             and mean occupancy, launches exactly forwards × the per-forward
             counts, and every micro-batched response equal to the same
             request served alone (int8 bit-equal, f32 within 1 count);
4e. families — dncnn, esrgan and srgan on their shipped weights, float32
             and int8 (phase 4's ``ServeState`` serves them too): every K2
             and K3 launch of the f32 kernel route (BatchNorm folded) held
             against its plain version on the same inputs (f32
             3e-5·max|ref|) at 256² and odd sizes (srgan: 64² and 44×60 LR),
             the served pixels within 1 count of the plain route, the kernel
             route within 1e-4 of the autograd route (nothing folded); every
             K5 launch of an int8 forward at 64² bit-equal to
             ``conv3x3_s8_plain``; ``/enhance`` requests with exactly the
             launches per forward (f32: dncnn 8 K3 + 1 K2, esrgan 16 K2,
             srgan 13 K2; int8: K5 15, 16 or 9 by esrgan's rung, 13); the
             int8 rung and its gate dB; the quality floors (70% of each
             family's recorded fixture gain, srgan's battery gain, srgan's
             fixture gain > 0) in f32 and int8; one tiled request per family
             (dncnn and esrgan 4097×1001, srgan 2100×96 LR) against the
             untiled forward (f32 within 1 count, int8 bit-equal), with
             exactly tiles × the per-forward launches; p50/p90 of 30
             ``/enhance`` requests (256², srgan 64² LR) per family and mode;
             forward times at 256² (srgan 64² LR) and a 2048² tile; in a
             fresh process (see phase 7), whole profiles of dncnn's forward
             at 256² in f32 and on its int8 rung and at a 2048² tile in f32,
             and of srgan's at 2048² LR (8192² out), batch 1, in both modes,
             with its time and peak memory; then K2 and K3 in f32 at the
             family shapes and the U-Net's at 512² beside cuDNN (TF32 off) and their bound
             (operations at 67 TFLOP/s, f32 outside the tensor cores, or
             bytes at 3.35 TB/s);
4f. cgan   — the shipped ``weights/cgan_epoch_500.keras`` read by the
             port's own HDF5 reader (no h5py on the card machine) and
             served as the JAX server serves it (the Keras backend by
             default), float32 and int8: every K2 launch of the f32 kernel
             route (the 3×3 tail) held against its plain version at 256²
             and 97×130, the served pixels within 1 count of the plain
             route and equal to a second forward (the cGAN runs cuDNN
             deterministic, its f32 transpose convs as phased 3×3 convs),
             the kernel route within 1e-4 of the autograd route; an
             int8 forward at 256² whose three K5 launches are each bit-equal
             to ``conv3x3_s8_plain`` and whose three rewritten 4×4 stride-2
             layers (space-to-depth + K5, K5 + depth-to-space) are each
             bit-equal to the direct integer conv; ``/enhance`` with exactly
             K2 ×1 (f32) or K5 ×3 (int8) per forward, ``"backend":
             "keras"``, the response equal to the forward, the rung (``int8-generic``) and its gate dB; p50/p90
             of 30 requests of 256² per mode; the fixture gain (label 5,
             ``cgan_backend=keras``) above 1.0 dB in both; one 4097×1001
             request against the untiled forward (f32 within 1 count, int8
             bit-equal); the torch fallback (``cgan_backend=torch``): a
             label answers 200 at the upload's size, a ``cond_file`` 500,
             no label 400, a label outside 0..9 400, no kernel launched, and
             then cgan and denoise still answer 200; forward times at 256²
             and 2048² (f32 also without the deterministic scope); then each rewritten layer at a 2048² input: K5 timed
             beside its plain version, ``torch._int_mm`` at its GEMM shape,
             the whole rewrite, cuDNN's f32 conv of the same layer and its
             bound (issued and useful operations at 1979 TOP/s, or bytes);
             the f32 transpose convs as the phased 3×3 conv the kernel
             route runs (within 3e-5 x max|ref| of cuDNN's transpose conv,
             equal to itself twice) beside cuDNN's transpose conv with its
             default and its deterministic algorithms; and K2 on the tail at
             2048² beside cuDNN and its bound;
4g. restormer — Restormer (seeded weights, published widths, f32) served
             by ``ServeState.denoise_image``: at 1024², 256² and 203×130
             every K2, K7 (``channel_attention``), K8 (``dwconv3x3``) and
             K9 (``pointwise_gemm``) launch held against its plain version
             on the same inputs (3e-5·max|ref|; K7 1e-3,
             ``K7_SERVED_TOL``), exactly 8 K2, 44 K7, 88 K8 and 178 K9
             launches a request, the served pixels within 1 count of the
             plain route;
             the share of served values at 0 or 255 on four of the
             benchmark's 1024² images; K7 and K8 at every shape of a 1024²
             forward (checked, twice bit-equal, K8's float4 body equal to
             its scalar body on an unaligned copy) beside their plain
             versions, the library (depthwise ``F.conv2d`` and the gate;
             ``torch.matmul`` and the softmax) and their bound (operations
             at 67 TFLOP/s or bytes at 3.35 TB/s), and K9 at every GEMM
             shape of the forward (checked, twice bit-equal) beside its
             plain version, cuBLAS's f32 GEMM (``library_ms``) and the
             bound of ``roofline.k9.restormer`` (operations at 495 TFLOP/s
             or bytes), each summed over one forward; then one 1024²
             request profiled in a fresh process (see phase 7), its
             counters zeroed just before the window.
             ``python3 chip_smoke.py --restormer-only`` runs phases 1 and
             4g alone (after the build, with K7's, K8's and K9's ptxas
             lines);
5. bench   — the port's bench line at batch 256: the bf16 step (exactly 4
             double conv + 2 single conv launches per step) and the int8
             ladder, whose rungs, rates and dB are printed; the s8 rung must
             pass the 40 dB gate and launch exactly K2 ×1, K5 ×9, K6 ×2 per
             step; then
             each kernel at the bench shapes (bf16, 128², batch 256) checked
             against its plain version and timed beside it, beside one cuDNN
             call for the same function (``library_ms``, a yardstick the port
             never calls) and its bound: the larger of its operations at 989
             TFLOP/s (dense bf16) and its bytes (each input read once, each
             output written once) at 3.35 TB/s; per layer the useful TFLOP/s
             and the share of the bound reached; the two layers behind a
             skip concat timed with two inputs beside torch.cat + one input;
5b. int8 times — each int8 kernel at the int8 step's shapes (batch 256,
             128²): time beside its plain version, its useful TOP/s and its
             bound (the larger of its operations at 1979 TOP/s, dense int8,
             and its bytes at 3.35 TB/s), beside the bf16 kernel (K3 pair or
             K2) of the same layers from phase 5 — no library call computes
             an int8 conv; as a yardstick, ``torch._int_mm`` at K5's im2col
             and K6's GEMM shapes (the s8 GEMM without the epilogue);
6. batch   — one bf16 forward at the JAX bench's batch of 2048, where
             down1's output holds 2^31 elements and upconv1's input 2^32,
             checked against the plain forward (64-bit indexing);
7. profile — one bf16 and one int8 bench step under torch.profiler: device
             time by kernel, the hand-written kernels' time and the
             device's busy share; every profiled window of the script holds
             its records of each hand-written kernel against the launch
             counters' deltas over it and fails where one is missing;
             since a process's later profiler sessions lose records
             (``profile_records_probe.py``), these windows and phase 11's
             train step run in a fresh process of their own;
8. noise   — the input stage's kernel (``noise_batch``: each sample its
             noise kind, the noisy batch and the clean target in one
             launch) against its plain version on the card, bit-equal in
             f32, for every kind at the train shape, at ragged shapes whose
             chunks straddle samples, without a gaussian sample, with other
             types and on an unaligned view, the clean target equal to
             ``x.to(float32) / 255.0 * 2.0 - 1.0``; at a first sample (a
             data-parallel rank's share: half the train batch, and an odd
             stream offset) in variants 1–3 and the blind σ, bit-equal to
             its plain version and to those rows of the whole batch's
             launch; each kind's distribution
             on constant images (gaussian and speckle σ, the uniform mean,
             the salt and pepper rates, a Poisson chi-square against scipy);
             the gaussian-only entry (the Pallas counterpart, same kernel)
             bit-equal to its plain version at 16×256×256×3, 2×64×64×3,
             3×9×7×3 and an unaligned view in f32 and bf16, the generator's
             known answers from the plain version on the card, moments and
             determinism on a constant image, and one tensor of more than
             2^31 elements whose first and last images are held against the
             plain version at their index offsets; then the modes the other
             families train with — variants 2 and 3 in [-1, 1] and on
             [0, 1], variant 1 on [0, 1] and the blind-σ Gaussian in both
             domains (every kind, the train shape, ragged, straddling and
             unaligned shapes, a byte of 255 whose poisson counts reach
             256) — bit-equal in f32, the clean target
             ``x.to(float32) / 255.0`` (``* 2 - 1`` in [-1, 1]); each
             kind's distribution in variants 2 and 3 on a constant image
             (the noise's mean and σ, the salt and pepper rates), every
             sample's blind σ against the stream's and 10^5 of them about
             27.5/255; and ``random_noise_batch`` (variant 2 in [-1, 1] and
             on [0, 1], variant 3 on [0, 1]) and ``blind_gaussian_batch``
             under ``torch.cuda.set_sync_debug_mode("error")``, one launch
             a call;
9. train-check — one f32 train step at 4×32×32 from fixed arrays, on the card
             and on the CPU with the port itself, and on the CPU in
             float64: losses rtol 1e-4, the discriminator's BatchNorm
             statistics atol 1e-4, the first moments within 4× the CPU's
             own gap to float64 (``moment_gaps``), the parameters within
             1e-4 relative wherever the gradient's sign is sure given that
             bound and 2·lr elsewhere (``adam_param_gap``), every
             generator parameter moved (no all-zero gradient), no conv
             kernel launched; then one f32 step of dncnn, esrgan, cgan and
             srgan at full width (2×32², srgan 8² LR and the shipped VGG
             tower), card against CPU to the same bounds, and dncnn's card
             step once more with its first gradient leaf zeroed, which the
             parameter bound must catch;
10. train  — 80 synthetic 256×256 PNGs, then ``cli.train`` at full width
             (batch 16, 256², one epoch = 4 steps) in bfloat16 and in
             float32: finite losses, PSNR > 5 dB, the noise kernel launched
             exactly once in every step through ``noise_batch`` (the whole
             input stage) and never through the gaussian-only entry (each
             entry counts its own launches), no conv kernel launched while
             training, the checkpoint
             resumed with identical parameters, a held-out evaluation that
             launches exactly 4 + 2 conv kernels per forward; steps/s and
             images/s over three windows of about 5 s each, with their
             spread; then, apart from the training path's count,
             ``random_noise_batch`` with ``types=("gaussian",)``: one launch
             per call;
11. train-profile — ``noise_batch`` at the train batch (the kinds and seed
             drawn as the trainer draws them): bit-equal to its plain
             version, timed beside it and beside its bound (the larger of
             its bytes at 3.35 TB/s and its issue floor from phase 2's
             counts at the card's highest SM clock); the gaussian-only entry
             and each kind alone (the probes) at the same batch; the kernel
             on the device's clock; ``random_noise_batch`` under
             ``torch.cuda.set_sync_debug_mode("error")`` (a host sync
             fails the run); the input stage's share of the step (its
             profiled train step is phase 7's);
12. train-families — ``cli.train --model dncnn|esrgan|cgan|srgan`` at full
             width (dncnn depth 17, esrgan 8 blocks, cgan's Keras generator,
             srgan ×4 with 5 blocks and the shipped ``weights/perceptual``
             tower), batch 16, 256² (srgan 64² LR), one epoch (4 steps) in
             bf16 and in f32 on phase 10's synthetic PNGs: finite metrics,
             the noise kernel launched exactly once a step, the checkpoint
             resumed with identical state, steps/s over a window of about
             3 s (its launches one a step too) and peak memory; then the
             noise kernel in each mode the trainers run at the train batch,
             bit-equal to its plain version, on the device's clock beside
             its bytes bound (1 byte read, 8 written an element);
13. data   — 80 synthetic PNGs of mixed sizes (256², 300×260, the 178×218
             CelebA frame, one 255×257), a corrupt file and 8 CelebA frames
             cropped in by ``prepare_clean_dataset``; ``cli.noise_gen`` on
             the card in variant 1 (batch 64: exactly one noise kernel
             launch per batch and type, each type's first batch bit-equal
             to the plain version with the same kinds and seed, the files
             the truncation of that output, the tree at the clean files'
             paths; images/s, and the kernel per render launch at
             64×256²×3 on the device's clock beside its bytes bound),
             variant 2 in srgan's layout (64² LR, clean HR copies) and
             variant 3 (its poisson through ``poisson_v3_exact``, no launch,
             its vals printed); ``cli.train --no-on-the-fly`` on the
             rendered pairs (denoise 256², batch 16, bf16 and f32; srgan on
             the LR tree, the shipped VGG tower, bf16) and ``cli.train
             --model esrgan --tensor-cache`` on a ``build_tensor_cache``
             npz cache and a ``.pt`` tree (the domain each took): finite
             metrics, no noise kernel launch, exact resume, steps/s; the
             native batch assembly built by the port's g++ build (a failed
             build fails the phase; a missing compiler must make
             ``DataPipeline(use_native=True)`` raise), its uint8 batches
             equal to ``native.resize_u8`` image by image, its float paired
             batches within 1e-5 of the loader's plan in numpy, both within
             2 counts (mean) and 30 (max) of the Pillow-exact python path;
             native and python assembly images/s with the host's CPU count
             (host numbers); and a ``cli.train`` epoch over the mixed sizes
             on the native stage with one noise kernel launch a step;
14. train to ship — ``ms_ssim`` at 16×256²×3 and a 176² HWC pair within
             1e-5 of a CPU float64 evaluation (ms a batch); ``cli.train
             --extra-metrics batch`` for denoise and esrgan (full width,
             256², batch 16, bf16, one 8-step epoch over 160 synthetic
             PNGs): the history's LPIPS and MS-SSIM finite and non-zero, one
             noise kernel launch a step and no conv kernel, steps/s with the
             extras beside the same step without them (in turns); the epoch
             extras of a 256² test pair through ``generate``: exactly two
             forwards' K3/K2 launches (the extras and the test image, a
             JPEG where PIL is installed, else one warning); ``remat``: one f32 step of dncnn,
             esrgan and cgan with and without it from the same state (loss
             1e-5 relative, BatchNorm statistics 1e-6, first moments within
             1e-4 of each leaf's largest and 1e-5 of the module's, the
             parameters by ``adam_param_gap`` given that bound; dncnn's
             remat step once more with a zeroed gradient leaf, which must
             fail it),
             esrgan's bf16 step at 256² batch 16 with and without it
             (steps/s, peak memory); ``fake_quant``: ``DnCNN(depth=5)``
             against its int8 program (K5) above 40 dB (the shipped dncnn's
             agreement printed), skip-all bit-equal to float, the STE
             gradients finite and non-zero; ``cli.qat`` of the shipped esrgan
             (100 steps, batch 32, 128²): one noise launch a step, the ship
             guard passed, the QAT provenance and fixture gain in
             ``meta.json``, served from the output on ``int8-generic`` with
             16 K5 launches a forward, its gate ≥ 40 dB and fixture gain ≥
             4.767 dB; ``--qat-lr 10`` refused with ``arrays.npz``
             byte-identical; 10 steps each of denoise and dncnn; ``cli.export``:
             the QAT'd esrgan as a ``.pth`` that loads to the npz state and
             serves bit-equal in f32 from a directory holding only it, the
             shipped ``.keras`` through an npz checkpoint to a new
             ``.keras`` whose datasets equal the shipped file's and whose
             cgan response (label 5, f32) equals the shipped one's, and both
             refusals (a tree not ``--model``'s, BatchNorm without
             ``generator_state``); ``cli.eval --iterations 2 --clean-dir`` of
             denoise, dncnn, esrgan (256²) and srgan (64² LR) over 16 images:
             K2/K3 launches exactly images × 2 × per forward, the first
             output within 1 count of the plain route, images/s, PSNR/SSIM;
             ``cli.train --profile-dir --graph-dir`` (run right after
             phase 2, before any other profiler of the script: 14h): a
             Chrome trace that parses and names each of the noise kernel's
             8 launches, and as many records of each hand-written kernel as
             were launched, one warning for the missing matplotlib, exit 0;
15. multi-device — one card, so every run here shows exactness and
             overhead, not scaling: (a) two gloo ranks on cuda:0
             (``make_train_step(mesh=)`` over ``process_mesh``) fine-tune
             the full-width denoise GAN (the shipped generator, a seeded
             discriminator) on the fly, global batch 16 at 256², 3 steps in
             f32 and in bf16, against the same steps in one process: each
             rank's noise (variant 1 and the blind σ) bit-equal to its rows
             of the whole-batch launch (K4's first sample); after step 1
             in f32 the BatchNorm statistics within 1e-4, as phase 9 holds
             the card against the CPU, and the first moments against a
             float64 step in one process within 4× the f32 single
             process's own gap (``moment_gaps``); the losses 1e-4 relative
             at step 1 and 1e-3 after; bf16's losses and statistics two
             ulps relative, its first moments reported against float64
             beside the single process's and a one-rank group's (DP_TOL);
             in both the parameters where Adam's step does not turn on a
             gradient's sign within 1e-4 relative (``adam_param_gap``);
             one noise launch a step a rank; two planted faults (the
             gradients not summed, each rank's own BatchNorm statistics)
             must fail the f32 bounds; (b) ``python -m
             torch.distributed.run --standalone --nproc-per-node 1 -m
             ...cli.train``: NCCL at world size 1 on cuda:0, one 4-step
             epoch, its checkpoint resumed without a mesh for one more;
             (c) ``ServeState(mesh=make_mesh(devices=["cuda:0"] * 4),
             use_tiling=False)`` on the shipped weights, f32 and int8: a
             3072×4096 denoise and a 2100×600 esrgan request served
             ``+sharded`` with 4 × the per-forward launches, their response
             bytes equal to the mesh-free (tiled) server's; 32 clients × 8
             requests of 256² micro-batched over the mesh, every response
             equal to the same request served alone, every batch through
             the data-parallel dispatch, requests/s;
             (d) ``tiled_apply`` of the denoise U-Net (seeded weights)
             over 4 strips at halo 32 against its untiled forward: the
             interior (rows 28 to −28) within 1e-5, the border band under
             0.1; at halo 4 above 1e-4;
16. retrain — (a) ``cli.train_serving_weights`` at full width and the
             script's shapes (batch 32, 128²; srgan batch 16) into a
             temporary ``--out``: denoise and esrgan 100 steps, dncnn 1000
             (it starts as the identity; SW_STEPS),
             srgan 100 stage-1 and 50 stage-2 steps with EMA 0.995 and a
             stage-1 cache (run twice: the second loads the cache and
             trains no stage-1 step), the perceptual tower 150 steps
             (noise variants 1, 2, 3); each run's noise-kernel launches
             exactly its steps plus its evaluations, each held-out
             evaluation's K2/K3 launches exactly one forward's, chunk 0 of
             each stage under ``set_sync_debug_mode("error")``, every
             loss and written parameter finite, ``meta.json`` with the
             script's keys, a fresh int8 ``ServeState`` on the output
             reproducing the recorded fixture (srgan: and battery) gain
             within 0.002 dB, the tower loading through
             ``load_perceptual`` as a trained one, and for denoise, dncnn
             and esrgan a held-out gain above the initial weights' on the
             same draw; images/s per chunk and peak memory; (b) the
             quickstart (its ``.pth`` served by ``ServeState``) and the
             multichip walkthrough on the one card (two gloo ranks' step-1
             losses within 1e-4 of one process, the sharded output and
             ``tiled_apply``'s interior bit-equal to one device).

The line before the last is the kernels JSON; the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import base64
import contextlib
import functools
import json
import logging
import os
import re
import shutil
import subprocess
import sys
import threading
import time
import urllib.request

import numpy as np
import torch

PEAK_BF16_FLOPS = 989e12   # H100 SXM dense bf16 (data sheet)
PEAK_INT8_OPS = 1979e12    # H100 SXM dense int8 (data sheet)
PEAK_BYTES = 3.35e12       # H100 SXM HBM3
PEAK_F32_FLOPS = 67e12     # H100 SXM float32 outside the tensor cores
# f32 on the tensor cores as three TF32 products a multiply: the data
# sheet's dense TF32 rate over three
PEAK_TF32X3_FLOPS = 495e12 / 3
# × max|ref|.  f32: the kernels' three TF32 products (the dropped lo·lo
# term, ~2^-22 of a product), their partial sums a chunk and their
# summation order kept them within 2.2e-6 of the plain versions in phase 3
# and 3.1e-6 on phase 4e's served launches (H100 80GB HBM3; phase 3 prints
# the worst); one TF32 product (10-bit mantissa) misses by 10-18x, so a
# kernel that quietly used TF32 fails.  bf16: two ulps.
TOL = {torch.float32: 3e-5, torch.bfloat16: 1.6e-2}
BENCH_BATCH = 256
BIG_BATCH = 2048  # the JAX bench's batch: tensors beyond 2^31 elements
LATENCY_REQUESTS = 100  # p90 then has 10 samples beyond it
SEED = 0
TRAIN_BATCH, TRAIN_SIZE, TRAIN_IMAGES = 16, 256, 80  # 64 train images: 4 steps
# steps per timed window of phase 10, about 5 s each
TIMED_STEPS = {"bfloat16": 200, "float32": 30}
# more than 2^31 elements; the last image straddles element 2^31
BIG_NOISE_SHAPE = (683, 1024, 1024, 3)
# the noise kernel's one-kind kernels, built on their own (phase 2)
NOISE_PROBE_SOURCES = ("noise_issue_probe.cu",)
NOISE_CHUNK = 8  # elements a thread of the noise kernel owns
PHILOX_KAT = [  # Random123 kat_vectors: counter, key, output
    ((0, 0, 0, 0), (0, 0),
     (0x6627e8d5, 0xe169c58d, 0xbc57ac4c, 0x9b00dbd8)),
    ((0xffffffff,) * 4, (0xffffffff,) * 2,
     (0x408f276d, 0x41c83b0e, 0xa20bc7c6, 0x6d5451fd)),
    ((0x243f6a88, 0x85a308d3, 0x13198a2e, 0x03707344),
     (0xa4093822, 0x299f31d0),
     (0xd16cfe09, 0x94fdcceb, 0x5001e420, 0x24126ea1)),
]


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def say(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, reps: int = 5, warmup: int = 2) -> float:
    """Mean device time of ``fn`` over ``reps`` back-to-back calls."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


# ---------------------------------------------------------------------------
# the U-Net's kernel shapes: (N, H, W, C0, C1, C2) for the double conv,
# (N, H, W, Cin, Cout, relu) for the single conv, at an input of H x W
def pair_shapes(n, h, w):
    h2, w2, h4, w4 = h // 2, w // 2, h // 4, w // 4
    return {"down1": (n, h, w, 3, 64, 64), "down2": (n, h2, w2, 64, 128, 128),
            "bottleneck": (n, h4, w4, 128, 256, 256),
            "upconv2": (n, h2, w2, 256, 128, 128)}


def single_shapes(n, h, w):
    return {"upconv1.0": (n, h, w, 128, 64, True),
            "upconv1.2": (n, h, w, 64, 3, False)}


def make_gen():
    return torch.Generator(device="cuda").manual_seed(SEED)


def rnd(gen, shape, dtype, scale=1.0):
    return (torch.randn(shape, generator=gen, device="cuda") * scale).to(dtype)


def single_inputs(gen, shape, dtype):
    n, h, w, cin, cout, relu = shape
    return (rnd(gen, (n, h, w, cin), dtype),
            rnd(gen, (3, 3, cin, cout), dtype, (9 * cin) ** -0.5),
            rnd(gen, (cout,), torch.float32, 0.1)), relu


def pair_inputs(gen, shape, dtype):
    n, h, w, c0, c1, c2 = shape
    return (rnd(gen, (n, h, w, c0), dtype),
            rnd(gen, (3, 3, c0, c1), dtype, (9 * c0) ** -0.5),
            rnd(gen, (c1,), torch.float32, 0.1),
            rnd(gen, (3, 3, c1, c2), dtype, (9 * c1) ** -0.5),
            rnd(gen, (c2,), torch.float32, 0.1))


def split_input(gen, x):
    """x's shape as the U-Net gives it to a conv behind a skip concat: the
    first half of the channels contiguous, the second half a crop (a strided
    view) of a larger tensor."""
    n, h, w, c = x.shape
    xa = rnd(gen, (n, h, w, c // 2), x.dtype)
    xb = rnd(gen, (n, h + 1, w + 2, c - c // 2), x.dtype)[:, :h, :w]
    return xa, xb


def halves(x):
    """x as the U-Net hands it over behind a skip concat (see split_input),
    with x's own values: cat(halves(x), 3) equals x."""
    n, h, w, c = x.shape
    big = torch.empty((n, h + 1, w + 2, c - c // 2), dtype=x.dtype,
                      device=x.device)
    big[:, :h, :w] = x[..., c // 2:]
    return x[..., : c // 2].contiguous(), big[:, :h, :w]


def phase_device():
    say("== phase 1: device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    say(card)
    say(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} "
        f"count {torch.cuda.device_count()}")
    return card


def phase_build(_build, noise):
    """Build the kernel library and, at the same time, the noise kernel's
    one-kind probes (not part of the library: only this script calls
    them); return the probes' library and the instructions a chunk of each
    kind issues."""
    import ctypes

    say("== phase 2: build")
    built = {}

    def build_probes():
        try:
            built["probes"] = _build.build(NOISE_PROBE_SOURCES,
                                           "cid_noise_probes")
        except Exception as e:  # noqa: BLE001 - reported below
            built["error"] = e

    probes_thread = threading.Thread(target=build_probes)
    probes_thread.start()
    res = _build.build()
    probes_thread.join()
    if "error" in built:
        fail(f"the noise probes did not build: {built['error']}")
    pres = built["probes"]
    for r in (res, pres):
        say(f"built {r.path.name} in {r.seconds:.1f} s"
            f"{' (cached)' if r.cached else ''}")
    # ptxas: one line per kernel (dynamic shared memory is set at launch and
    # not shown here; the sources' headers give it)
    name = None
    for line in (res.log + "\n" + pres.log).splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            short = re.search(r".*\d((?:conv3x3|convt2x2|double_conv3x3|"
                              r"noise|probe)"
                              r"[a-z_0-9]*?_(?:kernel|probe))(I\w*?E)?Ev?[PN]",
                              m.group(1))
            name = (short.group(1) + (short.group(2) or "")) if short \
                else m.group(1)[-60:]
        elif "spill" in line:
            spills = line.strip()
        elif "registers" in line and name:
            say(f"  {name}: {line.split(':', 1)[1].strip()}; {spills}")
            name = None
    _build.library()
    probes = ctypes.CDLL(str(pres.path))
    P, I, L, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
        ctypes.c_float
    probes.cid_noise_issue_probe.argtypes = (
        [I] + [P] * 4 + [L, I, P, P] + [F] * 5 + [P])
    probes.cid_noise_issue_probe.restype = I
    # which matrix instructions were compiled in
    tool = shutil.which("cuobjdump") or str(
        _build.find_nvcc()).replace("nvcc", "cuobjdump")

    def sass_of(path):
        try:
            out = subprocess.run([tool, "-sass", str(path)],
                                 capture_output=True, text=True, timeout=300)
        except OSError as e:
            fail(f"could not run cuobjdump ({e}): the matrix instructions "
                 "and the noise kernel's issue floor need its SASS")
        if out.returncode != 0:
            fail(f"cuobjdump failed ({out.stderr.strip()[:200]}): the matrix "
                 "instructions and the noise kernel's issue floor need its "
                 "SASS")
        return out.stdout

    sass = sass_of(res.path)
    if "noise_issue_probe" in sass:
        fail("the kernel library holds the noise probes")
    hgmma = len(re.findall(r"\bHGMMA\.", sass))
    igmma = len(re.findall(r"\bIGMMA\.", sass))
    hmma = len(re.findall(r"\bHMMA\.", sass))
    imma = len(re.findall(r"\bIMMA\.", sass))
    say(f"  matrix instructions in {res.path.name}: HGMMA (bf16 wgmma) "
        f"{hgmma}, IGMMA (s8 wgmma) {igmma}, HMMA (mma.sync bf16) {hmma}, "
        f"IMMA (mma.sync s8) {imma}")
    if hgmma < 1 or igmma < 1 or hmma < 1 or imma < 1:
        fail("the built library lacks a tensor-core matrix instruction")
    # the int8 kernels K5 (its Cout > 8 path) and K6 on the s8 wgmma, the
    # f32 bodies of K2 (Cout > 4) and K3, and K9, on the tf32 wgmma
    funcs = re.split(r"\n\s*Function : ", sass)
    for kernel in ("conv3x3_tf32_kernel", "double_conv3x3_tf32_kernel",
                   "pointwise_gemm_kernel"):
        body = "".join(f for f in funcs if f.split("\n", 1)[0].find(kernel)
                       >= 0)
        n = len(re.findall(r"\bHGMMA\.\w+\.F32\.TF32", body))
        say(f"  tf32 HGMMA in {kernel}: {n}")
        if n < 1:
            fail(f"{kernel} does not run on the tf32 wgmma")
    for kernel in ("conv3x3_s8_wgmma_kernel", "convt2x2_s8_kernel"):
        body = "".join(f for f in funcs if f.split("\n", 1)[0].find(kernel)
                       >= 0)
        n = len(re.findall(r"\bIGMMA\.", body))
        say(f"  IGMMA in {kernel}: {n}")
        if n < 1:
            fail(f"{kernel} does not run on the s8 wgmma")
    # the instructions a chunk of each noise kind must issue (phase 11)
    funcs = re.split(r"\n\s*Function : ", sass_of(pres.path))
    issue = {}
    for kind, code in noise.KIND_CODES.items():
        body = [f for f in funcs
                if f"noise_issue_probeILi{code}E" in f.split("\n", 1)[0]]
        if len(body) != 1:
            fail(f"noise_issue_probe<{code}> not found once in the SASS")
        issue[kind] = sass_issue_count(body[0])
    say("  instructions every 8-element chunk issues (noise_issue_probe, on "
        "every path from entry to exit): "
        + ", ".join(f"{k} {v}" for k, v in issue.items()))
    if min(issue.values()) < 20:
        fail("the noise probes' SASS was not read")
    return probes, issue


def sass_issue_count(body: str) -> int:
    """Instructions (NOPs aside) of a kernel's SASS in the basic blocks
    that every run from its entry to an exit passes through — its
    dominators of the exit — so a lower bound on what one thread (and so
    one warp) issues.  A predicated EXIT (the bounds check) is read as
    falling through, a call as falling through (the callee is not counted),
    a loop body that may run no time is not counted."""
    ins, labels = [], {}
    for line in body.splitlines():
        lab = re.match(r"\s*(\.L_x_\d+):", line)
        if lab:
            labels[lab.group(1)] = len(ins)
            continue
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", line)
        if m:
            ins.append((int(m.group(1), 16), m.group(2)))
    by_addr = {a: i for i, (a, _) in enumerate(ins)}

    def target(text):
        m = re.search(r"`\((\.L_x_\d+)\)", text)
        if m:
            return labels.get(m.group(1))
        m = re.search(r"\b0x([0-9a-f]+)\b", text)
        return by_addr.get(int(m.group(1), 16)) if m else None

    def op(text):
        return re.sub(r"^@!?U?P\w+\s+", "", text).split()[0]

    def guarded(text):
        return text.startswith("@") and not text.startswith("@PT ")

    leaders = {0}
    for i, (_, text) in enumerate(ins):
        o = op(text)
        if o.startswith(("BRA", "EXIT", "RET", "BRX", "JMX", "JMP")):
            leaders.add(i + 1)
            t = target(text) if o.startswith(("BRA", "JMP")) else None
            if t is not None:
                leaders.add(t)
    starts = sorted(x for x in leaders if x < len(ins))
    blocks = {b: (b, (starts + [len(ins)])[k + 1])
              for k, b in enumerate(starts)}
    succ, exit_node = {}, -1
    for b, (lo, hi) in blocks.items():
        text = ins[hi - 1][1]
        o = op(text)
        nxt = [hi] if hi in blocks else [exit_node]
        if o.startswith(("BRA", "JMP")):
            t = target(text)
            tt = [t] if t in blocks else [exit_node]
            succ[b] = tt + nxt if guarded(text) else tt
        elif o.startswith(("EXIT", "RET")):
            succ[b] = nxt if guarded(text) else [exit_node]
        elif o.startswith(("BRX", "JMX")):
            succ[b] = [exit_node]
        else:
            succ[b] = nxt
    seen, todo = {0}, [0]  # what the entry reaches (not a callee's body)
    while todo:
        for t in succ.get(todo.pop(), []):
            if t not in seen:
                seen.add(t)
                todo.append(t)
    if exit_node not in seen:
        return 0
    nodes = [b for b in blocks if b in seen] + [exit_node]
    preds = {n: [] for n in nodes}
    for b in nodes[:-1]:
        for t in succ[b]:
            preds[t].append(b)
    dom = {n: set(nodes) for n in nodes}
    dom[0] = {0}
    changed = True
    while changed:
        changed = False
        for n in nodes:
            if n == 0:
                continue
            ps = [dom[p] for p in preds[n]]
            new = ({n} | set.intersection(*ps)) if ps else {n}
            if new != dom[n]:
                dom[n], changed = new, True
    return sum(1 for b in dom[exit_node] if b != exit_node
               for i in range(*blocks[b]) if op(ins[i][1]) != "NOP")


def phase_mma_probes(_build):
    """csrc/mma.cuh's wrappers on the card.  Small integers in bf16: every
    product and sum is exact, so the results must be equal, and one
    misplaced fragment element or descriptor field shows."""
    lib = _build.library()
    gen = make_gen()

    def ints(*shape):
        return torch.randint(-8, 9, shape, generator=gen,
                             device="cuda").to(torch.bfloat16)

    a, b = ints(16, 16), ints(16, 8)
    d = torch.full((16, 8), float("nan"), device="cuda")
    _build.check(lib.cid_probe_mma_sync(a.data_ptr(), b.data_ptr(),
                                        d.data_ptr(), None), "mma.sync probe")
    torch.cuda.synchronize()
    ok = torch.equal(d, a.float() @ b.float())
    say(f"  mma.cuh cp.async + ldmatrix + mma.sync m16n8k16: "
        f"{'exact' if ok else 'FAIL'}")
    if not ok:
        fail("mma.sync probe disagrees with the plain product")
    for ksteps in (1, 2, 3, 4):
        a, b = ints(64, 16 * ksteps), ints(16 * ksteps, 64)
        d = torch.full((64, 64), float("nan"), device="cuda")
        _build.check(lib.cid_probe_wgmma(a.data_ptr(), b.data_ptr(),
                                         d.data_ptr(), ksteps, None),
                     "wgmma probe")
        torch.cuda.synchronize()
        ok = torch.equal(d, a.float() @ b.float())
        say(f"  mma.cuh cp.async + ldmatrix + wgmma m64n64k16, k = "
            f"{16 * ksteps}: {'exact' if ok else 'FAIL'}")
        if not ok:
            fail("wgmma probe disagrees with the plain product")
    phase_tf32_probes(lib, gen)


def tf32_truncated(t):
    """f32 ``t`` as the tensor cores read a tf32 operand: low 13 bits
    dropped."""
    return torch.bitwise_and(t.view(torch.int32), -0x2000).view(torch.float32)


def phase_tf32_probes(lib, gen):
    """The tf32 wgmma m64n64k8 (A by ldmatrix from 32-byte f32 rows, B
    K-major with the 32-byte swizzle) against the exact product of its
    operands with their low 13 bits dropped: integers in [-8, 8] with
    random low bits, so the truncated product is exact and a card that
    rounded those bits instead would differ; then mma.cuh's split of an
    f32 into hi + lo tf32 values (cvt.rna) bit-equal to the wrappers'
    ``round_tf32`` of the weights, ties included."""
    from celebrity_image_denoiser_tpu_torch.ops.cuda import _build, conv3x3

    def operand(*shape):
        ints = torch.randint(-8, 9, shape, generator=gen, device="cuda").float()
        noise = torch.randint(1, 1 << 13, shape, generator=gen, device="cuda",
                              dtype=torch.int32)
        noisy = torch.bitwise_or(ints.view(torch.int32), noise)
        return torch.where(ints != 0, noisy, 0).view(torch.float32)

    for ksteps in (1, 2, 3, 4):
        a, b = operand(64, 8 * ksteps), operand(64, 8 * ksteps)
        d = torch.full((64, 64), float("nan"), device="cuda")
        _build.check(lib.cid_probe_wgmma_tf32(a.data_ptr(), b.data_ptr(),
                                              d.data_ptr(), ksteps, None),
                     "tf32 wgmma probe")
        torch.cuda.synchronize()
        want = tf32_truncated(a).double() @ tf32_truncated(b).double().T
        ok = torch.equal(d.double(), want)
        say(f"  mma.cuh ldmatrix + wgmma m64n64k8 tf32 (K-major B), k = "
            f"{8 * ksteps}: {'exact on the truncated operands' if ok else 'FAIL'}")
        if not ok:
            fail("tf32 wgmma probe disagrees with the truncated product")
    v = torch.randn(1 << 20, generator=gen, device="cuda") * torch.exp2(
        torch.randint(-30, 30, (1 << 20,), generator=gen,
                      device="cuda").float())
    ties = torch.bitwise_or(torch.bitwise_and(v.view(torch.int32), -0x2000),
                            0x1000).view(torch.float32)
    v = torch.cat([v, ties])
    hi, lo = torch.empty_like(v), torch.empty_like(v)
    _build.check(lib.cid_probe_tf32_split(v.data_ptr(), v.numel(),
                                          hi.data_ptr(), lo.data_ptr(), None),
                 "tf32 split probe")
    want_hi = conv3x3.round_tf32(v)
    ok = torch.equal(hi, want_hi) and torch.equal(
        lo, conv3x3.round_tf32(v - want_hi))
    rel = ((hi.double() + lo.double() - v.double()).abs()
           / v.double().abs().clamp_min(1e-300)).max().item()
    say(f"  mma.cuh tf32 split of {v.numel()} values (half ties): "
        f"{'equal to round_tf32' if ok else 'FAIL'}, |v - hi - lo| <= "
        f"{rel:.2e} |v|")
    if not ok:
        fail("the card's tf32 split differs from the wrappers' round_tf32")


QUANTIZE_SCALES = 4096  # log-uniform over 2^-40..2^40, plus the edges


def phase_s8_probe(_build):
    """mma.cuh's s8 mma.sync m16n8k32 with ldmatrix x4 and x2 and its s8
    wgmma m64n64k32 (K-major B, 32-byte swizzle), over the whole s8 range:
    exact integer products (s32 sums far below 2^31); then the s8
    epilogue's quantization (conv_s8.cuh) for every bf16 bit pattern of h
    at 4096 log-uniform scales over 2^-40..2^40, 256 over the whole float
    range, the edges of its scaling and 3072 scales that put some h / s
    within an ulp of a half-integer, against
    clamp(rint(h / s), ±127) with torch's IEEE division on the card."""
    lib = _build.library()
    gen = make_gen()
    for ksteps in (1, 2, 3, 4):
        a = torch.randint(-128, 128, (64, 32 * ksteps), generator=gen,
                          device="cuda", dtype=torch.int8)
        b = torch.randint(-128, 128, (64, 32 * ksteps), generator=gen,
                          device="cuda", dtype=torch.int8)
        d = torch.full((64, 64), -7, dtype=torch.int32, device="cuda")
        _build.check(lib.cid_probe_wgmma_s8(a.data_ptr(), b.data_ptr(),
                                            d.data_ptr(), ksteps, None),
                     "s8 wgmma probe")
        torch.cuda.synchronize()
        ok = torch.equal(d.double(), a.double() @ b.double().T)
        say(f"  mma.cuh cp.async + ldmatrix + wgmma m64n64k32 s8, k = "
            f"{32 * ksteps}: {'exact' if ok else 'FAIL'}")
        if not ok:
            fail("s8 wgmma probe disagrees with the integer product")
    h = (torch.arange(1 << 16, dtype=torch.int32, device="cuda") << 16).view(
        torch.float32)
    # the hard cases: scales that put some h / s within an ulp of a
    # half-integer, where a product by 1/s alone rounds the other way
    hp = h[(h > 0.25) & (h < 256)]
    pick = hp[torch.randint(0, hp.numel(), (1024,), generator=gen,
                            device="cuda")]
    half = torch.randint(0, 127, (1024,), generator=gen, device="cuda") + 0.5
    near = (pick.double() / half).float()
    scales = torch.cat([
        torch.nextafter(near, torch.zeros_like(near)), near,
        torch.nextafter(near, torch.full_like(near, float("inf"))),
        torch.exp2(torch.rand(QUANTIZE_SCALES, generator=gen, device="cuda")
                   * 80 - 40),
        torch.exp2(torch.rand(256, generator=gen, device="cuda") * 277 - 149),
        torch.tensor([1.0, 2.0 ** -149, 2.0 ** -130, 2.0 ** -126, 2.0 ** -125,
                      2.0 ** -101, 2.0 ** -100, 0.99 * 2.0 ** -100,
                      2.0 ** 100, 1.01 * 2.0 ** 100, 2.0 ** 125, 2.0 ** 126,
                      2.0 ** 127, torch.finfo(torch.float32).max, 3.0 / 127,
                      0.1], device="cuda")])
    wrong = 0
    for s in scales.split(1024):
        out = torch.empty((s.numel(), h.numel()), dtype=torch.int8,
                          device="cuda")
        _build.check(lib.cid_probe_quantize(h.data_ptr(), h.numel(),
                                            s.data_ptr(), s.numel(),
                                            out.data_ptr(), None),
                     "quantize probe")
        q = torch.round(h[None, :] / s[:, None])
        ref = torch.where(q.isnan(), -127.0, q.clamp(-127, 127)).to(
            torch.int8)
        wrong += int((out != ref).sum().item())
        del out, q, ref
    say(f"  conv_s8.cuh quantize, {h.numel()} bf16 patterns x "
        f"{scales.numel()} scales: {wrong} differ from the IEEE division "
        f"{'(exact)' if wrong == 0 else 'FAIL'}")
    if wrong:
        fail("the s8 epilogue's quantization differs from rint(h / s)")
    for rep in range(3):
        a = torch.randint(-128, 128, (16, 32), generator=gen, device="cuda",
                          dtype=torch.int8)
        b = torch.randint(-128, 128, (16, 32), generator=gen, device="cuda",
                          dtype=torch.int8)
        d = torch.full((16, 24), -7, dtype=torch.int32, device="cuda")
        _build.check(lib.cid_probe_mma_s8(a.data_ptr(), b.data_ptr(),
                                          d.data_ptr(), None), "s8 probe")
        torch.cuda.synchronize()
        ref = a.double() @ b.double().T
        ok = torch.equal(d[:, :16].double(), ref) and torch.equal(
            d[:, 16:].double(), ref[:, 8:])
        say(f"  mma.cuh cp.async + ldmatrix x4/x2 + mma.sync m16n8k32 s8 "
            f"(draw {rep}): {'exact' if ok else 'FAIL'}")
        if not ok:
            fail("s8 mma.sync probe disagrees with the integer product")


def in_place(module, xa, xb):
    """The kernel reads x and the strided x2 through two pointers (no
    concatenation is written), in bf16 and in f32."""
    from celebrity_image_denoiser_tpu_torch.ops.cuda import conv3x3

    if not conv3x3.two_pointer_ok(xa, xb):
        fail(f"{module.__name__}: {xa.dtype} x {tuple(xa.shape)} with x2 "
             f"{tuple(xb.shape)} is concatenated, not read in place")


def phase_kernels(_build, conv3x3, double_conv):
    say("== phase 3: kernels vs plain (TF32 off)")
    phase_mma_probes(_build)
    gen = make_gen()
    worst = {"conv3x3_bias_relu": 0.0, "double_conv3x3_relu": 0.0}
    controls = []  # (layer, shape, plain fn, args, f32 reference)
    # the U-Net's shapes; ragged on every tile edge; smaller than a 16x16
    # tile; W not a multiple of 8
    shapes = [(8, 128, 128), (2, 132, 100), (2, 12, 20), (3, 40, 36)]
    for dtype in (torch.float32, torch.bfloat16):
        for n, h, w in shapes:
            control = dtype == torch.float32 and (n, h, w) == shapes[0]
            for layer, shape in pair_shapes(n, h, w).items():
                args = pair_inputs(gen, shape, dtype)
                got = double_conv.double_conv3x3_relu(*args)
                ref = double_conv.double_conv3x3_relu_plain(*args)
                worst["double_conv3x3_relu"] = max(
                    worst["double_conv3x3_relu"],
                    check("double_conv3x3_relu", layer, shape, dtype, got, ref))
                if control:
                    controls.append((layer, shape, functools.partial(
                        double_conv.double_conv3x3_relu_plain, *args), ref))
                if layer == "upconv2":  # the skip concat as two inputs
                    xa, xb = split_input(gen, args[0])
                    in_place(double_conv, xa, xb)
                    worst["double_conv3x3_relu"] = max(
                        worst["double_conv3x3_relu"],
                        check("double_conv3x3_relu", layer + " 2 in", shape,
                              dtype,
                              double_conv.double_conv3x3_relu(
                                  xa, *args[1:], x2=xb),
                              double_conv.double_conv3x3_relu_plain(
                                  xa, *args[1:], x2=xb)))
            for layer, shape in single_shapes(n, h, w).items():
                args, relu = single_inputs(gen, shape, dtype)
                ref = conv3x3.conv3x3_bias_relu_plain(*args, relu=relu)
                for entry in (conv3x3.conv3x3_bias_relu,
                              conv3x3.conv3x3_bias_relu_v2):
                    got = entry(*args, relu=relu)
                    worst["conv3x3_bias_relu"] = max(
                        worst["conv3x3_bias_relu"],
                        check(entry.__name__, layer, shape, dtype, got, ref))
                if control:
                    controls.append((layer, shape, functools.partial(
                        conv3x3.conv3x3_bias_relu_plain, *args, relu=relu),
                        ref))
                if layer == "upconv1.0":  # the skip concat as two inputs
                    xa, xb = split_input(gen, args[0])
                    in_place(conv3x3, xa, xb)
                    worst["conv3x3_bias_relu"] = max(
                        worst["conv3x3_bias_relu"],
                        check("conv3x3_bias_relu", layer + " 2 in", shape,
                              dtype,
                              conv3x3.conv3x3_bias_relu(
                                  xa, *args[1:], relu=relu, x2=xb),
                              conv3x3.conv3x3_bias_relu_plain(
                                  xa, *args[1:], relu=relu, x2=xb)))
    # the families' f32 shapes (phase 4e) at unpadded odd sizes: K3 3->64->64
    # and 64->64->64 (dncnn), K2 64->64 (the blocks), 64->256 (srgan's
    # upscale) and 64->3 with a zero bias (dncnn's last conv)
    f32 = torch.float32
    for layer, shape in (("dncnn 0+2", (1, 97, 130, 3, 64, 64)),
                         ("dncnn pair", (2, 97, 130, 64, 64, 64))):
        args = pair_inputs(gen, shape, f32)
        worst["double_conv3x3_relu"] = max(
            worst["double_conv3x3_relu"],
            check("double_conv3x3_relu", layer, shape, f32,
                  double_conv.double_conv3x3_relu(*args),
                  double_conv.double_conv3x3_relu_plain(*args)))
    for layer, shape in (("block conv", (1, 97, 130, 64, 64, False)),
                         ("upscale", (1, 44, 60, 64, 256, False)),
                         ("dncnn tail", (1, 97, 130, 64, 3, False))):
        (x, k, b), relu = single_inputs(gen, shape, f32)
        if layer == "dncnn tail":
            b = torch.zeros_like(b)
        worst["conv3x3_bias_relu"] = max(
            worst["conv3x3_bias_relu"],
            check("conv3x3_bias_relu", layer, shape, f32,
                  conv3x3.conv3x3_bias_relu(x, k, b, relu=relu),
                  conv3x3.conv3x3_bias_relu_plain(x, k, b, relu=relu)))
    # K2's narrow f32 body (Cout <= 4; 8x32 tiles, 64-channel chunks):
    # every Cout against Cin 3, 10, 16, 64, 67 at an odd size; batch 2 one
    # row and column past a tile, one short of it, an image smaller than a
    # tile in both dimensions, one pixel, a zero bias, x off its 16-byte
    # boundary (the 4-byte copies); each launch twice, bit-equal
    narrow = [(f"narrow {co}<-{ci}", (1, 97, 130, ci, co, ci % 2 == 1))
              for co in (1, 2, 3, 4) for ci in (3, 10, 16, 64, 67)]
    narrow += [("narrow batch2", (2, 33, 65, 64, 3, True)),
               ("narrow short", (1, 31, 63, 16, 3, False)),
               ("narrow small", (1, 5, 20, 64, 3, False)),
               ("narrow pixel", (1, 1, 1, 64, 3, True)),
               ("narrow no bias", (1, 45, 77, 64, 3, False))]
    for layer, shape in narrow:
        (x, k, b), relu = single_inputs(gen, shape, f32)
        if layer == "narrow no bias":
            b = torch.zeros_like(b)
        ref = conv3x3.conv3x3_bias_relu_plain(x, k, b, relu=relu)
        got = conv3x3.conv3x3_bias_relu(x, k, b, relu=relu)
        worst["conv3x3_bias_relu"] = max(
            worst["conv3x3_bias_relu"],
            check("conv3x3_bias_relu", layer, shape, f32, got, ref))
        if not torch.equal(got, conv3x3.conv3x3_bias_relu(x, k, b,
                                                          relu=relu)):
            fail(f"K2 {layer} {shape}: two launches differ")
        if layer == "narrow no bias":  # unaligned x (4-byte copies) and y
            xu = torch.empty(x.numel() + 1, device="cuda")[1:].view(x.shape)
            xu.copy_(x)
            got_u = conv3x3.conv3x3_bias_relu(xu, k, b, relu=relu)
            if not torch.equal(got_u, got):
                fail(f"K2 {layer}: an unaligned x changes the output")
    say(f"  narrow f32 body: {len(narrow)} shapes, each launched twice "
        "bit-equal")
    say("kernels: conv3x3_bias_relu, conv3x3_bias_relu_v2, "
        "double_conv3x3_relu")
    say(f"  f32 (three TF32 products, the narrow K2 body on the CUDA cores): "
        f"worst {F32_WORST[0]:.2e} x max|ref| over phase 3 (gate "
        f"{TOL[torch.float32]:.0e})")
    # control: the f32 check must reject TF32 in the kernels' place
    torch.backends.cudnn.allow_tf32 = True
    tf32 = [(layer, shape, fn(), ref) for layer, shape, fn, ref in controls]
    torch.backends.cudnn.allow_tf32 = False
    for layer, shape, got, ref in tf32:
        torch.cuda.synchronize()
        err = (got - ref).abs().max().item()
        tol = TOL[torch.float32] * ref.abs().max().item()
        say(f"  TF32 control {layer:10s} {str(shape):30s} max_abs_err "
            f"{err:.3e} ({err / ref.abs().max().item():.2e} x max|ref|) tol "
            f"{tol:.3e} {'rejected' if err > tol else 'ACCEPTED'}")
        if not err > tol:
            fail(f"the f32 check accepts TF32 for {layer} {shape}")
    return worst


# ---------------------------------------------------------------------------
# the int8 slice
def int8_layers(n, h, w):
    """The int8 step's convs at an input of h×w, in call order: name →
    (kernel, shape).  q8 (K2, s8 out): (N, H, W, Cin, Cout); k5: (N, H, W,
    Ca, Cb, Cout, relu, out); k6: (N, H, W, Cin, Cout, out)."""
    h2, w2, h4, w4 = h // 2, w // 2, h // 4, w // 4
    return {
        "down1.0": ("q8", (n, h, w, 3, 64)),
        "down1.2": ("k5", (n, h, w, 64, 0, 64, True, "s8")),
        "down2.0": ("k5", (n, h2, w2, 64, 0, 128, True, "s8")),
        "down2.2": ("k5", (n, h2, w2, 128, 0, 128, True, "s8")),
        "bottleneck.0": ("k5", (n, h4, w4, 128, 0, 256, True, "s8")),
        "bottleneck.2": ("k5", (n, h4, w4, 256, 0, 256, True, "s8")),
        "up2": ("k6", (n, h4, w4, 256, 128, "s8")),
        "upconv2.0": ("k5", (n, h2, w2, 128, 128, 128, True, "s8")),
        "upconv2.2": ("k5", (n, h2, w2, 128, 0, 128, True, "s8")),
        "up1": ("k6", (n, h2, w2, 128, 64, "s8")),
        "upconv1.0": ("k5", (n, h, w, 64, 64, 64, True, "s8")),
        "upconv1.2": ("k5", (n, h, w, 64, 0, 3, False, "bf16")),
    }


def s8_rand(gen, shape):
    return torch.randint(-127, 128, shape, generator=gen, device="cuda",
                         dtype=torch.int8)


def epilogue_inputs(gen, cin, cout, out):
    """w_scale, bias, out_scale of a layer: products of about unit size,
    stored across the s8 range."""
    ws = (torch.rand(cout, generator=gen, device="cuda") + 0.5) * 3.0 / (
        (9 * cin) ** 0.5 * 127 * 127 / 3)
    bias = (rnd(gen, (cout,), torch.float32, 0.1).to(torch.bfloat16)
            if out != "f32" else None)
    so = ((torch.rand(cout, generator=gen, device="cuda") + 0.5) * 3.0 / 127
          if out == "s8" else None)
    return ws, bias, so


def int8_inputs(gen, kind, shape):
    """(args, kwargs) of the kernel entry for a layer of int8_layers."""
    if kind == "q8":
        from celebrity_image_denoiser_tpu_torch.ops.cuda import conv3x3
        from celebrity_image_denoiser_tpu_torch.ops.quant import act_scale

        n, h, w, cin, cout = shape
        x = rnd(gen, (n, h, w, cin), torch.bfloat16)
        k = rnd(gen, (3, 3, cin, cout), torch.bfloat16, (9 * cin) ** -.5)
        b = rnd(gen, (cout,), torch.float32, 0.1)
        # scales calibrated on the output as the program's are (amax / 127
        # per channel): a bf16 ulp of h is then below one s8 step
        hh = torch.relu(conv3x3.conv3x3_bias_relu_plain(
            x, k, torch.zeros_like(b), relu=False) + b.to(torch.bfloat16))
        return (x, k, b, act_scale(hh.float().amax(dim=(0, 1, 2)))), {}
    if kind == "k5":
        n, h, w, ca, cb, cout, relu, out = shape
        x2 = (s8_rand(gen, (n, h + 1, w + 2, cb))[:, :h, :w] if cb else None)
        ws, bias, so = epilogue_inputs(gen, ca + cb, cout, out)
        return ((s8_rand(gen, (n, h, w, ca)),
                 s8_rand(gen, (cout, 3, 3, ca + cb)), ws, bias),
                {"relu": relu, "out_scale": so, "x2": x2})
    n, h, w, cin, cout, out = shape
    ws, bias, so = epilogue_inputs(gen, cin, cout, out)
    return ((s8_rand(gen, (n, h, w, cin)), s8_rand(gen, (2, 2, cout, cin)),
             ws, bias), {"out_scale": so})


def int8_entry(kind, conv3x3, k5, k6, plain=False):
    if kind == "q8":
        return (conv3x3.conv3x3_bias_relu_q8_plain if plain
                else conv3x3.conv3x3_bias_relu_q8)
    if kind == "k5":
        return k5.conv3x3_s8_plain if plain else k5.conv3x3_s8
    return k6.convt2x2_s8_plain if plain else k6.convt2x2_s8


def check_int8(kind, layer, shape, got, ref) -> float:
    """K5/K6: every output bit equal.  K2's s8 mode: its f32 sums run in
    another order than the plain version's, so a bf16 rounding of the conv
    may fall the other way: at most one s8 step, on at most 0.1%."""
    torch.cuda.synchronize()
    if got.shape != ref.shape or got.dtype != ref.dtype:
        fail(f"{kind} {layer}: {tuple(got.shape)} {got.dtype} vs "
             f"{tuple(ref.shape)} {ref.dtype}")
    diff = (got.float() - ref.float()).abs()
    err = diff.max().item()
    equal = (diff == 0).float().mean().item()
    ok = (err <= 1 and equal >= 0.999) if kind == "q8" else torch.equal(
        got, ref)
    say(f"  {kind} {layer:13s} {str(shape):42s} {str(got.dtype):15s} "
        f"max_abs_err {err:.3e} equal {equal:.6%} "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        fail(f"{kind} {layer} {shape} disagrees with its plain version")
    return err


def phase_int8_kernels(_build, conv3x3, k5, k6):
    say("== phase 3b: int8 kernels vs plain (exact in integers)")
    phase_s8_probe(_build)
    gen = make_gen()
    worst = {"q8": 0.0, "k5": 0.0, "k6": 0.0}
    cases = [(layer, kind, shape) for layer, (kind, shape)
             in int8_layers(BENCH_BATCH, 128, 128).items()]
    # ragged: odd H and W on every tile edge, a cropped strided second
    # input, Cout = 3 and 5 (one n8 block, odd), two output passes with a
    # ragged last one, the generic transform's raw f32 product
    cases += [
        ("ragged", "q8", (2, 37, 45, 3, 64)),
        ("ragged", "k5", (2, 37, 45, 64, 0, 128, True, "s8")),
        ("ragged 2 in", "k5", (2, 33, 30, 128, 128, 128, True, "s8")),
        ("ragged", "k5", (3, 19, 21, 64, 0, 3, False, "bf16")),
        ("ragged 2 in", "k5", (1, 7, 9, 64, 32, 5, True, "s8")),
        ("ragged", "k5", (2, 40, 36, 128, 0, 72, False, "bf16")),
        ("generic", "k5", (2, 64, 64, 128, 0, 128, False, "f32")),
        ("ragged", "k6", (2, 17, 23, 256, 128, "s8")),
        ("ragged", "k6", (1, 9, 7, 128, 64, "bf16")),
        ("generic", "k6", (2, 32, 32, 256, 128, "f32")),
        # the families' generic rungs (phase 4e): raw f32 out, Cin 64
        ("families", "k5", (1, 97, 130, 64, 0, 64, False, "f32")),
        ("families", "k5", (1, 44, 60, 64, 0, 256, False, "f32")),
    ]
    for layer, kind, shape in cases:
        args, kw = int8_inputs(gen, kind, shape)
        got = int8_entry(kind, conv3x3, k5, k6)(*args, **kw)
        ref = int8_entry(kind, conv3x3, k5, k6, plain=True)(*args, **kw)
        worst[kind] = max(worst[kind], check_int8(kind, layer, shape, got,
                                                  ref))
        del args, kw, got, ref
    torch.cuda.empty_cache()
    return worst


# the largest error × max|ref| of an f32 check() so far: the TF32 split's
# measured error on the card
F32_WORST = [0.0]


def check(name, layer, shape, dtype, got, ref) -> float:
    torch.cuda.synchronize()
    if got.shape != ref.shape or got.dtype != ref.dtype:
        fail(f"{name} {layer}: {tuple(got.shape)} {got.dtype} vs "
             f"{tuple(ref.shape)} {ref.dtype}")
    err = (got.float() - ref.float()).abs().max().item()
    scale = ref.float().abs().max().item()
    tol = TOL[dtype] * scale
    ok = err <= tol and bool(torch.isfinite(got.float()).all())
    if dtype == torch.float32:
        F32_WORST[0] = max(F32_WORST[0], err / scale)
    say(f"  {name:22s} {layer:10s} {str(shape):30s} {str(dtype):15s} "
        f"max_abs_err {err:.3e} ({err / scale:.2e} x max|ref|) tol "
        f"{tol:.3e} {'ok' if ok else 'FAIL'}")
    if not ok:
        fail(f"{name} {layer} {shape} {dtype} disagrees with its plain version")
    return err


def test_image(h, w, seed):
    """A smooth face-sized pattern plus noise, uint8 RGB."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    base = np.stack([128 + 90 * np.sin(xx / 17 + yy / 29),
                     128 + 80 * np.cos(yy / 13),
                     100 + 60 * np.sin((xx + yy) / 23)], -1)
    noisy = base + rng.normal(0, 20, base.shape)
    return np.clip(noisy, 0, 255).astype(np.uint8)


def post_enhance(url, png: bytes):
    return post_form(url, [("file", "x.png", "image/png", png)])


def post_form(url, fields):
    """POST a multipart form of ``(name, filename or None, content type,
    bytes)`` parts; (status, payload) also for an error status."""
    import urllib.error

    boundary = "cidchipsmoke7d1f"
    body = b""
    for name, filename, ctype, data in fields:
        disp = f"form-data; name=\"{name}\"" + (
            f"; filename=\"{filename}\"" if filename else "")
        body += (f"--{boundary}\r\nContent-Disposition: {disp}\r\n"
                 + (f"Content-Type: {ctype}\r\n" if ctype else "")
                 + "\r\n").encode() + data + b"\r\n"
    body += f"--{boundary}--\r\n".encode()
    req = urllib.request.Request(
        url, data=body, method="POST",
        headers={"Content-Type": f"multipart/form-data; boundary={boundary}"})
    try:
        with urllib.request.urlopen(req, timeout=300) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def quality_gate(st, label: str) -> None:
    """The serving quality gate: the fixture gain through ``st.enhance``
    must reach 70% of the gain recorded with the shipped weights."""
    from celebrity_image_denoiser_tpu_torch.serve import quality

    if quality.recorded_margin(st.weights_dir, "denoise") is None:
        fail("weights/denoise/meta.json records no fixture_gain_db")
    floor = quality.recorded_gate_floor(st.weights_dir, "denoise",
                                        default=1.0)
    gain = quality.fixture_gain_db(st, "denoise")
    say(f"  {label} fixture gain {gain:.3f} dB, floor {floor:.3f} dB "
        f"({quality.GATE_FRACTION:.0%} of the recorded "
        f"{quality.recorded_margin(st.weights_dir, 'denoise')} dB)")
    if gain < floor:
        fail(f"{label} server: fixture gain {gain:.3f} dB below the floor "
             f"{floor:.3f} dB")


def phase_serve(conv3x3, double_conv):
    from celebrity_image_denoiser_tpu_torch.data import imageio
    from celebrity_image_denoiser_tpu_torch.serve.app import make_server
    from celebrity_image_denoiser_tpu_torch.serve.handlers import ServeState

    say("== phase 4: serve (ServeState on the shipped weights, f32)")
    st = ServeState(device="cuda")
    if "denoise" not in st.healthz()["weights_loaded"]:
        fail("shipped denoise weights did not load")
    srv = make_server("127.0.0.1", 0, state=st)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    url = (f"http://127.0.0.1:{srv.server_address[1]}"
           "/enhance?model=denoise&graphs=false")
    totals = {"conv3x3_bias_relu": 0, "double_conv3x3_relu": 0}
    try:
        for i, (h, w) in enumerate(((256, 256), (98, 130), (64, 64))):
            img = test_image(h, w, seed=i)
            conv3x3.LAUNCHES = 0
            double_conv.LAUNCHES = 0
            t0 = time.perf_counter()
            status, payload = post_enhance(url, imageio.encode_png(img))
            dt = (time.perf_counter() - t0) * 1e3
            n1, n3 = conv3x3.LAUNCHES, double_conv.LAUNCHES
            totals["conv3x3_bias_relu"] += n1
            totals["double_conv3x3_relu"] += n3
            if status != 200:
                fail(f"/enhance {w}x{h}: HTTP {status} {payload}")
            if set(payload) != {"denoised_image_base64", "noise_graph_base64",
                                "backend"} or payload["backend"] != "torch":
                fail(f"/enhance {w}x{h}: bad payload keys {sorted(payload)}")
            out = imageio.decode_png(
                base64.b64decode(payload["denoised_image_base64"]))
            if out.shape != (h, w, 3):
                fail(f"/enhance {w}x{h}: output shape {out.shape}")
            ref = st.denoise_image(img, plain=True)
            diff = np.abs(out.astype(np.int16) - ref.astype(np.int16))
            say(f"  /enhance {w}x{h}: 200 in {dt:.1f} ms, launches "
                f"double_conv {n3} conv3x3 {n1}, vs plain max diff "
                f"{diff.max()} exact {np.mean(diff == 0):.4%}")
            if diff.max() > 1:
                fail(f"/enhance {w}x{h}: served pixels differ from the plain "
                     f"forward by {diff.max()}")
            if (n3, n1) != (4, 2):
                fail(f"/enhance {w}x{h}: launches double_conv {n3} conv3x3 "
                     f"{n1}, expected 4 and 2")
        # request latency as a closed loop of one client, 256x256 PNG
        png = imageio.encode_png(test_image(256, 256, seed=9))
        lat = []
        for _ in range(LATENCY_REQUESTS):
            t0 = time.perf_counter()
            status, _ = post_enhance(url, png)
            lat.append((time.perf_counter() - t0) * 1e3)
            if status != 200:
                fail(f"/enhance latency loop: HTTP {status}")
        p50, p90 = np.percentile(lat, [50, 90])
        say(f"  /enhance 256x256 latency over {len(lat)} requests (one "
            f"client, graphs=false): p50 {p50:.2f} ms p90 {p90:.2f} ms "
            f"max {max(lat):.2f} ms")
        quality_gate(st, "f32")
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=30)
    return totals


def int8_counts(conv3x3, double_conv, k5, k6, reset=False):
    """(K2, K3, K5, K6) launch counts; with ``reset`` set them to 0."""
    if reset:
        conv3x3.LAUNCHES = double_conv.LAUNCHES = k5.LAUNCHES = 0
        k6.LAUNCHES = 0
    return (conv3x3.LAUNCHES, double_conv.LAUNCHES, k5.LAUNCHES,
            k6.LAUNCHES)


INT8_PER_FORWARD = (1, 0, 9, 2)  # K2 (s8 out), K3, K5, K6


def u8_of(y):
    """The serving output map: clip(y·0.5+0.5) → truncate to uint8."""
    return (torch.clamp(y.float() * 0.5 + 0.5, 0, 1) * 255).to(torch.uint8)


def psnr_u8(diff) -> float:
    """Agreement of two u8 images in dB (the serving gate's measure) from
    their difference."""
    mse = float((torch.as_tensor(diff).double() ** 2).mean())
    return 10.0 * np.log10(255.0 ** 2 / max(mse, 1e-9))


def conv0_bracket(prog, x):
    """The s8 outputs conv 0 may give for ``x`` when its f32 sums run in any
    order: its epilogue (bf16 rounding, + bias in bf16, ReLU, quantize), which
    is monotone in the sum, at the plain f32 sum ∓ 4·n·2⁻²⁴·Σ|x·w| (n = 9·Cin
    products, each exact in f32; twice the worst-case bound of recursive
    summation, for each of the two sums).  One order flip can cost more than
    one s8 step where the bf16 rounding's ulp is over a step."""
    from celebrity_image_denoiser_tpu_torch.ops.cuda.conv3x3_s8 import (
        quantize_s8,
    )

    xb = x.to(torch.bfloat16).float().permute(0, 3, 1, 2)
    w = prog.wf0.float().permute(3, 2, 0, 1)
    with torch.inference_mode():
        y = torch.nn.functional.conv2d(xb, w, padding=1)
        tol = torch.nn.functional.conv2d(xb.abs(), w.abs(), padding=1)
        tol *= 4 * w.shape[1] * 9 * 2.0 ** -24

        def q(v):
            h = v.to(torch.bfloat16).permute(0, 2, 3, 1) + \
                prog.b0_f32.to(torch.bfloat16)
            return quantize_s8(torch.relu(h), prog.so0)
        return q(y - tol), q(y + tol)


def hold_s8_program(prog, x, label: str, max_step=None) -> torch.Tensor:
    """The s8 program's kernel route against its plain route on ``x``:
    conv 0 (K2's s8 mode) equal to its plain version on ≥ 99.9% of its
    values, every value inside ``conv0_bracket`` (and, with ``max_step``,
    within that many s8 steps); the rest of the program bit-equal to its
    plain route from the same conv-0 output (integer sums and single IEEE
    roundings); and end to end, each route with its own conv 0, at least
    40 dB.  Returns the kernel route's u8 output."""
    h0 = prog.first_conv(x)
    h0p = prog.first_conv(x, route="plain")
    yk = prog.body(h0)
    same = torch.equal(yk, prog.body(h0, route="plain"))
    d0 = (h0.int() - h0p.int()).abs()
    lo, hi = conv0_bracket(prog, x)
    outside = int(((h0 < lo) | (h0 > hi)).sum())
    differ = int((d0 > 0).sum())
    say(f"  {label}: conv 0 (K2 s8 mode) vs plain: {differ} of "
        f"{d0.numel()} s8 values differ, max {d0.max().item()} step, "
        f"{outside} outside the summation-order bracket; the rest of the "
        f"program from the same conv-0 output: "
        f"{'bit-equal' if same else 'DIFFERS'}")
    if not same or outside or differ > 1e-3 * d0.numel() or (
            max_step is not None and d0.max().item() > max_step):
        fail(f"{label}: the s8 program's kernel route disagrees with its "
             "plain route")
    del h0, d0, lo, hi
    # those few rounding differences in conv 0 reach the output through the
    # int8 output conv
    yk = u8_of(yk)
    diff = (yk.int() - u8_of(prog.body(h0p, route="plain")).int()).abs()
    db = psnr_u8(diff)
    say(f"  {label}: end to end u8 vs plain route: {int((diff > 0).sum())} "
        f"of {diff.numel()} pixels differ, max {diff.max().item()} counts, "
        f"{db:.2f} dB")
    if db < 40.0:
        fail(f"{label}: the s8 program's kernel route is below 40 dB of its "
             "plain route")
    return yk


def phase_int8_serve(conv3x3, double_conv, k5, k6):
    from celebrity_image_denoiser_tpu_torch.data import imageio
    from celebrity_image_denoiser_tpu_torch.data.synthetic import (
        calibration_batch,
    )
    from celebrity_image_denoiser_tpu_torch.ops.quant_unet import (
        quantize_apply_denoise_unet,
    )
    from celebrity_image_denoiser_tpu_torch.serve.app import make_server
    from celebrity_image_denoiser_tpu_torch.serve.handlers import ServeState

    say("== phase 4b: int8 serving (s8 skip-storage program, shipped "
        "weights)")
    st = ServeState(device="cuda", quantize="int8")
    if "denoise" not in st.healthz()["weights_loaded"]:
        fail("shipped denoise weights did not load")
    rung = st.ladder("denoise")
    say(f"  ladder: {rung}")
    if rung != "int8-s8skip":
        fail(f"the int8 ladder served {rung}, not int8-s8skip")
    # the program alone, kernel route vs plain route, on a batch of noisy
    # synthetic faces in the serving domain
    prog = quantize_apply_denoise_unet(st.models["denoise"],
                                       calibration_batch(True).cuda())
    x = calibration_batch(True, 128, generator=torch.Generator(
        device="cuda").manual_seed(1))
    int8_counts(conv3x3, double_conv, k5, k6, reset=True)
    y = prog(x)
    counts = int8_counts(conv3x3, double_conv, k5, k6)
    say(f"  s8 program {tuple(x.shape)}: launches K2 {counts[0]} K3 "
        f"{counts[1]} K5 {counts[2]} K6 {counts[3]}")
    if counts != INT8_PER_FORWARD:
        fail(f"s8 program launches {counts}, expected {INT8_PER_FORWARD}")
    if not torch.equal(hold_s8_program(prog, x, "s8 program", max_step=1),
                       u8_of(y)):
        fail("the s8 program's kernel route is not deterministic")

    srv = make_server("127.0.0.1", 0, state=st)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    url = (f"http://127.0.0.1:{srv.server_address[1]}"
           "/enhance?model=denoise&graphs=false")
    totals = [0, 0, 0, 0]
    try:
        for i, (h, w) in enumerate(((256, 256), (98, 130), (64, 64))):
            img = test_image(h, w, seed=i)
            int8_counts(conv3x3, double_conv, k5, k6, reset=True)
            t0 = time.perf_counter()
            status, payload = post_enhance(url, imageio.encode_png(img))
            dt = (time.perf_counter() - t0) * 1e3
            counts = int8_counts(conv3x3, double_conv, k5, k6)
            totals = [a + b for a, b in zip(totals, counts)]
            if status != 200 or payload.get("backend") != "torch":
                fail(f"int8 /enhance {w}x{h}: HTTP {status} {sorted(payload)}")
            out = imageio.decode_png(
                base64.b64decode(payload["denoised_image_base64"]))
            ref = st.denoise_image(img, plain=True)
            d = np.abs(out.astype(np.int16) - ref.astype(np.int16))
            say(f"  int8 /enhance {w}x{h}: 200 in {dt:.1f} ms, launches K2 "
                f"{counts[0]} K3 {counts[1]} K5 {counts[2]} K6 {counts[3]}, "
                f"vs plain route {int((d > 0).sum())} of {d.size} differ, "
                f"max {d.max()} counts, {psnr_u8(d):.2f} dB")
            if counts != INT8_PER_FORWARD or out.shape != (h, w, 3):
                fail(f"int8 /enhance {w}x{h}: launches {counts}, shape "
                     f"{out.shape}")
            if psnr_u8(d) < 40.0:
                fail(f"int8 /enhance {w}x{h}: below 40 dB of the plain "
                     "route")
        backends = st.stats.snapshot()["compute_backends"]
        say(f"  compute backends counted: {backends}")
        if backends != {"int8": 3}:
            fail(f"int8 serving counted {backends}")
        png = imageio.encode_png(test_image(256, 256, seed=9))
        lat = []
        for _ in range(LATENCY_REQUESTS):
            t0 = time.perf_counter()
            status, _ = post_enhance(url, png)
            lat.append((time.perf_counter() - t0) * 1e3)
            if status != 200:
                fail(f"int8 /enhance latency loop: HTTP {status}")
        p50, p90 = np.percentile(lat, [50, 90])
        say(f"  int8 /enhance 256x256 latency over {len(lat)} requests (one "
            f"client, graphs=false): p50 {p50:.2f} ms p90 {p90:.2f} ms "
            f"max {max(lat):.2f} ms")
        quality_gate(st, "int8")
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=30)
    return totals


# ---------------------------------------------------------------------------
# big inputs and micro-batching
TILED_SIZES = (("tall", 4097, 1001), ("wide", 1001, 4097),
               ("both", 3072, 4096))  # (name, H, W)
PER_FORWARD = {"float": (2, 4, 0, 0), "int8": INT8_PER_FORWARD}
MB_CLIENTS, MB_REQUESTS, MB_SIZE = 32, 8, 256  # phase 4d's HTTP load


class StageLog:
    """Collects the request log lines of ``serve/handlers.py`` (their
    arguments: model, w, h, total, decode, forward, figure, encode ms,
    compute, device) from whichever thread served them."""

    def __init__(self):
        import logging

        self.records = []
        self.handler = logging.Handler()
        self.handler.emit = self._emit
        self.logger = logging.getLogger("cid_torch.serve")

    def _emit(self, record):
        if record.msg.startswith("[%s] %dx%d in"):
            self.records.append(record.args)

    def __enter__(self):
        self.logger.addHandler(self.handler)
        return self

    def __exit__(self, *exc):
        self.logger.removeHandler(self.handler)


def n_tiles(h: int, w: int, threshold: int = 2048) -> int:
    """Tiles of a padded (multiple of 4) input over ``threshold``."""
    hh, ww = -(-h // 4) * 4, -(-w // 4) * 4
    per = [-(-e // threshold) if e > threshold else 1 for e in (hh, ww)]
    return per[0] * per[1]


def serve_in_thread(st):
    from celebrity_image_denoiser_tpu_torch.serve.app import make_server

    srv = make_server("127.0.0.1", 0, state=st)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    url = (f"http://127.0.0.1:{srv.server_address[1]}"
           "/enhance?model=denoise&graphs=false")
    return srv, thread, url


def stop_server(srv, thread):
    srv.shutdown()
    srv.server_close()
    thread.join(timeout=30)
    if thread.is_alive():
        fail("the HTTP server thread did not stop")


def served_input(st, img):
    """The padded, normalized (1, H, W, 3) f32 input ``st.denoise_image``
    gives the forward for ``img``, on the card, and its (top, left) pad."""
    from celebrity_image_denoiser_tpu_torch.core.config import MODEL_CFG
    from celebrity_image_denoiser_tpu_torch.data import imageio

    h, w = img.shape[:2]
    pl_, pt_, pr_, pb_ = st._padding("denoise", h, w)
    padded = np.pad(img, ((pt_, pb_), (pl_, pr_), (0, 0)))
    mean, std = MODEL_CFG["denoise"]["normalize"]
    x = imageio.normalize(imageio.to_float01(padded), mean[0], std[0])
    return torch.from_numpy(np.expand_dims(x, 0)).cuda(), (pt_, pl_)


def hold_untiled(ref, kind, name, img, y_ref) -> str:
    """Holds the untiled kernel-route reference ``y_ref`` (served by
    ``ref``) against the plain versions: f32 within 1 count of the plain
    forward; int8 through ``hold_s8_program`` on the same served input,
    whose kernel-route output must be ``y_ref`` itself."""
    h, w = img.shape[:2]
    if kind == "float":
        y_plain = ref.denoise_image(img, plain=True)
        d = np.abs(y_ref.astype(np.int16) - y_plain.astype(np.int16))
        if d.max() > 1:
            fail(f"float {name}: the untiled kernel route differs from the "
                 f"plain forward by {d.max()}")
        return (f"untiled vs plain max diff {d.max()} exact "
                f"{np.mean(d == 0):.6%}")
    x, (pt_, pl_) = served_input(ref, img)
    yk = hold_s8_program(ref._qapply["denoise"], x, f"int8 {name} untiled")
    if not np.array_equal(yk[0, pt_:pt_ + h, pl_:pl_ + w].cpu().numpy(),
                          y_ref):
        fail(f"int8 {name}: the program on the served input is not the "
             "served untiled output")
    return "untiled held to plain (above)"


def backends_after(st, before: dict) -> dict:
    now = st.stats.snapshot()["compute_backends"]
    return {k: v - before.get(k, 0) for k, v in now.items()
            if v != before.get(k, 0)}


def phase_tiling(conv3x3, double_conv, k5, k6):
    from celebrity_image_denoiser_tpu_torch.data import imageio
    from celebrity_image_denoiser_tpu_torch.serve.handlers import ServeState

    say("== phase 4c: big inputs, tiled (shipped weights, threshold 2048)")
    images = {name: test_image(h, w, seed=40 + i)
              for i, (name, h, w) in enumerate(TILED_SIZES)}
    pngs = {name: imageio.encode_png(img) for name, img in images.items()}
    totals = [0, 0, 0, 0]
    for kind, quantize in (("float", None), ("int8", "int8")):
        st = ServeState(device="cuda", quantize=quantize)
        # the same requests served untiled on the kernel route
        ref = ServeState(device="cuda", quantize=quantize,
                         tile_threshold_rows=8192)
        if quantize and (st.ladder("denoise") != "int8-s8skip"
                         or ref.ladder("denoise") != "int8-s8skip"):
            fail(f"the int8 ladder served {st.int8_rung}, {ref.int8_rung}")
        srv, thread, url = serve_in_thread(st)
        try:
            for name, h, w in TILED_SIZES:
                before = st.stats.snapshot()["compute_backends"]
                int8_counts(conv3x3, double_conv, k5, k6, reset=True)
                t0 = time.perf_counter()
                status, payload = post_enhance(url, pngs[name])
                dt = (time.perf_counter() - t0) * 1e3
                counts = int8_counts(conv3x3, double_conv, k5, k6)
                totals = [a + b for a, b in zip(totals, counts)]
                labels = backends_after(st, before)
                if status != 200:
                    fail(f"{kind} /enhance {w}x{h}: HTTP {status} {payload}")
                out = imageio.decode_png(
                    base64.b64decode(payload["denoised_image_base64"]))
                tiles = n_tiles(h, w)
                expect = tuple(tiles * c for c in PER_FORWARD[kind])
                y_ref = ref.denoise_image(images[name])
                if ref.last_compute_backend() != kind:
                    fail(f"the untiled reference ran "
                         f"{ref.last_compute_backend()}")
                plain_note = hold_untiled(ref, kind, name, images[name],
                                          y_ref)
                d = np.abs(out.astype(np.int16) - y_ref.astype(np.int16))
                say(f"  {kind} /enhance {name} {w}x{h}: 200 in {dt:.1f} ms, "
                    f"labels {labels}, {tiles} tiles, launches K2 "
                    f"{counts[0]} K3 {counts[1]} K5 {counts[2]} K6 "
                    f"{counts[3]} (expected {expect}), vs untiled max diff "
                    f"{d.max()} exact {np.mean(d == 0):.6%}; {plain_note}")
                if out.shape != (h, w, 3):
                    fail(f"{kind} {name}: output shape {out.shape}")
                if labels != {f"{kind}+tiled": 1}:
                    fail(f"{kind} {name}: labelled {labels}")
                if counts != expect:
                    fail(f"{kind} {name}: launches {counts}, expected "
                         f"{expect}")
                if d.max() > (1 if kind == "float" else 0):
                    fail(f"{kind} {name}: tiled differs from untiled by "
                         f"{d.max()}")
            # the both-axes request, timed three times
            lat = []
            with StageLog() as log:
                for _ in range(3):
                    t0 = time.perf_counter()
                    status, _ = post_enhance(url, pngs["both"])
                    lat.append((time.perf_counter() - t0) * 1e3)
                    if status != 200:
                        fail(f"{kind} both-axes timing: HTTP {status}")
            if len(log.records) != 3:
                fail(f"expected 3 request log lines, got {len(log.records)}")
            i = int(np.argsort(lat)[1])
            rec = log.records[i]
            say(f"  {kind} 3072x4096 (H x W) over 3 requests: median "
                f"{lat[i]:.1f} ms (all {', '.join(f'{v:.1f}' for v in lat)});"
                f" its stages: server {rec[3]:.1f} ms = decode {rec[4]:.1f} "
                f"+ forward+D2H {rec[5]:.1f} + encode {rec[7]:.1f} ms, "
                f"compute={rec[8]}")
        finally:
            stop_server(srv, thread)
        del st, ref
        torch.cuda.empty_cache()
    return totals


def run_load(url, pngs):
    """MB_CLIENTS closed-loop clients, each sending its MB_REQUESTS PNGs in
    turn; returns (wall s, latencies ms, response images in request
    order)."""
    import concurrent.futures

    out = [None] * len(pngs)
    lat = [0.0] * len(pngs)

    def client(c):
        for r in range(MB_REQUESTS):
            i = c * MB_REQUESTS + r
            t0 = time.perf_counter()
            status, payload = post_enhance(url, pngs[i])
            lat[i] = (time.perf_counter() - t0) * 1e3
            if status != 200:
                raise RuntimeError(f"request {i}: HTTP {status}")
            out[i] = payload["denoised_image_base64"]

    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(MB_CLIENTS) as ex:
        for f in [ex.submit(client, c) for c in range(MB_CLIENTS)]:
            f.result()
    wall = time.perf_counter() - t0
    return wall, lat, out


def batcher_totals(st) -> tuple:
    stats = st.batchers.stats()
    return (sum(v["batches"] for v in stats.values()),
            sum(v["requests"] for v in stats.values()))


def phase_microbatch(conv3x3, double_conv, k5, k6):
    from celebrity_image_denoiser_tpu_torch.data import imageio
    from celebrity_image_denoiser_tpu_torch.data.synthetic import (
        calibration_batch,
    )
    from celebrity_image_denoiser_tpu_torch.serve.handlers import ServeState

    say("== phase 4d: micro-batching (shipped weights)")
    st8 = ServeState(device="cuda", quantize="int8", microbatch_window_ms=2,
                     microbatch_max=16)
    if st8.ladder("denoise") != "int8-s8skip":
        fail(f"the int8 ladder served {st8.int8_rung}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st8.warmup(((256, 256), (2048, 2048)), models=("denoise",))
    warm = time.perf_counter() - t0
    say(f"  int8 warmup((256,256),(2048,2048)), batches 1-16: {warm:.2f} s")
    # one 16 x 2048^2 batch: s8 tensors of 4.29e9 elements (down1, up1,
    # upconv1), each image against its own batch-1 forward
    x = calibration_batch(True, 2048, sigmas=(0.12, 0.2),
                          generator=torch.Generator(
                              device="cuda").manual_seed(3))
    dispatch = st8._batched_dispatch("denoise")
    torch.cuda.reset_peak_memory_stats()
    int8_counts(conv3x3, double_conv, k5, k6, reset=True)
    yb = dispatch(x)
    torch.cuda.synchronize()
    counts = int8_counts(conv3x3, double_conv, k5, k6)
    if counts != INT8_PER_FORWARD:
        fail(f"the 16x2048^2 batch launched {counts}")
    differ = 0
    for i in range(x.shape[0]):
        differ += int((dispatch(x[i:i + 1]) != yb[i:i + 1]).sum())
    say(f"  int8 batch {tuple(x.shape)}: launches K2 {counts[0]} K5 "
        f"{counts[2]} K6 {counts[3]}; vs 16 batch-1 forwards {differ} of "
        f"{yb.numel()} bytes differ; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")
    if differ:
        fail("the 16x2048^2 int8 batch is not bit-equal to batch-1 forwards")
    # the batch-1 forwards against the plain route: with the equality above
    # this holds the whole batch to plain
    for i in (0, x.shape[0] - 1):
        yk = hold_s8_program(st8._qapply["denoise"], x[i:i + 1],
                             f"int8 2048x2048 image {i}")
        if not torch.equal(yk, yb[i:i + 1]):
            fail(f"image {i}: the program's kernel route is not the batch's "
                 "output")
    del x, yb, yk

    n = MB_CLIENTS * MB_REQUESTS
    pngs = [imageio.encode_png(test_image(MB_SIZE, MB_SIZE, seed=100 + i))
            for i in range(n)]
    totals = [0, 0, 0, 0]
    for kind, quantize in (("int8", "int8"), ("float", None)):
        if quantize:
            st_on = st8
        else:
            st_on = ServeState(device="cuda", microbatch_window_ms=2,
                               microbatch_max=16)
            st_on.warmup(((MB_SIZE, MB_SIZE),), models=("denoise",))
        st_off = ServeState(device="cuda", quantize=quantize)
        st_off.warmup(((MB_SIZE, MB_SIZE),), models=("denoise",))
        outs = {}
        for mode, st in (("off", st_off), ("on", st_on)):
            srv, thread, url = serve_in_thread(st)
            try:
                before = st.stats.snapshot()["compute_backends"]
                b0 = batcher_totals(st) if mode == "on" else (0, 0)
                int8_counts(conv3x3, double_conv, k5, k6, reset=True)
                wall, lat, outs[mode] = run_load(url, pngs)
                counts = int8_counts(conv3x3, double_conv, k5, k6)
                labels = backends_after(st, before)
            finally:
                stop_server(srv, thread)
            totals = [a + b for a, b in zip(totals, counts)]
            batches, reqs = (n, n) if mode == "off" else tuple(
                a - b for a, b in zip(batcher_totals(st), b0))
            p50, p90 = np.percentile(lat, [50, 90])
            say(f"  {kind} micro-batching {mode}: {n} requests "
                f"({MB_CLIENTS} clients x {MB_REQUESTS}, {MB_SIZE}^2 PNG) "
                f"in {wall:.2f} s: {n / wall:.1f} requests/s, p50 "
                f"{p50:.2f} ms p90 {p90:.2f} ms; forwards {batches}, mean "
                f"occupancy {reqs / batches:.2f}; labels {labels}; launches "
                f"K2 {counts[0]} K3 {counts[1]} K5 {counts[2]} K6 "
                f"{counts[3]}")
            if labels != {kind: n} or reqs != n:
                fail(f"{kind} {mode}: labels {labels}, {reqs} requests "
                     "batched")
            expect = tuple(batches * c for c in PER_FORWARD[kind])
            if counts != expect:
                fail(f"{kind} {mode}: launches {counts}, expected {expect} "
                     f"for {batches} forwards")
        worst, exact = 0, 0
        for a, b in zip(outs["off"], outs["on"]):
            ya = imageio.decode_png(base64.b64decode(a)).astype(np.int16)
            yb = imageio.decode_png(base64.b64decode(b)).astype(np.int16)
            worst = max(worst, int(np.abs(ya - yb).max()))
            exact += int((ya == yb).sum())
        share = exact / (n * MB_SIZE * MB_SIZE * 3)
        say(f"  {kind}: micro-batched responses vs the same requests served "
            f"alone: max diff {worst}, exact {share:.6%}")
        if worst > (1 if kind == "float" else 0):
            fail(f"{kind}: a micro-batched response differs from the same "
                 f"request served alone by {worst}")
        del st_on, st_off
        torch.cuda.empty_cache()
    return totals


# ---------------------------------------------------------------------------
# the dncnn, esrgan and srgan families
FAMILIES = ("dncnn", "esrgan", "srgan")
# (K2, K3) launches per f32 forward
F32_PER_FORWARD = {"dncnn": (1, 8), "esrgan": (16, 0), "srgan": (13, 0)}
# K5 launches per int8 forward, by rung (the 3-channel and 9x9 convs float)
K5_PER_FORWARD = {("dncnn", "int8-generic"): 15,
                  ("esrgan", "int8-generic"): 16,
                  ("esrgan", "int8-trunkfloat"): 9,
                  ("srgan", "int8-generic"): 13}
FAMILY_SIZES = {"dncnn": ((256, 256), (97, 130)),  # (H, W) requests
                "esrgan": ((256, 256), (97, 130)),
                "srgan": ((64, 64), (44, 60))}
FAMILY_TILED = {"dncnn": (4097, 1001), "esrgan": (4097, 1001),
                "srgan": (2100, 96)}
FAMILY_THRESHOLD = 2048  # the servers' tile threshold
FAMILY_REQUESTS = 30  # latency requests per family and mode
FAMILY_K5_FIXTURE = 64  # the K5 holds' input, a side
SRGAN_BIG = 2048  # the srgan LR side whose forward's memory is read
FAMILY_TILE = 2048  # the forward-time tile, a side
# f32 forwards at FAMILY_TILE² when K2 and K3 computed f32 on the CUDA
# cores (NVIDIA H100 80GB HBM3, 700.00 W): the TF32 bodies' yardstick
CUDA_CORE_F32_FORWARD_MS = {"dncnn": 278.7, "esrgan": 260.2}
# K2's narrow f32 rows on the CUDA-core body the ring body replaced (32x64
# tiles, 4-channel chunks; H100 80GB HBM3, 700 W), for comparison
NARROW_BEFORE_MS = {"unet upconv1.2": 0.189, "dncnn body.47 (no bias)": 0.182,
                    "cgan tail model.11": 2.290}
F32_TIMES_SIZE = 512  # the f32 kernel rows' input, a side


def family_url(url, fam):
    return url.replace("model=denoise", f"model={fam}")


def family_input(st, fam, img, device="cuda"):
    """The (1, H, W, 3) f32 input ``st.denoise_image`` gives the forward of
    ``fam`` for ``img``, on ``device``."""
    return torch.from_numpy(st._served_input(fam, img)[0]).to(device)


class Holds:
    """Wraps kernel entry points for the length of a ``with``: each launch
    is held against its plain version on the same inputs (f32: the check's
    tolerance; ``exact``: bit-equal).  The holds' plain calls launch
    nothing."""

    def __init__(self, entries, exact=False, tol=TOL[torch.float32]):
        self.entries = entries  # (module, entry name, plain function)
        self.exact = exact
        self.tol = tol  # f32: the largest error allowed, x max|ref|
        self.n = 0
        self.worst = 0.0  # the largest error / max|ref|
        self.shapes = set()

    def _wrap(self, name, entry, plain):
        def held(*args, **kw):
            y = entry(*args, **kw)
            # the f32 kernels' split weights are the kernel's alone
            ref = plain(*args, **{k: v for k, v in kw.items()
                                  if not k.endswith("_tf32")})
            self.n += 1
            self.shapes.add((name, tuple(args[0].shape), tuple(y.shape)))
            if self.exact:
                if not torch.equal(y, ref):
                    fail(f"{name} {tuple(args[0].shape)}: differs from its "
                         "plain version")
                return y
            err = (y.float() - ref.float()).abs().max().item()
            rel = err / max(ref.float().abs().max().item(), 1e-30)
            self.worst = max(self.worst, rel)
            if rel > self.tol or not bool(torch.isfinite(y).all()):
                fail(f"{name} {tuple(args[0].shape)} -> {tuple(y.shape)}: "
                     f"{rel:.2e} x max|ref| off its plain version")
            return y
        return held

    def __enter__(self):
        self.saved = [(m, n, getattr(m, n)) for m, n, _ in self.entries]
        for m, n, plain in self.entries:
            setattr(m, n, self._wrap(n, getattr(m, n), plain))
        return self

    def __exit__(self, *exc):
        for m, n, entry in self.saved:
            setattr(m, n, entry)


def family_quality(st, fam, label) -> str:
    """The family's quality floors through ``st.enhance``: 70% of the
    fixture gain recorded in ``weights/<fam>/meta.json``; for srgan 70% of
    its battery gain, and its fixture gain > 0."""
    from celebrity_image_denoiser_tpu_torch.serve import quality

    key = "battery_gain_db" if fam == "srgan" else "fixture_gain_db"
    if quality.recorded_margin(st.weights_dir, fam, key=key) is None:
        fail(f"weights/{fam}/meta.json records no {key}")
    floor = quality.recorded_gate_floor(st.weights_dir, fam, default=0.0,
                                        key=key)
    gain = (quality.srgan_battery_gain_db(st) if fam == "srgan"
            else quality.fixture_gain_db(st, fam))
    text = f"{label} {key[:-3]} {gain:.3f} dB (floor {floor:.3f})"
    if gain < floor:
        fail(f"{fam} {label}: {key} {gain:.3f} dB below the floor "
             f"{floor:.3f} dB")
    if fam == "srgan":
        fixture = quality.fixture_gain_db(st, fam)
        text += f", fixture {fixture:.3f} dB (> 0)"
        if fixture <= 0:
            fail(f"srgan {label}: fixture gain {fixture:.3f} dB")
    return text


def phase_families(conv3x3, double_conv, k5, k6, device="cuda"):
    import torch.nn.functional as F

    from celebrity_image_denoiser_tpu_torch.data import imageio
    from celebrity_image_denoiser_tpu_torch.serve.handlers import ServeState

    say("== phase 4e: the dncnn, esrgan and srgan families (shipped "
        "weights, f32 and int8)")
    t_phase = time.perf_counter()
    st_f = ServeState(device=device, tile_threshold_rows=FAMILY_THRESHOLD)
    st_q = ServeState(device=device, quantize="int8",
                      tile_threshold_rows=FAMILY_THRESHOLD)
    for st in (st_f, st_q):
        missing = set(FAMILIES) - set(st.healthz()["weights_loaded"])
        if missing:
            fail(f"shipped weights did not load: {sorted(missing)}")
    f32_holds = Holds([
        (conv3x3, "conv3x3_bias_relu", conv3x3.conv3x3_bias_relu_plain),
        (double_conv, "double_conv3x3_relu",
         double_conv.double_conv3x3_relu_plain)])
    k5_holds = Holds([(k5, "conv3x3_s8", k5.conv3x3_s8_plain)], exact=True)
    totals = [0, 0, 0, 0]  # (K2, K3, K5, K6) of the /enhance requests

    def counted(fn):
        int8_counts(conv3x3, double_conv, k5, k6, reset=True)
        out = fn()
        counts = int8_counts(conv3x3, double_conv, k5, k6)
        for i, c in enumerate(counts):
            totals[i] += c
        return out, counts

    servers = [serve_in_thread(st) for st in (st_f, st_q)]
    urls = {"float": servers[0][2], "int8": servers[1][2]}
    sts = {"float": st_f, "int8": st_q}
    records = {}
    try:
        for fam in FAMILIES:
            rung = st_q.ladder(fam)
            db = st_q.int8_gate_db.get(fam)
            say(f"  {fam}: int8 ladder {rung}"
                + (f", gate {db:.2f} dB" if db is not None else ""))
            if (fam, rung) not in K5_PER_FORWARD:
                fail(f"{fam}: the int8 ladder served {rung}")
            per = {"float": F32_PER_FORWARD[fam] + (0, 0),
                   "int8": (0, 0, K5_PER_FORWARD[(fam, rung)], 0)}
            rec = records.setdefault(fam, {"rung": rung, "gate_db": db})
            model = st_f.models[fam]
            # 1. the kernel route against the plain and autograd routes
            for i, (h, w) in enumerate(FAMILY_SIZES[fam]):
                img = test_image(h, w, seed=40 + i)
                n0 = f32_holds.n
                with f32_holds:
                    y_k = st_f.denoise_image(img, fam)
                y_p = st_f.denoise_image(img, fam, plain=True)
                d = np.abs(y_k.astype(np.int16) - y_p.astype(np.int16))
                x = family_input(st_f, fam, img, device)
                with torch.inference_mode():
                    xk = x.permute(0, 3, 1, 2)
                    da = (model(xk) - model(xk, route="autograd")).abs()
                da = da.max().item()
                say(f"  {fam} {w}x{h}: {f32_holds.n - n0} K2/K3 launches "
                    f"each within {TOL[torch.float32]:.0e} x max|ref| of "
                    f"plain (worst so far {f32_holds.worst:.2e}); served "
                    f"vs plain max diff {d.max()} exact "
                    f"{np.mean(d == 0):.4%}; kernel vs autograd route "
                    f"max {da:.2e}")
                if f32_holds.n - n0 != sum(F32_PER_FORWARD[fam]):
                    fail(f"{fam} {w}x{h}: {f32_holds.n - n0} kernel "
                         "launches held")
                if d.max() > 1:
                    fail(f"{fam} {w}x{h}: served pixels differ from the "
                         f"plain route by {d.max()}")
                if da > 1e-4:
                    fail(f"{fam} {w}x{h}: the kernel route is {da:.2e} off "
                         "the autograd route")
            # 2. every K5 launch of an int8 forward, bit-equal
            img = test_image(FAMILY_K5_FIXTURE, FAMILY_K5_FIXTURE, seed=47)
            n0 = k5_holds.n
            with k5_holds:
                st_q.denoise_image(img, fam)
            say(f"  {fam} int8 {FAMILY_K5_FIXTURE}x{FAMILY_K5_FIXTURE}: "
                f"{k5_holds.n - n0} K5 launches, each bit-equal to "
                "conv3x3_s8_plain")
            if k5_holds.n - n0 != per["int8"][2]:
                fail(f"{fam}: {k5_holds.n - n0} K5 launches held, expected "
                     f"{per['int8'][2]}")
            # 3. /enhance with exact launch counts, then latency
            for mode in ("float", "int8"):
                url = family_url(urls[mode], fam)
                for i, (h, w) in enumerate(FAMILY_SIZES[fam]):
                    img = test_image(h, w, seed=50 + i)
                    (status, payload), counts = counted(
                        lambda: post_enhance(url, imageio.encode_png(img)))
                    if status != 200 or set(payload) != {
                            "denoised_image_base64", "noise_graph_base64",
                            "backend"}:
                        fail(f"{fam} {mode} /enhance {w}x{h}: HTTP {status} "
                             f"{sorted(payload)}")
                    out = imageio.decode_png(base64.b64decode(
                        payload["denoised_image_base64"]))
                    want = sts[mode].denoise_image(img, fam)
                    say(f"  {fam} {mode} /enhance {w}x{h}: 200, "
                        f"{out.shape[1]}x{out.shape[0]} out, launches K2 "
                        f"{counts[0]} K3 {counts[1]} K5 {counts[2]} K6 "
                        f"{counts[3]}")
                    if counts != per[mode]:
                        fail(f"{fam} {mode} /enhance {w}x{h}: launches "
                             f"{counts}, expected {per[mode]}")
                    if not np.array_equal(out, want):
                        fail(f"{fam} {mode} /enhance {w}x{h}: the response "
                             "is not the forward's output")
                png = imageio.encode_png(test_image(
                    *FAMILY_SIZES[fam][0], seed=59))
                lat = []
                for _ in range(FAMILY_REQUESTS):
                    t0 = time.perf_counter()
                    (status, _), _ = counted(lambda: post_enhance(url, png))
                    lat.append((time.perf_counter() - t0) * 1e3)
                    if status != 200:
                        fail(f"{fam} {mode} latency loop: HTTP {status}")
                p50, p90 = np.percentile(lat, [50, 90])
                rec[f"{mode}_p50_ms"], rec[f"{mode}_p90_ms"] = p50, p90
                h, w = FAMILY_SIZES[fam][0]
                say(f"  {fam} {mode} /enhance {w}x{h} over {len(lat)} "
                    f"requests (one client, graphs=false): p50 {p50:.2f} "
                    f"ms p90 {p90:.2f} ms")
                # 4. the quality floors
                text, _ = counted(lambda: family_quality(sts[mode], fam,
                                                         mode))
                say(f"  {fam} {text}")
            # 5. one tiled request, against the untiled forward
            h, w = FAMILY_TILED[fam]
            img = test_image(h, w, seed=60)
            png = imageio.encode_png(img)
            hh, ww = st_f._input_shape(fam, h, w)
            tiles = (-(-hh // FAMILY_THRESHOLD)) * (-(-ww // FAMILY_THRESHOLD))
            for mode in ("float", "int8"):
                st = sts[mode]
                before = st.stats.snapshot()["compute_backends"]
                t0 = time.perf_counter()
                (status, payload), counts = counted(
                    lambda: post_enhance(family_url(urls[mode], fam), png))
                dt = time.perf_counter() - t0
                if status != 200:
                    fail(f"{fam} {mode} tiled {w}x{h}: HTTP {status}")
                label = backends_after(st, before)
                out = imageio.decode_png(base64.b64decode(
                    payload["denoised_image_base64"]))
                st.tile_threshold_rows = 1 << 16
                try:
                    ref = st.denoise_image(img, fam)
                finally:
                    st.tile_threshold_rows = FAMILY_THRESHOLD
                d = np.abs(out.astype(np.int16) - ref.astype(np.int16))
                want = tuple(tiles * c for c in per[mode])
                say(f"  {fam} {mode} tiled {w}x{h}: 200 in {dt:.2f} s, "
                    f"{label}, {tiles} tiles, launches {counts}, vs untiled "
                    f"max diff {d.max()} exact {np.mean(d == 0):.6%}")
                if label != {f"{mode}+tiled": 1} or counts != want:
                    fail(f"{fam} {mode} tiled: {label}, launches {counts}, "
                         f"expected {want}")
                if d.max() > (1 if mode == "float" else 0):
                    fail(f"{fam} {mode} tiled: differs from untiled by "
                         f"{d.max()}")
            # 6. forward times (device and host, the served forward with its
            # u8 output on the card) at 256² (srgan 64² LR) and a 2048² tile
            for mode in ("float", "int8"):
                apply = sts[mode]._apply(fam, "kernel")
                for side in ((FAMILY_SIZES[fam][0][0],) + (
                        () if fam == "srgan" else (FAMILY_TILE,))):
                    x = family_input(sts[mode], fam,
                                     test_image(side, side, seed=61), device)
                    with torch.inference_mode():
                        ms = time_ms(lambda: sts[mode]._to_u8(fam, apply(x)),
                                     reps=3, warmup=1)
                    rec[f"{mode}_forward_ms_{side}"] = ms
                    before = CUDA_CORE_F32_FORWARD_MS.get(fam) \
                        if mode == "float" and side == FAMILY_TILE else None
                    say(f"  {fam} {mode} forward at {side}x{side}: "
                        f"{ms:.3f} ms" + (
                            "" if before is None else
                            f" (the CUDA-core f32 bodies: {before} ms, "
                            f"{before / ms:.2f}x this)"))
                    del x
        # 7. whole profiles, in a fresh process: dncnn's forward at 256² in
        # f32 and int8 (where the int8 rung's time goes) and at a 2048² tile
        # in f32 (the narrow K2's share); srgan's at 2048² LR
        # (8192² out), batch 1, whose first call gives its time and peak
        # memory
        prof = profile_in_child("families")
        for label, r in prof.items():
            fam, mode = label.split()[0], (
                "float" if label.split()[1] == "f32" else "int8")
            tile = label.endswith(f"{FAMILY_TILE}x{FAMILY_TILE}")
            records[fam][f"{mode}_profile" + ("_tile" if tile else "")] = {
                k: r.get(k) for k in ("busy_ms", "kernel_ms", "wall_ms")}
            if fam == "srgan":
                say(f"  srgan {mode} {SRGAN_BIG}x{SRGAN_BIG} LR -> output "
                    f"{r['shape']}: {r['warm_s']:.3f} s (forward + D2H of "
                    f"the u8 output; the profiled one {r['wall_ms'] / 1e3:.3f}"
                    f" s), peak {r['peak_gib']:.2f} GiB")
                if r["shape"] != [1, 4 * SRGAN_BIG, 4 * SRGAN_BIG, 3]:
                    fail(f"srgan {mode} {SRGAN_BIG}²: shape {r['shape']}")
                records["srgan"][f"{mode}_big_s_run0"] = r["warm_s"]
                records["srgan"][f"{mode}_big_s_run1"] = r["wall_ms"] / 1e3
                records["srgan"][f"{mode}_big_peak_gib"] = r["peak_gib"]
    finally:
        for srv, thread, _ in servers:
            stop_server(srv, thread)
    family_layout_probe(device)
    rows = family_f32_times(conv3x3, double_conv, device)
    k5_rows = family_k5_times(k5)
    say(f"  phase 4e: {time.perf_counter() - t_phase:.1f} s; kernel "
        f"launches held: {f32_holds.n} K2/K3 (f32, worst "
        f"{f32_holds.worst:.2e} x max|ref|), {k5_holds.n} K5 (bit-equal); "
        f"/enhance launches K2 {totals[0]} K3 {totals[1]} K5 {totals[2]} "
        f"K6 {totals[3]}")
    return totals, records, rows + k5_rows, f32_holds.worst

# ---------------------------------------------------------------------------
# phase 4g: Restormer on K2, K7 and K8
RESTORMER_SIZES = ((1024, 1024), (256, 256), (203, 130))  # (H, W) requests
RESTORMER_PER_FORWARD = {"K2": 8, "K7": 44, "K8": 88, "K9": 178}
RESTORMER_SIDE = 1024  # the benchmark cell's uploads, a side
# K7 on a served request's activations, x max|ref|: its Gram sums and the
# plain version's GEMM add some 10^5 to 10^6 products a value in other
# orders, which on the model's (far from zero-mean) activations moved the
# softmaxed maps by 3.8e-5 of their largest (H100 80GB HBM3) where random
# inputs read 3e-8.  A wrong head, a missing temperature or norm, or a
# block of pixels left out of a sum moves them by 1e-2 or more.
K7_SERVED_TOL = 1e-3


def restormer_arch() -> dict:
    """The published widths, as the benchmark's configuration states them."""
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "port_bench", "configs", "restormer.json")
    with open(path) as f:
        return json.load(f)["arch"]


def restormer_launch_shapes(arch: dict, side: int) -> dict:
    """One forward's K7 and K8 launches at a side² input, by shape: (kernel,
    side, channels in, heads for K7 or the gate for K8) → launches."""
    from port_bench.roofline_restormer import hidden, levels

    shapes = {}
    for _, c, heads, n, div in levels(arch):
        s = side // div
        for key in (("K7", s, 3 * c, heads), ("K8", s, 3 * c, False),
                    ("K8", s, 2 * hidden(arch, c), True)):
            shapes[key] = shapes.get(key, 0) + n
    return shapes


def restormer_times(k7, k8, arch) -> dict:
    """K7 and K8 at each shape of a ``RESTORMER_SIDE``² forward on the
    device's clock: the kernel (against its plain version on the same
    random inputs, twice bit-equal; K8 without the gate also equal to its
    scalar body, on a copy one float off alignment), its plain version, the
    library
    (PyTorch's depthwise ``F.conv2d`` and the gate for K8, ``torch.matmul``
    and the softmax for K7) and the bound (operations at 67 TFLOP/s or bytes
    at 3.35 TB/s); and by kernel the sums over one forward's launches."""
    import torch.nn.functional as F

    g = torch.Generator(device="cuda").manual_seed(3)
    rows, sums = [], {}
    for (kern, side, cin, arg), n in restormer_launch_shapes(
            arch, RESTORMER_SIDE).items():
        if kern == "K8":
            gate, cout = arg, cin // 2 if arg else cin
            x = torch.randn((1, side, side, cin), generator=g, device="cuda")
            w = torch.randn((3, 3, cin), generator=g, device="cuda") / 3
            wl = w.permute(2, 0, 1).unsqueeze(1).contiguous()
            xl = x.permute(0, 3, 1, 2)  # channels-last memory

            def run(x=x, w=w, gate=gate):
                return k8.dwconv3x3(x, w, gate=gate)

            def plain(x=x, w=w, gate=gate):
                return k8.dwconv3x3_plain(x, w, gate=gate)

            def lib(xl=xl, wl=wl, cin=cin, gate=gate):
                y = F.conv2d(xl, wl, padding=1, groups=cin)
                return F.gelu(y[:, :cin // 2]) * y[:, cin // 2:] if gate \
                    else y
            ops = 2 * side * side * 9 * cin
            nbytes = 4 * (side * side * (cin + cout) + 9 * cin)
            label = f"K8 {side}x{side}x{cin}" + (" gated" if gate else "")
        else:
            heads, c = arg, cin // 3
            d = c // heads
            qkv = torch.randn((1, side, side, cin), generator=g,
                              device="cuda")
            temp = torch.rand((heads,), generator=g, device="cuda") + 0.5
            q, k = k7.heads_of(qkv, heads)
            qc, kc = q.contiguous(), k.contiguous()

            def run(qkv=qkv, heads=heads, temp=temp):
                return k7.channel_attention(qkv, heads, temp)

            def plain(qkv=qkv, heads=heads, temp=temp):
                return k7.channel_attention_plain(qkv, heads, temp)

            def lib(qc=qc, kc=kc):
                return torch.matmul(qc, kc.transpose(-2, -1)).softmax(-1)
            ops = 2 * side * side * (c * d + 2 * c)
            nbytes = 4 * (2 * c * side * side + heads * d * d + heads)
            label = f"K7 {side}x{side} C {c}, {heads} head(s)"
        y, ref = run(), plain()
        err = ((y - ref).abs().max() / ref.abs().max().clamp_min(1e-30)
               ).item()
        if err > TOL[torch.float32] or not torch.equal(y, run()):
            fail(f"{label}: {err:.2e} x max|ref| off its plain version, or "
                 "two launches differ")
        if kern == "K8" and not arg:
            # one float off 16-byte alignment: the scalar body, which
            # must give the float4 body's bits
            buf = torch.empty(x.numel() + 1, device="cuda")
            xs = buf[1:].view(x.shape)
            xs.copy_(x)
            if not torch.equal(k8.dwconv3x3(xs, w), y):
                fail(f"{label}: the float4 body's bits differ from the "
                     "scalar body's")
            del buf, xs
        del y, ref
        ms, plain_ms, lib_ms = device_ms(run), device_ms(plain), \
            device_ms(lib)
        b = bound_ms(ops, nbytes, PEAK_F32_FLOPS)
        by = "operations" if ops / PEAK_F32_FLOPS >= nbytes / PEAK_BYTES \
            else "bytes"
        rows.append({"kernel": kern, "shape": label, "per_forward": n,
                     "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                     "bound_ms": b, "bound_by": by, "max_rel_err": err})
        say(f"  {label} (x{n} a forward): {ms:.4f} ms, plain {plain_ms:.4f}, "
            f"library {lib_ms:.4f}, bound {b:.4f} by {by} "
            f"({b / ms:.1%}); {err:.2e} x max|ref|")
        s = sums.setdefault(kern, {k: 0.0 for k in (
            "ms", "plain_ms", "library_ms", "bound_ms")})
        for k in s:
            s[k] += n * rows[-1][k]
    for kern, s in sums.items():
        say(f"  {kern} over one {RESTORMER_SIDE}x{RESTORMER_SIDE} forward: "
            f"{s['ms']:.3f} ms, plain {s['plain_ms']:.3f}, library "
            f"{s['library_ms']:.3f}, bound {s['bound_ms']:.3f} "
            f"({s['bound_ms'] / s['ms']:.1%})")
    return {"rows": rows, "sums": sums}


def restormer_k9_shapes(arch: dict, side: int) -> dict:
    """One forward's K9 launches at a side² input, by shape: (what, side,
    K, Cout, LayerNorm folded, residual, a weight per image) → launches."""
    from port_bench.roofline_restormer import hidden, levels

    shapes = {}
    for _, c, _, n, div in levels(arch):
        s, hid = side // div, hidden(arch, c)
        for key in (("qkv", s, c, 3 * c, True, False, False),
                    ("v W_eff + x", s, c, c, False, True, True),
                    ("project_in", s, c, 2 * hid, True, False, False),
                    ("project_out + x", s, hid, c, False, True, False)):
            shapes[key] = shapes.get(key, 0) + n
    d = arch["dim"]
    for s, c in ((side // 4, 8 * d), (side // 2, 4 * d)):
        shapes[("reduce_chan", s, c, c // 2, False, False, False)] = 1
    return shapes


def restormer_k9_times(k9, arch) -> dict:
    """K9 at each shape of a ``RESTORMER_SIDE``² forward on the device's
    clock: the kernel (against its plain version on the same random
    inputs, twice bit-equal), its plain version, cuBLAS's float32 GEMM
    (``torch.addmm`` / ``baddbmm`` with TF32 off, the residual as its
    input where there is one; the LayerNorm not included) and the bound of
    the benchmark's ``roofline.k9.restormer`` (operations at 495 TFLOP/s,
    the TF32 peak, or bytes at 3.35 TB/s); and the sums over one
    forward's launches."""
    from port_bench.harness import BENCH_DIR, load_module

    metric = load_module(BENCH_DIR / "metrics" / "roofline.k9.restormer.py")
    g = torch.Generator(device="cuda").manual_seed(9)
    rows, total = [], {k: 0.0 for k in ("ms", "plain_ms", "library_ms",
                                          "bound_ms")}
    for (what, side, k, cout, ln, res, per_image), n in \
            restormer_k9_shapes(arch, RESTORMER_SIDE).items():
        m = side * side
        if per_image:  # the v slice of MDTA's qkv, its rows 3C apart
            a = torch.randn((1, side, side, 3 * k), generator=g,
                            device="cuda")[..., 2 * k:]
            w = torch.randn((1, cout, k), generator=g, device="cuda")
        else:
            a = torch.randn((1, side, side, k), generator=g, device="cuda")
            w = torch.randn((cout, k), generator=g, device="cuda")
        w /= k ** 0.5
        r = torch.randn((1, side, side, cout), generator=g,
                        device="cuda") if res else None
        split = k9.gemm_weights(w)

        def run(a=a, w=w, ln=ln, r=r, split=split):
            return k9.pointwise_gemm(a, w, layer_norm=ln, residual=r,
                                     w_tf32=split)

        def plain(a=a, w=w, ln=ln, r=r):
            return k9.pointwise_gemm_plain(a, w, layer_norm=ln, residual=r)

        a2 = a.reshape(1, m, k) if per_image else a.reshape(m, k)
        r2 = None if r is None else r.view(a2.shape[:-1] + (cout,))

        def lib(a2=a2, w=w, r2=r2):
            if a2.dim() == 3:
                return torch.baddbmm(r2, a2, w.transpose(1, 2))
            return torch.mm(a2, w.t()) if r2 is None else \
                torch.addmm(r2, a2, w.t())
        y, ref = run(), plain()
        err = ((y - ref).abs().max() / ref.abs().max().clamp_min(1e-30)
               ).item()
        label = (f"K9 {what} {side}x{side} {k} -> {cout}"
                 + (", LN folded" if ln else ""))
        if err > TOL[torch.float32] or not torch.equal(y, run()):
            fail(f"{label}: {err:.2e} x max|ref| off its plain version, or "
                 "two launches differ")
        del y, ref
        ms, plain_ms, lib_ms = device_ms(run), device_ms(plain), \
            device_ms(lib)
        ops, nbytes, bound_s = metric._launch(m, k, cout, res)
        b = bound_s * 1e3
        by = "operations" if ops / 495e12 >= nbytes / PEAK_BYTES \
            else "bytes"
        ceil3 = bound_ms(ops, nbytes, PEAK_TF32X3_FLOPS)
        rows.append({"kernel": "K9", "shape": label, "per_forward": n,
                     "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                     "bound_ms": b, "bound_by": by,
                     "tf32x3_bound_ms": ceil3, "max_rel_err": err})
        say(f"  {label} (x{n} a forward): {ms:.4f} ms, plain {plain_ms:.4f}, "
            f"library {lib_ms:.4f}, bound {b:.4f} by {by} ({b / ms:.1%}; "
            f"three-product ceiling {ceil3:.4f}); {err:.2e} x max|ref|")
        for key in total:
            total[key] += n * rows[-1][key]
        del a, w, r, split, a2, r2
    say(f"  K9 over one {RESTORMER_SIDE}x{RESTORMER_SIDE} forward: "
        f"{total['ms']:.3f} ms, plain {total['plain_ms']:.3f}, library "
        f"{total['library_ms']:.3f}, bound {total['bound_ms']:.3f} "
        f"({total['bound_ms'] / total['ms']:.1%})")
    return {"rows": rows, "sums": {"K9": total}}


def phase_restormer(conv3x3) -> dict:
    """Phase 4g: Restormer (seeded weights) served by ``ServeState`` on K2,
    K7, K8 and K9: every launch of a request at 1024², 256² and 203×130
    held against its plain version on the same inputs (f32: ``TOL``; K7
    ``K7_SERVED_TOL``), the
    launches of each request exactly ``RESTORMER_PER_FORWARD``, the served
    pixels within 1 count of the plain route; the share of served values
    at 0 or 255 on four of the benchmark's 1024² images; K7, K8 and K9 at
    the shapes of a 1024² forward (``restormer_times``,
    ``restormer_k9_times``); and a profiled 1024² request in a fresh
    process (``restormer_windows``).  Returns launches, errors and times by
    kernel."""
    from celebrity_image_denoiser_tpu_torch.ops.cuda import (
        channel_attention as k7,
    )
    from celebrity_image_denoiser_tpu_torch.ops.cuda import dwconv3x3 as k8
    from celebrity_image_denoiser_tpu_torch.ops.cuda import (
        pointwise_gemm as k9,
    )
    from celebrity_image_denoiser_tpu_torch.serve.handlers import ServeState
    from port_bench import gen

    say("== phase 4g: restormer (seeded weights, f32) on K2, K7, K8 and K9")
    st = ServeState(device="cuda")
    t0 = time.perf_counter()
    model = st._model("restormer")
    say(f"  built at its first use in {time.perf_counter() - t0:.2f} s; "
        f"{sum(p.numel() for p in model.parameters()):,} parameters")
    holds = {"K2": Holds([(conv3x3, "conv3x3_bias_relu",
                           conv3x3.conv3x3_bias_relu_plain)]),
             "K7": Holds([(k7, "channel_attention",
                           k7.channel_attention_plain)], tol=K7_SERVED_TOL),
             "K8": Holds([(k8, "dwconv3x3", k8.dwconv3x3_plain)]),
             "K9": Holds([(k9, "pointwise_gemm", k9.pointwise_gemm_plain)])}
    launches = {k: 0 for k in RESTORMER_PER_FORWARD}
    for i, (h, w) in enumerate(RESTORMER_SIZES):
        img = test_image(h, w, seed=70 + i)
        before = launch_counters()
        with holds["K2"], holds["K7"], holds["K8"], holds["K9"]:
            y = st.denoise_image(img, "restormer")
        torch.cuda.synchronize()
        after = launch_counters()
        got = {k: after[k] - before[k] for k in after
               if after[k] != before[k]}
        if got != RESTORMER_PER_FORWARD:
            fail(f"restormer {w}x{h}: launched {got}, expected "
                 f"{RESTORMER_PER_FORWARD}")
        for k in launches:
            launches[k] += got.get(k, 0)
        yp = st.denoise_image(img, "restormer", plain=True)
        d = np.abs(y.astype(np.int16) - yp.astype(np.int16))
        if y.shape != img.shape or d.max() > 1:
            fail(f"restormer {w}x{h}: shape {y.shape}, kernel route "
                 f"{d.max()} counts off the plain route")
        say(f"  {w}x{h}: launches {got}; kernel vs plain route max "
            f"{d.max()} count(s), {np.mean(d == 0):.5f} equal")
    for k, hold in holds.items():
        say(f"  {k}: {hold.n} launches held against the plain version, "
            f"worst {hold.worst:.2e} x max|ref| ({len(hold.shapes)} shapes)")
    u8 = gen.noisy_u8(2 ** 31 + 99, 4, RESTORMER_SIDE, 0.1, "cuda")
    clipped = inputs = 0
    for img in u8.cpu().numpy():
        y = st.denoise_image(img, "restormer")
        clipped += int(np.sum((y == 0) | (y == 255)))
        inputs += int(np.sum((img == 0) | (img == 255)))
    say(f"  served values at 0 or 255 on four of the benchmark's 1024x1024 "
        f"images: {clipped / u8.numel():.4f} (their inputs: "
        f"{inputs / u8.numel():.4f})")
    del st, model, u8
    torch.cuda.empty_cache()
    times = restormer_times(k7, k8, restormer_arch())
    k9_times = restormer_k9_times(k9, restormer_arch())
    times["rows"] += k9_times["rows"]
    times["sums"].update(k9_times["sums"])
    prof = profile_in_child("restormer")
    return {"launches": launches,
            "max_rel_err": {k: h.worst for k, h in holds.items()},
            "times": times, "profile": prof}


def restormer_windows(tmp: str) -> list:
    """Phase 4g's window: one 1024² Restormer request through
    ``ServeState.denoise_image`` (seeded weights, f32); ``tmp`` unused."""
    from celebrity_image_denoiser_tpu_torch.serve.handlers import ServeState

    st = ServeState(device="cuda")
    img = test_image(RESTORMER_SIDE, RESTORMER_SIDE, seed=71)
    return [(f"restormer f32 request at {RESTORMER_SIDE}x{RESTORMER_SIDE}",
             lambda: st.denoise_image(img, "restormer"),
             RESTORMER_PER_FORWARD, 12)]


def restormer_kernel_entries(res: dict) -> list:
    """The kernels JSON's K7, K8 and K9 entries from phase 4g."""
    entries = []
    for kern, name, source in (
            ("K7", "channel_attention", "mdta_attention.cu"),
            ("K8", "dwconv3x3", "dwconv3x3.cu"),
            ("K9", "pointwise_gemm", "pointwise_gemm.cu")):
        if res["launches"][kern] < 1:
            fail(f"{name} was not launched on the main path")
        s = res["times"]["sums"][kern]
        entries.append({
            "name": name, "route": "cuda",
            "source": f"celebrity_image_denoiser_tpu_torch/csrc/{source}",
            # the JAX package serves no model with channel attention, a
            # depthwise conv or a 1x1 conv
            "replaces": None,
            # phase 4g's restormer requests
            "launches": res["launches"][kern],
            # the largest error of a served launch, x max|ref|
            "max_rel_err": res["max_rel_err"][kern],
            # per 1024² Restormer forward, summed over its launches
            "ms": s["ms"], "plain_ms": s["plain_ms"],
            "library_ms": s["library_ms"], "bound_ms": s["bound_ms"],
            "shapes": [r for r in res["times"]["rows"]
                       if r["kernel"] == kern],
        })
    return entries


def family_layout_probe(device="cuda"):
    """cuDNN's float convs of the families (9×9 heads and tails, dncnn's
    3-channel 3×3 convs) on each tile of a 4097×1001 input (tiles of 2048
    rows, halo 32) against the whole image, over the rows a tile keeps:
    in contiguous NCHW memory, which the models give their heads, every
    value must be equal (the int8 rungs quantize the heads' outputs, so a
    tiled int8 request is bit-equal to an untiled one only then); in
    channels-last memory the differing values are printed."""
    import torch.nn.functional as F

    gen = torch.Generator(device=device).manual_seed(SEED)
    h, w, halo = 4097, 1001, 32
    tiles = []
    for start in range(0, h, FAMILY_THRESHOLD):
        stop = min(start + FAMILY_THRESHOLD, h)
        tiles.append((max(start - halo, 0), min(stop + halo, h), start, stop))
    for label, cin, cout, k in (("9x9 head", 3, 64, 9),
                                ("9x9 tail", 64, 3, 9),
                                ("3x3 3->64", 3, 64, 3),
                                ("3x3 64->3", 64, 3, 3)):
        x = torch.rand((1, cin, h, w), generator=gen, device=device)
        wt = torch.randn((cout, cin, k, k), generator=gen, device=device)
        b = torch.randn((cout,), generator=gen, device=device)
        differ = {}
        for fmt in (torch.contiguous_format, torch.channels_last):
            with torch.inference_mode():
                full = F.conv2d(x.contiguous(memory_format=fmt), wt, b,
                                padding=k // 2)
                n = 0
                for lo, hi, start, stop in tiles:
                    t = F.conv2d(x[:, :, lo:hi].contiguous(memory_format=fmt),
                                 wt, b, padding=k // 2)
                    n += int((t[:, :, start - lo:stop - lo]
                              != full[:, :, start:stop]).sum())
            differ[str(fmt).split(".")[-1]] = n
            del full
        say(f"  cuDNN {label} on {len(tiles)} tiles of {w}x{h} vs whole: "
            f"values that differ {differ}")
        if differ["contiguous_format"]:
            fail(f"cuDNN's {label} conv in NCHW memory depends on the tile")


def f32_bounds(flops, nbytes):
    """An f32 conv's bound (ms) and what sets it: operations as three TF32
    products on the tensor cores (495 / 3 TFLOP/s) or bytes at 3.35 TB/s;
    and the CUDA-core bound the f32 rows had before (operations at 67
    TFLOP/s), kept so that earlier shares stay comparable."""
    b = bound_ms(flops, nbytes, PEAK_TF32X3_FLOPS)
    by = ("operations" if flops / PEAK_TF32X3_FLOPS >= nbytes / PEAK_BYTES
          else "bytes")
    return b, by, bound_ms(flops, nbytes, PEAK_F32_FLOPS)


def family_f32_times(conv3x3, double_conv, device="cuda"):
    """K2 and K3 in f32 at the families' shapes and the U-Net's (batch 1,
    ``F32_TIMES_SIZE``²), each checked against its plain version, timed
    (the narrow body, Cout <= 4, on the device's clock) beside it, beside
    cuDNN (``F.conv2d`` + bias + ReLU, NCHW, TF32 off) and
    beside its bound (``f32_bounds``: operations as three TF32 products,
    bytes; and the old CUDA-core bound).  The kernels get their weights'
    split copies made once, as the models' caches hand them over."""
    import torch.nn.functional as F

    s = F32_TIMES_SIZE
    unet_pairs = pair_shapes(1, s, s)
    unet_singles = single_shapes(1, s, s)
    pairs = [("unet " + k, v) for k, v in unet_pairs.items()] + [
        ("dncnn body.0+2", (1, s, s, 3, 64, 64)),
        ("dncnn body.5+8", (1, s, s, 64, 64, 64))]
    singles = [("unet " + k, v) for k, v in unet_singles.items()] + [
        ("dncnn body.47 (no bias)", (1, s, s, 64, 3, False)),
        ("esrgan/srgan block conv", (1, s, s, 64, 64, False)),
        ("srgan upscale.0", (1, s, s, 64, 256, False))]
    gen = torch.Generator(device=device).manual_seed(SEED)
    dt = torch.float32
    rows = []

    def row(kernel, layer, shape, got, ref, ms, plain, lib, flops, nbytes):
        err = (got - ref).abs().max().item() / ref.abs().max().item()
        if err > TOL[dt]:
            fail(f"f32 {kernel} {layer}: {err:.2e} x max|ref| off plain")
        b, by, old = f32_bounds(flops, nbytes)
        rows.append({"kernel": kernel, "layer": layer, "shape": shape,
                     "ms": ms, "plain_ms": plain, "library_ms": lib,
                     "bound_ms": b, "bound_by": by,
                     "cuda_core_bound_ms": old, "max_rel_err": err,
                     "tflops": flops / ms / 1e9})
        say(f"  f32 {kernel:20s} {layer:24s} {str(shape):28s} {ms:8.3f} ms "
            f"plain {plain:8.3f} cuDNN {lib:8.3f} bound {b:.3f} ({by}) "
            f"{flops / ms / 1e9:6.2f} TFLOP/s, {b / ms:.1%} of bound; "
            f"CUDA-core bound {old:.3f} ({old / ms:.1%}); {err:.2e} x "
            f"max|ref|")

    def rnd(shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=device) * scale

    for layer, (n, h, w, c0, c1, c2) in pairs:
        x = rnd((n, h, w, c0))
        w1, b1 = rnd((3, 3, c0, c1), (9 * c0) ** -0.5), rnd((c1,), 0.1)
        w2, b2 = rnd((3, 3, c1, c2), (9 * c1) ** -0.5), rnd((c2,), 0.1)
        xc = x.permute(0, 3, 1, 2).contiguous()
        o1, o2 = w1.permute(3, 2, 0, 1).contiguous(), \
            w2.permute(3, 2, 0, 1).contiguous()
        with torch.inference_mode():
            args = (x, w1, b1, w2, b2)
            split = {"w1_tf32": conv3x3.tf32_weights(w1),
                     "w2_tf32": conv3x3.tf32_weights(w2)}
            got = double_conv.double_conv3x3_relu(*args, **split)
            ref = double_conv.double_conv3x3_relu_plain(*args)
            ms = time_ms(lambda: double_conv.double_conv3x3_relu(
                *args, **split), 10)
            plain = time_ms(
                lambda: double_conv.double_conv3x3_relu_plain(*args), 10)
            lib = time_ms(lambda: F.relu(F.conv2d(F.relu(F.conv2d(
                xc, o1, b1, padding=1)), o2, b2, padding=1)), 10)
        flops = 2 * n * h * w * 9 * (c0 * c1 + c1 * c2)
        nbytes = 4 * (x.numel() + w1.numel() + w2.numel() + c1 + c2
                      + n * h * w * c2)
        row("double_conv3x3_relu", layer, (n, h, w, c0, c1, c2), got, ref,
            ms, plain, lib, flops, nbytes)
    for layer, (n, h, w, cin, cout, relu) in singles:
        x = rnd((n, h, w, cin))
        wt = rnd((3, 3, cin, cout), (9 * cin) ** -0.5)
        b = (torch.zeros(cout, device=device) if "no bias" in layer
             else rnd((cout,), 0.1))
        xc = x.permute(0, 3, 1, 2).contiguous()
        wo = wt.permute(3, 2, 0, 1).contiguous()
        act = F.relu if relu else (lambda t: t)
        with torch.inference_mode():
            split = conv3x3.tf32_weights(wt) if cout > 4 else None
            got = conv3x3.conv3x3_bias_relu(x, wt, b, relu=relu,
                                            kernel_tf32=split)
            ref = conv3x3.conv3x3_bias_relu_plain(x, wt, b, relu=relu)
            # the narrow body's launch is short: on the device's clock, so
            # that the wrapper's host time between launches does not count
            ms = (device_ms if cout <= 4 else functools.partial(
                time_ms, reps=10))(lambda: conv3x3.conv3x3_bias_relu(
                    x, wt, b, relu=relu, kernel_tf32=split))
            plain = time_ms(lambda: conv3x3.conv3x3_bias_relu_plain(
                x, wt, b, relu=relu), 10)
            lib = time_ms(lambda: act(F.conv2d(xc, wo, b, padding=1)), 10)
        flops = 2 * n * h * w * 9 * cin * cout
        nbytes = 4 * (x.numel() + wt.numel() + cout + n * h * w * cout)
        row("conv3x3_bias_relu", layer, (n, h, w, cin, cout, relu), got, ref,
            ms, plain, lib, flops, nbytes)
        if layer in NARROW_BEFORE_MS:
            before = NARROW_BEFORE_MS[layer]
            say(f"    (the replaced narrow body here: {before} ms, "
                f"{before / ms:.2f}x this)")
    return rows


def family_k5_times(k5):
    """K5 in its raw f32 mode (the generic int8 rungs' convs) at 64→64 and
    64→256, batch 1, ``F32_TIMES_SIZE``²: bit-equal to its plain version,
    timed beside it, beside ``torch._int_mm`` at the im2col GEMM shape (no
    epilogue; no PyTorch call computes this function) and beside its bound
    (operations at 1979 TOP/s, bytes at 3.35 TB/s)."""
    s = F32_TIMES_SIZE
    gen = make_gen()
    rows = []
    for layer, shape in (("block conv", (1, s, s, 64, 0, 64, False, "f32")),
                         ("srgan upscale.0",
                          (1, s, s, 64, 0, 256, False, "f32"))):
        n, h, w, cin, _, cout, _, _ = shape
        args, kw = int8_inputs(gen, "k5", shape)
        with torch.inference_mode():
            got = k5.conv3x3_s8(*args, **kw)
            check_int8("k5", layer, shape, got, k5.conv3x3_s8_plain(*args,
                                                                    **kw))
            ms = time_ms(lambda: k5.conv3x3_s8(*args, **kw), 10)
            plain = time_ms(lambda: k5.conv3x3_s8_plain(*args, **kw), 2, 1)
            mm = int_mm_ms("k5", args, kw)
        ops = 2 * n * h * w * 9 * cin * cout
        nbytes = n * h * w * cin + cout * 9 * cin + 4 * cout \
            + 4 * n * h * w * cout
        b = bound_ms(ops, nbytes, PEAK_INT8_OPS)
        by = ("operations" if ops / PEAK_INT8_OPS >= nbytes / PEAK_BYTES
              else "bytes")
        rows.append({"layer": layer, "shape": shape, "ms": ms,
                     "plain_ms": plain, "int_mm_ms": mm, "bound_ms": b,
                     "bound_by": by})
        say(f"  k5 raw f32 {layer:16s} {str(shape):40s} {ms:.3f} ms plain "
            f"{plain:.3f} _int_mm {mm:.3f} bound {b:.4f} ({by}) "
            f"{ops / ms / 1e9:.1f} TOP/s, {b / ms:.1%} of bound")
    return rows


# ---------------------------------------------------------------------------
# phase 4f: the cGAN family
CGAN_SIZES = ((256, 256), (97, 130))  # (H, W) requests
CGAN_TILED = (4097, 1001)
CGAN_REQUESTS = 30  # latency requests per mode
CGAN_BIG = 2048  # the forward-time input and the K5 rewrite rows, a side
CGAN_K5_FIXTURE = 256  # the held int8 forward's input, a side
# (K2, K3, K5, K6) launches per forward of the Keras cGAN: f32 runs its 3x3
# tail on K2; int8 its three 4x4 stride-2 layers on K5 (the 3-channel head
# and tail float)
CGAN_PER_FORWARD = {"float": (1, 0, 0, 0), "int8": (0, 0, 3, 0)}
CGAN_FLOOR_DEFAULT = 1.0  # cgan records no margin: tests/test_serve.py:495


def direct_conv_s8(x_i8, w_i8, w_scale, stride, padding, rewrite=None):
    """The int8 conv as one direct integer conv (float64 sums of s8
    products are exact), the replay's plain reference on the card."""
    import torch.nn.functional as F

    acc = F.conv2d(x_i8.double(), w_i8.double(), stride=stride,
                   padding=padding).to(torch.int32)
    return acc.float() * w_scale.view(1, -1, 1, 1)


def direct_convt_s8(x_i8, w_i8, w_scale, stride, padding=0, rewrite=None):
    import torch.nn.functional as F

    acc = F.conv_transpose2d(x_i8.double(), w_i8.double(), stride=stride,
                             padding=padding).to(torch.int32)
    return acc.float() * w_scale.view(1, -1, 1, 1)


def phase_cgan(conv3x3, double_conv, k5, k6, device="cuda"):
    from celebrity_image_denoiser_tpu_torch.data import imageio
    from celebrity_image_denoiser_tpu_torch.ops import quant
    from celebrity_image_denoiser_tpu_torch.serve import quality
    from celebrity_image_denoiser_tpu_torch.serve.handlers import (
        KERAS,
        ServeState,
    )

    say("== phase 4f: the cgan family (the shipped Keras generator, f32 and "
        "int8; the torch fallback)")
    t_phase = time.perf_counter()
    st_f = ServeState(device=device, tile_threshold_rows=FAMILY_THRESHOLD)
    st_q = ServeState(device=device, quantize="int8",
                      tile_threshold_rows=FAMILY_THRESHOLD)
    for st in (st_f, st_q):
        if st.keras_cgan is None or "cgan" not in st.healthz()[
                "weights_loaded"]:
            fail("the shipped weights/cgan_epoch_500.keras did not load "
                 "through ckpt/keras.py")
    n_params = sum(p.numel() for p in st_f.keras_cgan.parameters())
    say(f"  weights/cgan_epoch_500.keras read by the port's HDF5 reader "
        f"(no h5py): {n_params} parameters; default backend "
        f"{st_f.info()['default_backends']['cgan']!r}")
    f32_holds = Holds([
        (conv3x3, "conv3x3_bias_relu", conv3x3.conv3x3_bias_relu_plain)])
    k5_holds = Holds([(k5, "conv3x3_s8", k5.conv3x3_s8_plain)], exact=True)
    direct_holds = Holds([(quant, "int8_conv2d", direct_conv_s8),
                          (quant, "int8_conv_transpose2d", direct_convt_s8)],
                         exact=True)
    totals = [0, 0, 0, 0]

    def counted(fn):
        int8_counts(conv3x3, double_conv, k5, k6, reset=True)
        out = fn()
        counts = int8_counts(conv3x3, double_conv, k5, k6)
        for i, c in enumerate(counts):
            totals[i] += c
        return out, counts

    rung = st_q.ladder(KERAS)
    db = st_q.int8_gate_db.get(KERAS)
    say(f"  cgan int8 ladder {rung}"
        + (f", gate {db:.2f} dB vs float" if db is not None else ""))
    if rung != "int8-generic":
        fail(f"cgan: the int8 ladder served {rung}, not int8-generic")
    rec = {"rung": rung, "gate_db": db}
    sts = {"float": st_f, "int8": st_q}
    servers = [serve_in_thread(st) for st in (st_f, st_q)]
    urls = {"float": family_url(servers[0][2], "cgan"),
            "int8": family_url(servers[1][2], "cgan")}
    model = st_f.keras_cgan
    try:
        # 1. the kernel route against the plain and autograd routes
        for i, (h, w) in enumerate(CGAN_SIZES):
            img = test_image(h, w, seed=70 + i)
            n0 = f32_holds.n
            with f32_holds:
                y_k = st_f.denoise_image(img, "cgan")
            y_p = st_f.denoise_image(img, "cgan", plain=True)
            d = np.abs(y_k.astype(np.int16) - y_p.astype(np.int16))
            # the same request again: cuDNN runs deterministic in the cGAN
            rep_d = np.abs(st_f.denoise_image(img, "cgan").astype(np.int16)
                           - y_k.astype(np.int16))
            x = family_input(st_f, "cgan", img, device)
            with torch.inference_mode():
                xk = x.permute(0, 3, 1, 2)
                da = (model(xk) - model(xk, route="autograd")).abs()
            da = da.max().item()
            say(f"  cgan {w}x{h}: {f32_holds.n - n0} K2 launch(es) within "
                f"{TOL[torch.float32]:.0e} x max|ref| of plain (worst so "
                f"far {f32_holds.worst:.2e}); served vs plain max diff "
                f"{d.max()} exact {np.mean(d == 0):.4%}; served twice max "
                f"diff {rep_d.max()} exact {np.mean(rep_d == 0):.4%}; kernel "
                f"vs autograd route max {da:.2e}")
            if f32_holds.n - n0 != CGAN_PER_FORWARD["float"][0]:
                fail(f"cgan {w}x{h}: {f32_holds.n - n0} K2 launches held")
            if d.max() > 1 or rep_d.max() > 0:
                fail(f"cgan {w}x{h}: served pixels differ from the plain "
                     f"route by {d.max()} or from themselves by "
                     f"{rep_d.max()}")
            if da > 1e-4:
                fail(f"cgan {w}x{h}: the kernel route is {da:.2e} off the "
                     "autograd route")
        # 2. every K5 launch of an int8 forward bit-equal to its plain
        # version, and each rewritten conv to the direct integer conv
        img = test_image(CGAN_K5_FIXTURE, CGAN_K5_FIXTURE, seed=72)
        n0, m0 = k5_holds.n, direct_holds.n
        with direct_holds, k5_holds:
            st_q.denoise_image(img, "cgan")
        shapes = sorted(s for s in k5_holds.shapes)
        say(f"  cgan int8 {CGAN_K5_FIXTURE}x{CGAN_K5_FIXTURE}: "
            f"{k5_holds.n - n0} K5 launches bit-equal to conv3x3_s8_plain, "
            f"{direct_holds.n - m0} rewritten convs bit-equal to the direct "
            f"integer conv; K5 (input, output) shapes {shapes}")
        if k5_holds.n - n0 != 3 or direct_holds.n - m0 != 3:
            fail(f"cgan int8: {k5_holds.n - n0} K5 launches and "
                 f"{direct_holds.n - m0} rewritten convs held, expected 3")
        rec["k5_shapes"] = [list(s[1:]) for s in shapes]
        # 3. /enhance with exact launch counts, then latency
        for mode in ("float", "int8"):
            for i, (h, w) in enumerate(CGAN_SIZES):
                img = test_image(h, w, seed=73 + i)
                (status, payload), counts = counted(
                    lambda: post_enhance(urls[mode], imageio.encode_png(img)))
                if status != 200 or payload.get("backend") != "keras":
                    fail(f"cgan {mode} /enhance {w}x{h}: HTTP {status} "
                         f"backend {payload.get('backend')}")
                out = imageio.decode_png(base64.b64decode(
                    payload["denoised_image_base64"]))
                want = sts[mode].denoise_image(img, "cgan")
                d = np.abs(out.astype(np.int16) - want.astype(np.int16))
                say(f"  cgan {mode} /enhance {w}x{h}: 200, backend keras, "
                    f"{out.shape[1]}x{out.shape[0]} out, launches K2 "
                    f"{counts[0]} K3 {counts[1]} K5 {counts[2]} K6 "
                    f"{counts[3]}; vs the forward max diff {d.max()}")
                if counts != CGAN_PER_FORWARD[mode]:
                    fail(f"cgan {mode} /enhance {w}x{h}: launches {counts}, "
                         f"expected {CGAN_PER_FORWARD[mode]}")
                if out.shape != img.shape or d.max() > 0:
                    fail(f"cgan {mode} /enhance {w}x{h}: the response is not "
                         "the forward's output")
            png = imageio.encode_png(test_image(*CGAN_SIZES[0], seed=75))
            lat = []
            for _ in range(CGAN_REQUESTS):
                t0 = time.perf_counter()
                (status, _), _ = counted(lambda: post_enhance(urls[mode],
                                                              png))
                lat.append((time.perf_counter() - t0) * 1e3)
                if status != 200:
                    fail(f"cgan {mode} latency loop: HTTP {status}")
            p50, p90 = np.percentile(lat, [50, 90])
            rec[f"{mode}_p50_ms"], rec[f"{mode}_p90_ms"] = p50, p90
            h, w = CGAN_SIZES[0]
            say(f"  cgan {mode} /enhance {w}x{h} over {len(lat)} requests "
                f"(one client, graphs=false): p50 {p50:.2f} ms p90 "
                f"{p90:.2f} ms")
            # 4. the quality floor: the fixture through the Keras backend
            floor = quality.recorded_gate_floor(st_f.weights_dir, "cgan",
                                                default=CGAN_FLOOR_DEFAULT)
            gain, _ = counted(lambda: quality.fixture_gain_db(sts[mode],
                                                              "cgan"))
            rec[f"{mode}_fixture_gain_db"] = gain
            say(f"  cgan {mode} fixture gain {gain:.4f} dB (floor "
                f"{floor:.3f})")
            if gain <= floor:
                fail(f"cgan {mode}: fixture gain {gain:.3f} dB not above "
                     f"the floor {floor:.3f} dB")
        # 5. one tiled request against the untiled forward
        h, w = CGAN_TILED
        img = test_image(h, w, seed=76)
        png = imageio.encode_png(img)
        tiles = n_tiles(h, w, FAMILY_THRESHOLD)
        for mode in ("float", "int8"):
            st = sts[mode]
            before = st.stats.snapshot()["compute_backends"]
            t0 = time.perf_counter()
            (status, payload), counts = counted(
                lambda: post_enhance(urls[mode], png))
            dt = time.perf_counter() - t0
            if status != 200:
                fail(f"cgan {mode} tiled {w}x{h}: HTTP {status}")
            label = backends_after(st, before)
            out = imageio.decode_png(base64.b64decode(
                payload["denoised_image_base64"]))
            st.tile_threshold_rows = 1 << 16
            try:
                ref = st.denoise_image(img, "cgan")
            finally:
                st.tile_threshold_rows = FAMILY_THRESHOLD
            d = np.abs(out.astype(np.int16) - ref.astype(np.int16))
            want = tuple(tiles * c for c in CGAN_PER_FORWARD[mode])
            rec[f"{mode}_tiled_s"] = dt
            say(f"  cgan {mode} tiled {w}x{h}: 200 in {dt:.2f} s, {label}, "
                f"{tiles} tiles, launches {counts}, vs untiled max diff "
                f"{d.max()} exact {np.mean(d == 0):.6%}")
            if label != {f"{mode}+tiled": 1} or counts != want:
                fail(f"cgan {mode} tiled: {label}, launches {counts}, "
                     f"expected {want}")
            if d.max() > (1 if mode == "float" else 0):
                fail(f"cgan {mode} tiled: differs from untiled by {d.max()}")
        # 6. the torch fallback: a label (200), a condition image (500),
        # neither (400), a label outside the table (400, checked on the
        # host: on the card it would end the process's CUDA context); always
        # float, no kernel.  Then the card still serves the other paths.
        img = test_image(37, 29, seed=77)
        png = imageio.encode_png(img)
        url = urls["float"] + "&cgan_backend=torch"
        file_part = ("file", "x.png", "image/png", png)
        for what, fields, want_status in (
                ("label 5", [file_part, ("label", None, None, b"5")], 200),
                ("cond_file", [file_part, ("cond_file", "c.png", "image/png",
                                           png)], 500),
                ("no label", [file_part], 400),
                ("label 'x'", [file_part, ("label", None, None, b"x")], 400),
                ("label 10", [file_part, ("label", None, None, b"10")], 400),
                ("label -1", [file_part, ("label", None, None, b"-1")], 400),
                ("label 9", [file_part, ("label", None, None, b"9")], 200)):
            (status, payload), counts = counted(lambda: post_form(url,
                                                                  fields))
            text = f"  cgan torch backend, {what}: HTTP {status}"
            if status == 200:
                out = imageio.decode_png(base64.b64decode(
                    payload["denoised_image_base64"]))
                text += (f", backend {payload['backend']}, "
                         f"{out.shape[1]}x{out.shape[0]} out")
                if payload["backend"] != "torch" or out.shape != img.shape:
                    fail(f"cgan torch backend: {payload['backend']} "
                         f"{out.shape}")
            say(text + f", launches {counts}")
            if status != want_status or any(counts):
                fail(f"cgan torch backend {what}: HTTP {status}, launches "
                     f"{counts}; expected {want_status} and none")
        for fam, u in (("cgan", urls["float"]), ("cgan", urls["int8"]),
                       ("denoise", servers[0][2])):
            status, _ = post_enhance(u, png)
            say(f"  after those, {fam} at {u.split('?')[1]}: HTTP {status}")
            if status != 200:
                fail(f"{fam} after the torch backend's refusals: HTTP "
                     f"{status}")
        # 7. forward times (the served forward with its u8 output on the
        # card) at 256² and 2048²; f32 also with cuDNN's default (not
        # deterministic) algorithms, the cost of the deterministic scope
        from celebrity_image_denoiser_tpu_torch.models import cgan as cgan_mod

        scope = cgan_mod.deterministic_cudnn
        for mode, key in (("float", "float"), ("float", "float_nondet"),
                          ("int8", "int8")):
            apply = sts[mode]._apply(KERAS, "kernel")
            cgan_mod.deterministic_cudnn = (contextlib.nullcontext
                                            if key == "float_nondet"
                                            else scope)
            try:
                for side in (CGAN_SIZES[0][0], CGAN_BIG):
                    x = family_input(sts[mode], "cgan",
                                     test_image(side, side, seed=78), device)
                    with torch.inference_mode():
                        ms = time_ms(lambda: sts[mode]._to_u8(KERAS,
                                                              apply(x)),
                                     reps=5, warmup=1)
                    rec[f"{key}_forward_ms_{side}"] = ms
                    say(f"  cgan {key} forward at {side}x{side}: {ms:.3f} "
                        "ms")
                    del x
            finally:
                cgan_mod.deterministic_cudnn = scope
    finally:
        for srv, thread, _ in servers:
            stop_server(srv, thread)
    rows = cgan_k5_times(k5, quant, device)
    tail = cgan_tail_time(conv3x3, device)
    say(f"  phase 4f: {time.perf_counter() - t_phase:.1f} s; kernel launches "
        f"held: {f32_holds.n} K2 (f32, worst {f32_holds.worst:.2e} x "
        f"max|ref|), {k5_holds.n} K5 (bit-equal); /enhance launches K2 "
        f"{totals[0]} K3 {totals[1]} K5 {totals[2]} K6 {totals[3]}")
    return totals, rec, rows, tail, f32_holds.worst


def cgan_k5_times(k5, quant, device="cuda"):
    """The three rewritten 4×4 stride-2 layers at a ``CGAN_BIG``² input
    (batch 1): the rewrite on the card bit-equal to the direct integer
    conv; K5's launch timed beside its plain version, ``torch._int_mm`` at
    its im2col GEMM shape and its bound (operations at 1979 TOP/s, dense
    int8, or bytes at 3.35 TB/s); the whole rewrite (with its space-to-depth
    or depth-to-space copy) and cuDNN's f32 conv of the same layer (TF32
    off) beside it; the useful operations' bound and the MACs the rewrite
    issues per useful one."""
    import torch.nn.functional as F

    gen = make_gen()
    s = CGAN_BIG
    rows, f32_rows = [], []
    for layer, transposed, (c_in, c_out, side) in (
            ("model.2 conv 64->128", False, (64, 128, s // 2)),
            ("model.5 convT 128->128", True, (128, 128, s // 4)),
            ("model.8 convT 128->64", True, (128, 64, s // 2))):
        x = s8_rand(gen, (1, c_in, side, side))
        ws = (torch.rand(c_out, generator=gen, device=device) + 0.5) * 1e-4
        if transposed:
            w = s8_rand(gen, (c_in, c_out, 4, 4))
            w3, ws3 = quant.d2s_convt4x4_weight(w), ws.repeat(4)
            xk = x.permute(0, 2, 3, 1).contiguous()
            rewrite = lambda: quant.d2s_convt4x4_s8(x, w3, ws3)  # noqa: E731
            direct = lambda: direct_convt_s8(x, w, ws, 2, 1)  # noqa: E731
            xf, wf = x.float(), w.float()
            cudnn = lambda: F.conv_transpose2d(  # noqa: E731
                xf, wf, stride=2, padding=1)
            useful = 2 * side * side * 4 * 4 * c_in * c_out
            f32_rows.append((layer, xf, wf, cudnn))
        else:
            w = s8_rand(gen, (c_out, c_in, 4, 4))
            w3, ws3 = quant.s2d_conv4x4_weight(w), ws
            h2 = side // 2
            xk = quant.space_to_depth(x)
            rewrite = lambda: quant.s2d_conv4x4_s8(x, w3, ws3)  # noqa: E731
            direct = lambda: direct_conv_s8(x, w, ws, 2, 1)  # noqa: E731
            xf, wf = x.float(), w.float()
            cudnn = lambda: F.conv2d(xf, wf, stride=2,  # noqa: E731
                                     padding=1)
            useful = 2 * h2 * h2 * 4 * 4 * c_in * c_out
        args = (xk, w3, ws3)
        with torch.inference_mode():
            got = rewrite()
            ref = direct()
            torch.cuda.synchronize()
            if got.shape != ref.shape or not torch.equal(got, ref):
                fail(f"cgan {layer}: the rewrite differs from the direct "
                     "integer conv")
            check_int8("k5", layer, tuple(xk.shape) + (int(w3.shape[0]),),
                       k5.conv3x3_s8(*args), k5.conv3x3_s8_plain(*args))
            ms = time_ms(lambda: k5.conv3x3_s8(*args), 10)
            whole = time_ms(rewrite, 10)
            plain = time_ms(lambda: k5.conv3x3_s8_plain(*args), 2, 1)
            mm = int_mm_ms("k5", args, {})
            lib = time_ms(cudnn, 10)
        n, h, wd, cin = xk.shape
        cout = int(w3.shape[0])
        ops = 2 * n * h * wd * 9 * cin * cout
        nbytes = xk.numel() + w3.numel() + 4 * cout + 4 * n * h * wd * cout
        b = bound_ms(ops, nbytes, PEAK_INT8_OPS)
        by = ("operations" if ops / PEAK_INT8_OPS >= nbytes / PEAK_BYTES
              else "bytes")
        b_useful = bound_ms(useful, nbytes, PEAK_INT8_OPS)
        rows.append({"layer": layer, "k5_shape": [n, h, wd, cin, cout],
                     "ms": ms, "rewrite_ms": whole, "plain_ms": plain,
                     "int_mm_ms": mm, "cudnn_f32_ms": lib, "bound_ms": b,
                     "bound_by": by, "useful_bound_ms": b_useful,
                     "mac_overhead": ops / useful})
        say(f"  k5 cgan {layer:24s} K5 {str((n, h, wd, cin, cout)):26s} "
            f"{ms:.3f} ms (rewrite {whole:.3f}) plain {plain:.3f} _int_mm "
            f"{mm:.3f} cuDNN f32 {lib:.3f} bound {b:.4f} ({by}; useful ops "
            f"{b_useful:.4f}) {ops / useful:.2f}x MACs, "
            f"{useful / ms / 1e9:.1f} useful TOP/s, {b_useful / ms:.1%} of "
            f"the useful bound ({b / ms:.1%} of the issued)")
        del x, xk, got, ref
    # the f32 transpose convs: cuDNN's default algorithms (not
    # deterministic), its deterministic ones, and the phased 3×3 conv the
    # f32 kernel route runs
    from celebrity_image_denoiser_tpu_torch.models.cgan import (
        CGANKerasGenerator,
    )

    probe = CGANKerasGenerator().to(device).eval()
    for layer, xf, wf, cudnn in f32_rows:
        conv = torch.nn.ConvTranspose2d(wf.shape[0], wf.shape[1], 4, 2, 1,
                                        device=device)
        with torch.no_grad():
            conv.weight.copy_(wf)
            conv.bias.zero_()
        phased = lambda: probe._phased(layer, conv, xf)  # noqa: E731
        with torch.inference_mode():
            ref = cudnn()
            got = phased()
            err = ((got - ref).abs().max() / ref.abs().max()).item()
            twice = torch.equal(got, phased())
            ms = time_ms(phased, 10)
            lib = time_ms(cudnn, 10)
            with torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                            deterministic=True,
                                            allow_tf32=False):
                lib_det = time_ms(cudnn, 3, 1)
        row = next(r for r in rows if r["layer"] == layer)
        row.update(f32_phased_ms=ms, cudnn_f32_det_ms=lib_det,
                   f32_phased_err=err)
        say(f"  f32 cgan {layer:24s} phased 3x3 conv {ms:.3f} ms (vs cuDNN "
            f"{err:.2e} x max|ref|, same twice {twice}); cuDNN transpose "
            f"{lib:.3f} ms, deterministic {lib_det:.3f} ms")
        if err > TOL[torch.float32] or not twice:
            fail(f"cgan f32 {layer}: the phased conv is {err:.2e} x max|ref| "
                 f"off cuDNN's transpose conv, or differs from itself")
        del got, ref
    del f32_rows
    return rows


def cgan_tail_time(conv3x3, device="cuda"):
    """K2 in f32 on the cGAN's tail (64 -> 3, bias, no ReLU: the narrow
    body) at a ``CGAN_BIG``² input: checked against its plain
    version, timed on the device's clock beside it, beside cuDNN (TF32 off)
    and beside its bound (``f32_bounds``)."""
    import torch.nn.functional as F

    gen = torch.Generator(device=device).manual_seed(SEED)
    s = CGAN_BIG
    x = torch.randn((1, s, s, 64), generator=gen, device=device)
    wt = torch.randn((3, 3, 64, 3), generator=gen, device=device) / 24.0
    b = torch.randn((3,), generator=gen, device=device) * 0.1
    xc = x.permute(0, 3, 1, 2).contiguous()
    wo = wt.permute(3, 2, 0, 1).contiguous()
    with torch.inference_mode():
        got = conv3x3.conv3x3_bias_relu(x, wt, b, relu=False)
        ref = conv3x3.conv3x3_bias_relu_plain(x, wt, b, relu=False)
        err = (got - ref).abs().max().item() / ref.abs().max().item()
        if err > TOL[torch.float32]:
            fail(f"cgan tail K2: {err:.2e} x max|ref| off plain")
        ms = device_ms(lambda: conv3x3.conv3x3_bias_relu(x, wt, b,
                                                         relu=False))
        plain = time_ms(lambda: conv3x3.conv3x3_bias_relu_plain(
            x, wt, b, relu=False), 10)
        lib = time_ms(lambda: F.conv2d(xc, wo, b, padding=1), 10)
    flops = 2 * s * s * 9 * 64 * 3
    nbytes = 4 * (x.numel() + wt.numel() + 3 + s * s * 3)
    bnd, by, old = f32_bounds(flops, nbytes)
    before = NARROW_BEFORE_MS["cgan tail model.11"]
    say(f"  f32 conv3x3_bias_relu cgan tail model.11 (1, {s}, {s}, 64, 3) "
        f"{ms:.3f} ms plain {plain:.3f} cuDNN {lib:.3f} bound {bnd:.3f} "
        f"({by}), {bnd / ms:.1%} of bound; CUDA-core bound {old:.3f} "
        f"({old / ms:.1%}); {err:.2e} x max|ref|; the replaced narrow body "
        f"{before} ms, {before / ms:.2f}x this")
    return {"layer": "cgan tail model.11", "shape": [1, s, s, 64, 3],
            "ms": ms, "plain_ms": plain, "library_ms": lib, "bound_ms": bnd,
            "bound_by": by, "cuda_core_bound_ms": old, "max_rel_err": err}


def bound_ms(flops, nbytes, peak_flops):
    return max(flops / peak_flops, nbytes / PEAK_BYTES) * 1e3


def phase_bench(conv3x3, double_conv, k5, k6, bench, worst):
    import torch.nn.functional as F

    say(f"== phase 5: bench (batch {BENCH_BATCH}) and kernel times")
    # per step kind: the agreement probe, the warm-up step, the timed ones
    steps = 2 + bench.N_ITERS
    int8_counts(conv3x3, double_conv, k5, k6, reset=True)
    _, rungs = bench.main(batch=BENCH_BATCH)
    n1, n3, n5, n6 = int8_counts(conv3x3, double_conv, k5, k6)
    for r in rungs:
        say(f"  rung {r['rung']:13s} " + (
            f"builder failed: {r['error']}" if not r["built"] else
            (f"gate {r['db']:.2f} dB, " if r["db"] is not None else "")
            + (f"{r['rate']:.1f} images/s" if r["rate"] else "not measured")))
    if len(rungs) < 2 or rungs[1]["rung"] != "int8-s8skip" \
            or rungs[1]["rate"] is None:
        fail("bench: the int8-s8skip rung did not pass its gate")
    say(f"  bench launches over {steps} bf16 and {steps} int8 steps: "
        f"double_conv {n3} conv3x3 {n1} conv3x3_s8 {n5} convt2x2_s8 {n6}")
    want = (4 * steps, 2 * steps + steps, 9 * steps, 2 * steps)
    if (n3, n1, n5, n6) != want:
        fail(f"bench: launches {(n3, n1, n5, n6)}, expected {want}")
    launches = {"conv3x3_bias_relu": n1, "double_conv3x3_relu": n3,
                "conv3x3_s8": n5, "convt2x2_s8": n6}
    layer_ms = {}  # bf16 kernel ms per layer, for phase 5b
    gen = make_gen()
    dt = torch.bfloat16
    n, h, w = BENCH_BATCH, bench.SIZE, bench.SIZE
    stats = {}

    def add(name, ms, plain, lib, flops, nbytes):
        s = stats.setdefault(name, {"ms": 0.0, "plain_ms": 0.0,
                                    "library_ms": 0.0, "bound_ms": 0.0,
                                    "operations": 0.0, "bytes": 0.0,
                                    "per_step": 0})
        s["per_step"] += 1
        ops_ms = flops / PEAK_BF16_FLOPS * 1e3
        bytes_ms = nbytes / PEAK_BYTES * 1e3
        s["ms"] += ms
        s["plain_ms"] += plain
        s["library_ms"] += lib
        s["bound_ms"] += max(ops_ms, bytes_ms)
        # each launch's bound is credited to the side that sets it
        s["operations" if ops_ms >= bytes_ms else "bytes"] += max(
            ops_ms, bytes_ms)

    def nchw(t):
        return t.permute(0, 3, 1, 2)

    def oihw(k):
        return k.permute(3, 2, 0, 1).contiguous()

    for layer, shape in pair_shapes(n, h, w).items():
        x, w1, b1, w2, b2 = pair_inputs(gen, shape, dt)
        _, hh, ww, c0, c1, c2 = shape
        k1, k2, bb1, bb2 = oihw(w1), oihw(w2), b1.to(dt), b2.to(dt)
        # upconv2 takes its input as the model gives it: two tensors
        xa, xb = halves(x) if layer == "upconv2" else (x, None)
        worst["double_conv3x3_relu"] = max(
            worst["double_conv3x3_relu"],
            check("double_conv3x3_relu", layer, shape, dt,
                  double_conv.double_conv3x3_relu(xa, w1, b1, w2, b2, x2=xb),
                  double_conv.double_conv3x3_relu_plain(x, w1, b1, w2, b2)))
        ms = time_ms(lambda: double_conv.double_conv3x3_relu(
            xa, w1, b1, w2, b2, x2=xb))
        plain = time_ms(lambda: double_conv.double_conv3x3_relu_plain(
            x, w1, b1, w2, b2))
        lib = time_ms(lambda: F.relu(F.conv2d(
            F.relu(F.conv2d(nchw(x), k1, bb1, padding=1)), k2, bb2, padding=1)))
        flops = 2 * n * hh * ww * 9 * (c0 * c1 + c1 * c2)
        nbytes = 2 * (x.numel() + w1.numel() + w2.numel() + n * hh * ww * c2) \
            + 4 * (c1 + c2)
        add("double_conv3x3_relu", ms, plain, lib, flops, nbytes)
        layer_ms[layer] = ms
        if xb is not None:
            cat = time_ms(lambda: double_conv.double_conv3x3_relu(
                torch.cat([xa, xb], dim=3), w1, b1, w2, b2))
            say(f"  double_conv3x3_relu {layer:10s} two inputs {ms:.3f} ms; "
                f"torch.cat + one input {cat:.3f} ms")
        bound = bound_ms(flops, nbytes, PEAK_BF16_FLOPS)
        say(f"  double_conv3x3_relu {layer:10s} {str(shape):30s} kernel "
            f"{ms:.3f} ms plain {plain:.3f} ms cudnn {lib:.3f} ms bound "
            f"{bound:.3f} ms: {flops / ms / 1e9:.1f} TFLOP/s useful, "
            f"{bound / ms:.1%} of the bound, {lib / ms:.2f}x cudnn's speed")
    for layer, shape in single_shapes(n, h, w).items():
        (x, k, b), relu = single_inputs(gen, shape, dt)
        _, hh, ww, cin, cout, _ = shape
        ko, bb = oihw(k), b.to(dt)
        act = F.relu if relu else (lambda t: t)
        # upconv1.0 takes its input as the model gives it: two tensors
        xa, xb = halves(x) if layer == "upconv1.0" else (x, None)
        worst["conv3x3_bias_relu"] = max(
            worst["conv3x3_bias_relu"],
            check("conv3x3_bias_relu", layer, shape, dt,
                  conv3x3.conv3x3_bias_relu(xa, k, b, relu=relu, x2=xb),
                  conv3x3.conv3x3_bias_relu_plain(x, k, b, relu=relu)))
        ms = time_ms(lambda: conv3x3.conv3x3_bias_relu(
            xa, k, b, relu=relu, x2=xb))
        plain = time_ms(lambda: conv3x3.conv3x3_bias_relu_plain(
            x, k, b, relu=relu))
        lib = time_ms(lambda: act(F.conv2d(nchw(x), ko, bb, padding=1)))
        flops = 2 * n * hh * ww * 9 * cin * cout
        nbytes = 2 * (x.numel() + k.numel() + n * hh * ww * cout) + 4 * cout
        add("conv3x3_bias_relu", ms, plain, lib, flops, nbytes)
        layer_ms[layer] = ms
        if xb is not None:
            cat = time_ms(lambda: conv3x3.conv3x3_bias_relu(
                torch.cat([xa, xb], dim=3), k, b, relu=relu))
            say(f"  conv3x3_bias_relu   {layer:10s} two inputs {ms:.3f} ms; "
                f"torch.cat + one input {cat:.3f} ms")
        bound = bound_ms(flops, nbytes, PEAK_BF16_FLOPS)
        say(f"  conv3x3_bias_relu   {layer:10s} {str(shape):30s} kernel "
            f"{ms:.3f} ms plain {plain:.3f} ms cudnn {lib:.3f} ms bound "
            f"{bound:.3f} ms: {flops / ms / 1e9:.1f} TFLOP/s useful, "
            f"{bound / ms:.1%} of the bound, {lib / ms:.2f}x cudnn's speed")
    for name, s in stats.items():
        say(f"  {name}: {s['per_step']} launches per step, kernel "
            f"{s['ms']:.3f} ms, plain {s['plain_ms']:.3f} ms, cudnn "
            f"{s['library_ms']:.3f} ms, bound {s['bound_ms']:.3f} ms per step "
            f"({s['bound_ms'] / s['ms']:.1%} of the bound)")
    return stats, launches, layer_ms


def int_mm_ms(kind, args, kw):
    """A yardstick for K5/K6, where no PyTorch call computes the same
    function: ``torch._int_mm`` (s8 x s8 -> s32, no epilogue) at the layer's
    GEMM shape — K6's [N·H·W, Cin] x [Cin, 4·Cout], K5's im2col
    [N·H·W, 9·Cin] x [9·Cin, Cout] with the im2col built before the timed
    region.  None where _int_mm does not take the shape (Cout < 8) or for
    K2.  The port never calls it."""
    import torch.nn.functional as F

    if kind == "k6":
        x, w = args[0], args[1]
        cin = x.shape[3]
        a = x.reshape(-1, cin)
        b = w.reshape(-1, cin).t()  # [Cin, 4·Cout], column-major
    elif kind == "k5":
        x, w = args[0], args[1]
        if kw.get("x2") is not None:
            x = torch.cat([x, kw["x2"]], dim=3)
        n, h, wd, cin = x.shape
        if w.shape[0] < 8:
            return None
        xp = F.pad(x, (0, 0, 1, 1, 1, 1))
        a = torch.cat([xp[:, dy:dy + h, dx:dx + wd] for dy in range(3)
                       for dx in range(3)], dim=3).reshape(-1, 9 * cin)
        del xp
        b = w.reshape(w.shape[0], -1).t()  # [9·Cin, Cout], (tap, cin) rows
    else:
        return None
    ms = time_ms(lambda: torch._int_mm(a, b), reps=10)
    del a, b
    return ms


def phase_int8_times(conv3x3, k5, k6, layer_ms):
    """Each int8 kernel at the int8 step's shapes, beside its plain version
    and its bound, and beside the bf16 kernel of the same layers."""
    import torch.nn.functional as F

    say(f"== phase 5b: int8 kernel times (batch {BENCH_BATCH}, 128²)")
    gen = make_gen()
    stats = {}
    int8_ms = {}
    for layer, (kind, shape) in int8_layers(BENCH_BATCH, 128, 128).items():
        args, kw = int8_inputs(gen, kind, shape)
        fn = int8_entry(kind, conv3x3, k5, k6)
        plain_fn = int8_entry(kind, conv3x3, k5, k6, plain=True)
        ms = time_ms(lambda: fn(*args, **kw), reps=10)
        plain = time_ms(lambda: plain_fn(*args, **kw), reps=2, warmup=1)
        x = args[0]
        if kind == "q8":
            n, h, w, cin, cout = shape
            ops = 2 * n * h * w * 9 * cin * cout
            nbytes = 2 * x.numel() + n * h * w * cout + 2 * args[1].numel()
            peak = PEAK_BF16_FLOPS  # bf16 products
        elif kind == "k5":
            n, h, w, ca, cb, cout, _, out = shape
            ops = 2 * n * h * w * 9 * (ca + cb) * cout
            nbytes = (n * h * w * (ca + cb) + args[1].numel()
                      + n * h * w * cout * (1 if out == "s8" else 2))
            peak = PEAK_INT8_OPS
        else:
            n, h, w, cin, cout, _ = shape
            ops = 2 * n * h * w * cin * 4 * cout
            nbytes = x.numel() + args[1].numel() + n * 4 * h * w * cout
            peak = PEAK_INT8_OPS
        ops_ms, bytes_ms = ops / peak * 1e3, nbytes / PEAK_BYTES * 1e3
        bound = max(ops_ms, bytes_ms)
        name = {"q8": "conv3x3_bias_relu_q8", "k5": "conv3x3_s8",
                "k6": "convt2x2_s8"}[kind]
        s = stats.setdefault(name, {"ms": 0.0, "plain_ms": 0.0,
                                    "bound_ms": 0.0, "operations": 0.0,
                                    "bytes": 0.0, "per_step": 0})
        s["per_step"] += 1
        s["ms"] += ms
        s["plain_ms"] += plain
        s["bound_ms"] += bound
        s["operations" if ops_ms >= bytes_ms else "bytes"] += bound
        int8_ms[layer] = ms
        lib = ""
        if kind == "k6":  # the bf16 step's transpose conv is a cuDNN call
            xb = rnd(gen, (n, cin, h, w), torch.bfloat16).contiguous(
                memory_format=torch.channels_last)
            wb = rnd(gen, (cin, cout, 2, 2), torch.bfloat16, cin ** -0.5)
            bb = rnd(gen, (cout,), torch.bfloat16)
            lib = (f"; bf16 step's cuDNN conv_transpose "
                   f"{time_ms(lambda: F.conv_transpose2d(xb, wb, bb, stride=2)):.3f} ms")
            del xb, wb, bb
        mm = int_mm_ms(kind, args, kw)
        if mm is not None:
            s["int_mm_ms"] = s.get("int_mm_ms", 0.0) + mm
            lib += f"; s8 GEMM without epilogue (torch._int_mm) {mm:.3f} ms"
        say(f"  {name:20s} {layer:13s} {str(shape):42s} kernel {ms:.3f} ms "
            f"plain {plain:.3f} ms bound {bound:.3f} ms "
            f"({'operations' if ops_ms >= bytes_ms else 'bytes'}): "
            f"{ops / ms / 1e9:.1f} TOP/s useful, {bound / ms:.1%} of the "
            f"bound{lib}")
        del args, kw
        torch.cuda.empty_cache()
    torch.cuda.empty_cache()
    # beside the bf16 kernels of the same layers (phase 5, same shapes)
    pairs = {"down1": ("down1.0", "down1.2"), "down2": ("down2.0", "down2.2"),
             "bottleneck": ("bottleneck.0", "bottleneck.2"),
             "upconv2": ("upconv2.0", "upconv2.2"),
             "upconv1.0": ("upconv1.0",), "upconv1.2": ("upconv1.2",)}
    for bf16_layer, convs in pairs.items():
        i8 = sum(int8_ms[c] for c in convs)
        say(f"  layer {bf16_layer:11s} int8 {i8:.3f} ms ({' + '.join(convs)})"
            f" vs bf16 {layer_ms[bf16_layer]:.3f} ms: "
            f"{layer_ms[bf16_layer] / i8:.2f}x")
    for name, s in stats.items():
        say(f"  {name}: {s['per_step']} launches per int8 step, kernel "
            f"{s['ms']:.3f} ms, plain {s['plain_ms']:.3f} ms, bound "
            f"{s['bound_ms']:.3f} ms per step ({s['bound_ms'] / s['ms']:.1%} "
            "of the bound)" + (f", torch._int_mm {s['int_mm_ms']:.3f} ms"
                               if "int_mm_ms" in s else ""))
    return stats


def phase_big_batch(bench):
    from celebrity_image_denoiser_tpu_torch.models.denoise_unet import (
        _BF16_2_OVER_255,
        DenoiseGenerator,
    )

    say(f"== phase 6: one forward at batch {BIG_BATCH} (bf16) vs plain")
    model = DenoiseGenerator(generator=torch.Generator().manual_seed(SEED))
    model = model.to(device="cuda", dtype=torch.bfloat16).eval()
    gen = make_gen()
    x = torch.randint(0, 256, (BIG_BATCH, bench.SIZE, bench.SIZE, 3),
                      generator=gen, dtype=torch.uint8, device="cuda")
    x = (x.to(torch.bfloat16) * _BF16_2_OVER_255 - 1.0).permute(0, 3, 1, 2)
    with torch.inference_mode():
        got = model(x)
        ref = model(x, route="plain")
    check("DenoiseGenerator", f"b{BIG_BATCH}", tuple(x.shape),
          torch.bfloat16, got, ref)


# Each hand-written kernel's device functions (``csrc/``), by the wrapper
# module whose launch counter counts them: a profiled window must name as
# many records of each as the counters made in it.
KERNEL_RECORDS = {
    "K2": ("conv3x3_wgmma_kernel", "conv3x3_narrow_kernel",
           "conv3x3_f32_narrow_kernel", "conv3x3_tf32_kernel"),
    "K3": ("double_conv3x3_wgmma_kernel", "double_conv3x3_tf32_kernel"),
    "K4": ("noise_batch_kernel",),
    "K5": ("conv3x3_s8_wgmma_kernel", "conv3x3_s8_narrow_kernel"),
    "K6": ("convt2x2_s8_kernel",),
    "K7": ("mdta_attention_kernel",),
    "K8": ("dwconv3x3_f32_kernel",),
    "K9": ("pointwise_gemm_kernel",),
}
_KERNEL_OF = {name: k for k, names in KERNEL_RECORDS.items()
              for name in names}
# a name as it stands in a demangled record: "(anonymous
# namespace)::conv3x3_wgmma_kernel<32, 4, false>(...)"; never a suffix of a
# longer name (double_conv3x3_wgmma_kernel)
_RECORD_NAME = re.compile(r"(?:^|[\s:])(" + "|".join(_KERNEL_OF)
                          + r")\s*[<(]")
# a synchronise and a host sleep after a profiled window opens, before its
# work: the profiler's start-up otherwise lands in the first launches and
# in the wall (on an H100 a bf16 bench step's window read 20.6 ms of wall
# with neither, 24.9 with the sleep alone, 16.3 with both, for the same
# 14.9-15.0 ms of device time)
PROFILE_LEAD_S = 0.2
# chip_smoke.py PROFILE_CHILD <group>: one group of profiled windows in a
# process of its own (see profile_child)
PROFILE_CHILD = "--profile-windows"


def kernel_of(record: str):
    """The kernel (K2...K9) a device record belongs to, or None."""
    m = _RECORD_NAME.search(record)
    return _KERNEL_OF[m.group(1)] if m else None


def launch_counters() -> dict:
    """Every kernel wrapper's launch count now, by kernel."""
    from celebrity_image_denoiser_tpu_torch.ops.cuda import (
        channel_attention,
        conv3x3,
        conv3x3_s8,
        convt2x2_s8,
        double_conv,
        dwconv3x3,
        noise,
        pointwise_gemm,
    )

    return {"K2": conv3x3.LAUNCHES, "K3": double_conv.LAUNCHES,
            "K4": noise.LAUNCHES + noise.GAUSSIAN_LAUNCHES,
            "K5": conv3x3_s8.LAUNCHES, "K6": convt2x2_s8.LAUNCHES,
            "K7": channel_attention.LAUNCHES, "K8": dwconv3x3.LAUNCHES,
            "K9": pointwise_gemm.LAUNCHES}


def zero_counters() -> None:
    """Every kernel wrapper's launch count set to 0."""
    from celebrity_image_denoiser_tpu_torch.ops.cuda import (
        channel_attention,
        conv3x3,
        conv3x3_s8,
        convt2x2_s8,
        double_conv,
        dwconv3x3,
        noise,
        pointwise_gemm,
    )

    for m in (channel_attention, conv3x3, conv3x3_s8, convt2x2_s8,
              double_conv, dwconv3x3, noise, pointwise_gemm):
        m.LAUNCHES = 0
    noise.GAUSSIAN_LAUNCHES = 0


def trace_records(events) -> tuple:
    """From a Chrome trace's events: the kernels' records by kernel, and the
    least (kernel start − its launch call's start) in µs, which is below 0
    only where the card's and the host's clocks disagree."""
    records = {k: 0 for k in KERNEL_RECORDS}
    launch = {e.get("args", {}).get("correlation"): e["ts"] for e in events
              if e.get("cat") == "cuda_runtime" and "ts" in e}
    lead = None
    for e in events:
        if e.get("cat") != "kernel":
            continue
        k = kernel_of(str(e.get("name")))
        if k:
            records[k] += 1
        t = launch.get(e.get("args", {}).get("correlation"))
        if t is not None:
            lead = e["ts"] - t if lead is None else min(lead, e["ts"] - t)
    return records, lead


def check_records(label, records, launches) -> None:
    """Print each kernel's records against its launches in a window; fail
    where they differ."""
    whole = all(records[k] == launches[k] for k in KERNEL_RECORDS)
    held = ", ".join(f"{k} {records[k]}/{launches[k]}"
                     for k in KERNEL_RECORDS if records[k] or launches[k])
    say(f"  {label}: kernel records / launches {held or 'none / none'}"
        f" ({'whole' if whole else 'RECORDS MISSING'})")
    if not whole:
        fail(f"{label}: the profile names {records} for the launches "
             f"{launches}")


def profiled(label, fn, top: int = 10, expect=None):
    """``fn()`` and a synchronise under ``torch.profiler`` (CPU and CUDA),
    after a lead-in (a synchronise and ``PROFILE_LEAD_S`` of host sleep)
    that the wall does not count.
    The window's kernel records are held against the launch counters'
    deltas over it (and ``expect``, a dict of kernel: launches, where
    given): a window that names fewer records than were launched fails the
    script.  Then the window's device busy share, its hand-written kernels'
    device time and its top kernels are printed.  Returns (fn's result,
    wall ms of fn, a dict: ``records``, ``launches``, ``busy_ms`` and
    ``kernel_ms`` by kernel).

    A window is whole only as a process's first profiler session or soon
    after it (``PERF.md`` §6): later sessions of the same process
    lose kernel records, more the longer the process has profiled.  So the
    checked windows run in a fresh process each (``profile_child``)."""
    import tempfile

    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    before = launch_counters()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        time.sleep(PROFILE_LEAD_S)
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    after = launch_counters()
    launches = {k: after[k] - before[k] for k in KERNEL_RECORDS}
    if expect is not None and any(launches[k] != expect.get(k, 0)
                                  for k in KERNEL_RECORDS):
        fail(f"{label}: launched {launches}, expected {expect}")
    with tempfile.TemporaryDirectory(prefix="cid_prof_") as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    _, lead = trace_records(events)
    from torch.autograd import DeviceType

    from celebrity_image_denoiser_tpu_torch.utils.profiling import SPANS

    records = {k: 0 for k in KERNEL_RECORDS}
    kernel_ms = {k: 0.0 for k in KERNEL_RECORDS}
    rows = []  # device-side events only, so no kernel is counted twice
    for ev in prof.key_averages():
        # a span's device-side range covers the kernels it launched
        if ev.device_type != DeviceType.CUDA or ev.key in SPANS:
            continue
        k = kernel_of(ev.key)
        dev_us = getattr(ev, "self_device_time_total",
                         getattr(ev, "self_cuda_time_total", 0.0))
        if k:
            records[k] += ev.count
            kernel_ms[k] += dev_us / 1e3
        if dev_us > 0:
            rows.append((dev_us / 1e3, ev.count, ev.key))
    lead_s = "none" if lead is None else f"{lead:.1f} us"
    check_records(f"{label} (least kernel start after its launch call "
                  f"{lead_s})", records, launches)
    info = {"records": records, "launches": launches}
    busy = sum(r[0] for r in rows)
    if not rows:
        say("  profiler saw no device time: not measured")
        return out, wall, info
    info.update(busy_ms=busy, kernel_ms=kernel_ms)
    mine = ", ".join(f"{k} {ms:.3f} ms ({ms / busy:.1%})"
                     for k, ms in kernel_ms.items() if launches[k])
    say(f"  wall {wall:.3f} ms, device busy {busy:.3f} ms "
        f"({busy / wall:.1%} of the wall; idle {1 - busy / wall:.1%}); "
        f"the hand-written kernels: {mine or 'none'}")
    for ms, count, key in sorted(rows, reverse=True)[:top]:
        say(f"  {ms:9.3f} ms {ms / busy:6.1%} x{count:<3d} {key[:90]}")
    return out, wall, info


def bench_windows(tmp: str) -> list:
    """Phase 7's windows, one bench step at batch ``BENCH_BATCH`` in bf16 and
    on the s8 program (random weights), and phase 11's, one bf16 train step
    of ``cli.train``'s denoise trainer at ``TRAIN_SIZE``², batch
    ``TRAIN_BATCH``, its images written to ``tmp``: (label, fn, expected
    launches, top rows)."""
    from celebrity_image_denoiser_tpu_torch import bench
    from celebrity_image_denoiser_tpu_torch.cli import train as cli_train
    from celebrity_image_denoiser_tpu_torch.data.synthetic import (
        calibration_batch,
    )
    from celebrity_image_denoiser_tpu_torch.models.denoise_unet import (
        DenoiseGenerator,
        serve_step,
    )
    from celebrity_image_denoiser_tpu_torch.ops.quant_unet import (
        quantize_apply_denoise_unet,
    )

    model = DenoiseGenerator(generator=torch.Generator().manual_seed(SEED))
    model = model.to(device="cuda").eval()
    prog = quantize_apply_denoise_unet(model, calibration_batch(True).cuda())
    model = model.to(torch.bfloat16)
    x = torch.randint(0, 256, (BENCH_BATCH, bench.SIZE, bench.SIZE, 3),
                      dtype=torch.uint8, device="cuda")
    imgs = write_train_pngs(tmp)
    tr = cli_train.build_trainer(cli_train.build_parser().parse_args([
        "--model", "denoise", "--clean-dir", tmp, "--image-size",
        str(TRAIN_SIZE), str(TRAIN_SIZE), "--batch-size", str(TRAIN_BATCH),
        "--num-epochs", "1", "--compute-dtype", "bfloat16",
        "--checkpoint-dir", f"{tmp}/ckpt"]))
    batch = torch.from_numpy(imgs[:TRAIN_BATCH]).cuda()
    return [("bf16 bench step", lambda: serve_step(model, x),
             {"K2": 2, "K3": 4}, 14),
            ("int8-s8skip bench step", lambda: bench.int8_step(prog, x),
             {"K2": 1, "K5": 9, "K6": 2}, 14),
            # one noise_batch launch; the step's convs are PyTorch's
            ("bf16 train step", lambda: tr.step_fn(
                tr.opt, None, batch, tr.noise_gen, 1e-4, 1e-4), {"K4": 1},
             12)]


def family_windows(tmp: str) -> list:
    """Phase 4e's windows on the shipped weights: dncnn's served forward at
    256², batch 1, in f32 and on its int8 rung, and at one ``FAMILY_TILE``²
    tile in f32, then srgan's at
    ``SRGAN_BIG``² LR in f32 and int8 (its first call, the warm-up, gives
    the forward's time and peak memory); ``tmp`` unused."""
    from celebrity_image_denoiser_tpu_torch.serve.handlers import ServeState

    sts = {"float": ServeState(device="cuda",
                               tile_threshold_rows=FAMILY_THRESHOLD),
           "int8": ServeState(device="cuda", quantize="int8",
                              tile_threshold_rows=FAMILY_THRESHOLD)}
    windows = []
    img = test_image(256, 256, seed=61)
    for mode, st in sts.items():
        rung = sts["int8"].ladder("dncnn") if mode == "int8" else "f32"
        expect = ({"K2": F32_PER_FORWARD["dncnn"][0],
                   "K3": F32_PER_FORWARD["dncnn"][1]} if mode == "float"
                  else {"K5": K5_PER_FORWARD[("dncnn", rung)]})
        apply = st._apply("dncnn", "kernel")
        x = family_input(st, "dncnn", img)

        def fwd(st=st, apply=apply, x=x):
            with torch.inference_mode():
                return st._to_u8("dncnn", apply(x))

        windows.append((f"dncnn {rung} forward at 256x256", fwd, expect, 8))
    # dncnn's f32 forward at one FAMILY_TILE² tile: its K2 launch is the
    # narrow body at the cGAN tail's shape
    st, side = sts["float"], FAMILY_TILE
    apply = st._apply("dncnn", "kernel")
    x = family_input(st, "dncnn", test_image(side, side, seed=61))

    def fwd_tile():
        with torch.inference_mode():
            return st._to_u8("dncnn", apply(x))

    windows.append((f"dncnn f32 forward at {side}x{side}", fwd_tile,
                    {"K2": F32_PER_FORWARD["dncnn"][0],
                     "K3": F32_PER_FORWARD["dncnn"][1]}, 8))
    big = family_input(sts["float"], "srgan", test_image(
        SRGAN_BIG, SRGAN_BIG, seed=62))
    for mode, st in sts.items():
        rung = sts["int8"].ladder("srgan") if mode == "int8" else "f32"
        expect = ({"K2": F32_PER_FORWARD["srgan"][0]} if mode == "float"
                  else {"K5": K5_PER_FORWARD[("srgan", rung)]})
        windows.append((f"srgan {rung} {SRGAN_BIG}x{SRGAN_BIG} LR forward",
                        lambda st=st: st._forward("srgan", big), expect, 8))
    return windows


def profile_child(group: str) -> int:
    """``chip_smoke.py PROFILE_CHILD <group>``: the group's profiled windows
    (``bench_windows``, ``family_windows``), each called once to warm up
    (its time, peak memory and output shape recorded), then each in a
    checked ``profiled`` window: the process's first profiler sessions,
    back to back.  The last line is the results' JSON."""
    import tempfile

    from celebrity_image_denoiser_tpu_torch.ops.cuda import _build

    _build.library()
    with tempfile.TemporaryDirectory(prefix="cid_prof_") as tmp:
        return _profile_windows(
            {"bench": bench_windows, "families": family_windows,
             "restormer": restormer_windows}[group](tmp))


def _profile_windows(windows) -> int:
    out = {}
    for label, fn, _, _ in windows:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        y = fn()
        torch.cuda.synchronize()
        out[label] = {"warm_s": time.perf_counter() - t0,
                      "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
                      "shape": list(getattr(y, "shape", ()))}
        del y
    for label, fn, expect, top in windows:
        zero_counters()  # a fresh process: nothing else counts them
        _, wall, info = profiled(label, fn, top=top, expect=expect)
        out[label].update({"wall_ms": wall, **{
            k: info.get(k) for k in ("records", "launches", "busy_ms",
                                     "kernel_ms")}})
    print(json.dumps({"profile_windows": out}), flush=True)
    return 0


def profile_in_child(group: str, timeout: float = 300.0) -> dict:
    """``profile_child(group)`` in a fresh process, its lines relayed; fails
    where the child failed.  The card's cached memory is released first."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    script = os.path.abspath(__file__)
    r = subprocess.run([sys.executable, script, PROFILE_CHILD, group],
                       capture_output=True, text=True, timeout=timeout,
                       cwd=os.path.dirname(script))
    lines = r.stdout.splitlines()
    for line in lines[:-1]:
        say(line)
    if r.returncode != 0 or not lines or "profile_windows" not in lines[-1]:
        say(lines[-1] if lines else "")
        say(r.stderr[-4000:])
        fail(f"the {group} profile windows' process exited {r.returncode}")
    say(f"  ({group}: a fresh process, {time.perf_counter() - t0:.1f} s)")
    return json.loads(lines[-1])["profile_windows"]


def phase_profile():
    """Phase 7 (and phase 11's window): ``bench_windows`` in a fresh
    process, each window checked (``profiled``)."""
    say(f"== phase 7: profile of one bench step, bf16 and int8 (batch "
        f"{BENCH_BATCH}); phase 11's bf16 train step")
    return profile_in_child("bench")


# ---------------------------------------------------------------------------
# the training slice
def check_noise(label, dtype, got, ref) -> float:
    """A noise kernel's output against its plain version: bit-equal (the
    same stream and the same float operations, logf/cosf/sqrtf the
    libdevice functions torch.log/cos/sqrt call)."""
    torch.cuda.synchronize()
    if got.shape != ref.shape or got.dtype != ref.dtype:
        fail(f"noise kernel {label}: {tuple(got.shape)} {got.dtype} vs "
             f"{tuple(ref.shape)} {ref.dtype}")
    err = (got.float() - ref.float()).abs().max().item()
    equal = bool(torch.equal(got, ref))
    ok = (equal and bool(torch.isfinite(got.float()).all())
          and got.min().item() >= -1.0 and got.max().item() <= 1.0)
    say(f"  {label:58s} {str(dtype):14s} max_abs_err {err:.3e} "
        f"{'bit-equal' if equal else 'NOT EQUAL'} {'ok' if ok else 'FAIL'}")
    if not ok:
        fail(f"noise kernel {label} {dtype} disagrees with its plain version")
    return err


def noise_inputs(gen, n, types=5):
    """What random_noise_batch draws, on the card: kinds and a seed."""
    kinds = torch.randint(0, types, (n,), generator=gen, device="cuda")
    return kinds, torch.randint(0, 1 << 62, (1,), generator=gen,
                                device="cuda")


def check_noise_batch(noise, label, kinds, seed, x, types=None, variant=1,
                      domain="tanh", first_sample=0) -> float:
    """``noise_batch`` (``kinds`` None: ``blind_noise_batch``) against its
    plain version, noisy and clean bit-equal, and the clean target the
    trainer's ``clean.to(float32) / 255.0`` (``* 2.0 - 1.0`` in [-1, 1]);
    ``x`` samples ``first_sample ..`` of a larger batch."""
    types = tuple(noise.KIND_CODES) if types is None else types
    if kinds is None:
        got = noise.blind_noise_batch(seed, x, domain, first_sample)
        ref = noise.blind_noise_batch_plain(seed, x, domain, first_sample)
        entry = f"blind {domain} "
    else:
        got = noise.noise_batch(kinds, seed, x, types, variant, domain,
                                first_sample)
        ref = noise.noise_batch_plain(kinds, seed, x, types, variant, domain,
                                      first_sample)
        entry = "" if (variant, domain) == (1, "tanh") else \
            f"v{variant} {domain} "
    if first_sample:
        entry += f"first_sample {first_sample} "
    err = check_noise(f"noise_batch noisy {entry}{label}", torch.float32,
                      got[0], ref[0])
    err = max(err, check_noise(f"noise_batch clean {entry}{label}",
                               torch.float32, got[1], ref[1]))
    clean = x.to(torch.float32) / 255.0
    if not torch.equal(got[1], clean if domain == "unit"
                       else clean * 2.0 - 1.0):
        fail("noise_batch's clean target is not the trainer's "
             "clean.to(float32) / 255.0 (* 2.0 - 1.0)")
    if domain == "unit" and got[0].min().item() < 0:
        fail(f"noise_batch {entry}{label}: a value below 0 on [0, 1]")
    return err


def check_first_sample(noise, gen) -> float:
    """The kernel at a first sample (a data-parallel rank's share): rows
    ``k ..`` of the train batch (an even stream offset) and of 5×5×7×3
    samples (105 elements: an odd one, the scalar path), in variants 1–3
    and the blind σ: bit-equal to its plain version and to those rows of
    the launch over the whole batch."""
    worst = 0.0
    for shape, k in (((TRAIN_BATCH, TRAIN_SIZE, TRAIN_SIZE, 3),
                      TRAIN_BATCH // 2), ((5, 5, 7, 3), 3)):
        x = torch.randint(0, 256, shape, generator=gen, dtype=torch.uint8,
                          device="cuda")
        kinds = torch.arange(shape[0], device="cuda") % 5
        seed = torch.randint(0, 1 << 62, (1,), generator=gen, device="cuda")
        share = x[k:].contiguous()
        for variant in (0, 1, 2, 3):
            ks = None if variant == 0 else kinds[k:].contiguous()
            worst = max(worst, check_noise_batch(
                noise, f"{tuple(share.shape)} of {shape}", ks, seed, share,
                variant=max(variant, 1), first_sample=k))
            if variant == 0:
                whole = noise.blind_noise_batch(seed, x, "unit")
                part = noise.blind_noise_batch(seed, share, "unit", k)
            else:
                whole = noise.noise_batch(kinds, seed, x, variant=variant)
                part = noise.noise_batch(ks, seed, share, variant=variant,
                                         first_sample=k)
            if not (torch.equal(part[0], whole[0][k:])
                    and torch.equal(part[1], whole[1][k:])):
                fail(f"noise_batch v{variant} at first_sample {k}: not rows "
                     f"{k}.. of the whole batch's launch")
    say("  noise_batch at a first sample (variants 1-3, blind): bit-equal "
        "to its plain version and to the whole batch's rows")
    return worst


def phase_noise_kernel(noise) -> float:
    say("== phase 8: noise kernel vs plain")
    # the plain version's Philox on the card gives the known answers; the
    # kernel is then held to that stream bit for bit
    for counter, key, want in PHILOX_KAT:
        got = tuple(int(w) for w in noise.philox4x32_10(
            tuple(torch.tensor([c], device="cuda") for c in counter), key))
        say("  philox4x32_10 (plain, on the card) "
            + " ".join(f"{v:08x}" for v in got)
            + (" ok" if got == want else " FAIL"))
        if got != want:
            fail(f"the plain Philox misses a known answer: {got}")
    gen = make_gen()
    worst = 0.0
    # the whole input stage: every kind at the train shape, ragged shapes
    # (chunks across samples), a batch with no gaussian sample, other
    # types, an unaligned view (the scalar path)
    for shape, kinds, types in (
            ((TRAIN_BATCH, TRAIN_SIZE, TRAIN_SIZE, 3), None, None),
            ((5, 9, 7, 3), None, None),
            ((4, 33, 17, 3), [1, 2, 3, 4], None),
            ((3, 20, 12, 4), [1, 0, 1], ("poisson", "salt_pepper"))):
        x = torch.randint(0, 256, shape, generator=gen, dtype=torch.uint8,
                          device="cuda")
        k = (torch.arange(shape[0], device="cuda") % 5 if kinds is None
             else torch.tensor(kinds, device="cuda"))
        seed = torch.randint(0, 1 << 62, (1,), generator=gen, device="cuda")
        worst = max(worst, check_noise_batch(
            noise, f"{shape} kinds {k.tolist()[:6]}", k, seed, x, types))
    worst = max(worst, check_first_sample(noise, gen))
    flat = torch.randint(0, 256, (1 + 3 * 16 * 16 * 3,), generator=gen,
                         dtype=torch.uint8, device="cuda")
    x = flat[1:].view(3, 16, 16, 3)
    worst = max(worst, check_noise_batch(
        noise, "unaligned (3,16,16,3)", torch.tensor([3, 0, 1], device="cuda"),
        torch.tensor([77], device="cuda"), x))
    # the gaussian-only entry (the Pallas counterpart), as before
    for shape in ((TRAIN_BATCH, TRAIN_SIZE, TRAIN_SIZE, 3), (2, 64, 64, 3),
                  (3, 9, 7, 3)):
        x = torch.randint(0, 256, shape, generator=gen, dtype=torch.uint8,
                          device="cuda")
        for dtype in (torch.float32, torch.bfloat16):
            got = noise.fused_normalize_gaussian_noise(1234, x, 25.0, dtype)
            ref = noise.fused_normalize_gaussian_noise_plain(1234, x, 25.0,
                                                             dtype)
            worst = max(worst, check_noise(
                f"fused_normalize_gaussian_noise {shape}", dtype, got, ref))
    # an unaligned view takes the kernel's scalar path
    x = flat[1:1 + 2 * 16 * 16 * 3].view(2, 16, 16, 3)
    worst = max(worst, check_noise(
        "fused_normalize_gaussian_noise unaligned (2,16,16,3)", torch.float32,
        noise.fused_normalize_gaussian_noise(5, x, 25.0, torch.float32),
        noise.fused_normalize_gaussian_noise_plain(5, x, 25.0,
                                                   torch.float32)))
    # moments and determinism on a constant image (255 scale)
    xu = torch.full((2, 64, 64, 3), 128, dtype=torch.uint8, device="cuda")
    o = noise.fused_normalize_gaussian_noise(42, xu, 25.0, torch.float32)
    d = (o - (128 / 255 * 2 - 1)) * 255 / 2
    mean, std = d.mean().item(), d.std().item()
    same = torch.equal(o, noise.fused_normalize_gaussian_noise(
        42, xu, 25.0, torch.float32))
    other = not torch.equal(o, noise.fused_normalize_gaussian_noise(
        43, xu, 25.0, torch.float32))
    say(f"  constant 128: mean {mean:+.3f} std {std:.3f} (255 scale), range "
        f"[{o.min().item():.3f}, {o.max().item():.3f}], same seed identical "
        f"{same}, other seed differs {other}")
    if not (abs(mean) < 1.0 and abs(std - 25.0) < 2.0 and same and other
            and o.min().item() >= -1.0 and o.max().item() <= 1.0):
        fail("noise kernel: moments or determinism off")
    noise_distributions(noise, gen)
    worst = max(worst, phase_noise_modes(noise, gen))
    # beyond 2^31 elements: the last image against the plain version
    n_img = BIG_NOISE_SHAPE[1] * BIG_NOISE_SHAPE[2] * BIG_NOISE_SHAPE[3]
    total = BIG_NOISE_SHAPE[0] * n_img
    big = torch.randint(0, 256, BIG_NOISE_SHAPE, generator=gen,
                        dtype=torch.uint8, device="cuda")
    out = noise.fused_normalize_gaussian_noise(77, big, 25.0, torch.bfloat16)
    torch.cuda.synchronize()
    for label, i in (("first image", 0), ("last image", BIG_NOISE_SHAPE[0] - 1)):
        ref = noise.fused_normalize_gaussian_noise_plain(
            77, big[i:i + 1], 25.0, torch.bfloat16, _index_offset=i * n_img)
        worst = max(worst, check_noise(
            f"fused_normalize_gaussian_noise {total} elements, {label}",
            torch.bfloat16, out[i:i + 1], ref))
    if total <= 2 ** 31:
        fail("the large tensor does not pass 2^31 elements")
    del big, out
    torch.cuda.empty_cache()
    return worst


def noise_distributions(noise, gen) -> None:
    """Each kind of noise_batch on constant images (8 x 64 x 64 x 3): the
    gaussian's σ (25 on the 255 scale) and the speckle's (0.1·x), the
    uniform's mean (12.5 / 255), the salt and pepper rates (1 − e^(−0.06)
    each; salt among the pixels pepper left), and the poisson counts
    against scipy's Poisson by chi-square; each within 4 standard errors or
    p > 1e-3."""
    from scipy import stats

    shape, v = (8, 64, 64, 3), 128
    n = shape[0] * shape[1] * shape[2]
    x = torch.full(shape, v, dtype=torch.uint8, device="cuda")
    seed = torch.randint(0, 1 << 62, (1,), generator=gen, device="cuda")

    def run(kind, xx=x):
        k = torch.full((shape[0],), noise.KIND_CODES[kind], device="cuda")
        return ((noise.noise_batch(k, seed, xx)[0] + 1) / 2).double()

    img = v / 255
    d = (run("gaussian") - img) * 255
    sd = d.std().item()
    se = 25 / (2 * 3 * n) ** 0.5
    say(f"  gaussian σ {sd:.3f} (want 25, ±{4 * se:.3f})")
    sp = (run("speckle") - img).std().item()
    say(f"  speckle σ {sp:.5f} (want {0.1 * img:.5f})")
    um = (run("uniform") - img).mean().item()
    se_u = 25 / 12 ** 0.5 / (3 * n) ** 0.5
    say(f"  uniform mean {um * 255:.4f} / 255 (want 12.5 ± {4 * se_u:.4f})")
    out = run("salt_pepper")
    pepper = (out == 0).all(-1).double().mean().item()
    kept = ~(out == 0).all(-1)
    salt = (out == 1).all(-1)[kept].double().mean().item()
    p = 1 - np.exp(-0.06)
    se_p = (p * (1 - p) / n) ** 0.5
    say(f"  salt & pepper: pepper {pepper:.5f}, salt (of the rest) "
        f"{salt:.5f} (want {p:.5f} ± {4 * se_p:.5f} each)")
    pv = {}
    for lam in (5, 128):
        xl = torch.full(shape, lam, dtype=torch.uint8, device="cuda")
        counts = torch.round(run("poisson", xl) * 255).long().flatten()
        cdf = stats.poisson.cdf(np.arange(255), lam)
        pmf = np.diff(np.concatenate([[0.0], cdf, [1.0]]))
        lo, hi = int(stats.poisson.ppf(1e-3, lam)), int(
            stats.poisson.ppf(1 - 1e-3, lam))
        edges = [0] + list(range(lo + 1, hi + 1)) + [256]
        obs = np.histogram(counts.cpu().numpy(), bins=edges)[0]
        exp = np.array([pmf[a:b].sum() for a, b in zip(edges, edges[1:])])
        pv[lam] = stats.chisquare(obs, exp * counts.numel()).pvalue
    say("  poisson chi-square p: " + ", ".join(
        f"λ {k} {v:.3g}" for k, v in pv.items()))
    if not (abs(sd - 25) < 4 * se + 0.05
            and abs(sp - 0.1 * img) < 0.02 * 0.1 * img
            and abs(um * 255 - 12.5) < 4 * se_u
            and abs(pepper - p) < 4 * se_p and abs(salt - p) < 4 * se_p
            and min(pv.values()) > 1e-3):
        fail("a noise kind's distribution is off")


def phase_noise_modes(noise, gen) -> float:
    """Phase 8's part for the modes the other families train with: variants
    2 and 3 and variant 1 on [0, 1] (every kind, the train shape, ragged,
    straddling and unaligned shapes, a byte of 255 whose poisson counts
    reach 256 in variants 2 and 3) and the blind-σ Gaussian, bit-equal to
    their plain versions in both domains; their distributions; and one
    launch per input-stage call with no host sync."""
    from celebrity_image_denoiser_tpu_torch.data import noise as noise_lib

    worst = 0.0
    flat = torch.randint(0, 256, (1 + 3 * 16 * 16 * 3,), generator=gen,
                         dtype=torch.uint8, device="cuda")
    cases = (((TRAIN_BATCH, TRAIN_SIZE, TRAIN_SIZE, 3), None),
             ((5, 9, 7, 3), None), ((4, 33, 17, 3), [1, 2, 3, 4]),
             ("unaligned", [3, 0, 1]), ((2, 16, 16, 3), [3, 3]))
    for variant, domain in ((1, "unit"), (2, "tanh"), (2, "unit"),
                            (3, "tanh"), (3, "unit"), (None, "tanh"),
                            (None, "unit")):
        for shape, kinds in cases:
            if shape == "unaligned":
                x = flat[1:].view(3, 16, 16, 3)
            elif kinds == [3, 3]:  # poisson at λ 256: counts of 256
                if variant is None:
                    continue
                x = torch.full(shape, 255, dtype=torch.uint8, device="cuda")
            else:
                x = torch.randint(0, 256, shape, generator=gen,
                                  dtype=torch.uint8, device="cuda")
            n = x.shape[0]
            k = (None if variant is None
                 else torch.arange(n, device="cuda") % 5 if kinds is None
                 else torch.tensor(kinds, device="cuda"))
            seed = torch.randint(0, 1 << 62, (1,), generator=gen,
                                 device="cuda")
            label = (f"{tuple(x.shape)}" if k is None
                     else f"{tuple(x.shape)} kinds {k.tolist()[:5]}")
            worst = max(worst, check_noise_batch(
                noise, label, k, seed, x, None, variant or 1, domain))
    noise_mode_distributions(noise, gen)
    # the input stage of each family: one launch a call, no host read
    x = torch.randint(0, 256, (TRAIN_BATCH, 64, 64, 3), generator=gen,
                      dtype=torch.uint8, device="cuda")
    stage_gen = torch.Generator(device="cuda")
    stage_gen.manual_seed(SEED)
    calls = (("random_noise_batch v2 tanh (cgan)", lambda: noise_lib.
              random_noise_batch(stage_gen, x, variant=2)),
             ("random_noise_batch v2 unit (srgan)", lambda: noise_lib.
              random_noise_batch(stage_gen, x, variant=2, domain="unit")),
             ("random_noise_batch v3 unit (esrgan)", lambda: noise_lib.
              random_noise_batch(stage_gen, x, variant=3, domain="unit")),
             ("blind_gaussian_batch unit (dncnn)", lambda: noise_lib.
              blind_gaussian_batch(stage_gen, x)))
    for label, fn in calls:
        torch.cuda.synchronize()
        before = noise.LAUNCHES
        torch.cuda.set_sync_debug_mode("error")
        try:
            for _ in range(3):
                fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
        n = noise.LAUNCHES - before
        say(f"  {label} x3 under set_sync_debug_mode('error'): no host "
            f"sync, noise kernel launches {n}")
        if n != 3:
            fail(f"{label}: {n} launches for 3 calls, expected one a call")
    return worst


def clipped_moments(mu, sigma):
    """Mean and σ of clip(mu + sigma·N(0, 1), 0, 1)."""
    from scipy import integrate, stats

    def moment(k):
        body = integrate.quad(lambda v: v ** k * stats.norm.pdf(
            v, mu, sigma), 0, 1)[0]
        return body + stats.norm.sf(1, mu, sigma)  # the mass clipped to 1

    m1, m2 = moment(1), moment(2)
    return m1, (m2 - m1 * m1) ** 0.5


def noise_mode_distributions(noise, gen) -> None:
    """Each kind of variants 2 and 3 on a constant image of byte 128 (8 x
    64 x 64 x 3 on [0, 1]): the noise's mean and σ against their values
    (the gaussian's and speckle's of the clipped normal; the uniform's
    range; the poisson's x/256 variance) within 4 standard errors and 3%;
    the salt & pepper rates (variant 2: 5% of the elements flip, half to
    salt; variant 3: 0.2% pepper, salt 0.2% of the rest) within 4 standard
    errors; the blind σ of each sample equal to ``blind_sigmas`` within
    4%, and 10^5 of those within [5, 50]/255 about 27.5/255."""
    shape, v = (8, 64, 64, 3), 128
    n = float(np.prod(shape))
    x = torch.full(shape, v, dtype=torch.uint8, device="cuda")
    img = float(noise.x01(x[:1, :1, :1, :1]).item())
    seed = torch.randint(0, 1 << 62, (1,), generator=gen, device="cuda")
    bad = []

    def run(kind, variant):
        k = torch.full((shape[0],), noise.KIND_CODES[kind], device="cuda")
        return noise.noise_batch(k, seed, x, variant=variant,
                                 domain="unit")[0].double()

    def near(label, got, want, tol):
        ok = abs(got - want) <= tol
        say(f"  {label}: {got:.6f} (want {want:.6f} ± {tol:.6f})"
            f"{'' if ok else ' FAIL'}")
        if not ok:
            bad.append(label)

    for variant in (2, 3):
        sig = 25 / 255 if variant == 2 else 0.1
        for kind, (mu, sd) in (
                ("gaussian", clipped_moments(img, sig)),
                ("speckle", clipped_moments(img, img * (0.1 if variant == 2
                                                        else 1.0))),
                ("uniform", (img, (100 / 255 if variant == 2 else 0.1)
                             / 12 ** 0.5)),
                ("poisson", (img, (img / 256) ** 0.5))):
            out = run(kind, variant)
            se = sd / n ** 0.5
            near(f"v{variant} {kind} mean", out.mean().item(), mu,
                 4 * se + 1e-7)
            near(f"v{variant} {kind} σ", out.std().item(), sd,
                 max(4 * sd / (2 * n) ** 0.5, 0.03 * sd))
        out = run("salt_pepper", variant)
        salt = (out == 1).double().mean().item()
        pepper = (out == 0).double().mean().item()
        if variant == 2:
            want_s = want_p = 0.05 * 0.5
        else:
            want_p, want_s = 0.002, 0.002 * (1 - 0.002)
        for label, got, want in (("salt", salt, want_s),
                                 ("pepper", pepper, want_p)):
            near(f"v{variant} salt & pepper {label} rate", got, want,
                 4 * (want * (1 - want) / n) ** 0.5)
    # blind σ: per sample on the constant image, and the stream's σ's
    noisy, clean = noise.blind_noise_batch(seed, x)
    est = (noisy - clean).double().std(dim=(1, 2, 3))
    sig = noise.blind_sigmas(seed, shape[0], "cuda").double()
    worst = ((est - sig).abs() / sig).max().item()
    say(f"  blind σ per sample (255 scale): "
        + ", ".join(f"{v * 255:.2f}" for v in est.tolist())
        + f"; against blind_sigmas at most {worst:.2%} apart")
    if worst > 0.04:
        bad.append("blind σ per sample")
    many = noise.blind_sigmas(seed, 100_000, "cuda").double() * 255
    se = 45 / 12 ** 0.5 / 100_000 ** 0.5
    near("blind σ mean over 10^5 samples (255 scale)", many.mean().item(),
         27.5, 4 * se)
    if many.min().item() < 5 or many.max().item() > 50:
        bad.append("blind σ outside [5, 50]")
    if bad:
        fail(f"noise mode distributions off: {bad}")


def phase_train_check(conv3x3, double_conv):
    from celebrity_image_denoiser_tpu_torch.models.denoise_unet import (
        DenoiseDiscriminator,
        DenoiseGenerator,
    )
    from celebrity_image_denoiser_tpu_torch.train.gan_trainer import (
        make_train_step,
    )

    say("== phase 9: one f32 train step, card vs CPU (4x32x32, TF32 off)")
    rng = np.random.default_rng(SEED)
    clean = rng.uniform(-1, 1, (4, 32, 32, 3)).astype(np.float32)
    noisy = np.clip(clean + rng.normal(0, 0.2, clean.shape), -1,
                    1).astype(np.float32)
    results, opts = {}, {}
    conv3x3.LAUNCHES = 0
    double_conv.LAUNCHES = 0
    for run, dev, dtype in (("cpu", "cpu", torch.float32),
                            ("cuda", "cuda", torch.float32),
                            ("cpu64", "cpu", torch.float64)):
        init = torch.Generator().manual_seed(SEED)
        g = DenoiseGenerator(generator=init).to(dev, dtype)
        d = DenoiseDiscriminator(generator=init).to(dev, dtype)
        before = {k: v.clone() for k, v in g.state_dict().items()}
        init_fn, step_fn = make_train_step(
            g, d, compute_dtype=str(dtype).removeprefix("torch."))
        opts[run] = init_fn()
        out = step_fn(opts[run], torch.from_numpy(noisy).to(dev, dtype),
                      torch.from_numpy(clean).to(dev, dtype), None, 1e-4,
                      1e-4)
        unmoved = [k for k, v in g.state_dict().items()
                   if torch.equal(v, before[k])]
        if unmoved:  # Adam's first step moves every weight with a gradient
            fail(f"train step on {run}: no gradient reached {unmoved}")
        results[run] = (
            {k: float(v) for k, v in out.items()},
            {f"G.{k}": v.cpu() for k, v in g.state_dict().items()}
            | {f"D.{k}": v.cpu() for k, v in d.state_dict().items()})
    if conv3x3.LAUNCHES or double_conv.LAUNCHES:
        fail("the train step launched a conv kernel (it has no backward)")
    (m_cpu, sd_cpu), (m_gpu, sd_gpu) = results["cpu"], results["cuda"]
    gaps = moment_gaps(opts)
    params = adam_param_gap({"opt": opts["cuda"], "params": sd_gpu},
                            {"opt": opts["cpu"], "params": sd_cpu}, 1e-4,
                            moment_allowed(opts))
    for k in ("g_loss", "d_loss"):
        rel = abs(m_gpu[k] - m_cpu[k]) / abs(m_cpu[k])
        say(f"  {k}: card {m_gpu[k]:.7f} cpu {m_cpu[k]:.7f} rel {rel:.2e}")
        if not rel <= 1e-4:
            fail(f"train step: {k} differs between card and CPU")
    stats = max([(sd_gpu[k] - v).abs().max().item()
                 for k, v in sd_cpu.items() if "running_" in k], default=0.0)
    say(f"  BatchNorm running stats max diff {stats:.3e} (tol 1e-4); "
        f"parameters: {param_line(params)}; "
        + "; ".join(f"{w} first moments against f64: worst leaf {v[1]}, "
                    f"card over its bound {v[0]:.3f} (tol 1)"
                    for w, v in gaps.items())
        + f"; psnr card {m_gpu['psnr']:.4f} cpu {m_cpu['psnr']:.4f}; every "
        "generator parameter moved; conv kernel launches 0")
    if not (stats <= 1e-4 and params[0] <= 1.0 and params[4] <= 1.0
            and max(v[0] for v in gaps.values()) <= 1.0):
        fail("train step: state differs between card and CPU")


TRAIN_FAMILIES = ("dncnn", "esrgan", "cgan", "srgan")
CHECK_HW = 32  # phase 9's families: 2 x 32² (srgan 8² LR -> 32² HR)


def param_line(params) -> str:
    """``adam_param_gap``'s tuple as a line."""
    return (f"{params[2]} of {params[3]} weights held to 1e-4 relative, "
            f"ratio {params[0]:.3f} ({params[1]}), the rest {params[4]:.3f} "
            "of 2·lr (tol 1)")


def moment_gaps(opts):
    """{"G"/"D": (worst ratio, leaf, card gap, CPU gap)}: each leaf's first
    moment after the step, on the card and on the CPU in f32, against the
    CPU's in f64 (``compute_dtype="float64"``).  After one Adam step the
    first moment is (1 − b1)·grad: this holds the gradients, which the
    parameters' bound cannot see (every weight moves by about ±lr at step
    1).  A deep BatchNorm net's f32 gradient is only as exact as its
    conditioning allows (dncnn at depth 17 and batch 2 stands up to 3.5e-2
    of a leaf's largest from f64 on the CPU), so the card is held to the
    CPU's own accuracy: its largest |difference| in a leaf within the
    largest of 4× the CPU's, 1e-4 of the leaf's largest f64 value and 1e-5
    of the module's largest (a bias feeding a train-mode BatchNorm has a
    gradient of exactly 0, so both sides hold rounding there, up to 1e-6 of
    it on the CPU).  The gaps are the differences over the leaf's largest
    f64 value, floored at 1e-5 of the module's largest."""
    out = {}
    for name, leaves in moment_leaves(opts).items():
        worst = (-1.0, "", 0.0, 0.0)
        for k, (card, cpu, bound, scale) in leaves.items():
            worst = max(worst, (card / bound, k, card / scale, cpu / scale))
        out[name] = worst
    return out


def moment_leaves(opts) -> dict:
    """{"G"/"D": {leaf: (card gap, CPU f32 gap, bound, scale)}}: each
    leaf's largest |difference| of first moments to the float64 step's, on
    the card and on the CPU, the bound ``moment_gaps`` holds the card's to
    and the leaf's scale (``moment_gaps``)."""
    out = {}
    for i, name in enumerate(("G", "D")):
        ref = opts["cpu64"][i].mu
        if not ref:
            continue
        top = max(v.abs().max().item() for v in ref.values())
        out[name] = {}
        for k, v in ref.items():
            card, cpu = ((opts[dev][i].mu[k].cpu().double() - v).abs().max()
                         .item() for dev in ("cuda", "cpu"))
            big = v.abs().max().item()
            out[name][k] = (card, cpu, max(4 * cpu, 1e-4 * big, 1e-5 * top),
                            max(big, 1e-5 * top))
    return out


def moment_allowed(opts) -> dict:
    """{"G"/"D": {leaf: gap}}: the largest gap between the card's first
    moments and the CPU f32 step's that passing ``moment_gaps`` allows
    (its bound to float64 plus the CPU's own gap), for
    ``adam_param_gap``'s ``allowed``."""
    return {name: {k: bound + cpu for k, (_, cpu, bound, _) in
                   leaves.items()}
            for name, leaves in moment_leaves(opts).items()}


@contextlib.contextmanager
def zeroed_gradient_leaf():
    """A planted fault for the length of a ``with``: every Adam update the
    train steps build takes the gradient of its first leaf as zero.
    Yields the names of the leaves zeroed."""
    from types import SimpleNamespace

    from celebrity_image_denoiser_tpu_torch.train import gan_trainer

    real, zeroed = gan_trainer.optim, []

    def planted(factory):
        def build(*a, **kw):
            init, update = factory(*a, **kw)

            def faulty(grads, state, params, lr):
                first = next(iter(grads))
                zeroed.append(first)
                update({**grads, first: torch.zeros_like(grads[first])},
                       state, params, lr)
            return init, faulty
        return build

    gan_trainer.optim = SimpleNamespace(adam=planted(real.adam),
                                        adam_keras=planted(real.adam_keras))
    try:
        yield zeroed
    finally:
        gan_trainer.optim = real


def family_step(family, run, dev, dtype, noisy, clean, opts):
    """One step of ``family`` from the seeded modules
    (``cli.train.build_modules``) on ``dev`` in ``dtype``; its Adam states
    into ``opts[run]``; returns (metrics, {"G.<leaf>"/"D.<leaf>": tensor on
    the CPU}, the leaves no gradient moved)."""
    from celebrity_image_denoiser_tpu_torch.cli.train import build_modules
    from celebrity_image_denoiser_tpu_torch.train.gan_trainer import (
        make_train_step,
    )

    hw = clean.shape[1]
    g, d, perc = build_modules(family, (hw, hw), sr_scale=4,
                               generator=torch.Generator().manual_seed(SEED))
    mods = {"G": g.to(dev, dtype)}
    if d is not None:
        mods["D"] = d.to(dev, dtype)
    if perc is not None:
        perc.to(dev, dtype)
    before = {k: v.clone() for k, v in g.state_dict().items()}
    init_fn, step_fn = make_train_step(
        g, d, family=family, perceptual=perc,
        compute_dtype=str(dtype).removeprefix("torch."))
    opts[run] = init_fn()
    out = step_fn(opts[run], torch.from_numpy(noisy).to(dev, dtype),
                  torch.from_numpy(clean).to(dev, dtype), None, 1e-4, 1e-4)
    unmoved = [k for k, v in g.state_dict().items()
               if "running_" not in k and "num_batches" not in k
               and torch.equal(v, before[k])]
    return ({k: float(v) for k, v in out.items()},
            {f"{m}.{k}": v.cpu() for m, mod in mods.items()
             for k, v in mod.state_dict().items()}, unmoved)


def adam_eps(family) -> float:
    """The ε of ``family``'s first Adam step in ``adam``'s form: cgan's
    Keras Adam 1e-7 / √(1 − 0.999)."""
    return 1e-7 / (1 - 0.999) ** 0.5 if family == "cgan" else DP_ADAM_EPS


def phase_train_check_families():
    """Phase 9 for the other families: one step of each from the same
    weights and arrays in f32 on the card and on the CPU, and in f64 on the
    CPU, the modules built by ``cli.train.build_modules``; then dncnn's
    card step again with one gradient leaf zeroed, which the bounds must
    catch."""
    from celebrity_image_denoiser_tpu_torch.train.gan_trainer import (
        UNIT_FAMILIES,
    )

    for family in TRAIN_FAMILIES:
        rng = np.random.default_rng(SEED)
        n, hw = 2, CHECK_HW
        clean = rng.uniform(0, 1, (n, hw, hw, 3)).astype(np.float32)
        noisy = np.clip(clean + rng.normal(0, 0.1, clean.shape), 0, 1)
        if family == "srgan":
            noisy = noisy.reshape(n, hw // 4, 4, hw // 4, 4, 3).mean(
                axis=(2, 4))
        if family not in UNIT_FAMILIES:
            noisy, clean = noisy * 2 - 1, clean * 2 - 1
        noisy = noisy.astype(np.float32)
        results, opts = {}, {}
        for run, dev, dtype in (("cpu", "cpu", torch.float32),
                                ("cuda", "cuda", torch.float32),
                                ("cpu64", "cpu", torch.float64)):
            m, sd, unmoved = family_step(family, run, dev, dtype, noisy,
                                         clean, opts)
            if unmoved:
                fail(f"{family} train step on {run}: no gradient reached "
                     f"{unmoved}")
            results[run] = (m, sd)
        (m_cpu, sd_cpu), (m_gpu, sd_gpu) = results["cpu"], results["cuda"]
        rels = {}
        for k in ("g_loss", "d_loss"):
            rels[k] = (abs(m_gpu[k] - m_cpu[k]) / abs(m_cpu[k])
                       if m_cpu[k] else abs(m_gpu[k]))
        stats = max([(sd_gpu[k] - v).abs().max().item()
                     for k, v in sd_cpu.items() if "running_" in k],
                    default=0.0)
        gaps = moment_gaps(opts)
        allowed = moment_allowed(opts)
        ref = {"opt": opts["cpu"], "params": sd_cpu}
        params = adam_param_gap({"opt": opts["cuda"], "params": sd_gpu},
                                ref, 1e-4, allowed, adam_eps(family))
        say(f"  {family}: g_loss card {m_gpu['g_loss']:.7f} cpu "
            f"{m_cpu['g_loss']:.7f} rel {rels['g_loss']:.2e}; d_loss card "
            f"{m_gpu['d_loss']:.7f} cpu {m_cpu['d_loss']:.7f} rel "
            f"{rels['d_loss']:.2e}; BatchNorm stats max diff {stats:.3e}; "
            f"parameters: {param_line(params)}; psnr card "
            f"{m_gpu['psnr']:.4f} cpu {m_cpu['psnr']:.4f}")
        for name, (ratio, leaf, card, cpu) in gaps.items():
            say(f"    {name} first moments (the gradients) against f64: "
                f"worst leaf {leaf}, card gap {card:.2e}, CPU f32 gap "
                f"{cpu:.2e}, card over its bound {ratio:.3f} (tol 1)")
        if not (max(rels.values()) <= 1e-4 and stats <= 1e-4
                and params[0] <= 1.0 and params[4] <= 1.0
                and max(r[0] for r in gaps.values()) <= 1.0):
            fail(f"{family} train step: card and CPU differ")
        if family == "dncnn":  # the planted fault
            with zeroed_gradient_leaf() as zeroed:
                _, sd_bad, _ = family_step(family, "cuda", "cuda",
                                           torch.float32, noisy, clean, opts)
            bad = adam_param_gap({"opt": opts["cuda"], "params": sd_bad},
                                 ref, 1e-4, allowed)
            bad_mu = moment_gaps(opts)["G"]
            say(f"    planted fault, {zeroed[0]}'s gradient zeroed on the "
                f"card: parameters {param_line(bad)}; first moments ratio "
                f"{bad_mu[0]:.3f} ({bad_mu[1]})"
                + ("; caught" if bad[0] > 1.0 else "; NOT caught"))
            if not bad[0] > 1.0:
                fail("phase 9: the parameter bound does not catch a zeroed "
                     "gradient leaf")


def timed_steps(trainer, batch, steps, repeats=3, warmup=3) -> list:
    """Seconds per train step of ``trainer.step_fn`` on a resident batch:
    one figure for each of ``repeats`` windows of ``steps`` steps, sorted."""
    def run(n):
        for _ in range(n):
            trainer.step_fn(trainer.opt, None, batch, trainer.noise_gen,
                            1e-4, 1e-4)
        torch.cuda.synchronize()

    run(warmup)
    secs = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        run(steps)
        secs.append((time.perf_counter() - t0) / steps)
    return sorted(secs)


def phase_train(conv3x3, double_conv, noise):
    import tempfile

    from celebrity_image_denoiser_tpu_torch.cli import train as cli_train
    from celebrity_image_denoiser_tpu_torch.data import noise as noise_lib

    say(f"== phase 10: cli.train at batch {TRAIN_BATCH}, {TRAIN_SIZE}x"
        f"{TRAIN_SIZE}, one epoch")
    launches = gaussian_launches = 0
    step_sec = {}
    trainers = {}
    with tempfile.TemporaryDirectory(prefix="cid_train_") as tmp:
        imgs = write_train_pngs(tmp)
        for cdt in ("bfloat16", "float32"):
            argv = ["--model", "denoise", "--clean-dir", tmp, "--image-size",
                    str(TRAIN_SIZE), str(TRAIN_SIZE), "--batch-size",
                    str(TRAIN_BATCH), "--num-epochs", "1", "--compute-dtype",
                    cdt, "--checkpoint-dir", f"{tmp}/ckpt_{cdt}",
                    "--graph-dir", f"{tmp}/graphs"]
            noise.LAUNCHES = noise.GAUSSIAN_LAUNCHES = 0
            conv3x3.LAUNCHES = double_conv.LAUNCHES = 0
            t0 = time.perf_counter()
            tr = cli_train.run(argv)
            wall = time.perf_counter() - t0
            k4, k4g, k2, k3 = (noise.LAUNCHES, noise.GAUSSIAN_LAUNCHES,
                               conv3x3.LAUNCHES, double_conv.LAUNCHES)
            hist = {k: v[-1] for k, v in tr.metric_history.items() if v}
            say(f"  {cdt}: {tr.steps} steps in {wall:.2f} s (first-use "
                f"set-up included), g_loss {hist.get('g_loss')} d_loss "
                f"{hist.get('d_loss')} psnr {hist.get('psnr')} ssim "
                f"{hist.get('ssim')}; noise kernel launches: noise_batch "
                f"{k4}, gaussian-only entry {k4g} (steps with a gaussian "
                f"sample {tr.steps_with_gaussian}); conv kernel launches "
                f"{k2 + k3}")
            if tr.steps != 4 or len(tr.metric_history["g_loss"]) != 1:
                fail(f"train {cdt}: expected 4 steps and one finite epoch")
            if not all(np.isfinite(v) for v in hist.values()):
                fail(f"train {cdt}: non-finite metrics {hist}")
            if not hist["psnr"] > 5.0:
                fail(f"train {cdt}: PSNR {hist['psnr']} not above 5 dB")
            if k4 != tr.steps:
                fail(f"train {cdt}: noise_batch launches {k4}, expected one "
                     f"per step ({tr.steps})")
            if k4g:
                fail(f"train {cdt}: the gaussian-only entry launched {k4g} "
                     "times while training")
            if k2 or k3:
                fail(f"train {cdt}: conv kernels launched while training")
            launches += k4
            gaussian_launches += k4g
            # the checkpoint resumes with identical parameters
            again = cli_train.build_trainer(
                cli_train.build_parser().parse_args(argv + ["--resume"]))
            if again.start_epoch != 1:
                fail(f"train {cdt}: resume found no checkpoint")
            for a, b in ((tr.generator, again.generator),
                         (tr.discriminator, again.discriminator)):
                for (k, v), w in zip(a.state_dict().items(),
                                     b.state_dict().values()):
                    if not k.endswith("num_batches_tracked") \
                            and not torch.equal(v, w):
                        fail(f"train {cdt}: {k} differs after resume")
            if again.opt[0].step != 4 or not all(
                    torch.equal(v, again.opt[0].nu[k])
                    for k, v in tr.opt[0].nu.items()):
                fail(f"train {cdt}: optimiser state differs after resume")
            # held-out evaluation through the conv kernels
            test = np.stack([tr.pipeline.dataset.get_test(i) for i in
                             range(len(tr.pipeline.dataset.test_paths))])
            clean_u8 = torch.from_numpy(test).cuda()
            noisy, clean, _ = noise_lib.random_noise_batch(make_gen(),
                                                           clean_u8)
            conv3x3.LAUNCHES = double_conv.LAUNCHES = 0
            val = again.evaluate_dataset([(noisy, clean)])
            k2, k3 = conv3x3.LAUNCHES, double_conv.LAUNCHES
            say(f"  {cdt}: resumed at epoch {again.start_epoch} with "
                f"identical state; held-out {tuple(noisy.shape)} psnr "
                f"{val['psnr']:.3f} ssim {val['ssim']:.4f}, launches "
                f"double_conv {k3} conv3x3 {k2}")
            if (k3, k2) != (4, 2) or not np.isfinite(val["psnr"]):
                fail(f"train {cdt}: evaluation launched double_conv {k3} "
                     f"conv3x3 {k2}, expected 4 and 2")
            # steady-state rate on a resident batch (input stage included)
            batch = torch.from_numpy(imgs[:TRAIN_BATCH]).cuda()
            steps = TIMED_STEPS[cdt]
            secs = timed_steps(tr, batch, steps)
            sec = secs[len(secs) // 2]
            say(f"  {cdt}: median {1 / sec:.3f} steps/s, "
                f"{TRAIN_BATCH / sec:.1f} images/s ({sec * 1e3:.2f} ms per "
                f"step); {len(secs)} windows of {steps} steps on a resident "
                "batch, on-the-fly noise included: "
                + ", ".join(f"{1 / v:.3f}" for v in secs[::-1])
                + f" steps/s, spread {(secs[-1] - secs[0]) / sec:.1%} of "
                "the median")
            step_sec[cdt] = sec
            trainers[cdt] = tr
    # every sample through the noise kernel: one launch per call.  A check
    # of its own: these launches are not the training path's
    batch = torch.from_numpy(imgs[:TRAIN_BATCH]).cuda()
    gen = make_gen()
    noise.LAUNCHES = noise.GAUSSIAN_LAUNCHES = 0
    for _ in range(3):
        out, _, kinds = noise_lib.random_noise_batch(gen, batch,
                                                     types=("gaussian",))
    torch.cuda.synchronize()
    say(f"  random_noise_batch(types=('gaussian',)) x3: noise_batch "
        f"launches {noise.LAUNCHES}, gaussian-only entry "
        f"{noise.GAUSSIAN_LAUNCHES}")
    if noise.LAUNCHES != 3 or noise.GAUSSIAN_LAUNCHES \
            or kinds.tolist() != [0] * TRAIN_BATCH \
            or not bool(torch.isfinite(out).all()):
        fail("gaussian-only input stage: expected one noise_batch launch "
             "per call")
    return (launches, gaussian_launches, trainers["bfloat16"], batch,
            step_sec["bfloat16"])


def check_resume(tr, argv, label: str) -> None:
    """The checkpoint that ``cli.train`` run with ``argv`` wrote resumes
    with the trainer's state: modules and the generator's optimiser."""
    from celebrity_image_denoiser_tpu_torch.cli import train as cli_train

    again = cli_train.build_trainer(
        cli_train.build_parser().parse_args(argv + ["--resume"]))
    if again.start_epoch != 1 or again.opt[0].step != tr.steps:
        fail(f"{label}: resume found no checkpoint")
    pairs = [(tr.generator, again.generator)]
    if tr.discriminator is not None:
        pairs.append((tr.discriminator, again.discriminator))
    for a, b in pairs:
        for (k, v), w in zip(a.state_dict().items(), b.state_dict().values()):
            if not k.endswith("num_batches_tracked") and not torch.equal(v, w):
                fail(f"{label}: {k} differs after resume")
    if not all(torch.equal(v, again.opt[0].nu[k])
               for k, v in tr.opt[0].nu.items()):
        fail(f"{label}: optimiser state differs after resume")


def write_train_pngs(tmp, n: int = TRAIN_IMAGES) -> np.ndarray:
    """``n`` synthetic clean images of TRAIN_SIZE² as PNGs in ``tmp``;
    returns them as uint8 NHWC."""
    from celebrity_image_denoiser_tpu_torch.data import imageio
    from celebrity_image_denoiser_tpu_torch.data.synthetic import (
        synth_clean_batch,
    )

    imgs = synth_clean_batch(make_gen(), n, TRAIN_SIZE)
    imgs = (imgs * 255).round().to(torch.uint8).cpu().numpy()
    for i, im in enumerate(imgs):
        with open(f"{tmp}/{i:03d}.png", "wb") as f:
            f.write(imageio.encode_png(im))
    return imgs


# phase 12's timed window per run, seconds
FAMILY_WINDOW_S = 3.0


def phase_train_families(noise):
    """Phase 12: cli.train for the other families at full width."""
    import tempfile

    from celebrity_image_denoiser_tpu_torch.cli import train as cli_train

    say(f"== phase 12: cli.train for {', '.join(TRAIN_FAMILIES)} at full "
        f"width, batch {TRAIN_BATCH}, {TRAIN_SIZE}x{TRAIN_SIZE} (srgan "
        f"{TRAIN_SIZE // 4}x{TRAIN_SIZE // 4} LR), one epoch, bf16 and f32")
    t_phase = time.perf_counter()
    launches, rows = 0, {}
    with tempfile.TemporaryDirectory(prefix="cid_train_families_") as tmp:
        imgs = write_train_pngs(tmp)
        batch = torch.from_numpy(imgs[:TRAIN_BATCH]).cuda()
        for family in TRAIN_FAMILIES:
            for cdt in ("bfloat16", "float32"):
                argv = ["--model", family, "--clean-dir", tmp,
                        "--image-size", str(TRAIN_SIZE), str(TRAIN_SIZE),
                        "--batch-size", str(TRAIN_BATCH), "--num-epochs",
                        "1", "--compute-dtype", cdt, "--checkpoint-dir",
                        f"{tmp}/ckpt_{family}_{cdt}", "--graph-dir",
                        f"{tmp}/graphs"]
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                noise.LAUNCHES = noise.GAUSSIAN_LAUNCHES = 0
                t0 = time.perf_counter()
                tr = cli_train.run(argv)
                wall = time.perf_counter() - t0
                k4 = noise.LAUNCHES
                hist = {k: v[-1] for k, v in tr.metric_history.items() if v}
                if tr.steps != 4 or len(tr.metric_history["g_loss"]) != 1:
                    fail(f"{family} {cdt}: expected 4 steps and one finite "
                         "epoch")
                if not all(np.isfinite(v) for v in hist.values()):
                    fail(f"{family} {cdt}: non-finite metrics {hist}")
                if k4 != tr.steps or noise.GAUSSIAN_LAUNCHES:
                    fail(f"{family} {cdt}: noise kernel launches {k4} (and "
                         f"{noise.GAUSSIAN_LAUNCHES} gaussian-only) for "
                         f"{tr.steps} steps")
                launches += k4
                check_resume(tr, argv, f"{family} {cdt}")
                # steady state on a resident batch, input stage included
                step = functools.partial(tr.step_fn, tr.opt, None, batch,
                                         tr.noise_gen, 1e-4, 1e-4)
                for _ in range(2):
                    step()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(3):
                    step()
                torch.cuda.synchronize()
                est = (time.perf_counter() - t0) / 3
                n_steps = int(min(400, max(3, round(FAMILY_WINDOW_S / est))))
                noise.LAUNCHES = 0
                t0 = time.perf_counter()
                for _ in range(n_steps):
                    m = step()
                torch.cuda.synchronize()
                sec = (time.perf_counter() - t0) / n_steps
                if noise.LAUNCHES != n_steps:
                    fail(f"{family} {cdt}: {noise.LAUNCHES} noise kernel "
                         f"launches in {n_steps} timed steps")
                launches += noise.LAUNCHES
                vals = {k: float(v) for k, v in m.items()
                        if k != "noise_kinds"}
                if not all(np.isfinite(v) for v in vals.values()):
                    fail(f"{family} {cdt}: non-finite metrics {vals}")
                peak = torch.cuda.max_memory_allocated() / 2 ** 30
                rows.setdefault(family, {})[cdt] = {
                    "steps_per_s": 1 / sec, "images_per_s": TRAIN_BATCH / sec,
                    "peak_gib": peak, "timed_steps": n_steps,
                    "epoch_s": wall}
                say(f"  {family} {cdt}: epoch of {tr.steps} steps in "
                    f"{wall:.2f} s (set-up included), g_loss "
                    f"{hist['g_loss']:.5f} d_loss {hist['d_loss']:.5f} psnr "
                    f"{hist['psnr']:.3f} ssim {hist['ssim']:.4f}; noise "
                    f"kernel launches {k4} (one a step); resumed with "
                    f"identical state; {1 / sec:.3f} steps/s "
                    f"({TRAIN_BATCH / sec:.1f} images/s, {n_steps} steps, "
                    f"{noise.LAUNCHES} noise launches); peak "
                    f"{peak:.2f} GiB")
                del tr, step, m
                torch.cuda.empty_cache()
    modes = noise_mode_times(noise)
    say(f"  phase 12: {time.perf_counter() - t_phase:.1f} s")
    return launches, rows, modes


def noise_mode_times(noise) -> list:
    """The noise kernel in each mode the trainers run, at the train batch
    (kinds and seed drawn as the trainer draws them): its time on the
    device's clock beside its plain version and its bytes bound (1 byte
    read and 8 written per element at 3.35 TB/s)."""
    gen = make_gen()
    x = torch.randint(0, 256, (TRAIN_BATCH, TRAIN_SIZE, TRAIN_SIZE, 3),
                      generator=gen, dtype=torch.uint8, device="cuda")
    kinds, seed = noise_inputs(gen, TRAIN_BATCH)
    bound = x.numel() * 9 / PEAK_BYTES * 1e3
    out = []
    for mode, variant, domain in (
            ("v1 tanh (denoise)", 1, "tanh"), ("v2 tanh (cgan)", 2, "tanh"),
            ("v2 unit (srgan)", 2, "unit"), ("v3 unit (esrgan)", 3, "unit"),
            ("v1 unit (dncnn, --noise-variant 1)", 1, "unit"),
            ("blind unit (dncnn)", None, "unit")):
        if variant is None:
            fn = functools.partial(noise.blind_noise_batch, seed, x, domain)
            plain = functools.partial(noise.blind_noise_batch_plain, seed, x,
                                      domain)
        else:
            fn = functools.partial(noise.noise_batch, kinds, seed, x,
                                   tuple(noise.KIND_CODES), variant, domain)
            plain = functools.partial(noise.noise_batch_plain, kinds, seed,
                                      x, tuple(noise.KIND_CODES), variant,
                                      domain)
        got, ref = fn(), plain()
        err = max(check_noise(f"noise_batch {mode} {tuple(x.shape)}",
                              torch.float32, got[i], ref[i]) for i in (0, 1))
        ms = device_ms(fn)
        plain_ms = time_ms(plain)
        say(f"  noise kernel {mode}: {ms:.4f} ms on the device's clock, "
            f"plain {plain_ms:.3f} ms, bound {bound:.5f} ms (bytes), "
            f"{bound / ms:.1%} of it")
        out.append({"mode": mode, "ms": ms, "plain_ms": plain_ms,
                    "bound_ms": bound, "bound_by": "bytes",
                    "max_abs_err": err})
    return out


@functools.lru_cache(maxsize=1)
def max_sm_clock_hz() -> float:
    from celebrity_image_denoiser_tpu_torch.ops.cuda import timing
    try:
        return timing.max_sm_clock_hz()
    except RuntimeError as e:
        fail(str(e))


def device_ms(fn, reps: int = 50) -> float:
    """Mean device time of ``fn`` over ``reps`` calls, back to back on the
    device's clock (``ops/cuda/timing.py``); fails the phase where the host
    could not enqueue them while the card slept."""
    from celebrity_image_denoiser_tpu_torch.ops.cuda import timing
    try:
        return timing.device_ms(fn, reps)
    except RuntimeError as e:
        fail(str(e))


def issue_floor_ms(issue, kinds, x) -> float:
    """The least time the SMs take to issue what this batch's chunks must:
    per sample, its chunks (8 elements a thread, 32 threads a warp) times
    the instructions its kind's chunk issues (phase 2), over 4 warp
    instructions a clock on every SM at the card's highest SM clock."""
    per_warp = x[0].numel() / (NOISE_CHUNK * 32)
    per_kind = list(issue.values())  # in the order of the kind codes
    warp_ins = sum(per_warp * per_kind[k] for k in kinds.tolist())
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return warp_ins / (4 * sms * max_sm_clock_hz()) * 1e3


def phase_train_profile(_build, probes, noise, trainer, batch, step_sec,
                        issue):
    from celebrity_image_denoiser_tpu_torch.data import noise as noise_lib

    say("== phase 11: the input stage's kernel at the train batch, and one "
        "bf16 train step profiled")
    x = batch.contiguous()
    kinds, seed = noise_inputs(make_gen(), TRAIN_BATCH)
    err = check_noise_batch(noise, f"{tuple(x.shape)} (the train batch)",
                            kinds, seed, x)
    # back-to-back calls by events (the host's wrapper time shows where it
    # exceeds the kernel's), and the kernel alone on the device's clock
    # (device_ms): the kernels line's time
    ev_ms = time_ms(lambda: noise.noise_batch(kinds, seed, x), reps=50,
                    warmup=5)
    ms = device_ms(lambda: noise.noise_batch(kinds, seed, x))
    plain = time_ms(lambda: noise.noise_batch_plain(kinds, seed, x))
    nbytes = x.numel() * (1 + 4 + 4)
    bytes_ms = nbytes / PEAK_BYTES * 1e3
    ops_ms = issue_floor_ms(issue, kinds, x)
    stats = {"ms": ms, "plain_ms": plain,
             "bound_ms": max(bytes_ms, ops_ms),
             "bound_by": "operations" if ops_ms > bytes_ms else "bytes",
             "max_abs_err": err}
    say(f"  noise_batch {tuple(x.shape)} kinds {kinds.tolist()}: kernel "
        f"{ms:.4f} ms on the device's clock ({ev_ms:.4f} ms a call back to "
        f"back by events), plain {plain:.3f} ms; bound "
        f"{stats['bound_ms']:.4f} ms by {stats['bound_by']} (bytes "
        f"{bytes_ms:.4f} ms: {nbytes} at 3.35 TB/s; issue {ops_ms:.4f} ms); "
        f"{stats['bound_ms'] / ms:.1%} of the bound; "
        f"{nbytes / ms / 1e6:.1f} GB/s; library: none")
    # the gaussian-only entry at the same batch
    every = torch.zeros_like(kinds)
    g_stats = {}
    for dtype in (torch.float32, torch.bfloat16):
        g_ev = time_ms(lambda: noise.fused_normalize_gaussian_noise(
            1, x, 25.0, dtype), reps=50, warmup=5)
        g_ms = device_ms(lambda: noise.fused_normalize_gaussian_noise(
            1, x, 25.0, dtype))
        g_plain = time_ms(lambda: noise.fused_normalize_gaussian_noise_plain(
            1, x, 25.0, dtype))
        gb = x.numel() * (1 + torch.empty((), dtype=dtype).element_size())
        g_bytes = gb / PEAK_BYTES * 1e3
        g_ops = issue_floor_ms(issue, every, x)
        g_stats[dtype] = {"ms": g_ms, "plain_ms": g_plain,
                          "bound_ms": max(g_bytes, g_ops),
                          "bound_by": ("operations" if g_ops > g_bytes
                                       else "bytes")}
        say(f"  fused_normalize_gaussian_noise {tuple(x.shape)} "
            f"{str(dtype):15s} kernel {g_ms:.4f} ms on the device's clock "
            f"({g_ev:.4f} ms by events), plain {g_plain:.3f} ms; bytes "
            f"{g_bytes:.4f} ms, issue {g_ops:.4f} ms (its chunks as "
            "noise_batch's gaussian ones)")
    # each kind alone (the probes, f32 noisy and clean): where the time goes
    _, table, guide = noise.poisson_tables(x.device)
    y, z = torch.empty(x.shape, device="cuda"), torch.empty(x.shape,
                                                            device="cuda")
    p = 1 - np.exp(-0.06)
    for kind, code in noise.KIND_CODES.items():
        def probe():
            _build.check(probes.cid_noise_issue_probe(
                code, x.data_ptr(), y.data_ptr(), z.data_ptr(),
                seed.data_ptr(), x.numel(), 3, table.data_ptr(),
                guide.data_ptr(), 25.0 / 255.0, 0.1, 25.0 / 255.0, p, p,
                None), "noise_issue_probe")
        k_ms = device_ms(probe)
        k_ops = issue_floor_ms(issue, torch.full_like(kinds, code), x)
        say(f"  one kind, the whole batch: {kind:12s} {k_ms:.4f} ms (issue "
            f"floor {k_ops:.4f} ms, {issue[kind]} instructions a chunk)")
    del y, z
    # the input stage brings nothing to the host: a sync raises here
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(3):
            noise_lib.random_noise_batch(trainer.noise_gen, batch)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    say("  random_noise_batch x3 under torch.cuda.set_sync_debug_mode("
        "'error'): no host sync")
    # the input stage's share of a step (CUDA events around the stage), and
    # the host's time per call (calls back to back: the card waits on it)
    stage = time_ms(lambda: noise_lib.random_noise_batch(
        trainer.noise_gen, batch), reps=20, warmup=3)
    for label, fn in (("noise_batch", lambda: noise.noise_batch(kinds, seed,
                                                                 x)),
                      ("random_noise_batch", lambda: noise_lib.
                       random_noise_batch(trainer.noise_gen, batch))):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(200):
            fn()
        host = (time.perf_counter() - t0) / 200 * 1e3
        torch.cuda.synchronize()
        say(f"  host time per {label} call, 200 back to back: {host:.4f} ms")
    say(f"  input stage (random_noise_batch: draws + one launch) {stage:.4f} "
        f"ms of a {step_sec * 1e3:.3f} ms bf16 step (phase 10's median): "
        f"{stage / (step_sec * 1e3):.2%}")
    say("  one bf16 train step's profile: phase 7, in a fresh process")
    stats["gaussian_only"] = g_stats[torch.float32]
    return stats


# ---------------------------------------------------------------------------
# phase 13: the data layer
DATA_BATCH = 64  # the renderer's batch
# (H, W) of the clean tree's files per person: 256², 300×260, the CelebA
# frame (178 wide, 218 tall) and one odd 255×257; 80 files
DATA_SIZES = {"person0": [(256, 256)] * 30, "person1": [(300, 260)] * 20,
              "person2": [(218, 178)] * 29, "person3": [(255, 257)]}
CELEBA_FRAMES = 8  # raw frames that prepare_clean_dataset crops into the tree
CELEBA_FRAME = (218, 178)  # (H, W) of an aligned CelebA image


def data_rels(root) -> list:
    from celebrity_image_denoiser_tpu_torch.data import imageio

    return sorted(os.path.relpath(p, root) for p in imageio.list_images(root))


def write_data_tree(tmp) -> str:
    """Phase 13's clean tree: DATA_SIZES of synthetic PNGs, one corrupt
    file, and CELEBA_FRAMES raw 178×218 frames put in by
    ``prepare_clean_dataset`` (centre crop, 256² bicubic)."""
    from celebrity_image_denoiser_tpu_torch.data import celeba, imageio
    from celebrity_image_denoiser_tpu_torch.data.synthetic import (
        synth_clean_batch,
    )

    gen = make_gen()

    def synth(n, h, w):
        imgs = synth_clean_batch(gen, n, max(h, w))[:, :h, :w]
        return (imgs * 255).round().to(torch.uint8).cpu().numpy()

    clean = f"{tmp}/clean"
    for person, sizes in DATA_SIZES.items():
        os.makedirs(f"{clean}/{person}")
        for i, img in enumerate(synth(len(sizes), *sizes[0])):
            imageio.imwrite(f"{clean}/{person}/{i:03d}.png", img)
    with open(f"{clean}/person3/broken.png", "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\nnot a png")
    os.makedirs(f"{tmp}/raw/celeb")
    frames = synth(CELEBA_FRAMES, *CELEBA_FRAME)
    for i, img in enumerate(frames):
        imageio.imwrite(f"{tmp}/raw/celeb/{i:03d}.png", img)
    n = celeba.prepare_clean_dataset(f"{tmp}/raw", clean, (TRAIN_SIZE,
                                                           TRAIN_SIZE))
    got = imageio.imread_rgb(f"{clean}/celeb/000.png")
    want = imageio.resize_u8(celeba.center_face_crop(frames[0]),
                             (TRAIN_SIZE, TRAIN_SIZE))
    if n != CELEBA_FRAMES or not np.array_equal(got, want):
        fail(f"prepare_clean_dataset: {n} crops, the first "
             f"{'equal' if np.array_equal(got, want) else 'NOT equal'} to "
             "the crop's bicubic resize")
    return clean


def render(noise, clean, out, extra) -> tuple:
    """``cli.noise_gen`` (on the card) of ``clean`` into ``out``: each call
    of ``noise_batch`` recorded (its arguments and noisy output; the first
    batch's of each type only, to hold them to the plain version) and the
    vals of each ``poisson_v3_exact`` call; the launch count from 0."""
    from celebrity_image_denoiser_tpu_torch.cli import noise_gen
    from celebrity_image_denoiser_tpu_torch.data import noise as noise_lib

    calls, vals = [], []
    real, real_exact = noise.noise_batch, noise_lib.poisson_v3_exact

    def recorded(kinds, seed, x, types, variant, domain):
        noisy, clean_out = real(kinds, seed, x, types, variant, domain)
        first = types not in [c["types"] for c in calls]
        calls.append({"types": types, "variant": variant, "domain": domain,
                      "kinds": kinds, "seed": seed.clone(),
                      "x": x if first else None,
                      "noisy": noisy.clone() if first else None})
        return noisy, clean_out

    def exact(gen, img):
        vals.append(noise_lib.v3_poisson_vals(img))
        return real_exact(gen, img)

    argv = ["--clean-dir", clean, "--out-dir", out, "--image-size",
            str(TRAIN_SIZE), str(TRAIN_SIZE), "--batch", str(DATA_BATCH),
            "--seed", "11"] + extra
    noise.noise_batch, noise_lib.poisson_v3_exact = recorded, exact
    try:
        noise.LAUNCHES = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if noise_gen.main(argv) != 0:
            fail(f"cli.noise_gen {' '.join(extra)} failed")
        sec = time.perf_counter() - t0
        launches = noise.LAUNCHES
    finally:
        noise.noise_batch, noise_lib.poisson_v3_exact = real, real_exact
    return calls, vals, launches, sec


def check_render(noise, clean, out, calls, launches, kinds_per_batch, lr):
    """A render's launches (one per batch and type), its tree, and each
    type's first batch: bit-equal to ``noise_batch_plain`` with the same
    kinds and seed, and its files the truncation of that output (the LR
    downscale first in srgan's layout).  Returns the worst error."""
    from celebrity_image_denoiser_tpu_torch.data import imageio
    from celebrity_image_denoiser_tpu_torch.ops.resize import resize

    rels = [r for r in data_rels(clean) if not r.endswith("broken.png")]
    batches = -(-(len(rels) + 1) // DATA_BATCH)
    if launches != len(calls) or launches != kinds_per_batch * batches:
        fail(f"cli.noise_gen: {launches} noise kernel launches ({len(calls)} "
             f"calls) for {kinds_per_batch} types x {batches} batches")
    dirs = sorted(noise.KIND_CODES) + (["clean_hr"] if lr else [])
    if sorted(os.listdir(out)) != sorted(dirs):
        fail(f"cli.noise_gen: {sorted(os.listdir(out))} under {out}")
    for d in dirs:
        if data_rels(f"{out}/{d}") != rels:
            fail(f"cli.noise_gen: the {d} tree's paths differ from the "
                 "clean tree's")
    err = 0.0
    for kind in sorted({c["types"][0] for c in calls}):
        c = next(c for c in calls if c["types"] == (kind,))
        if c["domain"] != "unit" or c["kinds"].tolist() != \
                [0] * c["x"].shape[0]:
            fail(f"cli.noise_gen {kind}: launched on {c['domain']} with "
                 f"kinds {c['kinds'].tolist()}")
        ref, _ = noise.noise_batch_plain(c["kinds"], c["seed"], c["x"],
                                         c["types"], c["variant"], "unit")
        err = max(err, check_noise(
            f"render v{c['variant']} {kind} {tuple(c['x'].shape)}",
            torch.float32, c["noisy"], ref))
        noisy = c["noisy"] if lr is None else resize(c["noisy"], lr,
                                                     "bicubic")
        want = torch.clamp(noisy * 255.0, 0, 255).to(torch.uint8).cpu()
        for i, rel in enumerate(rels[:c["x"].shape[0]]):
            if not np.array_equal(imageio.imread_rgb(f"{out}/{kind}/{rel}"),
                                  want[i].numpy()):
                fail(f"cli.noise_gen {kind} {rel}: the file is not the "
                     "truncation of the kernel's output")
    return err


def train_data(argv, noise, label) -> dict:
    """``cli.train`` with ``argv`` for one epoch on the card: finite
    metrics, no noise kernel launch, the checkpoint resumed exactly;
    steps/s over the epoch (loading and the checkpoint's save included, the
    trainer's set-up not)."""
    from celebrity_image_denoiser_tpu_torch.cli import train as cli_train

    noise.LAUNCHES = noise.GAUSSIAN_LAUNCHES = 0
    tr = cli_train.build_trainer(cli_train.build_parser().parse_args(
        argv + ["--num-epochs", "1"]))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tr.train()
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    hist = {k: v[-1] for k, v in tr.metric_history.items() if v}
    if tr.steps < 1 or not all(np.isfinite(v) for v in hist.values()):
        fail(f"{label}: {tr.steps} steps, metrics {hist}")
    if noise.LAUNCHES or noise.GAUSSIAN_LAUNCHES:
        fail(f"{label}: {noise.LAUNCHES} noise kernel launches on a path "
             "whose pairs carry their noise")
    check_resume(tr, argv + ["--num-epochs", "1"], label)
    row = {"steps": tr.steps, "steps_per_s": tr.steps / sec,
           "native": tr.pipeline.use_native, "dataset":
           type(tr.pipeline.dataset).__name__}
    say(f"  {label}: {tr.steps} steps in {sec:.2f} s ({row['steps_per_s']:.3f}"
        f" steps/s, loading included; batch assembly "
        f"{'native' if row['native'] else 'python'}), g_loss "
        f"{hist['g_loss']:.5f} psnr {hist['psnr']:.3f}; no noise kernel "
        "launch; resumed with identical state")
    return row


def assembly_rate(pipe, batches: int = 4) -> float:
    """Images/s of the host's batch assembly (decode, resize, stack) over
    the first ``batches`` batches of an epoch's order."""
    idx = pipe._indices()
    t0 = time.perf_counter()
    for b in range(batches):
        pipe._load_batch(idx[b * pipe.batch_size:(b + 1) * pipe.batch_size])
    return batches * pipe.batch_size / (time.perf_counter() - t0)


def phase_data(noise):
    """Phase 13: the data layer on the card."""
    import tempfile

    from celebrity_image_denoiser_tpu_torch.cli import train as cli_train
    from celebrity_image_denoiser_tpu_torch.data import (
        caching,
        datasets,
        imageio,
        native,
    )
    from celebrity_image_denoiser_tpu_torch.data.pipeline import DataPipeline

    say(f"== phase 13: the data layer — cli.noise_gen on the card (one noise "
        f"kernel launch per batch of {DATA_BATCH} and type), cli.train on "
        "disk pairs and caches, the native batch assembly")
    t_phase = time.perf_counter()
    out = {}
    size = (TRAIN_SIZE, TRAIN_SIZE)
    with tempfile.TemporaryDirectory(prefix="cid_data_") as tmp:
        clean = write_data_tree(tmp)
        n_files = len(data_rels(clean))
        sizes = ", ".join(f"{len(v)} of {v[0][0]}x{v[0][1]}"
                          for v in DATA_SIZES.values())
        say(f"  clean tree: {n_files} files ({n_files - 1} decodable: "
            f"{sizes}, {CELEBA_FRAMES} CelebA frames through "
            "prepare_clean_dataset)")
        # 1. variant 1, all five types
        calls, _, launches, sec = render(noise, clean, f"{tmp}/v1",
                                         ["--variant", "1"])
        err = check_render(noise, clean, f"{tmp}/v1", calls, launches, 5,
                           None)
        x = next(c["x"] for c in calls if c["x"] is not None)
        if tuple(x.shape) != (DATA_BATCH, TRAIN_SIZE, TRAIN_SIZE, 3):
            fail(f"render batch {tuple(x.shape)}")
        bound = x.numel() * 9 / PEAK_BYTES * 1e3
        kernel_ms = {}
        for kind in noise.KIND_CODES:
            c = next(c for c in calls if c["types"] == (kind,))
            kernel_ms[kind] = device_ms(functools.partial(
                noise.noise_batch, c["kinds"], c["seed"], x, (kind,), 1,
                "unit"))
        plain_ms = time_ms(functools.partial(
            noise.noise_batch_plain, c["kinds"], c["seed"], x, ("gaussian",),
            1, "unit"))
        rate = (n_files - 1) * 5 / sec
        # where the render's host time goes: a file's decode and resize (the
        # Pillow-exact python path, person1's files), and its PNG encode
        # (the first batch's truncated gaussian output)
        files = [f"{clean}/{r}" for r in data_rels(clean)
                 if r.startswith("person1/")][:8]
        t0 = time.perf_counter()
        for f in files:
            imageio.imread_rgb(f, size)
        read_ms = (time.perf_counter() - t0) / len(files) * 1e3
        c = next(c for c in calls if c["types"] == ("gaussian",))
        imgs = torch.clamp(c["noisy"][:16] * 255.0, 0, 255).to(
            torch.uint8).cpu().numpy()
        t0 = time.perf_counter()
        for img in imgs:
            imageio.encode_png(img)
        encode_ms = (time.perf_counter() - t0) / len(imgs) * 1e3
        h, w, _ = imageio.imread_rgb(files[0]).shape
        say(f"  render host stages: decode + resize of a {h}x{w} file "
            f"{read_ms:.2f} ms, PNG encode of a noisy {TRAIN_SIZE}x"
            f"{TRAIN_SIZE} file {encode_ms:.2f} ms (host numbers)")
        say(f"  render v1: {launches} launches ({len(calls)} calls), "
            f"{rate:.1f} images/s ({(n_files - 1) * 5} files in {sec:.2f} "
            f"s); noise_batch per render launch {tuple(x.shape)} on the "
            f"device's clock: " + ", ".join(
                f"{k} {v:.4f}" for k, v in kernel_ms.items())
            + f" ms; bound {bound:.4f} ms (bytes: {x.numel() * 9} at 3.35 "
            f"TB/s), plain {plain_ms:.3f} ms")
        out["render"] = {"launches": launches, "images_per_s": rate,
                         "ms": kernel_ms, "bound_ms": bound,
                         "plain_ms": plain_ms, "max_abs_err": err,
                         "read_ms": read_ms, "encode_ms": encode_ms}
        # 2. variant 2 in srgan's layout (LR a quarter of the size, clean
        # HR copies), and variant 3, whose poisson takes the per-image scale
        lr = TRAIN_SIZE // 4
        calls2, _, launches2, sec2 = render(
            noise, clean, f"{tmp}/v2", ["--variant", "2", "--lr-size",
                                        str(lr), str(lr)])
        err = max(err, check_render(noise, clean, f"{tmp}/v2", calls2,
                                    launches2, 5, (lr, lr)))
        hr = data_rels(f"{tmp}/v2/clean_hr")
        first = imageio.imread_rgb(f"{tmp}/v2/clean_hr/{hr[0]}")
        resized = imageio.imread_rgb(f"{clean}/{hr[0]}", size)
        if len(hr) != n_files - 1 or np.abs(first.astype(int)
                                            - resized).max() > 1:
            fail("cli.noise_gen --lr-size: clean HR copies")
        calls3, vals, launches3, sec3 = render(noise, clean, f"{tmp}/v3",
                                               ["--variant", "3"])
        err = max(err, check_render(noise, clean, f"{tmp}/v3", calls3,
                                    launches3, 4, None))
        if len(vals) != n_files - 1:
            fail(f"variant 3 poisson: {len(vals)} poisson_v3_exact calls")
        say(f"  render v2 ({lr}x{lr} LR): {launches2} launches, "
            f"{(n_files - 1) * 5 / sec2:.1f} images/s; v3: {launches3} "
            f"launches (poisson through poisson_v3_exact, no launch: vals "
            f"{sorted(set(vals))} over {len(vals)} images), "
            f"{(n_files - 1) * 5 / sec3:.1f} images/s")
        out["render"]["launches"] += launches2 + launches3
        out["render"]["max_abs_err"] = err
        # 3. cli.train on the disk pairs, and srgan on the LR tree
        base = ["--clean-dir", clean, "--image-size", str(TRAIN_SIZE),
                str(TRAIN_SIZE), "--batch-size", str(TRAIN_BATCH),
                "--no-on-the-fly"]
        out["pairs"] = {}
        for cdt in ("bfloat16", "float32"):
            out["pairs"][f"denoise {cdt}"] = train_data(
                base + ["--noisy-dir", f"{tmp}/v1", "--compute-dtype", cdt,
                        "--checkpoint-dir", f"{tmp}/ck_pairs_{cdt}"],
                noise, f"cli.train denoise --no-on-the-fly {cdt}")
        srgan = ["--model", "srgan", "--clean-dir", f"{tmp}/v2/clean_hr",
                 "--noisy-dir", f"{tmp}/v2", "--image-size", str(TRAIN_SIZE),
                 str(TRAIN_SIZE), "--batch-size", str(TRAIN_BATCH),
                 "--no-on-the-fly", "--checkpoint-dir", f"{tmp}/ck_srgan"]
        args = cli_train.build_parser().parse_args(srgan)
        ds = cli_train.build_dataset(args, cli_train.build_config(args))
        if ds[0][0].shape != (lr, lr, 3) or ds[0][1].shape != size + (3,):
            fail(f"srgan pairs: {ds[0][0].shape} / {ds[0][1].shape}")
        out["pairs"]["srgan bfloat16"] = train_data(
            srgan, noise, f"cli.train srgan --no-on-the-fly ({lr}x{lr} LR) "
            "bf16")
        # 4. caches: the npz cache of the rendered pairs, and a .pt tree
        n = caching.build_tensor_cache(f"{tmp}/v1/gaussian", clean,
                                       f"{tmp}/cache", image_size=size)
        pt = f"{tmp}/Pre_dataset/gaussian"
        pairs = datasets.collect_pairs(f"{tmp}/v1", clean, ("speckle",))[:32]
        for i, (noisy_path, clean_path) in enumerate(pairs):
            for side, path in (("noisy", noisy_path), ("clean", clean_path)):
                os.makedirs(f"{pt}/{side}_tensor/p{i % 2}", exist_ok=True)
                arr = imageio.to_float01(imageio.imread_rgb(path, size))
                torch.save(torch.from_numpy(arr).permute(2, 0, 1).contiguous(),
                           f"{pt}/{side}_tensor/p{i % 2}/{i:03d}.pt")
        out["caches"] = {}
        for label, path, kind in (("npz", f"{tmp}/cache",
                                   caching.TensorPairDataset),
                                  (".pt", f"{tmp}/Pre_dataset",
                                   caching.TorchTensorPairDataset)):
            argv = ["--model", "esrgan", "--tensor-cache", path,
                    "--image-size", str(TRAIN_SIZE), str(TRAIN_SIZE),
                    "--batch-size", str(TRAIN_BATCH), "--checkpoint-dir",
                    f"{tmp}/ck_cache_{label}"]
            args = cli_train.build_parser().parse_args(argv)
            ds = cli_train.build_dataset(args, cli_train.build_config(args))
            if not isinstance(ds, kind) or ds.normalized is not False:
                fail(f"--tensor-cache {label}: {type(ds).__name__} "
                     f"normalized {getattr(ds, 'normalized', None)}")
            row = train_data(argv, noise,
                             f"cli.train esrgan --tensor-cache {label}")
            row.update(pairs=len(ds), domain="[0,1]",
                       recorded=ds.domain_recorded)
            made = (f"build_tensor_cache of the v1 gaussian pairs, {n}"
                    if label == "npz" else "torch.save of v1 speckle pairs")
            how = ("recorded in meta.json" if ds.domain_recorded
                   else "assumed (torchvision ToTensor)")
            say(f"  --tensor-cache {label}: {len(ds)} pairs ({made}), domain "
                f"[0, 1] {how}, esrgan's: no remap")
            out["caches"][label] = row
        # 5. the native batch assembly: the port's own build
        try:
            native.load(rebuild=True)
        except RuntimeError as e:
            fail(f"the native loader did not build: {e}")
        old = os.environ.get("CXX")
        os.environ["CXX"] = f"{tmp}/no-such-compiler"
        try:
            native.load(rebuild=True)
            fail("the native loader built with a missing compiler")
        except RuntimeError as e:
            refused = str(e).splitlines()[0]
        try:
            DataPipeline(datasets.CleanImageDataset(clean, size), 4,
                         use_native=True)
            fail("use_native=True ran with a failed build")
        except RuntimeError:
            pass
        finally:
            if old is None:
                del os.environ["CXX"]
            else:
                os.environ["CXX"] = old
        try:
            native.load(rebuild=True)
        except RuntimeError as e:
            fail(f"the native loader did not build again: {e}")
        lib = native._build.output_path().name
        say(f"  native loader: built by g++ ({lib}); a failed build raises "
            f"({refused[:80]}...) and "
            "DataPipeline(use_native=True) refuses before the first batch")
        clean_ds = datasets.CleanImageDataset(clean, size)
        pipe = DataPipeline(clean_ds, TRAIN_BATCH, use_native=True,
                            num_threads=4)
        python = DataPipeline(clean_ds, TRAIN_BATCH, use_native=False)
        order = pipe._indices()
        worst = 0.0
        for b, (got, slow) in enumerate(zip(pipe, python)):
            raws = [r for r in (clean_ds.raw(int(i)) for i in
                                order[b * TRAIN_BATCH:(b + 1) * TRAIN_BATCH])
                    if r is not None]
            raws += raws[:TRAIN_BATCH - len(raws)]
            if got.dtype != torch.uint8 or got.device.type != "cuda":
                fail(f"native clean batch {got.dtype} on {got.device}")
            got, slow = got.cpu().numpy(), slow.cpu().numpy()
            for k, raw in enumerate(raws):
                if not np.array_equal(got[k], native.resize_u8(raw, size)):
                    fail("a native uint8 batch image differs from "
                         "native.resize_u8")
            d = np.abs(got.astype(int) - slow)
            worst = max(worst, d.mean())
            if d.mean() >= 2.0 or d.max() > 30:
                fail(f"native vs the Pillow-exact path: mean {d.mean():.3f}, "
                     f"max {d.max()} counts")
        paired = datasets.PairedImageDataset(f"{tmp}/v1", clean,
                                             image_size=size)
        ppipe = DataPipeline(paired, TRAIN_BATCH, use_native=True,
                             num_threads=4)
        porder = ppipe._indices()
        plain_err = 0.0
        for b, (noisy, cl) in enumerate(ppipe):
            if b == 2:
                break
            part = [int(i) for i in
                    porder[b * TRAIN_BATCH:(b + 1) * TRAIN_BATCH]]
            raws = [paired.raw(i) for i in part]
            for j, side in enumerate((noisy, cl)):
                ref = native.assemble_batch_plain([r[j] for r in raws], size)
                e = float(np.abs(side.cpu().numpy() - ref).max())
                plain_err = max(plain_err, e)
                slow = np.stack([paired[i][j] for i in part])
                d = np.abs(side.cpu().numpy() - slow) * 127.5
                if e > 1e-5 or d.mean() >= 2.0 or d.max() > 30:
                    fail(f"native paired batch: {e:.2e} from the numpy plan, "
                         f"{d.mean():.3f} / {d.max():.1f} counts from the "
                         "Pillow-exact path")
        rates = {"native": assembly_rate(DataPipeline(
            clean_ds, TRAIN_BATCH, use_native=True, num_threads=4)),
            "python": assembly_rate(python),
            # pairs/s, with cli.train's two decode threads
            "paired": assembly_rate(DataPipeline(paired, TRAIN_BATCH,
                                                 use_native=True))}
        say(f"  native clean batches: uint8 on the card, every image equal "
            f"to native.resize_u8; within {worst:.3f} counts (mean) of the "
            f"Pillow-exact path; paired float batches within {plain_err:.2e} "
            f"of the loader's plan in numpy; assembly at {TRAIN_SIZE}x"
            f"{TRAIN_SIZE}, batch "
            f"{TRAIN_BATCH}: native (4 threads) {rates['native']:.1f} "
            f"images/s, python {rates['python']:.1f} images/s; the v1 pairs "
            f"with cli.train's 2 decode threads {rates['paired']:.1f} "
            f"pairs/s; host CPUs {os.cpu_count()} (host numbers)")
        # the on-the-fly trainer over the mixed sizes, native by default
        argv = ["--clean-dir", clean, "--image-size", str(TRAIN_SIZE),
                str(TRAIN_SIZE), "--batch-size", str(TRAIN_BATCH),
                "--num-epochs", "1", "--checkpoint-dir", f"{tmp}/ck_native",
                "--graph-dir", f"{tmp}/graphs"]
        noise.LAUNCHES = noise.GAUSSIAN_LAUNCHES = 0
        tr = cli_train.run(argv)
        k4 = noise.LAUNCHES
        if not tr.pipeline.use_native or tr.steps < 1 or k4 != tr.steps \
                or noise.GAUSSIAN_LAUNCHES \
                or not np.isfinite(tr.metric_history["g_loss"]).all():
            fail(f"cli.train over the native stage: native "
                 f"{tr.pipeline.use_native}, {tr.steps} steps, {k4} noise "
                 "kernel launches")
        check_resume(tr, argv, "cli.train denoise (native)")
        say(f"  cli.train denoise over the mixed sizes: native batch "
            f"assembly, {tr.steps} steps, {k4} noise kernel launches (one a "
            "step), resumed with identical state")
        out["native"] = {"images_per_s": rates, "cpus": os.cpu_count(),
                         "max_plain_err": plain_err, "k4_launches": k4}
    say(f"  phase 13: {time.perf_counter() - t_phase:.1f} s")
    return out


# ---------------------------------------------------------------------------
# phase 14: train to ship
SHIP_IMAGES = 160  # 128 train images after the 20% split: 8 steps of 16
SHIP_STEPS = 8
SHIP_WINDOW = 12  # steps per timed window (extras off / on, remat)
QAT_STEPS, QAT_CHUNK, QAT_BATCH, QAT_SIZE = 100, 50, 32, 128
# a gentle lr for the shipped (already QAT'd) esrgan: at the script's 2e-5,
# 100 steps took its held-out gain from 10.14 to 8.40 dB on the port's draw
# on an H100 and the guard refused, and the JAX script falls alike on the
# same batches (tests/torch_port_qat_witness.py, PERF.md §6); gentler still
# for the 10-step runs: dncnn's fake quant agrees with its float forward at
# only ~20 dB at batch 32 (batch-dynamic scales, in the JAX package too),
# and 10 steps at 2e-6 lost 0.8 dB and were refused
QAT_LR, QAT_LR_SHORT = "2e-6", "2e-7"
EVAL_IMAGES = 16
# (K2, K3) launches per forward of each family's kernel route
EVAL_PER_FORWARD = {"denoise": (2, 4), "dncnn": (1, 8), "esrgan": (16, 0),
                    "srgan": (13, 0)}
ESRGAN_FIXTURE_FLOOR = 4.767  # 70% of weights/esrgan's recorded 6.81 dB


def weights_dir() -> str:
    from celebrity_image_denoiser_tpu_torch.core.config import (
        default_weights_dir,
    )

    return default_weights_dir()


class LogLines(logging.Handler):
    """The records of one logger while attached (``with``)."""

    def __init__(self, name):
        super().__init__(logging.WARNING)
        self.logger = logging.getLogger(name)
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())

    def __enter__(self):
        self.logger.addHandler(self)
        return self

    def __exit__(self, *exc):
        self.logger.removeHandler(self)


def ship_metrics() -> dict:
    """``ms_ssim`` on the card against a CPU float64 evaluation."""
    from celebrity_image_denoiser_tpu_torch.metrics import ms_ssim

    gen = make_gen()
    a = torch.rand((16, 256, 256, 3), generator=gen, device="cuda")
    b = (a + 0.1 * torch.randn(a.shape, generator=gen, device="cuda")
         ).clamp(0, 1)
    errs = []
    for x, y in ((a, b), (a[0, :176, :176], b[0, 40:216, 30:206])):
        got = ms_ssim(x, y).double().cpu()
        ref = ms_ssim(x.double().cpu(), y.double().cpu())
        if got.shape != ref.shape or not bool(torch.isfinite(got).all()):
            fail(f"ms_ssim {tuple(x.shape)}: {got} against {ref}")
        errs.append(float((got - ref).abs().max()))
    if max(errs) > 1e-5:
        fail(f"ms_ssim on the card {errs} off the CPU float64 evaluation")
    ms = time_ms(lambda: ms_ssim(a, b), reps=10)
    say(f"  ms_ssim: 16x256x256x3 and a 176x176 HWC pair within "
        f"{max(errs):.2e} of a CPU float64 evaluation; {ms:.3f} ms a batch")
    return {"max_abs_err": max(errs), "ms": ms}


def step_rates(trainers, batch, steps=SHIP_WINDOW, rounds=2) -> list:
    """Steps/s of each trainer's step on a resident uint8 batch, in turns
    (a, b, a, b, ...): the best of ``rounds`` windows each."""
    best = [0.0] * len(trainers)
    for tr in trainers:  # warm-up
        for _ in range(2):
            tr.step_fn(tr.opt, None, batch, tr.noise_gen, 1e-4, 1e-4)
    for _ in range(rounds):
        for i, tr in enumerate(trainers):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(steps):
                tr.step_fn(tr.opt, None, batch, tr.noise_gen, 1e-4, 1e-4)
            torch.cuda.synchronize()
            best[i] = max(best[i], steps / (time.perf_counter() - t0))
    return best


def ship_extras(conv3x3, double_conv, noise, tmp, imgs) -> dict:
    """``cli.train --extra-metrics batch`` (denoise, esrgan) and the epoch
    extras of a test pair."""
    from celebrity_image_denoiser_tpu_torch.cli import train as cli_train

    out = {"k4": 0, "k2": 0, "k3": 0}
    batch = torch.from_numpy(imgs[:TRAIN_BATCH]).cuda()
    for family in ("denoise", "esrgan"):
        argv = ["--model", family, "--clean-dir", f"{tmp}/clean", "--image-size",
                str(TRAIN_SIZE), str(TRAIN_SIZE), "--batch-size",
                str(TRAIN_BATCH), "--num-epochs", "1", "--compute-dtype",
                "bfloat16", "--graph-dir", f"{tmp}/graphs"]
        noise.LAUNCHES = conv3x3.LAUNCHES = double_conv.LAUNCHES = 0
        tr = cli_train.run(argv + ["--extra-metrics", "batch",
                                   "--checkpoint-dir", f"{tmp}/ck_{family}"])
        k4, convs = noise.LAUNCHES, conv3x3.LAUNCHES + double_conv.LAUNCHES
        hist = {k: v[-1] for k, v in tr.metric_history.items()}
        if tr.steps != SHIP_STEPS or k4 != SHIP_STEPS or convs:
            fail(f"{family} --extra-metrics batch: {tr.steps} steps, {k4} "
                 f"noise kernel launches, {convs} conv kernel launches")
        if not all(np.isfinite(v) for v in hist.values()) or \
                not hist["lpips"] > 0 or not 0 < hist["msssim"] <= 1:
            fail(f"{family} --extra-metrics batch: history {hist}")
        off = cli_train.build_trainer(cli_train.build_parser().parse_args(
            argv + ["--checkpoint-dir", f"{tmp}/ck_off"]))
        noise.LAUNCHES = 0
        on_rate, off_rate = step_rates([tr, off], batch)
        if noise.LAUNCHES != 2 * (2 + 2 * SHIP_WINDOW):
            fail(f"{family}: {noise.LAUNCHES} noise launches in the timed "
                 "windows")
        out["k4"] += k4 + noise.LAUNCHES
        out[family] = {"steps_per_s_extras": on_rate,
                       "steps_per_s_off": off_rate, "lpips": hist["lpips"],
                       "msssim": hist["msssim"]}
        say(f"  cli.train --model {family} --extra-metrics batch, bf16, "
            f"{TRAIN_SIZE}², batch {TRAIN_BATCH}: {tr.steps} steps, lpips "
            f"{hist['lpips']:.5f} msssim {hist['msssim']:.4f}, one noise "
            f"launch a step, no conv kernel; {on_rate:.3f} steps/s with the "
            f"extras, {off_rate:.3f} without")
        del tr, off
        torch.cuda.empty_cache()
    # "epoch": the test pair through generate, once for the extras and once
    # for the test image (a JPEG where PIL is installed, else a warning)
    tr = cli_train.build_trainer(cli_train.build_parser().parse_args(
        ["--clean-dir", f"{tmp}/clean", "--image-size", str(TRAIN_SIZE),
         str(TRAIN_SIZE), "--batch-size", str(TRAIN_BATCH), "--num-epochs",
         "1", "--checkpoint-dir", f"{tmp}/ck_epoch", "--extra-metrics",
         "epoch"]))
    rng = np.random.default_rng(SEED)
    clean = imgs[-1].astype(np.float32) / 127.5 - 1.0
    noisy = np.clip(clean + 0.2 * rng.standard_normal(clean.shape), -1,
                    1).astype(np.float32)
    tr.test_pair = (noisy, clean)
    tr.cfg.test_image_dir = f"{tmp}/test_images"
    noise.LAUNCHES = conv3x3.LAUNCHES = double_conv.LAUNCHES = 0
    with LogLines("cid_torch.train") as log:
        hist = tr.train()
    k2, k3 = conv3x3.LAUNCHES, double_conv.LAUNCHES
    if (k2, k3) != (2 * 2, 2 * 4) or noise.LAUNCHES != SHIP_STEPS:
        fail(f"epoch extras: K2 {k2}, K3 {k3} (want 4, 8: two forwards), "
             f"noise {noise.LAUNCHES}")
    if not (hist["lpips"][-1] > 0 and 0 < hist["msssim"][-1] <= 1):
        fail(f"epoch extras: {hist}")
    try:  # the denoise family's test image is a PIL JPEG
        import PIL  # noqa: F401
        has_pil = True
    except ImportError:
        has_pil = False
    image = f"{tmp}/test_images/testimg_epoch0.jpg"
    if os.path.exists(image) != has_pil or has_pil == any(
            "not installed" in line for line in log.lines):
        fail(f"the test image: PIL {'present' if has_pil else 'missing'}, "
             f"file {os.path.exists(image)}, warnings {log.lines}")
    out["k4"] += noise.LAUNCHES
    out["k2"] += k2
    out["k3"] += k3
    out["epoch"] = {"lpips": hist["lpips"][-1], "msssim": hist["msssim"][-1]}
    say(f"  GANTrainer(extra_metrics='epoch', test_pair=256²): lpips "
        f"{hist['lpips'][-1]:.5f} msssim {hist['msssim'][-1]:.4f}; K3 {k3} "
        f"+ K2 {k2} (two forwards: the extras and the test image, "
        f"{'written' if has_pil else 'not written: no PIL, one warning'})")
    del tr
    torch.cuda.empty_cache()
    return out


def ship_remat(noise, tmp, imgs) -> dict:
    """One f32 step with and without ``remat`` from the same state; then
    esrgan's bf16 step at the train shape: peak memory and steps/s."""
    from celebrity_image_denoiser_tpu_torch.cli import train as cli_train
    from celebrity_image_denoiser_tpu_torch.train import gan_trainer

    def step(family, remat):
        g, d, p = cli_train.build_modules(
            family, (64, 64), generator=torch.Generator().manual_seed(SEED))
        g = g.cuda()
        d = None if d is None else d.cuda()
        gen = make_gen()
        lo = 0.0 if family in gan_trainer.UNIT_FAMILIES else -1.0
        clean = torch.rand((2, 64, 64, 3), generator=gen,
                           device="cuda") * (1 - lo) + lo
        noisy = (clean + 0.1 * torch.randn(clean.shape, generator=gen,
                                           device="cuda")).clamp(lo, 1)
        init, step_fn = gan_trainer.make_train_step(
            g, d, family=family, remat=remat, perceptual=p)
        # lr 1e-4: a weight whose gradient is ~0 moves ±lr by the sign
        # cuDNN's atomics give it (adam_param_gap's rest)
        opt = init()
        m = step_fn(opt, noisy, clean, None, 1e-4, 1e-4)
        sd = {f"G.{k}": v.detach().clone() for k, v in g.state_dict().items()}
        if d is not None:
            sd.update({f"D.{k}": v.detach().clone()
                       for k, v in d.state_dict().items()})
        return float(m["g_loss"]), {"opt": opt, "params": sd}

    def gaps(plain, run, allowed):
        """The worst first-moment ratio to ``allowed`` and
        ``adam_param_gap``'s tuple of ``run`` against ``plain``."""
        mu = max((((b.mu[k] - v).abs().max().item() / allowed[w][k], k)
                  for w, a, b in zip(("G", "D"), plain["opt"], run["opt"])
                  for k, v in a.mu.items()), default=(0.0, ""))
        return mu, adam_param_gap(run, plain, 1e-4, allowed,
                                  adam_eps(family))

    out = {}
    for family in ("dncnn", "esrgan", "cgan"):
        (l0, s0), (l1, s1) = step(family, False), step(family, True)
        rel = abs(l1 - l0) / abs(l0)
        stats = max(float((s0["params"][k].double()
                           - s1["params"][k].double()).abs().max())
                    for k in s0["params"] if "running" in k)
        # remat recomputes the same forward: its gradients are the plain
        # step's but for the order of cuDNN's sums; each leaf's first
        # moments within 1e-4 of its largest and 1e-5 of the module's
        allowed = {}
        for w, st in zip(("G", "D"), s0["opt"]):
            if st.mu:
                top = max(v.abs().max().item() for v in st.mu.values())
                allowed[w] = {k: max(1e-4 * v.abs().max().item(), 1e-5 * top)
                              for k, v in st.mu.items()}
        mu, params = gaps(s0, s1, allowed)
        if rel > 1e-5 or stats > 1e-6 or mu[0] > 1.0 or params[0] > 1.0 \
                or params[4] > 1.0:
            fail(f"{family} remat: g_loss {rel:.2e} rel, BN stats {stats:.2e}"
                 f", first moments ratio {mu[0]:.3f} ({mu[1]}), parameters "
                 f"{param_line(params)} off the plain step")
        out[family] = {"loss_rel": rel, "bn_stats": stats, "mu": mu[0],
                       "params": params}
        say(f"  {family} f32 step, remat against plain: g_loss {rel:.2e} "
            f"rel, BN running stats {stats:.2e}, first moments ratio "
            f"{mu[0]:.3f} ({mu[1]}), parameters: {param_line(params)}")
        if family == "dncnn":  # the planted fault, in the remat step
            with zeroed_gradient_leaf() as zeroed:
                _, bad = step(family, True)
            mu, params = gaps(s0, bad, allowed)
            out["fault"] = {"leaf": zeroed[0], "mu": mu[0], "params": params}
            say(f"  planted fault, {zeroed[0]}'s gradient zeroed in the "
                f"remat step: first moments ratio {mu[0]:.3f}, parameters "
                f"{param_line(params)}"
                + ("; caught" if params[0] > 1.0 else "; NOT caught"))
            if not params[0] > 1.0:
                fail("phase 14: the parameter bound does not catch a zeroed "
                     "gradient leaf")
    batch = torch.from_numpy(imgs[:TRAIN_BATCH]).cuda()
    argv = ["--model", "esrgan", "--clean-dir", f"{tmp}/clean", "--image-size",
            str(TRAIN_SIZE), str(TRAIN_SIZE), "--batch-size",
            str(TRAIN_BATCH), "--compute-dtype", "bfloat16",
            "--checkpoint-dir", f"{tmp}/ck_remat"]
    noise.LAUNCHES = 0
    for remat in (False, True):
        tr = cli_train.build_trainer(cli_train.build_parser().parse_args(
            argv + (["--remat"] if remat else [])))
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        (rate,) = step_rates([tr], batch)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        key = "remat" if remat else "plain"
        out["esrgan_bf16_" + key] = {"steps_per_s": rate, "peak_gib": peak}
        say(f"  esrgan bf16 {TRAIN_SIZE}² batch {TRAIN_BATCH}, {key}: "
            f"{rate:.3f} steps/s, peak {peak:.2f} GiB")
        del tr
    out["k4"] = noise.LAUNCHES
    torch.cuda.empty_cache()
    return out


def ship_fake_quant(k5) -> dict:
    """``fake_quant`` on the card: tests/test_quant.py:695's check against
    the int8 program, the shipped dncnn's agreement, skip-all, STE."""
    from celebrity_image_denoiser_tpu_torch.ckpt.convert import (
        load_npz_state_dict,
    )
    from celebrity_image_denoiser_tpu_torch.data.synthetic import (
        calibration_batch,
    )
    from celebrity_image_denoiser_tpu_torch.models.dncnn import DnCNN
    from celebrity_image_denoiser_tpu_torch.ops import quant

    calib = calibration_batch(False, 32).cuda()
    x = calib[:4].permute(0, 3, 1, 2)
    out = {}
    small = DnCNN(depth=5, generator=torch.Generator().manual_seed(SEED))
    shipped = DnCNN()
    shipped.load_state_dict(load_npz_state_dict(
        os.path.join(weights_dir(), "dncnn"), module=shipped), strict=False)
    for label, m in (("DnCNN(depth=5)", small), ("shipped dncnn", shipped)):
        m = m.cuda().eval()
        with torch.no_grad():
            yf = m(x, route="autograd")
            with quant.fake_quant():
                yfq = m(x, route="autograd")
            with quant.fake_quant(skip=lambda w: True):
                y_id = m(x, route="autograd")
        k5.LAUNCHES = 0
        yq = quant.quantize_apply(m, calib)(calib[:4]).permute(0, 3, 1, 2)
        if k5.LAUNCHES < 1:
            fail(f"{label}: the int8 program launched no K5")
        db = 10 * np.log10(1.0 / max(float(((yfq - yq) ** 2).mean()), 1e-12))
        if not torch.equal(y_id, yf) or torch.equal(yfq, yf):
            fail(f"{label}: skip-all must equal float and fake quant differ")
        m.zero_grad()
        with quant.fake_quant():
            ((m(x, route="autograd") - x) ** 2).mean().backward()
        grads = [c.weight.grad for c in m.modules()
                 if isinstance(c, torch.nn.Conv2d)]
        if not all(bool(torch.isfinite(g).all()) for g in grads) or not any(
                float(g.abs().max()) > 0 for g in grads):
            fail(f"{label}: the STE gradient is not finite and non-zero")
        if label.startswith("DnCNN") and db <= 40.0:
            fail(f"{label}: fake quant {db:.2f} dB against the int8 program")
        out[label] = db
        say(f"  {label}: fake quant {db:.2f} dB against the int8 program "
            f"({k5.LAUNCHES} K5 launches)"
            f"{'' if label.startswith('DnCNN') else ' (no bar)'}; skip-all "
            "bit-equal to float; STE gradients finite, non-zero")
    return out


def png_of(img) -> bytes:
    from celebrity_image_denoiser_tpu_torch.data import imageio

    return imageio.encode_png(np.ascontiguousarray(img))


def ship_qat(conv3x3, k5, noise, tmp, imgs) -> dict:
    """``cli.qat`` on the shipped esrgan (then served on the all-int8 rung),
    its refusal, and short fine-tunes of denoise and dncnn."""
    from celebrity_image_denoiser_tpu_torch.cli import qat as cli_qat
    from celebrity_image_denoiser_tpu_torch.serve import quality
    from celebrity_image_denoiser_tpu_torch.serve.handlers import ServeState

    out = {"k4": 0, "k5": 0}
    dst = f"{tmp}/qat"
    with open(os.path.join(weights_dir(), "esrgan", "meta.json")) as f:
        src_meta = json.load(f)
    noise.LAUNCHES = k5.LAUNCHES = conv3x3.LAUNCHES = 0
    t0 = time.perf_counter()
    res = cli_qat.run(["--family", "esrgan", "--qat-steps", str(QAT_STEPS),
                       "--chunk", str(QAT_CHUNK), "--batch", str(QAT_BATCH),
                       "--size", str(QAT_SIZE), "--qat-lr", QAT_LR,
                       "--init-from", os.path.join(weights_dir(), "esrgan"),
                       "--out", dst])
    wall = time.perf_counter() - t0
    if noise.LAUNCHES != QAT_STEPS + 2:  # a step each, two held-out sets
        fail(f"QAT: {noise.LAUNCHES} noise kernel launches for "
             f"{QAT_STEPS} steps and two evaluations")
    out["k4"] += noise.LAUNCHES
    out["k5"] += k5.LAUNCHES  # the fixture recording, int8
    with open(f"{dst}/esrgan/meta.json") as f:
        meta = json.load(f)
    want = {"qat_steps": QAT_STEPS, "qat_lr": float(QAT_LR),
            "qat_agree": 2.0}
    if any(meta.get(k) != v for k, v in want.items()) or \
            "fixture_gain_db" not in meta:
        fail(f"QAT meta {meta}")
    chunks = res["chunks"]
    rate = QAT_STEPS / sum(c["seconds"] for c in chunks)
    st = ServeState(weights_dir=dst, quantize="int8")
    rung = st.ladder("esrgan")
    gate = st.int8_gate_db.get("esrgan")
    k5.LAUNCHES = 0
    st.enhance("esrgan", png_of(imgs[0]), include_graph=False)
    per_forward = k5.LAUNCHES
    fg = quality.fixture_gain_db(st, "esrgan")
    out["k5"] += k5.LAUNCHES
    if rung != "int8-generic" or gate is None or gate < 40.0 or \
            per_forward != 16 or fg < ESRGAN_FIXTURE_FLOOR or \
            st.last_compute_backend() != "int8":
        fail(f"QAT'd esrgan served on {rung} at {gate} dB, {per_forward} K5 "
             f"launches a forward, fixture {fg:.3f} dB")
    say(f"  cli.qat esrgan (8 blocks): {QAT_STEPS} steps, batch "
        f"{QAT_BATCH}, {QAT_SIZE}², "
        f"{rate:.3f} steps/s ({wall:.1f} s with evaluation and the fixture "
        "recording), agreement by chunk "
        f"{[round(c['agree_db'], 2) for c in chunks]} dB; held-out gain "
        f"{meta['gain_db']:.3f} dB (the source {res['before']['gain_db']} "
        f"on the same draw, recorded {src_meta['gain_db']}); one noise "
        f"launch a step; served on {rung} at {gate:.2f} dB, 16 K5 a "
        f"forward, fixture gain {fg:.3f} dB (recorded "
        f"{meta['fixture_gain_db']}, floor {ESRGAN_FIXTURE_FLOOR})")
    out["esrgan"] = {"steps_per_s": rate, "agree_db": [
        c["agree_db"] for c in chunks], "gain_db": meta["gain_db"],
        "source_gain_db": src_meta["gain_db"],
        "source_gain_db_same_draw": res["before"]["gain_db"], "gate_db": gate,
        "fixture_gain_db": fg}
    with open(f"{dst}/esrgan/arrays.npz", "rb") as f:
        before = f.read()
    try:
        cli_qat.run(["--family", "esrgan", "--qat-steps", "2", "--chunk",
                     "2", "--batch", str(QAT_BATCH), "--size", str(QAT_SIZE),
                     "--qat-lr", "10", "--init-from", os.path.join(weights_dir(), "esrgan"),
                     "--out", dst])
        fail("QAT at lr 10 shipped")
    except SystemExit as e:
        if "REFUSING to ship" not in str(e):
            raise
    with open(f"{dst}/esrgan/arrays.npz", "rb") as f:
        if f.read() != before:
            fail("the refused fine-tune changed arrays.npz")
    say("  cli.qat --qat-lr 10: REFUSING to ship, arrays.npz byte-identical")
    for fam in ("denoise", "dncnn"):
        noise.LAUNCHES = 0
        res = cli_qat.run(["--family", fam, "--qat-steps", "10", "--chunk",
                           "10", "--batch", str(QAT_BATCH), "--size",
                           str(QAT_SIZE), "--qat-lr", QAT_LR_SHORT,
                           "--init-from",
                           os.path.join(weights_dir(), fam), "--out",
                           f"{tmp}/qat_{fam}"])
        if noise.LAUNCHES != 12:
            fail(f"QAT {fam}: {noise.LAUNCHES} noise launches for 10 steps "
                 "and two evaluations")
        out["k4"] += noise.LAUNCHES
        m = res["meta"]
        out[fam] = {"gain_db": m["gain_db"], "agree_db":
                    res["chunks"][0]["agree_db"],
                    "fixture_gain_db": m["fixture_gain_db"]}
        say(f"  cli.qat {fam}: 10 steps, agreement "
            f"{res['chunks'][0]['agree_db']:.2f} dB, held-out gain "
            f"{m['gain_db']:.3f} dB (the source {res['before']['gain_db']}), "
            f"fixture {m['fixture_gain_db']:.3f} dB")
    # K2: the held-out evaluations' forwards, the denoise gate's s8 mode
    out["k2"] = conv3x3.LAUNCHES
    del st
    torch.cuda.empty_cache()
    return out


def ship_export(conv3x3, tmp, imgs) -> dict:
    """The QAT'd esrgan as a ``.pth`` and the shipped cgan as a new
    ``.keras``, each loaded and served against its source."""
    from celebrity_image_denoiser_tpu_torch.ckpt import checkpoint
    from celebrity_image_denoiser_tpu_torch.ckpt import convert
    from celebrity_image_denoiser_tpu_torch.ckpt.keras import (
        H5File,
        load_keras_model,
    )
    from celebrity_image_denoiser_tpu_torch.cli import export as cli_export
    from celebrity_image_denoiser_tpu_torch.models.cgan import (
        CGANKerasGenerator,
    )
    from celebrity_image_denoiser_tpu_torch.models.esrgan import (
        ESRGANGenerator,
    )
    from celebrity_image_denoiser_tpu_torch.serve.handlers import ServeState

    import zipfile

    conv3x3.LAUNCHES = 0
    os.makedirs(f"{tmp}/pth")
    pth = f"{tmp}/pth/esrgan_epoch_500.pth"
    cli_export.main(["--model", "esrgan", "--checkpoint", f"{tmp}/qat/esrgan",
                     "--format", "pth", "--out", pth])
    a, b = ESRGANGenerator(), ESRGANGenerator()
    a.load_state_dict(convert.load_pth_state_dict(pth), strict=True)
    b.load_state_dict(convert.load_npz_state_dict(f"{tmp}/qat/esrgan",
                                                  module=b), strict=False)
    if any(not torch.equal(v, w) for v, w in zip(a.state_dict().values(),
                                                 b.state_dict().values())):
        fail("the exported .pth does not load to the npz checkpoint's state")
    png = png_of(imgs[1])
    r_pth = ServeState(weights_dir=f"{tmp}/pth").enhance(
        "esrgan", png, include_graph=False)
    r_npz = ServeState(weights_dir=f"{tmp}/qat").enhance(
        "esrgan", png, include_graph=False)
    if r_pth["denoised_image_base64"] != r_npz["denoised_image_base64"]:
        fail("esrgan served from the .pth differs from the npz checkpoint")
    say("  cli.export --format pth (the QAT'd esrgan): loads to the npz "
        "state exactly; served f32 from a weights dir holding only "
        "esrgan_epoch_500.pth, bit-equal to the npz-served response")
    shipped = os.path.join(weights_dir(), "cgan_epoch_500.keras")
    m = CGANKerasGenerator()
    load_keras_model(m, shipped)
    params, state = convert.state_dict_to_jax_params(m.state_dict(), module=m)
    checkpoint.save_checkpoint(f"{tmp}/cgan_ck", {
        "generator": params, "generator_state": state})
    os.makedirs(f"{tmp}/keras")
    keras = f"{tmp}/keras/cgan_epoch_500.keras"
    cli_export.main(["--model", "cgan", "--checkpoint", f"{tmp}/cgan_ck",
                     "--format", "keras", "--out", keras])
    old = H5File(zipfile.ZipFile(shipped).read("model.weights.h5"))
    new = H5File(zipfile.ZipFile(keras).read("model.weights.h5"))
    n = 0
    for layer in new.list("layers"):
        for v in new.list(f"layers/{layer}/vars"):
            path = f"layers/{layer}/vars/{v}"
            if not np.array_equal(old[path], new[path]):
                fail(f"{path} of the exported .keras differs")
            n += 1
    png = png_of(imgs[2])
    r_new = ServeState(weights_dir=f"{tmp}/keras").enhance(
        "cgan", png, label=5, include_graph=False)
    r_old = ServeState().enhance("cgan", png, label=5, include_graph=False)
    if r_new["denoised_image_base64"] != r_old["denoised_image_base64"] or \
            r_new.get("backend") != "keras":
        fail("cgan served from the exported .keras differs from the shipped")
    for argv, what in (
            (["--model", "denoise", "--checkpoint", os.path.join(weights_dir(), "srgan")],
             "does not hold"),
            (["--model", "dncnn", "--checkpoint", f"{tmp}/dncnn_no_state"],
             "generator_state")):
        if what == "generator_state":
            sections, _ = checkpoint.load_checkpoint(os.path.join(weights_dir(), "dncnn"))
            checkpoint.save_checkpoint(argv[-1], {
                "generator": sections["generator"]})
        bad = f"{tmp}/refused.pth"
        try:
            cli_export.main(argv + ["--out", bad])
            fail(f"cli.export {argv} wrote a file")
        except SystemExit as e:
            if what not in str(e) or os.path.exists(bad):
                fail(f"cli.export {argv}: {e}")
    say(f"  cli.export --model cgan --format keras: {n} datasets bit-equal "
        "to the shipped file's; served (label 5, f32) bit-equal to the "
        "shipped .keras; the two refusals (a tree that is not --model's, "
        "BatchNorm without generator_state): SystemExit, no file")
    return {"k2": conv3x3.LAUNCHES, "datasets": n}


def ship_eval(conv3x3, double_conv, tmp) -> dict:
    """``cli.eval`` on the shipped weights, exact launches, the first output
    against the plain route."""
    from celebrity_image_denoiser_tpu_torch.cli import eval as cli_eval
    from celebrity_image_denoiser_tpu_torch.data import imageio
    from celebrity_image_denoiser_tpu_torch.data.synthetic import (
        synth_clean_batch,
    )

    os.makedirs(f"{tmp}/eval/in")
    os.makedirs(f"{tmp}/eval/clean")
    clean = (synth_clean_batch(make_gen(), EVAL_IMAGES, TRAIN_SIZE) * 255
             ).round().to(torch.uint8).cpu().numpy()
    rng = np.random.default_rng(SEED)
    noisy = np.clip(clean + rng.normal(0, 20, clean.shape), 0,
                    255).astype(np.uint8)
    for i in range(EVAL_IMAGES):
        imageio.imwrite(f"{tmp}/eval/in/{i:02d}.png", noisy[i])
        imageio.imwrite(f"{tmp}/eval/clean/{i:02d}.png", clean[i])
    out = {"k2": 0, "k3": 0}
    for model, (k2f, k3f) in EVAL_PER_FORWARD.items():
        side = TRAIN_SIZE // 4 if model == "srgan" else TRAIN_SIZE
        size = ["--image-size", str(side), str(side)]
        dst = f"{tmp}/eval/out_{model}"
        conv3x3.LAUNCHES = double_conv.LAUNCHES = 0
        t0 = time.perf_counter()
        res = cli_eval.run(["--model", model, "--input-dir",
                            f"{tmp}/eval/in", "--output-dir", dst,
                            "--clean-dir", f"{tmp}/eval/clean",
                            "--iterations", "2"] + size)
        wall = time.perf_counter() - t0
        n = EVAL_IMAGES * 2
        got = (conv3x3.LAUNCHES, double_conv.LAUNCHES)
        if got != (n * k2f, n * k3f) or res["forwards"] != n:
            fail(f"cli.eval {model}: (K2, K3) launches {got} for {n} "
                 f"forwards, want {(n * k2f, n * k3f)}")
        out["k2"] += got[0]
        out["k3"] += got[1]
        net = cli_eval.load_model(model, None).cuda()
        x = imageio.to_float01(imageio.imread_rgb(f"{tmp}/eval/in/00.png",
                                                  (side, side)))
        tanh = model in ("denoise", "srgan")
        xt = torch.from_numpy(x * 2 - 1 if tanh else x)[None].cuda()
        with torch.inference_mode():
            y = net(xt.permute(0, 3, 1, 2), route="plain").permute(
                0, 2, 3, 1)[0].cpu().numpy()
        y01 = np.clip(y * 0.5 + 0.5 if tanh else y, 0, 1)
        ref = (y01 * 255).astype(np.uint8).astype(int)
        written = imageio.imread_rgb(f"{dst}/00_iter1.png").astype(int)
        diff = int(np.abs(written - ref).max())
        if diff > 1 or res["psnr"] is None or not np.isfinite(res["psnr"]):
            fail(f"cli.eval {model}: the first output {diff} counts off the "
                 f"plain route; PSNR {res['psnr']}")
        out[model] = {"images_per_s": EVAL_IMAGES / wall,
                      "forwards_per_s": n / res["forward_seconds"],
                      "psnr": res["psnr"], "ssim": res["ssim"]}
        say(f"  cli.eval --model {model} --iterations 2 ({EVAL_IMAGES} "
            f"images at {side}²): K2 {got[0]} "
            f"+ K3 {got[1]} (exact), the first output within {diff} count "
            f"of the plain route; {EVAL_IMAGES / wall:.2f} images/s end to "
            f"end, {n / res['forward_seconds']:.1f} forwards/s; PSNR "
            f"{res['psnr']:.3f} SSIM {res['ssim']:.4f}")
    return out


def ship_profile(noise, tmp) -> dict:
    """``cli.train --profile-dir --graph-dir`` for one denoise epoch."""
    from celebrity_image_denoiser_tpu_torch.cli import train as cli_train

    noise.LAUNCHES = 0
    before = launch_counters()
    with LogLines("cid_torch.cli.train") as log:
        rc = cli_train.main([
            "--clean-dir", f"{tmp}/clean", "--image-size", str(TRAIN_SIZE),
            str(TRAIN_SIZE), "--batch-size", str(TRAIN_BATCH),
            "--num-epochs", "1", "--checkpoint-dir", f"{tmp}/ck_prof",
            "--profile-dir", f"{tmp}/prof", "--graph-dir",
            f"{tmp}/graphs_prof"])
    traces = os.listdir(f"{tmp}/prof")
    if rc != 0 or len(traces) != 1:
        fail(f"cli.train --profile-dir: rc {rc}, traces {traces}")
    with open(f"{tmp}/prof/{traces[0]}") as f:
        events = json.load(f)["traceEvents"]
    # every hand-written kernel's records against its launches: one
    # noise_batch launch a step, no conv kernel (the train step's convs are
    # PyTorch's)
    after = launch_counters()
    records, lead = trace_records(events)
    launches = {k: after[k] - before[k] for k in KERNEL_RECORDS}
    check_records(f"cli.train --profile-dir trace (least kernel start after "
                  f"its launch call {lead} us)", records, launches)
    k4 = records["K4"]
    if k4 != SHIP_STEPS or noise.LAUNCHES != SHIP_STEPS:
        fail(f"the trace names {k4} noise_batch_kernel launches for "
             f"{noise.LAUNCHES} launched")
    if not any("matplotlib" in line for line in log.lines) or \
            os.path.exists(f"{tmp}/graphs_prof"):
        fail(f"--graph-dir without matplotlib: {log.lines}")
    say(f"  cli.train --profile-dir: a Chrome trace of {len(events)} events "
        f"naming {k4} noise_batch_kernel launches of {noise.LAUNCHES} "
        "(one a step); --graph-dir: "
        f"'{next(l for l in log.lines if 'matplotlib' in l)}', exit 0")
    return {"k4": noise.LAUNCHES, "events": len(events),
            "k4_in_trace": k4}


def phase_ship_trace(noise) -> dict:
    """Phase 14's profiling step (``ship_profile``), run before any other
    ``torch.profiler`` session of this process: a process's later sessions
    lose kernel records (``profiled``); after phases 4e, 7 and 11 had
    profiled, its trace once held 7 of the 8."""
    import tempfile

    say("== phase 14h (run first, before the other profilers): cli.train "
        "--profile-dir")
    with tempfile.TemporaryDirectory(prefix="cid_trace_") as tmp:
        os.makedirs(f"{tmp}/clean")
        write_train_pngs(f"{tmp}/clean", SHIP_IMAGES)
        return ship_profile(noise, tmp)


def phase_ship(conv3x3, double_conv, k5, noise, profile) -> dict:
    """Phase 14: train to ship; ``profile`` is ``phase_ship_trace``'s."""
    import tempfile

    say("== phase 14: train to ship (MS-SSIM and the extra metrics, remat, "
        "fake quant and QAT onto the int8 gate, .pth/.keras export, the "
        "eval CLI, profiling)")
    t_phase = time.perf_counter()
    out = {}
    with tempfile.TemporaryDirectory(prefix="cid_ship_") as tmp:
        os.makedirs(f"{tmp}/clean")  # the training PNGs, alone in their tree
        imgs = write_train_pngs(f"{tmp}/clean", SHIP_IMAGES)
        out["metrics"] = ship_metrics()
        out["extras"] = ship_extras(conv3x3, double_conv, noise, tmp, imgs)
        out["remat"] = ship_remat(noise, tmp, imgs)
        out["fake_quant"] = ship_fake_quant(k5)
        out["qat"] = ship_qat(conv3x3, k5, noise, tmp, imgs)
        out["export"] = ship_export(conv3x3, tmp, imgs)
        out["eval"] = ship_eval(conv3x3, double_conv, tmp)
    out["profile"] = profile
    out["seconds"] = time.perf_counter() - t_phase
    say(f"  phase 14: {out['seconds']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# phase 15: multiple devices
DP_RANKS, DP_BATCH, DP_STEPS = 2, 16, 3  # 15a: the global batch, 256²
MESH_SIZE = 4  # 15c, 15d: a serving mesh naming cuda:0 four times
MESH_BIG = (3072, 4096)  # 15c: (H, W) of the sharded denoise request
MESH_ESRGAN = (2100, 600)  # 15c: over the threshold on the height only
# 15a's bounds after step 1, against the same steps in one process: f32 as
# phase 9 holds the card against the CPU (losses 1e-4 relative, BatchNorm
# statistics 1e-4, the first moments by moment_gaps against a float64 step,
# within 4× the single process's own gap); bf16 two ulps (TOL) relative for
# the losses and statistics, its first moments reported against float64,
# not held: f32 carries the gradient check, and two planted faults show it
# fails them.  The parameters (both) by adam_param_gap; steps 2 and 3's
# losses 1e-3 (f32) relative
DP_TOL = {"float32": {"loss": 1e-4, "later": 1e-3, "stats": 1e-4},
          "bfloat16": {"loss": 1.6e-2, "later": 1.6e-2, "stats": 1.6e-2}}
DP_LR, DP_ADAM_EPS = 1e-4, 1e-8  # the steps' lr; train/optim.py::adam's eps
# 15a's planted faults, one f32 step each on the ranks: the gradients not
# summed over the ranks; each rank's BatchNorm statistics its own batch's
DP_FAULTS = ("no_grad_sum", "local_bn")


@contextlib.contextmanager
def planted(fault):
    """The trainer with ``fault`` planted for the length of a ``with``."""
    from types import SimpleNamespace

    from celebrity_image_denoiser_tpu_torch.train import gan_trainer

    real = gan_trainer.collectives
    if fault == "no_grad_sum":
        gan_trainer.collectives = SimpleNamespace(
            psum=lambda x, group=None: x, psum_mean=real.psum_mean)
    try:
        yield
    finally:
        gan_trainer.collectives = real


def dp_steps(mesh, clean_u8, dtypes=("float32", "bfloat16"),
             faults=()) -> dict:
    """Phase 15a's work on one rank of ``mesh`` (None: the whole batch in
    this process): K4's share of the whole-batch draw in variant 1 and the
    blind σ; then DP_STEPS on-the-fly steps of the full-width denoise GAN
    (the shipped generator, a seeded discriminator: a fine-tune) in each of
    ``dtypes`` (float64: one step, the reference), on its share; the first
    moments, parameters and BatchNorm statistics after step 1, every step's
    losses, and the K4 launches of the steps; then one f32 step with each
    of ``faults`` planted (``DP_FAULTS``)."""
    from types import SimpleNamespace

    from celebrity_image_denoiser_tpu_torch.ckpt.convert import (
        load_npz_state_dict,
    )
    from celebrity_image_denoiser_tpu_torch.data import noise as noise_lib
    from celebrity_image_denoiser_tpu_torch.models.denoise_unet import (
        DenoiseDiscriminator,
        DenoiseGenerator,
    )
    from celebrity_image_denoiser_tpu_torch.ops.cuda import noise
    from celebrity_image_denoiser_tpu_torch.ops.norm import (
        set_batch_norm_group,
    )
    from celebrity_image_denoiser_tpu_torch.parallel.mesh import (
        shard_count,
        shard_index,
    )
    from celebrity_image_denoiser_tpu_torch.train.gan_trainer import (
        make_train_step,
    )

    rank, world = ((0, 1) if mesh is None
                   else (shard_index(mesh), shard_count(mesh)))
    n = clean_u8.shape[0] // world
    local = torch.from_numpy(clean_u8[rank * n:(rank + 1) * n]).cuda()
    res = {"k4": {}, "steps": {}, "faults": {}}
    for label in ("v1", "blind"):
        gen = torch.Generator(device="cuda").manual_seed(SEED + 5)
        if label == "v1":
            y = noise_lib.random_noise_batch(gen, local, variant=1,
                                             rank=rank, world=world)[0]
        else:
            y = noise_lib.blind_gaussian_batch(gen, local, rank=rank,
                                               world=world)[0]
        res["k4"][label] = y.cpu()

    def steps(cdt, n_steps, fault=None):
        init = torch.Generator().manual_seed(SEED)
        g = DenoiseGenerator(generator=init)
        g.load_state_dict(load_npz_state_dict(weights_dir() + "/denoise",
                                              module=g))
        g = g.cuda()
        d = DenoiseDiscriminator(generator=init).cuda()
        for m in (g, d):
            m.to(torch.float64 if cdt == "float64" else torch.float32,
                 memory_format=torch.channels_last)
        init_fn, step_fn = make_train_step(g, d, on_the_fly_noise=True,
                                           compute_dtype=cdt, mesh=mesh)
        if fault == "local_bn":
            for m in (g, d):
                set_batch_norm_group(m, None)
        opt = init_fn()
        gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
        losses = []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with planted(fault):
            for s in range(n_steps):
                out = step_fn(opt, None, local, gen, DP_LR, DP_LR)
                losses.append([float(out["g_loss"]), float(out["d_loss"])])
                if s == 0:
                    first = {
                        "opt": tuple(SimpleNamespace(mu={
                            k: v.detach().cpu().double() for k, v in
                            st.mu.items()}) for st in opt),
                        "params": {f"{w}.{k}": v.detach().cpu().double()
                                   for w, m in (("G", g), ("D", d))
                                   for k, v in m.named_parameters()},
                        "stats": {f"D.{k}": v.cpu().double() for k, v in
                                  d.named_buffers() if "running_" in k}}
        torch.cuda.synchronize()
        return {"losses": losses, "first": first,
                "s": time.perf_counter() - t0}

    noise.LAUNCHES = 0
    for cdt in dtypes:
        res["steps"][cdt] = steps(cdt, 1 if cdt == "float64" else DP_STEPS)
    res["k4_launches"] = noise.LAUNCHES
    for fault in faults:
        res["faults"][fault] = steps("float32", 1, fault)
    return res


def dp_rank(rank, world, init, out_dir, clean_u8) -> None:
    """A rank of phase 15a (spawned): ``dp_steps`` over a process group of
    ``world`` ranks on cuda:0, gloo, the faults included."""
    import pickle

    import torch.distributed as dist

    from celebrity_image_denoiser_tpu_torch.parallel.mesh import process_mesh

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=world)
    try:
        res = dp_steps(process_mesh(), clean_u8, faults=DP_FAULTS)
    finally:
        dist.destroy_process_group()
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(res, f)


def grad_errors(opt, ref64) -> dict:
    """{"G"/"D": (module error, worst leaf error, leaf)}: the first moments
    (the gradients) after the step against the float64 step's, as
    ‖Δ‖₂ / ‖ref‖₂ over the whole module and per leaf; a leaf whose float64
    gradient is under 1e-3 of the module's largest leaf's (a bias before a
    BatchNorm, whose gradient is 0 but for rounding) is left out of the
    per-leaf figure."""
    out = {}
    for i, name in enumerate(("G", "D")):
        ref = ref64[i].mu
        diff = {k: float((opt[i].mu[k] - v).norm()) for k, v in ref.items()}
        norm = {k: float(v.norm()) for k, v in ref.items()}
        top = max(norm.values())
        leaf = max((diff[k] / norm[k], k) for k in ref
                   if norm[k] >= 1e-3 * top)
        whole = (sum(d * d for d in diff.values())
                 / sum(v * v for v in norm.values())) ** 0.5
        out[name] = (whole, *leaf)
    return out


def adam_param_gap(got, ref, lr=DP_LR, allowed=None,
                   eps=DP_ADAM_EPS) -> tuple:
    """(worst ratio of a held weight, its leaf, weights held, weights in
    all, worst ratio of the rest): the parameters after step 1 of ``got``
    against ``ref`` ({"opt": (G's, D's Adam state), "params": {"G.<leaf>"
    / "D.<leaf>": tensor}}; ``dp_steps``' "first").  Adam's first step at
    ``lr`` moves a weight by lr·g/(|g| + ε), about ±lr: the two agree
    within 1e-6 + 1e-4·|p| wherever both gradients share their sign and
    |g| ≥ 100 ε (``eps``: Adam's ε; Keras' Adam, whose ε sits outside the
    bias correction, acts as ``adam`` with ε/√(1 − b2)), and such a weight
    is held there; a weight whose gradient
    is within twice its gap of zero or under 100 ε may take the other sign,
    and is held within 2·lr + 1e-6.  The gap is ``allowed``'s ({"G"/"D":
    {leaf: the largest first-moment gap the run's moment check lets
    through}}), which does not depend on ``got``, so a gradient the run
    lost or zeroed fails here too; without it, each weight's own gap
    between the two runs' first moments (which the moments' check
    bounds)."""
    worst, rest, held, total = (0.0, ""), 0.0, 0, 0
    for i, w in enumerate(("G", "D")):
        mu_ref, mu_got = ref["opt"][i].mu, got["opt"][i].mu
        for k, g_ref in mu_ref.items():
            g_ref = g_ref.cpu()
            p_ref = ref["params"][f"{w}.{k}"].cpu()
            gap = (got["params"][f"{w}.{k}"].cpu() - p_ref).abs()
            mu_gap = (allowed[w][k] if allowed is not None
                      else (mu_got[k].cpu() - g_ref).abs())
            sure = ((g_ref.abs() >= 0.1 * 100 * eps)
                    & (g_ref.abs() > 2 * mu_gap))
            if sure.any():
                worst = max(worst, ((gap / (1e-6 + 1e-4 * p_ref.abs()))[
                    sure].max().item(), f"{w}.{k}"))
            if not sure.all():
                rest = max(rest, gap[~sure].max().item()
                           / (2 * lr + 1e-6))
            held += int(sure.sum())
            total += sure.numel()
    return worst[0], worst[1], held, total, rest


def dp_gaps(got, ref, ref64, cdt) -> dict:
    """A run's numbers after step 1 against the single process's ``ref``
    (``dp_steps``' "steps" entry) and the float64 step's first moments,
    and whether they are within DP_TOL[cdt] (``ok``)."""
    tol = DP_TOL[cdt]
    rel = [max(abs(a - b) / abs(b) for a, b in zip(ga, gb))
           for ga, gb in zip(got["losses"], ref["losses"])]
    stats = max(float((got["first"]["stats"][k] - v).abs().max())
                / (1.0 if cdt == "float32" else
                   max(1.0, float(v.abs().max())))
                for k, v in ref["first"]["stats"].items())
    params = adam_param_gap(got["first"], ref["first"])
    row = {"loss_rel": rel, "stats": stats, "params": params,
           "mu64": grad_errors(got["first"]["opt"], ref64)}
    ok = (rel[0] <= tol["loss"] and max(rel) <= tol["later"]
          and stats <= tol["stats"] and params[0] <= 1.0
          and params[4] <= 1.0)
    if cdt == "float32":
        gaps = moment_gaps({"cpu64": ref64, "cuda": got["first"]["opt"],
                            "cpu": ref["first"]["opt"]})
        row["mu"] = {k: v[:2] for k, v in gaps.items()}
        ok = ok and all(v[0] <= 1.0 for v in gaps.values())
    row["ok"] = ok
    return row


def phase_dp_train(noise, tmp) -> dict:
    """15a: two gloo ranks on cuda:0 against the single-process run; a
    group of one rank (the synced BatchNorm's arithmetic without a split)
    in bf16; the planted faults, which the f32 bounds must catch."""
    import pickle
    import tempfile

    import torch.distributed as dist
    import torch.multiprocessing as mp

    from celebrity_image_denoiser_tpu_torch.parallel.mesh import process_mesh

    say(f"  15a: data-parallel training, {DP_RANKS} gloo ranks on cuda:0, "
        f"full-width denoise GAN, global batch {DP_BATCH}, {TRAIN_SIZE}², "
        f"on the fly, {DP_STEPS} steps f32 and bf16")
    clean = write_train_pngs(tmp, DP_BATCH)
    single = dp_steps(None, clean, ("float64", "float32", "bfloat16"))
    with tempfile.TemporaryDirectory(prefix="cid_dp_") as d:
        dist.init_process_group("gloo", init_method=f"file://{d}/pg1",
                                rank=0, world_size=1)
        try:
            group1 = dp_steps(process_mesh(), clean, ("bfloat16",))
        finally:
            dist.destroy_process_group()
        # the ranks share the card with this process: hand back its cache
        held = torch.cuda.memory_reserved() / 2 ** 30
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        say(f"  this process's cached memory before the ranks start: "
            f"{held:.2f} GiB, released to "
            f"{torch.cuda.memory_reserved() / 2 ** 30:.2f} GiB")
        t0 = time.perf_counter()
        mp.spawn(dp_rank, args=(DP_RANKS, f"file://{d}/pg", d, clean),
                 nprocs=DP_RANKS, join=True)
        spawn_s = time.perf_counter() - t0
        ranks = []
        for r in range(DP_RANKS):
            with open(f"{d}/rank{r}.pkl", "rb") as f:
                ranks.append(pickle.load(f))
    n = DP_BATCH // DP_RANKS
    for label in ("v1", "blind"):
        for r, res in enumerate(ranks):
            if not torch.equal(res["k4"][label],
                               single["k4"][label][r * n:(r + 1) * n]):
                fail(f"rank {r}'s {label} noise is not its rows of the "
                     "whole-batch launch")
    say(f"  K4 at first_sample {', '.join(str(r * n) for r in range(DP_RANKS))}"
        ": each rank's noisy rows bit-equal to the whole-batch launch's "
        "(variant 1 and the blind sigma)")
    out = {"spawn_s": spawn_s, "k4_launches": sum(r["k4_launches"]
                                                   for r in ranks)}
    if out["k4_launches"] != DP_RANKS * 2 * DP_STEPS:
        fail(f"15a: {out['k4_launches']} noise launches, expected "
             f"{DP_RANKS * 2 * DP_STEPS} (one a step a rank)")
    ref64 = single["steps"]["float64"]["first"]["opt"]
    for cdt in DP_TOL:
        ref = single["steps"][cdt]
        row = {"single_steps_per_s": DP_STEPS / ref["s"],
               "single_mu64": grad_errors(ref["first"]["opt"], ref64)}
        for r, res in enumerate(ranks):
            got = res["steps"][cdt]
            row[f"rank{r}"] = dict(dp_gaps(got, ref, ref64, cdt),
                                   steps_per_s=DP_STEPS / got["s"])
            if r > 0 and got["losses"] != ranks[0]["steps"][cdt]["losses"]:
                fail(f"15a {cdt}: the ranks report different losses")
            if not row[f"rank{r}"]["ok"]:
                fail(f"15a {cdt} rank {r}: {row[f'rank{r}']} against the "
                     f"single-process run (bounds {DP_TOL[cdt]}, parameters "
                     "and moments ratio 1)")
        r0 = row["rank0"]
        say(f"  {cdt}: losses {[round(v, 6) for v in ref['losses'][-1]]} "
            f"(single, step {DP_STEPS}); rank 0 vs single: losses "
            f"{max(r0['loss_rel']):.2e} rel (step 1 {r0['loss_rel'][0]:.2e}),"
            f" after step 1 BatchNorm statistics {r0['stats']:.2e}, "
            f"parameters: {r0['params'][2]} of {r0['params'][3]} weights "
            f"held to 1e-4 relative, ratio {r0['params'][0]:.3f} "
            f"({r0['params'][1]}), the rest {r0['params'][4]:.3f} of 2·lr"
            + ("".join(f", {w} first moments ratio {v[0]:.3f} ({v[1]})"
                       for w, v in r0.get("mu", {}).items()))
            + f"; steps/s over the {DP_STEPS} steps, the first included: "
            f"single {row['single_steps_per_s']:.3f}, a rank "
            f"{r0['steps_per_s']:.3f} (two ranks share the card)")
        if cdt == "bfloat16":
            row["group1_mu64"] = grad_errors(
                group1["steps"][cdt]["first"]["opt"], ref64)
        runs = [("single", row["single_mu64"])] + (
            [("one-rank group", row["group1_mu64"])]
            if "group1_mu64" in row else []) + [("rank 0", r0["mu64"])]
        say(f"  {cdt} gradients against float64, |Δ|/|ref| over the module "
            "(the worst leaf): " + "; ".join(
                f"{w}: " + ", ".join(f"{who} {e[w][0]:.2e} ({e[w][1]:.2e} "
                                     f"{e[w][2]})" for who, e in runs)
                for w in ("G", "D")))
        out[cdt] = row
    ref = single["steps"]["float32"]
    out["faults"] = {}
    for fault in DP_FAULTS:
        row = dp_gaps(ranks[0]["faults"][fault], ref, ref64, "float32")
        out["faults"][fault] = row
        say(f"  planted fault {fault} (f32, one step): losses "
            f"{row['loss_rel'][0]:.2e} rel, BatchNorm statistics "
            f"{row['stats']:.2e}, parameters ratio {row['params'][0]:.3f} "
            f"({row['params'][2]} of {row['params'][3]} held), "
            + ", ".join(f"{w} first moments ratio {v[0]:.3f} ({v[1]})"
                        for w, v in row["mu"].items())
            + ("; caught" if not row["ok"] else "; NOT caught"))
        if row["ok"]:
            fail(f"15a: the f32 bounds do not catch the planted fault "
                 f"{fault}")
    return out


def phase_torchrun(noise, tmp) -> dict:
    """15b: ``cli.train`` under ``torch.distributed.run`` at world size 1
    (NCCL), one 4-step epoch; its checkpoint resumes without a mesh."""
    from celebrity_image_denoiser_tpu_torch.cli import train as cli_train

    os.makedirs(f"{tmp}/clean", exist_ok=True)
    write_train_pngs(f"{tmp}/clean")
    argv = ["--model", "denoise", "--clean-dir", f"{tmp}/clean",
            "--image-size", str(TRAIN_SIZE), str(TRAIN_SIZE), "--batch-size",
            str(TRAIN_BATCH), "--num-epochs", "1", "--checkpoint-dir",
            f"{tmp}/ck", "--graph-dir", f"{tmp}/graphs"]
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node", "1", "-m",
           "celebrity_image_denoiser_tpu_torch.cli.train", *argv]
    say("  15b: " + " ".join(cmd[1:4] + ["..."] + cmd[4:8]))
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    dt = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        print(log[-4000:], file=sys.stderr)
        fail(f"15b: torch.distributed.run exited {proc.returncode}")
    if "data parallel: rank 0 of 1 over nccl on cuda:0" not in log:
        print(log[-4000:], file=sys.stderr)
        fail("15b: the run did not report NCCL at world size 1 on cuda:0")
    noise.LAUNCHES = 0
    tr = cli_train.build_trainer(cli_train.build_parser().parse_args(
        argv + ["--resume", "--num-epochs", "2"]))
    if tr.mesh is not None or tr.start_epoch != 1:
        fail(f"15b: resumed with mesh {tr.mesh}, epoch {tr.start_epoch}")
    hist = tr.train()
    ok = len(hist["g_loss"]) == 2 and np.isfinite(hist["g_loss"]).all()
    if not ok or noise.LAUNCHES != 4:
        fail(f"15b: the resumed epoch: history {hist['g_loss']}, "
             f"{noise.LAUNCHES} noise launches (expected 4)")
    say(f"  15b: exit 0 in {dt:.1f} s (process start and the kernels' build "
        f"included), NCCL at world size 1 on cuda:0; rank 0's checkpoint "
        f"resumed without a mesh at epoch 1, one more epoch: g_loss "
        f"{hist['g_loss'][0]:.5f} -> {hist['g_loss'][1]:.5f}, 4 noise "
        "launches")
    return {"s": dt, "k4_launches": noise.LAUNCHES}


def mesh_request(st, model, png, kind, label, counts, expect):
    """One ``enhance`` of ``st``: its response and launches, held to
    ``label`` and ``expect``."""
    int8_counts(*counts, reset=True)
    t0 = time.perf_counter()
    r = st.enhance(model, png, "image/png", include_graph=False)
    dt = (time.perf_counter() - t0) * 1e3
    got = int8_counts(*counts)
    if st.last_compute_backend() != f"{kind}+{label}":
        fail(f"15c {kind} {model}: served {st.last_compute_backend()}, "
             f"expected {kind}+{label}")
    if expect is not None and got != expect:
        fail(f"15c {kind} {model}: launches {got}, expected {expect}")
    return r["denoised_image_base64"], got, dt


def phase_mesh_serve(conv3x3, double_conv, k5, k6) -> dict:
    """15c: the shipped weights over a mesh of cuda:0 four times."""
    from celebrity_image_denoiser_tpu_torch.parallel import make_mesh
    from celebrity_image_denoiser_tpu_torch.serve import handlers

    counts = (conv3x3, double_conv, k5, k6)
    mesh = make_mesh(devices=["cuda:0"] * MESH_SIZE)
    build_dp, dp_batches = handlers.data_parallel_apply, [0]

    def counted_dp(*args, **kwargs):
        """The server's data-parallel forward, counting the batches it
        runs."""
        fn = build_dp(*args, **kwargs)

        def run(xs):
            dp_batches[0] += 1
            return fn(xs)
        return run

    handlers.data_parallel_apply = counted_dp
    try:
        return mesh_serve(mesh, counts, dp_batches)
    finally:
        handlers.data_parallel_apply = build_dp


def mesh_serve(mesh, counts, dp_batches) -> dict:
    """15c's requests over ``mesh``; ``dp_batches``: the count of batches
    the data-parallel dispatch ran."""
    from celebrity_image_denoiser_tpu_torch.data import imageio
    from celebrity_image_denoiser_tpu_torch.serve.handlers import ServeState

    say(f"  15c: serving over {mesh}")
    big = imageio.encode_png(test_image(*MESH_BIG, seed=150))
    esr = imageio.encode_png(test_image(*MESH_ESRGAN, seed=151))
    n = MB_CLIENTS * MB_REQUESTS
    pngs = [imageio.encode_png(test_image(MB_SIZE, MB_SIZE, seed=300 + i))
            for i in range(n)]
    esrgan_per = {"float": (16, 0, 0, 0), "int8": (0, 0, 16, 0)}
    out, totals = {}, [0, 0, 0, 0]
    for kind, quantize in (("float", None), ("int8", "int8")):
        # both axes are over the threshold: without tiling the height
        # shards (3072 = 4 × 768); requests that run whole are
        # micro-batched over the mesh
        t0 = time.perf_counter()
        st = ServeState(device="cuda", quantize=quantize, mesh=mesh,
                        use_tiling=False, microbatch_window_ms=2,
                        microbatch_max=16)
        ref = ServeState(device="cuda", quantize=quantize)
        if quantize and (st.ladder("denoise") != "int8-s8skip"
                         or st.ladder("esrgan") != "int8-generic"):
            fail(f"15c: the int8 ladder served {st.int8_rung}")
        row = {}
        for model, png, per in (("denoise", big, PER_FORWARD[kind]),
                                ("esrgan", esr, esrgan_per[kind])):
            y, got, dt = mesh_request(st, model, png, kind, "sharded",
                                      counts, tuple(MESH_SIZE * c
                                                    for c in per))
            totals = [a + b for a, b in zip(totals, got)]
            y_ref, _, dt_ref = mesh_request(ref, model, png, kind, "tiled",
                                            counts, None)
            if y != y_ref:
                a = imageio.decode_png(base64.b64decode(y)).astype(np.int16)
                b = imageio.decode_png(base64.b64decode(y_ref)).astype(
                    np.int16)
                fail(f"15c {kind} {model}: the sharded response differs "
                     f"from the mesh-free server's (max {np.abs(a - b).max()}"
                     ")")
            h, w = MESH_BIG if model == "denoise" else MESH_ESRGAN
            say(f"  {kind} {model} {w}x{h} (H x W {h}x{w}): {kind}+sharded "
                f"in {dt:.1f} ms over {MESH_SIZE} strips, launches {got}; "
                f"response bytes equal to the mesh-free server's "
                f"({kind}+tiled, {dt_ref:.1f} ms)")
            row[model] = {"ms": dt, "mesh_free_ms": dt_ref, "launches": got}
        # 32 clients x 8 requests of 256², micro-batched over the mesh
        mb = st
        mb.warmup(((MB_SIZE, MB_SIZE),), models=("denoise",))
        ref.warmup(((MB_SIZE, MB_SIZE),), models=("denoise",))
        alone = []
        for p in pngs:
            alone.append(ref.enhance("denoise", p, "image/png",
                                     include_graph=False)[
                "denoised_image_base64"])
        srv, thread, url = serve_in_thread(mb)
        try:
            b0, dp0 = batcher_totals(mb), dp_batches[0]
            int8_counts(*counts, reset=True)
            wall, lat, got = run_load(url, pngs)
            launches = int8_counts(*counts)
            batches, reqs = (a - b for a, b in zip(batcher_totals(mb), b0))
            dp_run = dp_batches[0] - dp0
        finally:
            stop_server(srv, thread)
        totals = [a + b for a, b in zip(totals, launches)]
        differ = sum(a != b for a, b in zip(got, alone))
        p50, p90 = np.percentile(lat, [50, 90])
        say(f"  {kind} micro-batched over the mesh: {n} requests "
            f"({MB_CLIENTS} clients x {MB_REQUESTS}, {MB_SIZE}^2) in "
            f"{wall:.2f} s: {n / wall:.1f} requests/s, p50 {p50:.2f} ms p90 "
            f"{p90:.2f} ms; {batches} batches, mean occupancy "
            f"{reqs / batches:.2f}; launches {launches}; {differ} responses "
            "differ from the same requests served alone")
        if differ or reqs != n or dp_run != batches:
            fail(f"15c {kind}: {differ} micro-batched responses differ, "
                 f"{reqs} of {n} requests batched, {dp_run} of {batches} "
                 "batches through the data-parallel dispatch")
        row["microbatch"] = {"requests_per_s": n / wall, "p50_ms": p50,
                             "p90_ms": p90, "batches": batches,
                             "occupancy": reqs / batches}
        row["s"] = time.perf_counter() - t0
        say(f"  15c {kind}: {row['s']:.1f} s")
        out[kind] = row
        del st, mb, ref
        torch.cuda.empty_cache()
    out["launches"] = totals
    return out


def phase_halo_tiling(conv3x3, double_conv, k5, k6) -> dict:
    """15d: ``tiled_apply`` of the full-width denoise U-Net (seeded random
    weights, as the JAX test's bound of 0.1 on the border band was set)
    over MESH_SIZE strips against its untiled forward (kernel route)."""
    from celebrity_image_denoiser_tpu_torch.models.denoise_unet import (
        DenoiseGenerator,
    )
    from celebrity_image_denoiser_tpu_torch.parallel import (
        make_mesh,
        tiled_apply,
    )

    g = DenoiseGenerator(generator=torch.Generator().manual_seed(SEED))
    g = g.cuda().eval()
    mesh = make_mesh(devices=["cuda:0"] * MESH_SIZE)
    x = torch.from_numpy(np.random.default_rng(SEED).uniform(
        -1, 1, (1, 1024, 512, 3)).astype(np.float32)).cuda()
    counts = (conv3x3, double_conv, k5, k6)
    out = {}
    with torch.inference_mode():
        full = g(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        for halo in (32, 4):
            fn = tiled_apply(g, mesh, halo=halo)
            int8_counts(*counts, reset=True)
            y = fn(x)
            torch.cuda.synchronize()
            got = int8_counts(*counts)
            d = (y - full).abs()
            out[halo] = {"interior": float(d[:, 28:-28].max()),
                         "max": float(d.max()), "launches": got}
    h32, h4 = out[32], out[4]
    say(f"  15d: tiled_apply over {MESH_SIZE} strips of 256 rows (1x1024x512"
        f", the denoise U-Net with seeded weights, f32): halo 32 interior (rows 28..-28) max "
        f"diff {h32['interior']:.2e}, border band {h32['max']:.2e}; halo 4 "
        f"max diff {h4['max']:.2e}; launches {h32['launches']}")
    if h32["launches"] != tuple(MESH_SIZE * c for c in PER_FORWARD["float"]):
        fail(f"15d: launches {h32['launches']}")
    if not (h32["interior"] <= 1e-5 and h32["max"] < 0.1
            and h4["max"] > 1e-4):
        fail("15d: tiled_apply out of its bounds (interior 1e-5, band 0.1, "
             "halo 4 above 1e-4)")
    return {"halo32": h32, "halo4": h4,
            "launches": [a + b for a, b in zip(h32["launches"],
                                               h4["launches"])]}


def phase_multidevice(conv3x3, double_conv, k5, k6, noise) -> dict:
    """Phase 15: data-parallel training, the torch.distributed.run CLI,
    the serving mesh and halo tiling."""
    import tempfile

    say("== phase 15: multiple devices (one H100: the ranks and the mesh's "
        "entries share it, so these runs show exactness and overhead, not "
        "scaling)")
    t_phase = time.perf_counter()
    out = {}
    with tempfile.TemporaryDirectory(prefix="cid_multi_") as tmp:
        os.makedirs(f"{tmp}/dp")
        out["train"] = phase_dp_train(noise, f"{tmp}/dp")
        out["train"]["s"] = time.perf_counter() - t_phase
        say(f"  15a: {out['train']['s']:.1f} s")
        out["torchrun"] = phase_torchrun(noise, tmp)
    out["serve"] = phase_mesh_serve(conv3x3, double_conv, k5, k6)
    t0 = time.perf_counter()
    out["tiled"] = phase_halo_tiling(conv3x3, double_conv, k5, k6)
    out["tiled"]["s"] = time.perf_counter() - t0
    out["seconds"] = time.perf_counter() - t_phase
    say(f"  phase 15: {out['seconds']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# phase 16: the serving-weights trainer (cli.train_serving_weights) at the
# script's shapes, and the two examples
SW_SIZE, SW_BATCH, SW_SRGAN_BATCH, SW_CHUNK = 128, 32, 16, 50
# steps of denoise, dncnn and esrgan: dncnn starts as the identity (its
# 17-layer residual branch is ~1e-7 at PyTorch's init) and 100 steps left
# it 0.136 dB below the identity on the held-out blind-sigma draw, where
# 20,000 steps reach 11.4 dB (an H100 at 700 W, PERF.md §5)
SW_STEPS = {"denoise": 100, "dncnn": 1000, "esrgan": 100}
SW_SRGAN = ("--pretrain-steps", "100", "--steps", "50", "--ema", "0.995")
SW_TOWER_STEPS = 150  # three chunks: noise variants 1, 2 and 3
# the keys the script writes into meta.json (train_family:276-290, 296-327;
# train_perceptual:580-586)
SW_META = ("family", "steps", "pretrain_steps", "batch", "size", "lr",
           "stage_lr", "data", "psnr_out", "psnr_in", "gain_db",
           "fixture_gain_db")
SW_SRGAN_META = ("ema", "ema_selected", "lpips_out", "lpips_bicubic",
                 "battery_gain_db")
SW_TOWER_META = ("kind", "steps", "final_mse", "data")
SW_GAIN_TOL = 0.002  # dB: the recorded gain is rounded to 1e-3


@contextlib.contextmanager
def no_host_sync():
    """``torch.cuda.set_sync_debug_mode("error")`` for a ``with``."""
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(0)


def sw_runs(tmp) -> list:
    """(label, family, argv) of 16a's runs."""
    common = ["--chunk", str(SW_CHUNK), "--size", str(SW_SIZE), "--out",
              f"{tmp}/w"]
    runs = [(fam, fam, ["--family", fam, "--steps", str(steps),
                        "--batch", str(SW_BATCH)] + common)
            for fam, steps in SW_STEPS.items()]
    srgan = ["--family", "srgan", "--batch", str(SW_SRGAN_BATCH), *SW_SRGAN,
             "--pretrain-ckpt", f"{tmp}/stage1"] + common
    runs += [("srgan", "srgan", srgan), ("srgan cached", "srgan", srgan),
             ("perceptual", "perceptual",
              ["--family", "perceptual", "--steps", str(SW_TOWER_STEPS),
               "--batch", str(SW_BATCH)] + common)]
    return runs


def sw_check_run(label, family, res, out_dir, evals, launches, guarded,
                 card) -> dict:
    """16a's checks of one run; returns its row."""
    from celebrity_image_denoiser_tpu_torch.train import serving

    meta, chunks = res["meta"], res["chunks"]
    stages = sorted({c["stage"] for c in chunks})
    steps = len(chunks) * SW_CHUNK
    want_k4 = steps + len(evals)
    if launches["k4"] != want_k4:
        fail(f"16a {label}: {launches['k4']} noise launches for {steps} "
             f"training steps and {len(evals)} evaluations")
    for fam, k2, k3 in evals:
        if (k2, k3) != EVAL_PER_FORWARD[fam]:
            fail(f"16a {label}: an evaluation launched K2 x{k2}, K3 x{k3}, "
                 f"expected {EVAL_PER_FORWARD[fam]}")
    if len(guarded) != len(stages):
        fail(f"16a {label}: {len(guarded)} chunks ran under the sync check "
             f"for stages {stages}")
    values = [v for c in chunks for k, v in c.items()
              if k not in ("stage", "steps")]
    sections = np.load(os.path.join(out_dir, "arrays.npz"))
    if not (all(np.isfinite(values))
            and all(np.isfinite(sections[k]).all() for k in sections.files)):
        fail(f"16a {label}: a non-finite loss or parameter")
    keys = SW_TOWER_META if family == "perceptual" else SW_META + (
        SW_SRGAN_META if family == "srgan" else ())
    with open(os.path.join(out_dir, "meta.json")) as f:
        written = json.load(f)
    if any(k not in written for k in keys) or written != meta:
        fail(f"16a {label}: meta.json {sorted(written)} lacks one of "
             f"{keys}, or differs from the returned meta")
    rates = {s: [round(c["images_per_s"], 1) for c in chunks
                 if c["stage"] == s] for s in stages}
    row = {"steps": steps, "evaluations": len(evals), "launches": launches,
           "images_per_s": rates, "chunk_s": [c["seconds"] for c in chunks]}
    if family == "perceptual":
        loss = serving.load_perceptual(out_dir, log=lambda m: None).cuda()
        if not loss.to_unit:
            fail("16a: the written tower loads as a random one")
        x = torch.rand((2, 3, 64, 64), generator=make_gen(), device="cuda")
        d = float(loss(x * 2 - 1, x.flip(0) * 2 - 1))
        if not (np.isfinite(d) and d > 0):
            fail(f"16a: the written tower's content loss is {d}")
        row["final_mse"] = meta["final_mse"]
    say(f"  {label}: {steps} steps ({', '.join(stages)}), images/s a chunk "
        f"{rates}, {len(evals)} evaluations; K4 {launches['k4']}, K2 "
        f"{launches['k2']}, K3 {launches['k3']}, K5 {launches['k5']}; one "
        f"chunk a stage under set_sync_debug_mode('error'); finite; "
        f"meta.json has the script's keys [{card}]")
    return row


def sw_served(label, family, weights, meta) -> dict:
    """A fresh int8 ``ServeState`` on ``weights`` reproduces the recorded
    fixture gain (srgan: and battery gain)."""
    from celebrity_image_denoiser_tpu_torch.serve import quality
    from celebrity_image_denoiser_tpu_torch.serve.handlers import ServeState

    st = ServeState(weights_dir=weights, quantize="int8")
    if family not in st._weights_loaded:
        fail(f"16a {label}: ServeState did not load {weights}/{family}")
    got = {"fixture_gain_db": quality.fixture_gain_db(st, family)}
    if family == "srgan":
        got["battery_gain_db"] = quality.srgan_battery_gain_db(st)
    for k, v in got.items():
        if not abs(v - meta[k]) <= SW_GAIN_TOL:
            fail(f"16a {label}: served {k} {v:.4f} against the recorded "
                 f"{meta[k]}")
    return {"rung": st.ladder(family), **got}


def phase_serving_weights(card, conv3x3, double_conv, k5, noise) -> dict:
    """16a: every family through ``cli.train_serving_weights`` at the
    script's shapes into a temporary ``--out``."""
    import tempfile

    from celebrity_image_denoiser_tpu_torch.cli import (
        train_serving_weights as cli_sw,
    )
    from celebrity_image_denoiser_tpu_torch.train import qat, serving

    say(f"  16a: cli.train_serving_weights at full width, {SW_SIZE}², batch "
        f"{SW_BATCH} (srgan {SW_SRGAN_BATCH}), chunks of {SW_CHUNK}")
    guarded, evals = [], []

    def guard(index):
        if index:
            return contextlib.nullcontext()
        guarded.append(index)
        return no_host_sync()

    real_report = qat.heldout_report

    def counted(family, generator, noisy01, clean01):
        k2, k3 = conv3x3.LAUNCHES, double_conv.LAUNCHES
        rep = real_report(family, generator, noisy01, clean01)
        evals.append((family, conv3x3.LAUNCHES - k2,
                      double_conv.LAUNCHES - k3))
        return rep

    out = {"runs": {}, "launches": {"k2": 0, "k3": 0, "k4": 0, "k5": 0}}
    real_guard = serving.chunk_guard
    serving.chunk_guard, qat.heldout_report = guard, counted
    try:
        with tempfile.TemporaryDirectory(prefix="cid_sw_") as tmp:
            for label, family, argv in sw_runs(tmp):
                init_gain = None
                if family in ("denoise", "dncnn", "esrgan"):
                    g, _ = serving.build_models(
                        family, SW_SIZE, torch.Generator().manual_seed(0))
                    init_gain = qat.evaluate(family, g.cuda(),
                                             SW_SIZE)["gain_db"]
                    del g
                torch.cuda.empty_cache()
                noise.LAUNCHES = conv3x3.LAUNCHES = 0
                double_conv.LAUNCHES = k5.LAUNCHES = 0
                evals.clear()
                guarded.clear()
                torch.cuda.reset_peak_memory_stats()
                t0 = time.perf_counter()
                res = cli_sw.run(argv)
                wall = time.perf_counter() - t0
                peak = torch.cuda.max_memory_allocated() / 2 ** 30
                launches = {"k2": conv3x3.LAUNCHES,
                            "k3": double_conv.LAUNCHES,
                            "k4": noise.LAUNCHES, "k5": k5.LAUNCHES}
                for k, v in launches.items():
                    out["launches"][k] += v
                served_dir = f"{tmp}/w/{family}"
                row = sw_check_run(label, family, res, served_dir, list(evals),
                                   launches, guarded, card)
                row.update(wall_s=wall, peak_gib=peak)
                if family == "srgan" and label.endswith("cached"):
                    if any(c["stage"] == "srgan-pretrain"
                           for c in res["chunks"]):
                        fail("16a: the second srgan run trained stage 1 "
                             "again instead of loading its cache")
                if family != "perceptual":
                    row["served"] = sw_served(label, family, f"{tmp}/w",
                                              res["meta"])
                    row["reports"] = res["reports"]
                    row["gain_db"] = res["meta"]["gain_db"]
                    row["init_gain_db"] = init_gain
                    if init_gain is not None and \
                            not res["meta"]["gain_db"] > init_gain:
                        fail(f"16a {label}: held-out gain "
                             f"{res['meta']['gain_db']} dB after training, "
                             f"{init_gain} dB before")
                    say(f"    held-out gain {res['meta']['gain_db']} dB "
                        + (f"(the initial weights {init_gain} dB on the "
                           "same draw) " if init_gain is not None else "")
                        + f"{res['reports'].get('stage1', '')}; served int8 "
                        f"on {row['served']['rung']}: "
                        + ", ".join(f"{k} {v:.4f} (recorded "
                                    f"{res['meta'][k]})"
                                    for k, v in row["served"].items()
                                    if k != "rung")
                        + f"; peak {peak:.2f} GiB, {wall:.1f} s [{card}]")
                else:
                    say(f"    final_mse {row['final_mse']:.5f}; loads with "
                        f"to_unit; peak {peak:.2f} GiB, {wall:.1f} s [{card}]")
                out["runs"][label] = row
    finally:
        serving.chunk_guard = real_guard
        qat.heldout_report = real_report
    return out


def phase_examples(card, conv3x3, double_conv, noise) -> dict:
    """16b: the quickstart on the card, its .pth served; the multichip
    walkthrough on the one card."""
    import tempfile

    from celebrity_image_denoiser_tpu_torch.examples import (
        multichip,
        quickstart,
    )
    from celebrity_image_denoiser_tpu_torch.serve.handlers import ServeState

    out = {}
    with tempfile.TemporaryDirectory(prefix="cid_quickstart_") as wd:
        noise.LAUNCHES = conv3x3.LAUNCHES = double_conv.LAUNCHES = 0
        t0 = time.perf_counter()
        res = quickstart.run(wd, device="cuda")
        wall = time.perf_counter() - t0
        launches = {"k2": conv3x3.LAUNCHES, "k3": double_conv.LAUNCHES,
                    "k4": noise.LAUNCHES}
        # a step each, and the held-out batch's noise
        if launches["k4"] != res["steps"] + 1 or (
                launches["k2"], launches["k3"]) != EVAL_PER_FORWARD[
                    "denoise"]:
            fail(f"16b quickstart: launches {launches} for {res['steps']} "
                 "steps and one held-out forward")
        if not (np.isfinite(res["psnr"]) and os.path.isfile(res["image"])):
            fail(f"16b quickstart: held-out PSNR {res['psnr']}, image "
                 f"{res['image']}")
        st = ServeState(weights_dir=res["weights_dir"])
        r = st.enhance("denoise", png_of(np.zeros((64, 64, 3), np.uint8)),
                       include_graph=False)
        if "denoise" not in st._weights_loaded or \
                not r["denoised_image_base64"]:
            fail("16b: the quickstart's .pth did not serve")
        out["quickstart"] = {"steps": res["steps"], "psnr": res["psnr"],
                             "wall_s": wall, "launches": launches}
        say(f"  16b quickstart: {res['steps']} steps, held-out PSNR "
            f"{res['psnr']:.2f} dB, K4 {launches['k4']}, one forward's K2/K3; "
            f"its denoise_epoch_499.pth served by ServeState; {wall:.1f} s "
            f"[{card}]")
    t0 = time.perf_counter()
    mc = multichip.run(devices=MESH_SIZE, ranks=DP_RANKS, device="cuda")
    wall = time.perf_counter() - t0
    rel = mc["train"]["first_step_rel"]
    if not (max(rel) <= DP_TOL["float32"]["loss"]
            and mc["sharded"]["max_abs_diff"] == 0.0
            and mc["tiled"]["interior"] == 0.0 and mc["tiled"]["finite"]):
        fail(f"16b multichip: first-step losses {rel} relative (tol "
             f"{DP_TOL['float32']['loss']}), sharded "
             f"{mc['sharded']['max_abs_diff']}, tiled {mc['tiled']}")
    out["multichip"] = dict(mc, wall_s=wall)
    say(f"  16b multichip: {mc['train']['backend']} ranks' step-1 losses "
        f"within {max(rel):.2e} of one process; sharded and tiled (interior) "
        f"outputs bit-equal to one device, tiled edge bands "
        f"{mc['tiled']['band']:.2e}; {wall:.1f} s [{card}]")
    out["launches"] = out["quickstart"]["launches"]
    return out


def phase_retrain(card, conv3x3, double_conv, k5, noise) -> dict:
    """Phase 16: the serving-weights trainer and the examples."""
    say("== phase 16: retrain the shipped weights (cli.train_serving_weights)"
        " and the examples")
    t0 = time.perf_counter()
    out = {"train": phase_serving_weights(card, conv3x3, double_conv, k5,
                                          noise)}
    out["examples"] = phase_examples(card, conv3x3, double_conv, noise)
    out["seconds"] = time.perf_counter() - t0
    say(f"  phase 16: {out['seconds']:.1f} s")
    return out


# chip_smoke.py RESTORMER_ONLY: phases 1, the build's K7, K8 and K9 lines,
# and 4g
RESTORMER_ONLY = "--restormer-only"


def restormer_only(_build, conv3x3) -> int:
    """Phase 4g alone, after the card's line and a build whose ptxas lines
    for K7, K8 and K9 (registers, shared memory, spills) are printed; then
    the kernels JSON of K7, K8 and K9 and the ok line."""
    t_start = time.perf_counter()
    card = phase_device()
    res = _build.build()
    say(f"== build: {res.seconds:.1f} s (cached {res.cached})")
    keep = False
    for line in res.log.splitlines():
        if line.startswith("== "):
            keep = line[3:] in ("dwconv3x3.cu", "mdta_attention.cu",
                                "pointwise_gemm.cu")
        if keep and ("Compiling" in line or "registers" in line
                     or "spill" in line):
            say("  " + line.strip())
    _build.library()
    kernels = restormer_kernel_entries(phase_restormer(conv3x3))
    say(f"card: {card}; total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def main() -> int:
    # the port first: run outside a checkout, this fails before anything
    from celebrity_image_denoiser_tpu_torch import bench
    from celebrity_image_denoiser_tpu_torch.ops.cuda import (
        _build,
        conv3x3,
        double_conv,
        noise,
    )
    from celebrity_image_denoiser_tpu_torch.ops.cuda import conv3x3_s8 as k5
    from celebrity_image_denoiser_tpu_torch.ops.cuda import convt2x2_s8 as k6

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "runs on an NVIDIA card", file=sys.stderr, flush=True)
        return 2
    # the plain versions are the reference: full f32, no TF32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    if len(sys.argv) == 3 and sys.argv[1] == PROFILE_CHILD:
        return profile_child(sys.argv[2])
    if sys.argv[1:] == [RESTORMER_ONLY]:
        return restormer_only(_build, conv3x3)

    t_start = time.perf_counter()
    card = phase_device()
    probes, issue = phase_build(_build, noise)
    ship_trace = phase_ship_trace(noise)
    worst = phase_kernels(_build, conv3x3, double_conv)
    worst8 = phase_int8_kernels(_build, conv3x3, k5, k6)
    launches = phase_serve(conv3x3, double_conv)
    int8_launches = phase_int8_serve(conv3x3, double_conv, k5, k6)
    tiled_launches = phase_tiling(conv3x3, double_conv, k5, k6)
    mb_launches = phase_microbatch(conv3x3, double_conv, k5, k6)
    family_launches, families, f32_rows, family_err = phase_families(
        conv3x3, double_conv, k5, k6)
    cgan_launches, families["cgan"], cgan_rows, cgan_tail, cgan_err = \
        phase_cgan(conv3x3, double_conv, k5, k6)
    restormer = phase_restormer(conv3x3)
    # (K2, K3, K5, K6) launched by the serving phases 4b-4f
    served = [sum(c) for c in zip(int8_launches, tiled_launches, mb_launches,
                                  family_launches, cgan_launches)]
    stats, bench_launches, layer_ms = phase_bench(conv3x3, double_conv, k5,
                                                  k6, bench, worst)
    stats8 = phase_int8_times(conv3x3, k5, k6, layer_ms)
    phase_big_batch(bench)
    phase_profile()
    noise_err = phase_noise_kernel(noise)
    phase_train_check(conv3x3, double_conv)
    phase_train_check_families()
    noise_launches, gaussian_launches, trainer, batch, step_sec = \
        phase_train(conv3x3, double_conv, noise)
    if noise_launches < 1:
        fail("noise_batch was not launched on the training path")
    noise_stats = phase_train_profile(_build, probes, noise, trainer, batch,
                                      step_sec, issue)
    del trainer, batch
    torch.cuda.empty_cache()
    family_noise_launches, train_rows, noise_modes = \
        phase_train_families(noise)
    data = phase_data(noise)
    torch.cuda.empty_cache()
    ship = phase_ship(conv3x3, double_conv, k5, noise, ship_trace)
    # (K2, K3, K4, K5) launched on phase 14's paths: the extras' epoch,
    # cli.eval, the export round trip, cli.qat (its steps, evaluations and
    # served gate), the trainings' input stage
    ship_k2 = ship["extras"]["k2"] + ship["eval"]["k2"] + \
        ship["export"]["k2"] + ship["qat"]["k2"]
    ship_k3 = ship["extras"]["k3"] + ship["eval"]["k3"]
    ship_k4 = ship["extras"]["k4"] + ship["remat"]["k4"] + \
        ship["qat"]["k4"] + ship["profile"]["k4"]
    ship_k5 = ship["qat"]["k5"]
    multi = phase_multidevice(conv3x3, double_conv, k5, k6, noise)
    # (K2, K3, K5, K6) of phase 15's mesh paths: the sharded requests and
    # micro-batches (15c) and tiled_apply (15d); K4 of its ranks' and the
    # resumed epoch's steps (15a, 15b)
    multi_k = [a + b for a, b in zip(multi["serve"]["launches"],
                                     multi["tiled"]["launches"])]
    multi_k4 = multi["train"]["k4_launches"] + \
        multi["torchrun"]["k4_launches"]
    retrain = phase_retrain(card, conv3x3, double_conv, k5, noise)
    # (K2, K3, K4, K5) of phase 16's paths: the serving-weights trainer's
    # steps, held-out evaluations and fixture recordings, and the quickstart
    retrain_k = [retrain["train"]["launches"][k]
                 + retrain["examples"]["launches"].get(k, 0)
                 for k in ("k2", "k3", "k4", "k5")]

    replaces = {
        "conv3x3_bias_relu":
            "celebrity_image_denoiser_tpu/ops/pallas/conv_fused.py:143",
        "double_conv3x3_relu":
            "celebrity_image_denoiser_tpu/ops/pallas/double_conv.py:108",
    }
    kernels = []
    for name in ("conv3x3_bias_relu", "double_conv3x3_relu"):
        if launches[name] < 1 or bench_launches[name] < 1:
            fail(f"{name} was not launched on the main path")
        s = stats[name]
        entry = {
            "name": name, "route": "cuda",
            "source": f"celebrity_image_denoiser_tpu_torch/csrc/{name}.cu",
            "replaces": replaces[name],
            # the main paths: the float and int8 /enhance requests (single,
            # tiled and micro-batched; the dncnn, esrgan and srgan requests
            # of phase 4e, the cgan ones of 4f) and the bench run (the int8
            # requests launch K2 in its s8 mode only)
            # and phase 14's (cli.eval, the epoch extras, cli.qat, the
            # export round trip)
            # and phase 15's mesh paths, phase 16's evaluations, recordings
            # and quickstart; K2 also phase 4g's restormer requests
            "launches": (launches[name] + bench_launches[name]
                         + (served[0] + ship_k2 + multi_k[0] + retrain_k[0]
                            + restormer["launches"]["K2"]
                            if name == "conv3x3_bias_relu"
                            else served[1] + ship_k3 + multi_k[1]
                            + retrain_k[1])),
            "max_abs_err": worst[name],
            # the largest error of a phase 4e/4f launch, × max|ref|
            "families_max_rel_err": max(family_err, cgan_err),
            "ms": s["ms"], "plain_ms": s["plain_ms"],
            "bound_ms": s["bound_ms"],
            "bound_by": ("operations" if s["operations"] >= s["bytes"]
                         else "bytes"),
            "library_ms": s["library_ms"],
        }
        # f32 at the families' shapes and the U-Net's (phase 4e)
        entry["f32"] = [{k: r[k] for k in ("layer", "shape", "ms",
                                           "plain_ms", "library_ms",
                                           "bound_ms", "bound_by",
                                           "cuda_core_bound_ms")}
                        for r in f32_rows if r.get("kernel") == name]
        if name == "conv3x3_bias_relu":
            entry["cgan_tail"] = cgan_tail  # phase 4f, 2048²
            entry["also_replaces"] = (
                "celebrity_image_denoiser_tpu/ops/pallas/conv_fused.py:85")
            # its s8-out mode, the int8 step's first conv (phases 3b, 5b)
            q8 = stats8["conv3x3_bias_relu_q8"]
            entry["q8"] = {"max_abs_err": worst8["q8"], "ms": q8["ms"],
                           "plain_ms": q8["plain_ms"],
                           "bound_ms": q8["bound_ms"]}
        kernels.append(entry)
    # K5 and K6 have no Pallas original: the JAX package computes these
    # convs in XLA; no library call computes an int8 conv on the card
    for name, kind, where, n_launch in (
            ("conv3x3_s8", "k5", "celebrity_image_denoiser_tpu/ops/"
             "quant_unet.py:55 (_conv_q, an XLA conv)",
             served[2] + ship_k5 + multi_k[2] + retrain_k[3]),
            ("convt2x2_s8", "k6", "celebrity_image_denoiser_tpu/ops/"
             "quant_unet.py:62 (_convt_q, an XLA conv)",
             served[3] + multi_k[3])):
        if n_launch < 1 or bench_launches[name] < 1:
            fail(f"{name} was not launched on the main path")
        s = stats8[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"celebrity_image_denoiser_tpu_torch/csrc/{name}.cu",
            "replaces": where,
            # the int8 /enhance requests (single, tiled and micro-batched;
            # for K5 the families' of phase 4e too) and the bench run
            "launches": n_launch + bench_launches[name],
            "max_abs_err": worst8[kind],
            # per int8 bench step, summed over its launches (phase 5b)
            "ms": s["ms"], "plain_ms": s["plain_ms"],
            "bound_ms": s["bound_ms"],
            "bound_by": ("operations" if s["operations"] >= s["bytes"]
                         else "bytes"),
            "library_ms": None,
            # a yardstick, not the same function: torch._int_mm at the
            # layers' GEMM shapes without the epilogue (phase 5b; K5's
            # Cout = 3 output conv has none); for K6 also the bf16 step's
            # cuDNN transpose convs, printed in phase 5b
            "int_mm_ms": s.get("int_mm_ms"),
        })
        if name == "conv3x3_s8":  # its raw f32 mode, phases 4e and 4f
            kernels[-1]["raw_f32"] = [r for r in f32_rows
                                      if "int_mm_ms" in r]
            # cgan's 4x4 stride-2 layers through the exact rewrites, 2048²
            kernels[-1]["cgan_rewrites"] = cgan_rows
    kernels += restormer_kernel_entries(restormer)
    g = noise_stats["gaussian_only"]
    kernels.append({
        "name": "noise_batch", "route": "cuda",
        "source": "celebrity_image_denoiser_tpu_torch/csrc/"
                  "normalize_gaussian_noise.cu",
        "replaces":
            "celebrity_image_denoiser_tpu/ops/pallas/noise_kernel.py:46",
        # the cli.train runs of phases 10 (denoise), 12 (dncnn, esrgan,
        # cgan, srgan) and 13 (denoise over the native stage) and their
        # timed windows, one launch per step; and phase 13's renders, one
        # per batch and type; counts set to 0 just before each
        # and phase 15's ranks (15a) and resumed epoch (15b); phase 16's
        # training steps and evaluations, and the quickstart's steps
        "launches": (noise_launches + family_noise_launches
                     + data["render"]["launches"]
                     + data["native"]["k4_launches"] + ship_k4 + multi_k4
                     + retrain_k[2]),
        "max_abs_err": max(noise_err, noise_stats["max_abs_err"]),
        # one launch at the train batch (16 x 256 x 256 x 3, f32 noisy and
        # clean), phase 11; no single PyTorch call computes this
        "ms": noise_stats["ms"], "plain_ms": noise_stats["plain_ms"],
        "bound_ms": noise_stats["bound_ms"],
        "bound_by": noise_stats["bound_by"],
        "library_ms": None,
        # each mode the trainers run, at the train batch (phase 12)
        "modes": noise_modes,
        # cli.noise_gen's launches: every sample one kind on [0, 1], at the
        # renderer's batch (phase 13; ms per kind, bound by bytes)
        "render": {k: data["render"][k] for k in (
            "launches", "ms", "plain_ms", "bound_ms", "max_abs_err",
            "images_per_s")},
        # the same kernel through the Pallas function's counterpart (every
        # element gaussian, one f32 output), at the same batch; its own
        # count over the same cli.train runs (0: not on the main path)
        "gaussian_only": {
            "entry": "fused_normalize_gaussian_noise",
            "launches": gaussian_launches,
            "max_abs_err": noise_err, "ms": g["ms"],
            "plain_ms": g["plain_ms"], "bound_ms": g["bound_ms"],
            "bound_by": g["bound_by"], "library_ms": None},
    })
    print(json.dumps({"families": families}), flush=True)
    print(json.dumps({"train_families": train_rows}), flush=True)
    print(json.dumps({"data": data}), flush=True)
    print(json.dumps({"ship": ship}), flush=True)
    print(json.dumps({"multi": multi}), flush=True)
    print(json.dumps({"retrain": retrain}, default=str), flush=True)
    say(f"card: {card}; total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
