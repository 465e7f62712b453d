#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA H100 (sm_90a).

    python3 chip_smoke.py

Drives the port's main paths end to end, the serving path at the ADM-256
widths of the fork's CLIP-conditioned UNet, classifier-guided sampling with
ADM-G 256 and its classifier, training of the fork's 128 px recipe (bf16 and
int8), sampling and scoring what it trained through the fork's CLIs,
training the classifier, the fork's CLIP at ViT-B/32's widths (embeddings
and CLIP-guided sampling) and the fork's SR models through the four SR CLIs,
and exits non-zero if any phase fails; each phase's seconds are logged:

  1. device: the card's name, power limit and compute capability (9, 0);
  2. build: the CUDA kernels of ``guided_diffusion_clip_tpu_torch/ops/csrc``
     compiled from this checkout (one nvcc per source, in parallel);
  3. each forward kernel (K1 attention, K3 GroupNorm) against its plain
     PyTorch version on the card, at the shapes the paths give it, in f32
     (TF32 off) and bf16, with kernel and plain times (median of 12 runs
     after warm-up, CUDA events). K1 also at the recipe's one-head
     attention at batch 8 and 16 (image_sample, and under CFG), at the
     classifier's blocks and pool at batch 16 (classifier_train's
     microbatches) and at the 64 px quality proxies' (phase 16: d = 96 and
     128 in the generator, d = 96 in the classifier, batch 16), and in f32
     at every other attention shape of the quality tools' float32 networks
     (``proxy_f32_attn_shapes``: the 16 px ones, d = 64 and 32, and batch
     36 as phase 16 runs them; the blocks are picked by the shape). K3 (one launch a call) at six maps of the UNet and the
     classifier, at the recipe's four and at the classifier's 256 px map at
     batch 16 must also give each group's mean and rstd
     within 1e-5 relative of the plain version's, and the same bits again.
     K1 in bf16 and f32 (every d) must go to
     the tensor-core kernels (``launches_mma``; the f32 ones also count in
     ``launches_f32``); beside each bf16 case and the f32 ones of
     ``F32_TIMED_SHAPES`` (the classifier pool, the quality proxies', an f32
     torso's T = 1024) the log has ``F.scaled_dot_product_attention`` (in
     f32 with TF32 off), the FMA-pipe kernel on the same input (through its
     C entry point, for the log only) and the bound, f32's at the split-TF32
     rate;
  3b. the same for K2 (attention backward) at the classifier's shapes at
     batch 8 (guidance) and 16 (classifier_train), and in bf16 at the
     ADM-256 UNet's at batch 8 (clip_guided_sample's pred-x0 guidance), and
     at the quality proxies' d = 96 in f32 and bf16 and d = 128 in f32, and
     in f32 at (8, 1024, 8, 64) and at 3's other proxy shapes; in
     bf16 it is also held to the float64 result of the same values, where
     it may not be further off than the FMA kernel by more than f32's own
     rounding; the f32 timed shapes are timed against the library and the
     FMA kernel as in 3;
  4b. the full-width classifier's logits and guidance gradient (batch 1,
     f32, TF32 off), card (K1, K2, K3) against the CPU (plain versions);
  5. the HTTP server (``guided_diffusion_clip_tpu_torch.serve``) built from
     flags with random weights loaded from a .pt, answering /healthz and
     /sample requests (padded, explicit clip_feat, chunked, coalesced), with
     the kernels' launch counters checked against the forwards it ran;
  6. ``classifier_sample.main`` on the bf16 ADM-G 256 UNet and classifier
     (random weights from .pt files), 15 ancestral steps at batch 8 (the
     250 of bench.py cut to ``GUIDED_STEPS``: 100 before phase 13 came, 50
     before phase 17, 25 before phase 13b's torchrun children came back), with
     the launch counters checked against the steps it ran; then one guided
     step timed by part (each part as calls back to back, as the chain
     issues them) and profiled by kernel.

The int8 path (``--conv_impl int8``, kernels K4 and K5) adds:
  3c. K4 (the quantizing GroupNorm) against its plain version at the paths'
      shapes, with and without scale-shift, f32 and bf16, both emissions,
      with the same stats and repeat checks as K3;
  3d. K5 (the s8 conv) against its plain version, and cuDNN's bf16 conv
      timed at the same shapes: 3x3 at 256/32/16/8 px, the stems, the head,
      1x1 and stride-2 convs, an odd M and batch 1. Every shape with
      C % 16 == 0 and K > 16 must go to ``conv_s8_mma.cu``
      (``launches_mma``), every stem and head to ``conv_s8_thin.cu``
      (``launches_thin``), and each must equal the ``__dp4a`` kernel's
      output bit for bit (exact sums, the same epilogue, split launches
      included) and a repeat run; the ``__dp4a`` kernel's time is logged
      beside it;
  3g. the two quantize kernels of ``int8_conv`` against
      ``quantize_per_tensor`` on the card (all zeros, one huge value, exact
      ties, f32 and bf16, a size that is no multiple of 16);
  4c. a full-width int8 forward (batch 1, f32, TF32 off), card against
      CPU, teacher-forced: every quantizing GroupNorm's (q, s) and every
      per-tensor int8 conv's output is checked against the CPU's and
      replaced by it (a level that rounds the other way would otherwise
      move every later layer), the output head compared;
  4d. the same for the full-width int8 classifier's logits and guidance
      gradient;
  5b. ``serve --conv_impl int8`` answering requests (the same request
      twice gives the same bytes);
  6b. ``classifier_sample.main --conv_impl int8`` at batch 8, with its
      samples' spread held to the bf16 chain's, and one int8 guided step
      timed by part and profiled by kernel.

The deploy preset's sampling knobs and the last two kernels add:
  3e. K6 (the fused quantizing conv, both modes on the tensor cores) against
      its plain version at 256 px, 256 -> 256 and 32 px, 512 -> 512, batch 8,
      f32 and bf16 inputs, both modes, with cuDNN's bf16 conv timed at the
      same shapes;
  3f. K7 (the tensor-core probe) against its plain version (s8 bit for bit,
      wrapped sums included; bf16 at small T), then its two-T rate;
  4e. a full-width ``cache_mode="full"`` forward and a ``"shallow"`` one fed
      its deep feature (batch 1, f32, TF32 off), card against CPU, and on
      the card the shallow forward against the plain one at the same (x, t)
      and the plain one (through the kernels) against the CPU's full one
      (through the plain versions), which a phase 4 once held with a CPU
      forward of its own;
  5c. ``serve --cfg_scale 2.0 --cfg_cache 2 --sampler dpm++2m``, bf16, 25
      steps: the same request twice gives the same bytes, and the model ran
      steps + refreshes times a chain;
  6c. ``classifier_sample.main`` with the preset's four knobs (``--conv_impl
      int8 --deep_cache 5 --guidance_cache 2 --guidance_interval 200,800``),
      ``GUIDED_STEPS`` ancestral steps at batch 8: the launch counts equal those derived
      from the modules (full and shallow forwards) and from the schedule
      (which steps run the classifier);
  7.  the two tool entry points, ``tools.conv_bench`` and
      ``tools.mxu_ceiling``, called in-process: the paths that launch K6, K7.

Training, the fork's recipe (``configs/config.yaml``: the CLIP-conditioned
UNet at 128 px, one head at 16 and 8 px, bf16 torso, batch 48), adds:
  8a. K1 and K2 at its attention shapes (batch 48, d = 192 at T = 256 and
      d = 256 at T = 64), f32 and bf16 (the tensor-core kernels:
      ``launches_mma`` rises by one each, ``launches_f32`` in f32), against
      their plain versions, the same bits again, with the library call (f32
      with TF32 off) and the bound beside them; in bf16 also the FMA kernels'
      time on the same input, K1 with 32 and with 64 query rows a block, and
      both kernels held to the float64 result as in 3b;
  8b. one ``TrainLoop`` step of the full-width model (batch 4, dropout 0) on
      the card and on the CPU from the same weights, batch, t and noise: in
      f32 (TF32 off) loss, grad_norm, updated parameters and gradient within
      1e-3 relative L2; with the recipe's bf16 torso (f32 parameters, the
      convs' weights cast at the call, K1/K2/K3 in bf16 under autograd)
      within ``TRAIN_BF16_TOL``, the CPU's bf16 step against its f32 step
      printed beside it as the control;
  8c. ``python -m guided_diffusion_clip_tpu_torch.image_train --config-file``
      on 64 generated PNGs and a ``.pt`` CLIP dict (the recipe's file with
      save_interval 10, log_interval 5, the paths pointed at them and,
      respaced to ``VAL_STEPS`` steps for its validation chains), with
      ``DIFFUSION_TRAINING_TEST=1``: the three checkpoints, finite losses in
      progress.csv, the model loading strict=True into the sampler, and the
      entry point's ms a step and samples/s over steps 6-10, loader
      included, with the loop's wait for the loader; then a resume from
      ``model000010.pt`` for 2 steps (step, EMA and Adam count restored);
      the resume runs with ``--profile_dir``, whose trace must hold the
      ``train_step`` scope (``GDC_NATIVE_LOADER=1`` is not run: the native
      decoder needs libjpeg's and libpng's headers to build);
  8d. ``TIMED_STEPS`` timed ``run_step`` calls at batch 48 after 5 of warm-up, without
      and with ``use_checkpoint``: no host sync (``set_sync_debug_mode``),
      K1/K2/K3 launches against the counts from the modules (every K1/K2
      launch on the tensor-core kernels), ms a step and its split by part,
      samples/s, peak memory, device time by kernel group;
  8e. ``--train_conv_impl int8``: one step (batch 4, dropout 0) card against
      CPU, teacher-forced (``Int8Forcing``), in f32 within 1e-3 relative L2
      and with the bf16 torso within ``INT8_TRAIN_TOL``; then 20 int8 steps
      at batch 48 as 8d, K1-K5 and the quantize kernels counted.

Sampling and scoring the trained recipe through the fork's CLIs (from 8c's
run directory, ``configs/image_sample_config.yaml`` pointed at 16 generated
256 px test images):
  9.  ``image_sample.main`` from a checkpoint of N(0, 0.02) weights written
      into 8c's run directory (8c's EMA is still the initialization, whose
      output is 0), two batches of 8, ``SAMPLE_STEPS`` respaced ancestral steps, in
      bf16, with ``--conv_impl int8``, with ``--cfg_scale 3 --cfg_cache 2``
      and with ``denoise_start_point 800``: the UNet's forwards against the
      schedule, the launches against the modules' counts, seconds a batch,
      each mode's samples other than bf16's; then 5-step DDIM chains of
      ``image_sample.make_chain`` card against CPU (``SAMPLE_CHAINS``): f32
      at batch 2, bf16 and int8 (teacher-forced) at batch 4;
  9b. ``image_sample_repeat.main --repeats 2`` from 8c's EMA checkpoint: two
      run directories;
  9c. ``image_nll.main`` on 8 images from 8c's EMA checkpoint over a
      ``NLL_STEPS``-step schedule (its forwards, bpd and the term files;
      1000 once, whose other 900 forwards repeated phase 9's bf16 forward).

The classifier's trainer and the fork's CLIP (run inside phases 5-6's
directory, after 6c: phase 10 guides with 6's ADM-G 256 weights, 11 and 11b
use phase 5's ADM-256 CLIP UNet weights) add:
  10. ``classifier_train.main`` on ADM-G 256's classifier (``CLF_TRAIN_FLAGS``:
      batch 32 in microbatches of 16, noised, annealed, bf16 torso, 10
      iterations, a validation batch every 5) over generated class-named 256 px
      folders: the launches against the modules' counts (K1 and K2 a
      microbatch for each attention block and the float32 pool, K3 for each
      GroupNorm), progress.csv's keys, ms a step over steps 3-10 (CUDA
      events), peak memory; each of 5 steps' launches and the busy share
      (profiler) on the same trainer; one step (batch 2 in microbatches of 1)
      card vs CPU in f32 (TF32 off, 1e-3 relative L2) and with the bf16
      torso (``CLF_BF16_TOL``); then
      ``classifier_sample.main`` guiding 5 steps with the saved
      ``model000009.pt`` (strict=True);
  11. ViT-B/32 at its full widths (N(0, 0.02) weights written in OpenAI's
      names and loaded strict=True): both encoders in f32 card vs CPU (1e-3);
      the vision encoder's forward + backward at batch 8 (the CLIP-guided
      cond_fn's part), profiler device ms by kernel group;
      ``compute_clip_embeddings.main`` over 16 generated 256 px images card vs
      CPU (1e-3), ms an image, and its ``.pt`` fed to ``image_train`` (the
      recipe at batch 8) for 2 steps; the CLIP guidance gradient in pred-x0
      mode through the ADM-256 CLIP UNet (f32, batch ``CLIP_GRAD_BATCH``,
      model timestep 500 of a 100-step schedule) card vs CPU (1e-3);
  11b. ``clip_guided_sample.main`` on the ADM-256 CLIP UNet and ViT-B/32,
      ``--target_image``, batch 8, 5 ancestral steps (cut from 100 to 40 to
      pay for phase 12, to 20 for phase 13, to 10 for phase 14 and to 5 for
      phase 17), in bf16, with
      ``--conv_impl int8`` and with ``--guidance_cache 2``: the UNet's and
      CLIP's calls against the schedule, the launches against the modules'
      counts (two forwards and one backward a guided step), seconds a chain,
      peak memory. Until phase 17 came it also split a bf16 step by part (the
      loop's UNet forward, the cond_fn's, CLIP forward + backward, the UNet
      backward: ~20 s; since then phase 11 reads CLIP's part alone), and
      until phase 14 an int8 step, and held
      one int8 step (f32, batch 1) teacher-forced card vs CPU within
      ``CLIP_INT8_TOL``; ``--faults`` runs that step (twice clean, then
      under each fault), and the default run left both to pay for phase 14.

The fork's SR models (run inside phases 8-9's directory, after 9c, on 8c's
images and CLIP dict and phase 9's test set, checkpoint and samples): the
SR-delta model ``SRImageModel_Feat`` at the recipe's widths (x ++ img2, 6
input channels, the CLIP delta clip_feat - clip_feat2 + bias_feat as its
label) and the upstream ``SuperResModel`` (x ++ low_res upsampled 64 -> 128)
add:
  12a. the SR-delta model card vs CPU from N(0, 0.02) weights: a forward
      (batch 2, f32, TF32 off) within 1e-3 relative L2; one train step
      (batch 4, dropout 0, as 8b) with the bf16 torso within
      ``TRAIN_BF16_TOL``; one ``--train_conv_impl int8`` step teacher-forced
      in f32 within ``INT8_TRAIN_TOL``;
  12b. ``super_res_unsup.main`` on 8c's folder and dict with ``--data_dir_test``
      (the recipe's file, respaced to ``VAL_STEPS`` steps so that the save's
      two validation chains are that long), 11 steps at batch 48 and the
      save at step 10; then ``--load`` of that run with ``--train_conv_impl
      int8`` for 5 steps: the launches against the modules' counts, the files,
      the resume; then ``TIMED_STEPS`` timed steps at batch 48 each way, as 8d;
  12c. ``super_res_train.main`` (the upstream model, ``low_res`` from the
      loader) 3 steps at batch 48, its checkpoint loading strict=True into
      ``super_res_sample``'s model; ``super_res_sample.main`` from N(0, 0.02)
      weights on phase 9's samples area-downsampled to 64 px, batch 16,
      ``SR_SAMPLE_STEPS`` ancestral steps, bf16 and ``--conv_impl int8``: (16, 128, 128, 3) uint8
      samples, launches against the modules' counts, int8's samples other than
      bf16's and their spread within 0.5 of it;
  12d. ``super_res_depth_sweep_sample.main`` from phase 9's checkpoint on its
      test set: chains of 50, 70 and 90 respaced steps at batch 8 from img2,
      a PNG each plus ``target.png`` and ``start.png``, with their seconds.

More than one process, at world 1 (the card's machine has one GPU, and NCCL
takes one GPU a rank; ``parallel/``):
  13a. in this process, a world-1 process group (NCCL for CUDA tensors, gloo
      beside it) started and ended inside the phase: from one state and one
      batch of the recipe (batch 48, bf16 torso, dropout 0, the same t and
      noise), two plain steps (no group), then one step under DDP, one under
      FSDP2 (``param_sharding fsdp``) and one under ZeRO-1 (``opt_impl
      zero1``), each within ``TRAIN_BF16_TOL`` of the first plain step and
      within the plain steps' spread plus ``DIST_FLOOR`` (an f32 sum in
      another order); the spread is the larger of the two plain steps' and
      of a plain step with FSDP2's association of the gradient sums
      (``fsdp_association``) against the first, and FSDP2 must equal that step
      within ``DIST_FLOOR``; K1, K2 and K3 counted against the modules in
      each; each mode's step time beside the plain one (CUDA events). Then
      ``--train_conv_impl int8`` at batch 4, DDP and FSDP2 teacher-forced to
      the plain int8 step's roundings on the card (``Int8Forcing``, as 8e)
      within ``INT8_TRAIN_TOL`` of the plain int8 step of their association,
      K4, K5 and the quantize kernels counted too;
      a second FSDP2 int8 step must find every conv's cached ``w_q`` the
      quantization of the weights it read (FSDP2 refills the unsharded
      weights in place without a new version);
  13b. through ``python -m torch.distributed.run --standalone --nproc_per_node
      1``: ``image_train --param_sharding fsdp --ckpt_backend orbax`` from
      N(0, 0.02) weights on 8c's folder (the recipe, respaced to 25 steps so
      that the save's validation chain is 25 steps), stopped after its DCP
      save at step 3; resumed from ``<run>/orbax`` under ``--opt_impl zero1``
      for 3 more steps and a DCP save, while ``image_sample`` from
      ``<run>/orbax@ema_0.9999`` (25 steps, batch 8) runs under torchrun
      beside it (most of each child's time is its start); then
      ``image_sample`` in this process without torchrun: the same bytes.
      The DCP saves' seconds (blocking the loop, and until written) from the
      runs' logs.

The measuring tools (``guided_diffusion_clip_tpu_torch/tools/``), each through
its ``main()`` at its headline configuration, only its repeats and windows
cut by its own environment variables; each row's keys finite and positive,
its card the one ``nvidia-smi`` names, its launches counted against the
modules:
  14a. ``train_step_bench`` on the recipe (``TSB_CONFIG fork128``, batch 48),
      bf16 and ``TSB_CONV_IMPL int8``, one window of the tool's default 10
      steps: its device ms a step (the profiler's kernel sum) within
      ``TOOL_AGREEMENT`` of 8d's (8e's int8 ratio logged), its window's ms
      a step against 8d's median logged, and its FLOP count
      (``utils/flops.py``) the same both ways; run right after 8e;
  14b. ``perf_breakdown`` at batch 8, bf16: each part's device ms within
      ``TOOL_AGREEMENT`` of phase 6's profile of the same part
      (``profile_guided_step``), its CUDA-event ms against phase 6's
      logged (tests/test_torch_flops.py holds the guided step's FLOP
      count); run right after that split,
      so that both run in the same state of the process (at the end of the
      run the same parts' device ms read 0.71-1.01 of phase 6's).
      Wall-clock agreement is logged and not held: the recipe's step and
      the classifier's forward are host-bound (the card busy for 63-76 %
      and a quarter to a third of them), and on the shared host the same
      reading moved from 0.61 to 1.54 of the phase's within one run;
  14c. ``serve_bench`` at ADM-256, batch 8, ddim25, int8, 3 requests a
      measure: its server runs in another process, so the launches are the
      server's own, read from its ``/healthz`` against its forwards;
  14d. ``block_microbench`` at its four shapes.

The sampling benches, each through its ``main()`` on ADM-G 256 and its
classifier (``tools/_timing.make_models``: phase 6's configuration, the
tool's own N(0, 0.02) weights), int8, at a cut depth: ``PHASE15_BATCH``
images and ``PHASE15_STEPS`` respaced steps a chain; each row's keys finite,
its card the one ``nvidia-smi`` names, and its launches equal to those
derived from the modules (a full and a shallow UNet forward, a classifier
forward and backward) and from the schedule (which steps refresh a cache
or lie in a window), each chain run twice (warm-up, timed):
  15a. ``int8_quality_check`` at batch 1: one xla (bf16) and one int8 UNet
      forward and guidance gradient;
  15b. ``sampler_family_bench`` ``ddim10;dpm10;ancestral10`` under the
      classifier, then ``ddim10`` under ``cfg`` with ``SFB_CFG_CACHE 2`` (the
      UNet on the conditional batch each step and the unconditional one on
      every other step);
  15c. ``deep_cache_bench`` with ``DCB_INTERVALS 1,2,5``: the uncached chain's
      full forwards, then DeepCache's full forwards on the refresh steps and
      shallow ones between, the classifier every step; N = 1 refreshes
      every step, so it runs the uncached chain again, and its samples must
      equal the uncached chain's bit for bit (``rel_rmse`` 0), while each
      cached chain's must differ (``rel_rmse`` > 0);
  15d. ``guidance_interval_bench`` with ``GIB_WINDOWS 0,1000;200,800``: the
      classifier only on the steps whose model timestep lies in the window;
      the window [0, 1000] holds every step, so it runs the always-guided
      chain again, and its samples must equal that chain's bit for bit,
      while the windowed chain's must differ;
  15e. ``sample_overlap_bench`` with ``OB_BATCHES 1``: six unguided ddim25
      chains (warm-up, the host-only write's, two serial and two
      overlapped).

The quality tools, each through its ``main()`` at a cut depth
(``PHASE16_ENV``: ``PHASE16_TRAIN`` train steps of each proxy, one set of
``PHASE16_BATCH`` images, ``PHASE16_STEPS`` respaced steps a chain); each
line's keys the JAX tool's plus ``card``, every number finite, the card the
one ``nvidia-smi`` names, and its launches equal to those derived from the
modules (a float32 train step of the generator and of the classifier, bf16
and int8 generator forwards, full and shallow, the classifier's guidance
call and its forward), the train steps and the schedule:
  16a. ``int8_chain_quality`` at 16 px with ``INT8Q_VARIANT int8+dc5+gc2``:
      the generator and the noised classifier trained, four base-chain sets
      (bf16, fully guided) and the variant (the int8 generator refreshing its
      deep features on steps 0 and 5, the int8 classifier's gradient on every
      other step), the feature extractor's 20 steps;
  16b. ``guidance_quality_sweep`` at its 64 px default (K1 at d = 96 and 128
      in bf16 sampling and f32 training, K1 and K2 at d = 96 in the f32
      classifier), the points ``off:gc1`` and ``200:800:gc2`` (the
      classifier on the refresh steps inside the window) and the unguided
      set, the classifier's accuracy on each;
  16c. ``opt_long_horizon`` over ``tree,flat,zero1`` at 16 px (its one-rank
      process group started and ended in the tool).

Spatial partitioning (``--spatial_shard``, ``parallel/sp.py``):
  3h. the entries that K3, K4 and the quantize kernels split into on a row
      shard (``group_norm_stats``, ``group_norm_apply``,
      ``group_norm_quant_apply``, ``quantize_amax``, ``quantize_apply``)
      against their plain versions, f32 and bf16: the GroupNorm entries
      (``csrc/groupnorm_split.cu``) at ``SPLIT_MAPS`` (ADM-256's half-H
      map at every level, its concatenated widths, TP's local channels, the
      recipe's maps at batch 48, a 96-channel map, batch 8), the applies bit
      for bit against their first versions (``csrc/groupnorm.cu``), the
      stats' repeats bit-identical; at (2, 128, 256, 256) and (8, 128, 256,
      256) bf16 each timed beside its first version and plain version,
      host-inclusive and on the device (the profiler; a reading under its
      byte bound is marked L2-resident), and the split K3 and K4 beside their
      one launch; the amax pass's device time beside ``vector_norm(inf)``'s;
  17. two processes started by the smoke (``torch.multiprocessing``, gloo,
      both on cuda:0 after this process built the kernels; NCCL refuses two
      ranks on one GPU, so this is a test arrangement: the CLIs keep NCCL
      and one GPU a rank), a world of 2 with ``--spatial_shard 2``: ADM-256's
      CLIP UNet at batch 2 in f32 (TF32 off), bf16 and int8 (teacher-forced,
      ``Int8Forcing`` on the rank's rows), and ADM-G 256's classifier's
      guidance gradient in bf16 and in f32 (TF32 off),
      each rank's rows against the same model unsharded on the card
      (``SP_BOUNDS``) with its launches derived from the modules
      (``sp_counts``: K1 and its norm whole on the gathered map, every other
      GroupNorm split, every int8 conv's quantize split); then one bf16 train
      step of the recipe at batch 48 under DDP against the world-1 step taken
      first in this process (``SP_TRAIN_TOL``). Each comparison runs again
      with a fault on rank 1 (K3's statistics x 1.01, a dropped halo row) and
      logs its reading beside the clean one and the bound; a bound that no
      fault crosses fails the phase. The times are logged and claim nothing:
      two processes share one card and gloo stages through the host.

Tensor parallelism (``--tensor_shard``, ``parallel/tp.py``):
  18. in phase 17's two processes after their SP cases, SP cleared and TP 2
      set: the same forwards (int8 forced on the rank's channels), gradients
      and train step (``TrainLoop(tensor_shard=2)``), each whole output
      against the same call unsharded (``tp.whole()``, ``TP_BOUNDS``; the
      train step against phase 17's world-1 step, ``SP_TRAIN_TOL``) with its
      launches derived from the modules (``tp_counts``: K1 on the rank's
      heads, K3 on its 16 groups, K4 split with its bound reduced, K5 on the
      rank's output channels, the quantize kernels on gathered inputs), and
      again under a fault on rank 1 (``TP_FAULTS``: K3's statistics x 1.01,
      one ResBlock's scale and shift swapped, K4's per-image bound left
      unreduced), which must cross its bound.

    python3 chip_smoke.py --faults

builds the kernels and runs no path: it takes the two card-vs-CPU steps
whose bounds were set from faults, the bf16-torso classifier step of phase
10 and the int8 CLIP-guided step (11b's until phase 14 came), once on the CPU and then on the card
cleanly twice and under each of ``FAULTS`` (one kernel's result, or the
GroupNorm backward's, scaled on the card only), and prints each one's
distances beside the bounds they break.

Phases 3c, 3d and 3g hold K4, K5 and the quantize kernels at the recipe's
shapes too (64 channels at 128 px is 2 channels a GroupNorm group; the
3-channel stem, the SR models' 6-channel stem and the 6-channel head on
``conv_s8_thin.cu``; batch 8, 16 and 48), and 3d the quality proxies'
stem, 3-channel heads and 1x1 classifier heads.

Every count is set to 0 just before each main path (phases 5, 5b, 5c, 6, 6b,
6c, 7, the timed steps of 8d and 8e, each mode of 9, 9b and 9c, 10's
``classifier_train`` and its guided run, each mode of 11b, each CLI run and
the timed steps of 12b-12d, each mode's step of 13a, each tool of 14, 15 and 16, each of 17's and 18's sharded runs in
its process) and read just after it; every
K1 and K2 launch of a main path
(the sampling torsos at d = 64 and 96, the recipe's at d = 192 and 256) must have been a tensor-core launch, none
on the FMA-pipe kernels, and the float32 launches must be the modules' float32 calls: the classifier's attention
pool, float32 by the reference's design (one K1 and one K2 a classifier call), and in phase 16 the
quality tools' float32 training and classifiers.
Likewise every K5 launch of an int8 main path must have been a tensor-core
launch, none on ``__dp4a``: on ``conv_s8_thin.cu`` for the stems (3 channels
in, 6 in the SR models) and the 6-channel heads (3-channel in the quality
tools' proxies and their classifier), as many as the modules hold, and on
``conv_s8_mma.cu`` for every other conv; a ptxas spill in one of the tensor-core conv kernels
(the thin ones too), the quantize
kernels, the GroupNorm kernel (K3, K4), the bf16 K1/K2 at d = 64, 192 or 256 or K1 at d = 96, or the
float32 K1/K2 at any d fails the run (the other kernels' are printed).
The last lines are the kernels' JSON record (``launches`` summed over the main paths, K1's and K2's
split between their bf16 tensor-core kernels, timed at d = 64 in phases 3 and 3b,
and their float32 ones, timed at the classifier pool's shape there, K5's between
``conv_s8_mma.cu`` (``conv_s8``, timed at 3x3 256 -> 256 at 256 px) and ``conv_s8_thin.cu``
(``conv_s8_thin``, the stems and heads, timed at ADM-256's stem); ``bound_ms`` the least time the card
could take, from the bytes moved at 3.35 TB/s and the operations at the
data-sheet peak of their type; ``library_ms`` the time of the one PyTorch call
that computes the same function, timed here and used nowhere in the port),
the card's name and power limit, and ``{"ok": true, "device": {...}}``.
Without a CUDA device it exits non-zero and prints no result. It imports
nothing of JAX.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import glob
import io
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request

SLICE_FLAGS = [
    "--image_size", "256", "--num_channels", "256", "--num_res_blocks", "2",
    "--attention_resolutions", "32,16,8", "--num_head_channels", "64",
    "--resblock_updown", "True", "--use_scale_shift_norm", "True",
    "--learn_sigma", "True", "--class_cond", "True", "--use_fp16", "True",
    "--noise_schedule", "linear", "--diffusion_steps", "1000",
    "--timestep_respacing", "ddim25", "--use_ddim", "True",
    "--batch_size", "8", "--batch_buckets", "1,4", "--coalesce_ms", "50",
]
ATTN_PER_FORWARD = 16  # attention blocks of the ADM-256 UNet at 32/16/8 px
GN_PER_FORWARD = 101   # 42 ResBlocks x 2 + 16 attention norms + the head
# ADM-G 256 and its classifier (bench.py:170-198); 50 respaced ancestral steps. bench.py runs 250, with which
# the whole smoke took 991 s of the 1200 s it is allowed on an H100; the same tree with 100 took 1034 s on a
# slower host (its CPU steps), so 250 would leave no room there; the three chains take ~31 s at 100, ~72 s at 250.
# 50 to pay for phase 13 (with it and 100 steps the smoke took 1068 s), 25 for phase 17 (phases 5-6c: 188.1 ->
# 147.6 s), 15 for phase 17's f32 classifier gradient beside 13b's torchrun children
GUIDED_STEPS = 15
GUIDED_FLAGS = [
    "--image_size", "256", "--num_channels", "256", "--num_res_blocks", "2",
    "--attention_resolutions", "32,16,8", "--num_heads", "4", "--num_head_channels", "64",
    "--resblock_updown", "True", "--use_scale_shift_norm", "True", "--learn_sigma", "True",
    "--class_cond", "True", "--use_fp16", "True", "--noise_schedule", "linear",
    "--diffusion_steps", "1000", "--timestep_respacing", str(GUIDED_STEPS),
    "--classifier_use_fp16", "True", "--classifier_width", "128", "--classifier_depth", "2",
    "--classifier_attention_resolutions", "32,16,8", "--classifier_use_scale_shift_norm", "True",
    "--classifier_resblock_updown", "True", "--classifier_pool", "attention",
    "--classifier_scale", "1.0", "--batch_size", "8", "--num_samples", "8", "--seed", "0",
]
# per guided step: the UNet forward (16 K1, 101 K3), the classifier forward
# (7 attention blocks + the pool: 8 K1; 19 ResBlocks x 2 + 7 + out_norm: 46
# K3) and its backward (8 K2)
CLF_ATTN_PER_FORWARD = 8
CLF_GN_PER_FORWARD = 46
WEIGHT_SEED = 0


def log(msg: str) -> None:
    print(msg, flush=True)


def smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def cuda_ms(fn, runs: int = 12, warmup: int = 3) -> float:
    """Median device time of ``fn`` in ms (CUDA events around each call)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    times.sort()
    return times[len(times) // 2]


def tf32_off() -> None:
    """Full f32 matmuls and convs, for comparisons in f32."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


# the H100's data-sheet rates (SXM, dense): device memory, and operations by operand type; "f32x3" is float32
# work on the tensor cores as three TF32 products (the split of the float32 attention kernels) at the
# 494.7 T/s of dense TF32: 164.9 T/s, above the FMA pipes' 67 T/s, which such a kernel can run under
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bf16": 989e12, "s8": 1979e12, "f32": 67e12, "f32x3": 494.7e12 / 3}


def record(err, ms, plain_ms, nbytes, ops, op_type, library_ms=None) -> dict:
    """A kernel's headline record. ``nbytes``: every input read once and every
    output written once; ``ops``: the operations of the function on these
    inputs, of type ``op_type``."""
    t_bytes = 1e3 * nbytes / HBM_BYTES_PER_S
    t_ops = 1e3 * ops / PEAK_OPS_PER_S[op_type]
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations", "library_ms": library_ms}


def rate(ops, ms) -> str:
    """Operations over a time in ms, in T/s."""
    return f"{ops / (ms * 1e-3) / 1e12:.0f}"


def attention_bound(B, T, H, d, backward: bool, f32: bool = False) -> dict:
    """``record``'s bound of K1 (q, k, v read, out written; the two products)
    or K2 (qkv and dO read, dqkv written; five T x T x d products: S again,
    dP, dV, dQ, dK) in bf16, or with ``f32`` in float32 at the split-TF32
    rate ("f32x3"), for every float32 row, the FMA kernels' included."""
    size, op_type = (4, "f32x3") if f32 else (2, "bf16")
    if backward:
        return dict(nbytes=(3 + 1 + 3) * B * T * H * d * size, ops=10 * B * H * T * T * d, op_type=op_type)
    return dict(nbytes=4 * B * T * H * d * size, ops=4 * B * H * T * T * d, op_type=op_type)


# the classifier's attention pool at batch 8 (8 x 8 tokens and their mean; 512 channels in heads of
# 64, new head order): float32 by the reference's design, on the float32 tensor-core kernels
POOL_SHAPE = (8, 65, 8, 64, True)
# (B, T, heads, d, new_order) of the classifier's attention at 32, 16 and 8 px and of its pool, in
# classifier_train's microbatches of 16 (CLF_TRAIN_FLAGS)
CLF_TRAIN_ATTN_SHAPES = [(16, 1024, 4, 64, False), (16, 256, 8, 64, False), (16, 64, 8, 64, False),
                         (16, 65, 8, 64, True)]
# the ADM-256 UNet's attention at 32, 16 and 8 px at batch 8, whose K2 clip_guided_sample's
# pred-x0 guidance runs in bf16 (its f32 K2 runs at batch 1 in phase 11)
UNET_ATTN_SHAPES = [(8, 1024, 8, 64, False), (8, 256, 16, 64, False), (8, 64, 16, 64, False)]
# the 64 px quality proxies (tools/_proxies.py) at the tools' batch 16: the generator's attention at 16 and
# 8 px (384 and 512 channels in 4 heads), the classifier's at 16 px (192 channels in 2)
PROXY_ATTN_SHAPES = [(16, 256, 4, 96, False), (16, 64, 4, 128, False), (16, 256, 2, 96, False)]


def proxy_f32_attn_shapes() -> list:
    """(B, T, heads, d, new_order) of every attention layer of the quality
    tools' float32 networks (tools/_proxies.py: the 16 and 64 px generators,
    trained in float32, and their classifiers), read off the models' plans
    (``build_plan``), at the tools' batch 16 and phase 16's ``PHASE16_BATCH``.
    K1 and K2 pick their blocks by (T, B * heads, d), so each shape may run a
    block that no other case does."""
    from guided_diffusion_clip_tpu_torch.models.unet import build_plan
    from guided_diffusion_clip_tpu_torch.tools import _proxies as P

    shapes = set()
    for size in (16, 64):
        for cfg, encoder in ((P.generator_config(size), False), (P.classifier_config(size), True)):
            inp, mid, out, _ = build_plan(cfg)
            px, ch = size, cfg.model_channels
            for layer in (l for block in [*inp, mid, *([] if encoder else out)] for l in block):
                if layer["kind"] == "attn":
                    H = layer["heads"]
                    shapes.update((B, px * px, H, ch // H, cfg.use_new_attention_order) for B in (16, PHASE16_BATCH))
                    continue
                ch = layer["out"]
                if layer["kind"] == "down" or layer.get("down"):
                    px //= 2
                elif layer["kind"] == "up" or layer.get("up"):
                    px *= 2
    if not set(PROXY_ATTN_SHAPES) <= shapes:
        raise AssertionError(f"the proxies' attention {sorted(shapes)} lacks one of {PROXY_ATTN_SHAPES}")
    return sorted(shapes)


# the float32 shapes whose K1 and K2 are timed against the plain version, the library call (TF32 off), the
# FMA-pipe kernels and the bound: the pool, the quality proxies', and an f32 torso's 32 px attention
F32_TIMED_SHAPES = [POOL_SHAPE, *PROXY_ATTN_SHAPES, (8, 1024, 8, 64, False)]


def fma_attention(qkv, H, new, do=None):
    """K1 (or, given ``do``, K2) on the f32 FMA pipes (``attention_fwd.cu``,
    ``attention_bwd.cu``, the first versions), for a float32 or bf16 input,
    through the C entry points: the port sends every call to the tensor-core
    kernels, so this call is a yardstick for the log and ``held_to_f64``."""
    import math

    import torch

    from guided_diffusion_clip_tpu_torch.ops import attention as A
    from guided_diffusion_clip_tpu_torch.ops import build

    B, T, W = qkv.shape
    d = W // (3 * H)
    scale = 1.0 / math.sqrt(math.sqrt(d))
    lib, stream = build.load(), torch.cuda.current_stream(qkv.device).cuda_stream
    if do is None:
        out = torch.empty((B, T, H * d), dtype=qkv.dtype, device=qkv.device)
        rc = lib.gdc_attention_fwd(qkv.data_ptr(), out.data_ptr(), B, T, H, d, int(new), A._DTYPE_CODE[qkv.dtype],
                                   scale, stream)
    else:
        out = torch.empty_like(qkv)
        stats = torch.empty((3, B * H, T), dtype=torch.float32, device=qkv.device)
        rc = lib.gdc_attention_bwd(qkv.data_ptr(), do.data_ptr(), out.data_ptr(), stats.data_ptr(), B, T, H, d,
                                   int(new), A._DTYPE_CODE[qkv.dtype], scale, scale * scale, stream)
    build.check(rc, "the FMA attention kernel")
    return out


def attention_fwd_f64(qkv, H, new):
    """K1's function in float64 on the same bf16 values: q*s and k*s rounded
    to bf16 as the contract has it, the softmax, the weights (unrounded) and
    P V in float64."""
    import math

    import torch

    from guided_diffusion_clip_tpu_torch.ops import attention as A

    q, k, v = (a.transpose(1, 2) for a in A.split_qkv(qkv, H, new))  # (B, H, T, d)
    scale = 1.0 / math.sqrt(math.sqrt(q.shape[-1]))
    p = torch.softmax((q * scale).double() @ (k * scale).double().transpose(-1, -2), dim=-1)
    return A.merge_heads((p @ v.double()).transpose(1, 2))


def held_to_f64(name, out, fma, ref64) -> None:
    """A tensor-core kernel's bf16 result against the float64 one, beside the
    FMA kernel's on the same input: against the bf16 plain version both differ
    in last places only, and which of the two meets the larger of its flipped
    values is chance. The unrounded result tells them apart: the tensor-core
    kernel may not be behind the FMA kernel by more than f32's own rounding
    (one rounding of P or dS to bf16 would be 1e-3 * max|ref|)."""
    top, exact = ref64.abs().max().item(), ref64.to(out.dtype)
    err64, fma_err64 = ((x.double() - ref64).abs().max().item() for x in (out, fma))
    log(f"    against the float64 result of the same bf16 values, unrounded: max|d| {err64:.6g}, the FMA "
        f"kernel {fma_err64:.6g} (max|ref| {top:.3g}); results that differ from its bf16 rounding: "
        f"{int((out != exact).sum())} and {int((fma != exact).sum())} of {out.numel()}")
    if err64 > fma_err64 + 1e-5 * top:
        raise AssertionError(f"{name}: {err64:.6g} from the float64 result, the FMA kernel {fma_err64:.6g}")


def attention_bwd_f64(qkv, do, H, new):
    """K2's function in float64 on the same bf16 values, dqkv unrounded: q*s
    and k*s rounded to bf16 as the contract has it, every product, the
    softmax and the sums in float64."""
    import math

    import torch

    from guided_diffusion_clip_tpu_torch.ops import attention as A

    B, T, _ = qkv.shape
    q, k, v = (a.transpose(1, 2) for a in A.split_qkv(qkv, H, new))  # (B, H, T, d)
    scale = 1.0 / math.sqrt(math.sqrt(q.shape[-1]))
    dof = do.reshape(B, T, H, -1).transpose(1, 2).double()
    p = torch.softmax((q * scale).double() @ (k * scale).double().transpose(-1, -2), dim=-1)
    dv = p.transpose(-1, -2) @ dof
    dp = dof @ v.double().transpose(-1, -2)
    ds = p * (dp - (dp * p).sum(-1, keepdim=True))
    del p, dp
    dq = ds @ k.double() * (scale * scale)
    dk = ds.transpose(-1, -2) @ q.double() * (scale * scale)
    grads = [g.transpose(1, 2) for g in (dq, dk, dv)]  # (B, T, H, d)
    return torch.stack(grads, dim=2 if new else 3).reshape(qkv.shape)


def check_attention_launch(name, fn, dtype, n_mma, n_f32) -> None:
    """One K1 or K2 call (``fn`` its wrapper, ``n_mma`` and ``n_f32`` its
    counts before it): on the tensor cores (bf16 and float32 at every d) and
    counted as float32 for a float32 input."""
    import torch

    want = (1, int(dtype == torch.float32))
    got = (fn.launches_mma - n_mma, fn.launches_f32 - n_f32)
    if got != want:
        raise AssertionError(f"{name}: {got[0]} launches on the tensor cores and {got[1]} counted float32, want {want}")


def phase3_kernels(dev):
    """Each kernel against its plain version; returns the headline records."""
    import torch
    import torch.nn.functional as F

    from guided_diffusion_clip_tpu_torch.ops import attention as A
    from guided_diffusion_clip_tpu_torch.ops import groupnorm as G

    tf32_off()
    g = torch.Generator(device=dev).manual_seed(1)
    records = {}

    def check(name, out, ref, dtype, kind):
        diff = (out.float() - ref.float()).abs()
        scale = ref.float().abs().clamp(min=1.0)
        if dtype == torch.float32 and kind == "attn":
            bound, ok = "max|d| <= 1e-4", bool(diff.max() <= 1e-4)
        elif dtype == torch.float32:
            bound, ok = "|d| <= 1e-5*max(1,|ref|)", bool((diff <= 1e-5 * scale).all())
        else:
            bound, ok = "|d| <= 2e-2*max(1,|ref|)", bool((diff <= 2e-2 * scale).all())
        err = diff.max().item()
        if not torch.isfinite(out.float()).all() or not ok:
            raise AssertionError(f"{name}: max|d| {err:.3g} fails {bound}")
        return err, bound

    attn_cases = [  # (B, T, heads, d, new_order)
        (8, 1024, 8, 64, False), (8, 256, 16, 64, False), (8, 64, 16, 64, False),
        (8, 256, 16, 64, True), (8, 65, 4, 64, False),
        (8, 256, 1, 192, False), (8, 64, 1, 192, False),
        (8, 256, 1, 256, False), (8, 64, 1, 256, False), POOL_SHAPE,
        # the recipe's one-head attention as image_sample runs it under CFG (batch 16; batch 8 is above),
        # where fwd_q_rows picks 32-row blocks
        (16, 256, 1, 192, False), (16, 64, 1, 256, False),
        # the classifier's blocks and pool as classifier_train runs them (microbatches of 16)
        *CLF_TRAIN_ATTN_SHAPES,
        # the 64 px quality proxies' at the tools' batch (phase 16): the generator's 4 heads at 16 and 8 px
        # (d = 96 and 128, bf16 sampling, f32 training) and the classifier's 2 at 16 px (d = 96, f32)
        *PROXY_ATTN_SHAPES,
    ]
    # then, in float32, the rest of the quality proxies' float32 shapes (the 16 px networks', phase 16's batch)
    attn_cases = [(c, (torch.float32, torch.bfloat16)) for c in attn_cases] + [
        (c, (torch.float32,)) for c in proxy_f32_attn_shapes() if c not in PROXY_ATTN_SHAPES]
    with torch.inference_mode():
        for (B, T, H, d, new), dtypes in attn_cases:
            for dtype in dtypes:
                qkv = torch.randn(B, T, 3 * H * d, generator=g, device=dev).to(dtype)
                n_mma, n_f32 = A.attention_fwd_cuda.launches_mma, A.attention_fwd_cuda.launches_f32
                out = A.attention_fwd_cuda(qkv, H, new_order=new)
                ref = A.qkv_attention_plain(qkv, H, new_order=new)
                torch.cuda.synchronize()
                name = f"K1 attention B={B} T={T} heads={H} d={d} {'new' if new else 'legacy'} {str(dtype)[6:]}"
                check_attention_launch(name, A.attention_fwd_cuda, dtype, n_mma, n_f32)
                err, bound = check(name, out, ref, dtype, "attn")
                if not torch.equal(A.attention_fwd_cuda(qkv, H, new_order=new), out):
                    raise AssertionError(f"{name}: a repeat run gave other bits")
                ms = cuda_ms(lambda: A.attention_fwd_cuda(qkv, H, new_order=new))
                pms = cuda_ms(lambda: A.qkv_attention_plain(qkv, H, new_order=new))
                log(f"  {name}: max|d| {err:.3g} ({bound}), repeat bit-identical; kernel {ms:.4f} ms "
                    f"(mma.sync{' TF32 x3' if dtype == torch.float32 else ''}), plain {pms:.4f} ms")
                if dtype == torch.bfloat16 or (B, T, H, d, new) in F32_TIMED_SHAPES:
                    q, k, v = (t.permute(0, 2, 1, 3) for t in A.split_qkv(qkv, H, new))
                    lib = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v))
                    rec = record(err, ms, pms, **attention_bound(B, T, H, d, False, dtype == torch.float32),
                                 library_ms=lib)
                    fma = cuda_ms(lambda: fma_attention(qkv, H, new))
                    off = " (TF32 off)" if dtype == torch.float32 else ""
                    log(f"    F.scaled_dot_product_attention on the same q, k, v{off}: {lib:.4f} ms, the FMA kernel "
                        f"{fma:.4f} ms; bound {rec['bound_ms']:.4f} ms ({rec['bound_by']}), the kernel "
                        f"{ms / rec['bound_ms']:.1f}x the bound")
                    if (B, T, H, d, new, dtype) == (8, 1024, 8, 64, False, torch.bfloat16):
                        records["attention"] = rec
                    elif (B, T, H, d, new, dtype) == (*POOL_SHAPE, torch.float32):
                        records["attention_f32"] = rec

        # the UNet's 256 px maps (256, 512 channels), 128 px, 32 px, 8 px, the classifier's 256 px, and the
        # training recipe's maps (64 channels is 2 a group)
        for B, hw, C in [(8, 256 * 256, 256), (8, 8 * 8, 1024), (8, 256 * 256, 512), (8, 128 * 128, 256),
                         (8, 32 * 32, 512), (8, 256 * 256, 128), *RECIPE_GN_SHAPES,
                         (16, 256 * 256, 128)]:  # the last: the classifier's 256 px maps in classifier_train
            for dtype in (torch.float32, torch.bfloat16):
                for fused in (False, True):
                    x = (torch.randn(B, hw, C, generator=g, device=dev) * 2 + 0.5).to(dtype)
                    w = torch.randn(C, generator=g, device=dev) * 0.1 + 1
                    b = torch.randn(C, generator=g, device=dev) * 0.1
                    ss = None
                    if fused:
                        ss = (torch.randn(B, C, generator=g, device=dev) * 0.2,
                              torch.randn(B, C, generator=g, device=dev) * 0.2)
                    args = (x, w, b, 32, 1e-5, fused, ss)
                    n0 = G.fused_group_norm.launches
                    out, stats = G._fused_group_norm_stats(*args)
                    ref, rstats = G._group_norm_plain_stats(*args)
                    torch.cuda.synchronize()
                    name = (f"K3 group_norm x=({B},{hw},{C}) {str(dtype)[6:]} "
                            f"{'scale-shift+silu' if fused else 'plain affine'}")
                    if G.fused_group_norm.launches != n0 + 1:
                        raise AssertionError(f"{name}: {G.fused_group_norm.launches - n0} launches counted for one call")
                    err, bound = check(name, out, ref, dtype, "gn")
                    st_err = ((stats - rstats).abs() / rstats.abs()).max().item()
                    if not st_err <= 1e-5:
                        raise AssertionError(f"{name}: (2, B, G) mean and rstd rel err {st_err:.3g} (bound 1e-5)")
                    again, again_stats = G._fused_group_norm_stats(*args)
                    if not (torch.equal(again, out) and torch.equal(again_stats, stats)):
                        raise AssertionError(f"{name}: a repeat run gave other bits")
                    ms = cuda_ms(lambda: G.fused_group_norm(*args))
                    pms = cuda_ms(lambda: G.group_norm_plain(*args))
                    # 8 f32 operations an element (two moments, normalize, affine, SiLU)
                    rec = record(err, ms, pms, nbytes=2 * B * hw * C * x.element_size(), ops=8 * B * hw * C,
                                 op_type="f32")
                    log(f"  {name}: max|d| {err:.3g} ({bound}), stats rel err {st_err:.3g} (bound 1e-5), repeat "
                        f"bit-identical; kernel {ms:.4f} ms, plain {pms:.4f} ms, bound {rec['bound_ms']:.4f} ms")
                    if dtype == torch.bfloat16 and fused:
                        xc = x.transpose(1, 2).contiguous()  # (B, C, HW), the layout F.group_norm takes
                        wl, bl = w.to(dtype), b.to(dtype)
                        lib = cuda_ms(lambda: F.silu(F.group_norm(xc, 32, wl, bl, 1e-5)))
                        log(f"    F.silu(F.group_norm(x)) on the same x (no scale-shift): {lib:.4f} ms")
                        if (B, hw, C) == (8, 65536, 256):
                            records["group_norm"] = {**rec, "library_ms": lib}
    return records


def phase3b_attention_bwd(dev):
    """K2 against attention_bwd_plain at the classifier's shapes (batch 8 as
    guidance runs it, 16 as classifier_train does) and, in bf16, the ADM-256
    UNet's at batch 8 (clip_guided_sample); returns the headline records: the
    bf16 kernel's (batch 8, T = 1024, 4 heads) and the float32 kernel's (the
    pool at batch 8)."""
    import torch
    import torch.nn.functional as F

    from guided_diffusion_clip_tpu_torch.ops import attention as A

    tf32_off()
    g = torch.Generator(device=dev).manual_seed(5)
    f32, bf16 = ((torch.float32, 1e-4),), ((torch.bfloat16, 2e-2),)
    both = f32 + bf16
    cases = [  # (B, T, heads, d, new_order), dtypes: the classifier's blocks at batch 8, then its pool
        *((c, both) for c in [(8, 1024, 4, 64, False), (8, 256, 8, 64, False), (8, 64, 8, 64, False), POOL_SHAPE]),
        *((c, both) for c in CLF_TRAIN_ATTN_SHAPES), *((c, bf16) for c in UNET_ATTN_SHAPES),
        # the 64 px quality proxies' (float32 on their paths: the classifier's gradient at d = 96, training at
        # d = 96 and 128), and an f32 torso's 32 px attention
        *((c, both if c[3] == 96 else f32) for c in PROXY_ATTN_SHAPES), ((8, 1024, 8, 64, False), f32),
        # the rest of the quality proxies' float32 shapes (the 16 px networks', phase 16's batch)
        *((c, f32) for c in proxy_f32_attn_shapes() if c not in PROXY_ATTN_SHAPES),
    ]
    records = {}
    for (B, T, H, d, new), dtypes in cases:
        for dtype, tol in dtypes:
            qkv = torch.randn(B, T, 3 * H * d, generator=g, device=dev).to(dtype)
            do = torch.randn(B, T, H * d, generator=g, device=dev).to(dtype)
            n_mma, n_f32 = A.attention_bwd_cuda.launches_mma, A.attention_bwd_cuda.launches_f32
            out = A.attention_bwd_cuda(qkv, do, H, new_order=new)
            ref = A.qkv_attention_bwd_plain(qkv, do, H, new)
            torch.cuda.synchronize()
            name = f"K2 attention_bwd B={B} T={T} heads={H} d={d} {'new' if new else 'legacy'} {str(dtype)[6:]}"
            check_attention_launch(name, A.attention_bwd_cuda, dtype, n_mma, n_f32)
            diff = (out.float() - ref.float()).abs()
            err = diff.max().item()
            bound = f"|d| <= {tol:g}*max(1,|ref|)"
            if not torch.isfinite(out.float()).all() or not bool((diff <= tol * ref.float().abs().clamp(min=1.0)).all()):
                raise AssertionError(f"{name}: max|d| {err:.3g} fails {bound}")
            if not torch.equal(A.attention_bwd_cuda(qkv, do, H, new_order=new), out):
                raise AssertionError(f"{name}: a repeat run gave other bits")
            ms = cuda_ms(lambda: A.attention_bwd_cuda(qkv, do, H, new_order=new))
            pms = cuda_ms(lambda: A.qkv_attention_bwd_plain(qkv, do, H, new))
            log(f"  {name}: max|d| {err:.3g} ({bound}), repeat bit-identical; kernel {ms:.4f} ms "
                f"(mma.sync{' TF32 x3' if dtype == torch.float32 else ''}), plain {pms:.4f} ms")
            if dtype == torch.bfloat16 or (B, T, H, d, new) in F32_TIMED_SHAPES:
                q, k, v = (t.permute(0, 2, 1, 3).detach().requires_grad_(True) for t in A.split_qkv(qkv, H, new))
                with torch.enable_grad():
                    o = F.scaled_dot_product_attention(q, k, v)
                dob = do.reshape(B, T, H, d).permute(0, 2, 1, 3)
                lib = cuda_ms(lambda: torch.autograd.grad(o, (q, k, v), dob, retain_graph=True))
                rec = record(err, ms, pms, **attention_bound(B, T, H, d, True, dtype == torch.float32), library_ms=lib)
            if dtype == torch.float32 and (B, T, H, d, new) in F32_TIMED_SHAPES:
                fma_ms = cuda_ms(lambda: fma_attention(qkv, H, new, do))
                log(f"    backward of F.scaled_dot_product_attention on the same q, k, v, do (TF32 off): {lib:.4f} ms, "
                    f"the FMA kernel {fma_ms:.4f} ms; bound {rec['bound_ms']:.4f} ms ({rec['bound_by']}, at the "
                    f"split-TF32 rate), the kernel {ms / rec['bound_ms']:.1f}x the bound")
                if (B, T, H, d, new) == POOL_SHAPE:
                    records["attention_bwd_f32"] = rec
            if dtype == torch.bfloat16:
                fma = fma_attention(qkv, H, new, do)
                fma_err = (fma.float() - ref.float()).abs().max().item()
                fma_ms = cuda_ms(lambda: fma_attention(qkv, H, new, do))
                log(f"    backward of F.scaled_dot_product_attention on the same q, k, v, do: {lib:.4f} ms, the FMA "
                    f"kernel {fma_ms:.4f} ms with max|d| {fma_err:.3g}; bound {rec['bound_ms']:.4f} ms "
                    f"({rec['bound_by']})")
                held_to_f64(name, out, fma, attention_bwd_f64(qkv, do, H, new))
                if (B, T, H) == (8, 1024, 4):
                    records["attention_bwd"] = rec
    return records


# The training recipe's int8 shapes (configs/config.yaml: 64/128/192/256 channels at 128/32/16/8 px;
# sampling at batch 8, training at batch 48): K4's maps, K5's convs (3x3, the 1x1 skips, the
# stride-2 downsamples, the 3-channel stem and the 6-channel head on conv_s8_thin.cu) and the quantize
# kernels' inputs of int8_conv (the stem's image, a skip's and a downsample's input); the SR
# models' 6-channel stem (x ++ img2 or x ++ low_res) on conv_s8_thin.cu, at super_res_sample's batch 16
# and the trainers' 48; and the 64 px quality proxies' stem and 3-channel head (tools/_proxies.py, at
# the tools' batch 16), their 16 px generator's head and their classifiers' 1x1 heads at 1 px
RECIPE_GN_SHAPES = [(8, 128 * 128, 64), (8, 16 * 16, 192), (8, 8 * 8, 256), (48, 128 * 128, 64)]
RECIPE_CONVS = [
    ("recipe 3x3 128px", 8, 128, 64, 64, 3, 1, True), ("recipe 3x3 16px", 8, 16, 192, 192, 3, 1, True),
    ("recipe 3x3 8px", 8, 8, 512, 256, 3, 1, True), ("recipe stem", 8, 128, 3, 64, 3, 1, False),
    ("recipe head", 8, 128, 64, 6, 3, 1, False), ("recipe 1x1 32px", 8, 32, 64, 128, 1, 1, False),
    ("recipe 1x1 16px", 8, 16, 384, 192, 1, 1, False), ("recipe stride 2", 8, 128, 64, 64, 3, 2, False),
    ("recipe 3x3 128px", 48, 128, 64, 64, 3, 1, True), ("recipe stem", 48, 128, 3, 64, 3, 1, False),
    ("SR stem", 16, 128, 6, 64, 3, 1, False), ("SR stem", 48, 128, 6, 64, 3, 1, False),
    ("proxy stem", 16, 64, 3, 128, 3, 1, False), ("proxy head", 16, 64, 128, 3, 3, 1, True),
    ("proxy head", 16, 16, 64, 3, 3, 1, True), ("proxy clf 1x1 head", 16, 1, 192, 3, 1, 1, False),
    ("proxy clf 1x1 head", 16, 1, 64, 3, 1, 1, False),
]
RECIPE_QUANTIZE_SHAPES = [(8, 128, 128, 3), (8, 128, 128, 64), (48, 128, 128, 64), (8, 16, 16, 384),
                          (16, 128, 128, 6), (48, 128, 128, 6)]


def phase3c_group_norm_quant(dev):
    """K4 against group_norm_quant_plain at the paths' shapes; returns the
    headline record ((8, 65536, 256) bf16, scale-shift, s8)."""
    import torch

    from guided_diffusion_clip_tpu_torch.ops import groupnorm as G

    tf32_off()
    g = torch.Generator(device=dev).manual_seed(7)
    headline = None
    with torch.inference_mode():
        # ADM-256's maps, then the training recipe's (RECIPE_GN_SHAPES: 64 channels at 128 px is 2 a group)
        for B, hw, C in [(8, 256 * 256, 256), (8, 32 * 32, 512), (8, 8 * 8, 2048), (8, 256 * 256, 512),
                         (8, 128 * 128, 256), (8, 256 * 256, 128), *RECIPE_GN_SHAPES]:
            for dtype in (torch.float32, torch.bfloat16):
                x = (torch.randn(B, hw, C, generator=g, device=dev) * 2 + 0.5).to(dtype)
                w = torch.randn(C, generator=g, device=dev) * 0.1 + 1
                b = torch.randn(C, generator=g, device=dev) * 0.1
                for fused in (False, True):
                    ss = None
                    if fused:
                        ss = (torch.randn(B, C, generator=g, device=dev) * 0.2,
                              torch.randn(B, C, generator=g, device=dev) * 0.2)
                    for out_dtype in (torch.int8, dtype):
                        args = (x, w, b, 32, 1e-5, True, ss, out_dtype)
                        n0 = G.fused_group_norm_quant.launches
                        q, sc, stats = G._fused_group_norm_quant_stats(*args)
                        rq, rsc, rstats = G._group_norm_quant_plain_stats(*args)
                        torch.cuda.synchronize()
                        name = (f"K4 group_norm_quant x=({B},{hw},{C}) {str(dtype)[6:]} "
                                f"{'scale-shift+silu' if fused else 'silu'} emit {str(out_dtype)[6:]}")
                        if G.fused_group_norm_quant.launches != n0 + 1:
                            raise AssertionError(f"{name}: {G.fused_group_norm_quant.launches - n0} launches counted")
                        st_err = ((stats - rstats).abs() / rstats.abs()).max().item()
                        again = G._fused_group_norm_quant_stats(*args)
                        if not all(torch.equal(u, v) for u, v in zip(again, (q, sc, stats))):
                            raise AssertionError(f"{name}: a repeat run gave other bits")
                        if not st_err <= 1e-5:
                            raise AssertionError(f"{name}: (2, B, G) mean and rstd rel err {st_err:.3g} (bound 1e-5)")
                        d = (q.float() - rq.float()).abs()
                        flips = int((d > 0).sum())
                        s_err = ((sc - rsc).abs() / rsc).max().item()
                        if (q.dtype != out_dtype or d.max() > 1 or flips > max(1, 1e-4 * d.numel())
                                or not s_err <= 1e-6):
                            raise AssertionError(f"{name}: s rel err {s_err:.3g} (bound 1e-6), q max|d| "
                                                 f"{d.max().item()}, {flips} of {d.numel()} off (bound 1e-4)")
                        # in y's units: q * s against the plain version's
                        bshape = (B,) + (1,) * (q.dim() - 1)
                        deq = (q.float() * sc.reshape(bshape) - rq.float() * rsc.reshape(bshape)).abs().max().item()
                        ms = cuda_ms(lambda: G.fused_group_norm_quant(*args))
                        pms = cuda_ms(lambda: G.group_norm_quant_plain(*args))
                        # x read once, q written once; no PyTorch call quantizes a GroupNorm
                        rec = record(deq, ms, pms, nbytes=B * hw * C * (x.element_size() + q.element_size()),
                                     ops=12 * B * hw * C, op_type="f32")
                        log(f"  {name}: s rel err {s_err:.3g} (bound 1e-6), q off by one on {flips} "
                            f"(bound 1e-4 of {d.numel()}), max|q*s - ref| {deq:.3g}, stats rel err {st_err:.3g} "
                            f"(bound 1e-5), repeat bit-identical; kernel {ms:.4f} ms, plain {pms:.4f} ms, bound "
                            f"{rec['bound_ms']:.4f} ms")
                        if (B, hw, C, dtype, fused, out_dtype) == (8, 65536, 256, torch.bfloat16, True, torch.int8):
                            headline = rec
    return headline


def phase3d_conv_s8(dev):
    """K5 against conv_s8_plain at the paths' shapes, and cuDNN's bf16 conv
    timed at the same shapes: each case must have launched the kernel its
    shape picks (``conv_s8_mma.cu`` where ``uses_tensor_cores``, else the
    stem or head kernel of ``conv_s8_thin.cu``) and equal the ``__dp4a``
    kernel bit for bit, whose time is logged beside it; at the stems and
    heads also the device time a call (the profiler's) of the kernel, the
    ``__dp4a`` kernel and cuDNN's conv, free of the wrapper's host time.
    Returns the headline
    records: ``conv_s8`` (3x3 at 256 px, 256 -> 256, batch 8, bf16 out) and
    ``conv_s8_thin`` (ADM-256's stem, 3 -> 256 at 256 px, batch 8, bf16 out)."""
    import torch
    import torch.nn.functional as F

    from guided_diffusion_clip_tpu_torch.ops import quant as Q
    from guided_diffusion_clip_tpu_torch.utils.profiling import kernel_times

    tf32_off()
    g = torch.Generator(device=dev).manual_seed(8)
    records = {}
    cases = [  # (name, B, H, C, K, k, stride, per-image scales)
        ("3x3 256px", 8, 256, 256, 256, 3, 1, True), ("3x3 32px", 8, 32, 512, 512, 3, 1, True),
        ("3x3 8px", 8, 8, 2048, 1024, 3, 1, True), ("stem", 8, 256, 3, 256, 3, 1, False),
        ("head", 8, 256, 256, 6, 3, 1, True), ("classifier stem", 8, 256, 3, 128, 3, 1, False),
        ("1x1 8px", 8, 8, 2048, 1024, 1, 1, False), ("3x3 stride 2 64px", 8, 64, 256, 256, 3, 2, False),
        ("3x3 16px", 8, 16, 1024, 1024, 3, 1, True), ("3x3 16px", 8, 16, 2048, 1024, 3, 1, True),
        ("1x1 128px", 8, 128, 768, 256, 1, 1, False), ("3x3 8px", 3, 8, 2048, 1024, 3, 1, True),
        ("3x3 256px", 1, 256, 256, 256, 3, 1, True), *RECIPE_CONVS,
    ]
    with torch.inference_mode():
        for name, B, H, C, K, k, stride, per_image in cases:
            q = torch.randint(-127, 128, (B, H, H, C), generator=g, device=dev, dtype=torch.int8)
            w_q, s_w = Q.quantize_per_out_channel(torch.randn(k, k, C, K, generator=g, device=dev) * 0.05)
            s_img = torch.rand(B, generator=g, device=dev) * 0.02 + 0.001 if per_image else None
            bias = torch.randn(K, generator=g, device=dev) * 0.1
            xb = q.to(torch.bfloat16).permute(0, 3, 1, 2)  # channels_last NCHW view
            wb = w_q.to(torch.bfloat16).permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
            cudnn_ms = cuda_ms(lambda: F.conv2d(xb, wb, stride=stride, padding=(k - 1) // 2))
            rows = Q._pack_weights(w_q)  # packed once, as the models' Conv2d caches them
            mma, thin = Q.uses_tensor_cores(C, K, k), Q.uses_thin_kernel(C, K, k, stride)
            if not (mma or thin):
                raise AssertionError(f"K5 {name}: no tensor-core kernel takes {k}x{k} stride {stride} {C} -> {K}")
            Ho = (H + 2 * ((k - 1) // 2) - k) // stride + 1
            M, KRp = B * Ho * Ho, -(-k * k * C // 32) * 32
            how = ("conv_s8_mma.cu, tile %d x 128, %d slice(s) of the reduction" % Q.pick_tile(M, K, KRp) if mma
                   else f"conv_s8_thin.cu's {thin} kernel")
            for out_dtype, tol in ((torch.float32, 1e-6), (torch.bfloat16, 2e-2)):
                args = (q, w_q, s_img, s_w, bias, stride, out_dtype)
                n_mma, n_thin = Q.conv_s8_cuda.launches_mma, Q.conv_s8_cuda.launches_thin
                out = Q.conv_s8_cuda(*args, rows)
                ref = Q.conv_s8_plain(*args)
                torch.cuda.synchronize()
                label = f"K5 conv_s8 {name} B={B} {k}x{k} {C}->{K} out {str(out_dtype)[6:]}"
                ran = (Q.conv_s8_cuda.launches_mma - n_mma, Q.conv_s8_cuda.launches_thin - n_thin)
                if ran != (int(mma), int(not mma)):
                    raise AssertionError(f"{label}: launched conv_s8_mma.cu {ran[0]} and conv_s8_thin.cu {ran[1]} "
                                         f"times, not {how}")
                diff = (out.float() - ref.float()).abs()
                err = diff.max().item()
                if out.shape != ref.shape or not bool((diff <= tol * ref.float().abs().clamp(min=1)).all()):
                    raise AssertionError(f"{label}: max|d| {err:.3g} fails {tol:g}*max(1,|ref|)")
                same = Q.conv_s8_dp4a(*args, rows)
                if not torch.equal(out, same) or not torch.equal(Q.conv_s8_cuda(*args), out):
                    raise AssertionError(f"{label}: {int((out != same).sum())} of {out.numel()} values differ from "
                                         f"the __dp4a kernel's, or a repeat run gave other bits")
                ms = cuda_ms(lambda: Q.conv_s8_cuda(*args, rows))
                pms = cuda_ms(lambda: Q.conv_s8_plain(*args))
                dp4a_ms = cuda_ms(lambda: Q.conv_s8_dp4a(*args, rows))
                ops = 2 * M * C * K * k * k
                rec = record(err, ms, pms, nbytes=B * H * H * C + M * K * out.element_size() + k * k * C * K,
                             ops=ops, op_type="s8", library_ms=cudnn_ms)
                log(f"  {label} ({how}): max|d| {err:.3g} (bound {tol:g}*max(1,|ref|)), bit-identical to the __dp4a "
                    f"kernel and to a repeat run; kernel {ms:.4f} ms ({rate(ops, ms)} TOP/s), __dp4a {dp4a_ms:.4f} ms, "
                    f"plain {pms:.4f} ms, cuDNN bf16 conv {cudnn_ms:.4f} ms, bound {rec['bound_ms']:.4f} ms "
                    f"({rec['bound_by']}), {ms / rec['bound_ms']:.2f} x bound")
                if thin:  # device time a call, the wrapper's host time left out: one profile, split by kernel name
                    device = dict.fromkeys(("kernel", "__dp4a", "cuDNN"), 0.0)
                    for kname, (t, _) in kernel_times(lambda: (Q.conv_s8_cuda(*args, rows), Q.conv_s8_dp4a(*args, rows),
                                                               F.conv2d(xb, wb, stride=stride, padding=(k - 1) // 2)),
                                                      reps=10).items():
                        device["kernel" if f"conv_s8_{thin}_kernel" in kname else
                               "__dp4a" if "conv_s8_kernel" in kname else "cuDNN"] += t
                    log(f"    device ms a call (profiler): kernel {device['kernel']:.4f} "
                        f"({device['kernel'] / rec['bound_ms']:.2f} x bound), __dp4a {device['__dp4a']:.4f}, "
                        f"cuDNN bf16 conv {device['cuDNN']:.4f}")
                if (name, B, out_dtype) == ("3x3 256px", 8, torch.bfloat16):
                    records["conv_s8"] = rec
                if (name, B, out_dtype) == ("stem", 8, torch.bfloat16):
                    records["conv_s8_thin"] = rec
            del q, xb
    return records


def phase3g_quantize(dev):
    """The quantize kernels against quantize_per_tensor on the card: s within
    1e-6 relative (the plain version divides by 127 as a product with the
    rounded reciprocal there), q within one level on at most 1e-4 of the
    tensor and equal wherever the scales are; the factors are s * s_w rounded
    once. Returns the headline record ((8, 256, 256, 256) bf16, the UNet's
    largest float conv input)."""
    import torch

    from guided_diffusion_clip_tpu_torch.ops import quant as Q

    g = torch.Generator(device=dev).manual_seed(13)
    headline = None
    s_w = torch.rand(256, generator=g, device=dev) * 0.01 + 1e-4
    cases = [("randn", (8, 256, 256, 256)), ("randn", (8, 256, 256, 3)), ("randn", (8, 8, 8, 1024)),
             ("randn", (3, 7, 5, 3)), ("zeros", (2, 16, 16, 64)), ("one huge value", (2, 16, 16, 64)),
             ("exact ties", (2, 16, 16, 67)), *(("randn", shape) for shape in RECIPE_QUANTIZE_SHAPES)]
    with torch.inference_mode():
        for case, shape in cases:
            for dtype in (torch.float32, torch.bfloat16):
                x = torch.randn(shape, generator=g, device=dev) * 3
                if case == "zeros":
                    x.zero_()
                elif case == "one huge value":
                    x.view(-1)[x.numel() // 2] = -3e30
                elif case == "exact ties":  # amax 127: the scale is 1 and every k + 0.5 is a tie
                    x = torch.randint(-126, 126, shape, generator=g, device=dev).float() + 0.5
                    x.view(-1)[0] = 127.0
                x = x.to(dtype)
                q, s, factors = Q.quantize_per_tensor_cuda(x, s_w)
                rq, rs = Q.quantize_per_tensor(x)
                torch.cuda.synchronize()
                label = f"quantize {case} {shape} {str(dtype)[6:]}"
                d = (q.float() - rq.float()).abs()
                flips = int((d > 0).sum())
                s_err = ((s - rs).abs() / rs).item()
                ok = (q.dtype == torch.int8 and q.shape == x.shape and d.max() <= 1 and flips <= max(1, 1e-4 * d.numel())
                      and s_err <= 1e-6 and torch.equal(factors, s * s_w) and (flips == 0 or not torch.equal(s, rs)))
                if case == "zeros":
                    ok = ok and not q.any() and s.item() == torch.tensor(1e-8).div(torch.tensor(127.0)).item()
                if case == "exact ties":
                    ok = ok and s.item() == 1.0 and torch.equal(q, torch.round(x.float()).to(torch.int8))
                if not ok:
                    raise AssertionError(f"{label}: s rel err {s_err:.3g} (bound 1e-6), q max|d| {d.max().item()}, "
                                         f"{flips} of {d.numel()} off (bound 1e-4, 0 with equal scales)")
                ms = cuda_ms(lambda: Q.quantize_per_tensor_cuda(x, s_w))
                pms = cuda_ms(lambda: Q.quantize_per_tensor(x))
                # the bound as K3's and K4's: x read once, q written once (the kernels read x twice, the amax
                # and then the values, from HBM wherever x exceeds the L2); ~6 f32 operations a value
                rec = record(float(d.max().item()), ms, pms, nbytes=x.numel() * (x.element_size() + 1),
                             ops=6 * x.numel(), op_type="f32")
                log(f"  {label}: s rel err {s_err:.3g} (bound 1e-6), q off by one on {flips} (bound 1e-4 of {d.numel()}); "
                    f"kernels {ms:.4f} ms, plain {pms:.4f} ms, bound {rec['bound_ms']:.4f} ms ({rec['bound_by']})")
                if (case, shape, dtype) == ("randn", (8, 256, 256, 256), torch.bfloat16):
                    headline = rec
    return headline


# one of two space ranks' rows of ADM-256's largest map at the serving batch (phase 17): (2, 128, 256, 256)
SP_HALF_SHAPE = (2, 128, 256, 256)
# the split entries' maps (phase 3h), (shape, groups): ADM-256's half-H maps at batch 2 at every level (256 and
# 128 px at 256 channels, 64 and 32 px at 512, 16 and 8 px at 1024), its concatenations (C / G = 64, 48, 24), TP's
# local channels (16 of the 32 groups: 256 px, 16 px), the recipe at batch 48 (C / G = 2 at 128 px, 6 at 16 px,
# half-H), a 96-channel map (C / G = 3), and ADM-256's top level at batch 8 under SP 2, larger than the L2
SPLIT_MAPS = [(SP_HALF_SHAPE, 32), ((2, 64, 128, 256), 32), ((2, 32, 64, 512), 32), ((2, 16, 32, 512), 32),
              ((2, 8, 16, 1024), 32), ((2, 4, 8, 1024), 32), ((2, 4, 8, 2048), 32), ((2, 8, 16, 1536), 32),
              ((2, 32, 64, 768), 32), ((2, 256, 256, 128), 16), ((2, 16, 16, 512), 16), ((48, 64, 128, 64), 32),
              ((48, 8, 16, 192), 32), ((2, 16, 32, 96), 32), ((8, 128, 256, 256), 32)]
# the maps timed in bf16: kernel, first version, plain version, each host-inclusive and on the device
SPLIT_TIMED = (SP_HALF_SHAPE, (8, 128, 256, 256))


def device_parts(fn, parts: dict, reps: int = 10) -> dict:
    """``fn``'s device ms a call (the profiler's kernel sum, ``kernel_times``)
    by part: each key of ``parts`` sums the kernels whose names hold one of
    its strings, "other" the rest."""
    from guided_diffusion_clip_tpu_torch.utils.profiling import kernel_times

    out = dict.fromkeys([*parts, "other"], 0.0)
    for name, (t, _) in kernel_times(fn, reps).items():
        out[next((k for k, subs in parts.items() if any(s in name for s in subs)), "other")] += t
    return out


def on_device(ms: float, bound: float) -> str:
    """A device time beside its byte bound: a reading under the bound had its
    input in the L2 (it left a write-back or an earlier call's read there),
    not a rate the memory gave."""
    return f"{ms / bound:.2f} x bound" if ms >= bound else f"{ms / bound:.2f} x bound: L2-resident, not a met bound"


def phase3h_split_entries(dev):
    """The entries that K3, K4 and the quantize kernels are split into on a
    row shard (phase 17) or a channel shard (phase 18, K4), at the maps of
    ``SPLIT_MAPS``, bf16 and f32: the stats kernel's sums within 1e-5 of the
    sum of |x| of the plain version's (f32 sums in another order), its
    extremes equal and a repeat's bits the same; the two applies bit for bit
    the first versions' (``*_simple``, csrc/groupnorm.cu) and within K3's
    bounds and one level on at most 1e-4 of q of the plain versions'. Each
    call launches its kernel once. At ``SPLIT_TIMED`` in bf16 each entry is
    timed beside its first version and its plain version, host-inclusive and
    on the device, and the split K3 and K4 beside their one launch. The
    quantize entries: the amax word equal to the plain amax and
    ``quantize_given_cuda`` bit-identical to the two-pass kernels, at three
    maps; the amax pass's device time beside ``vector_norm(inf)``'s at the
    timed maps. Returns the headline records ((2, 128, 256, 256) bf16)."""
    import torch

    from guided_diffusion_clip_tpu_torch.ops import groupnorm as G
    from guided_diffusion_clip_tpu_torch.ops import quant as Q

    g = torch.Generator(device=dev).manual_seed(19)
    records = {}
    entries = {"stats": G.group_norm_stats_cuda, "apply": G.group_norm_apply_cuda,
               "quant_apply": G.group_norm_quant_apply_cuda}
    with torch.inference_mode():
        for shape, groups in SPLIT_MAPS:
            B, C = shape[0], shape[-1]
            for dtype in (torch.float32, torch.bfloat16):
                x = (torch.randn(shape, generator=g, device=dev) * 2 + 0.5).to(dtype)
                tag = f"x={shape} G={groups} {str(dtype)[6:]}"
                n0 = {k: fn.launches for k, fn in entries.items()}
                sums, ext = G.group_norm_stats_cuda(x, groups, True)
                again = G.group_norm_stats_cuda(x, groups, True)
                rs, rext = G.group_norm_stats_plain(x, groups, True)
                scale = torch.stack([x.float().abs(), x.float().square()]).reshape(2, B, -1, groups,
                                                                                    C // groups).sum((2, 4))
                ratio = ((sums - rs).abs() / (1e-5 * scale + 1e-6)).max().item()
                if not ratio <= 1 or not torch.equal(ext, rext) or not (
                        torch.equal(again[0], sums) and torch.equal(again[1], ext)):
                    raise AssertionError(f"group_norm_stats {tag}: sums at {ratio:.3g} of the bound, extremes "
                                         f"equal: {torch.equal(ext, rext)}, a repeat's bits the same: "
                                         f"{torch.equal(again[0], sums) and torch.equal(again[1], ext)}")
                a = torch.randn(B, C, generator=g, device=dev) * 0.5
                b = torch.randn(B, C, generator=g, device=dev) * 0.5
                inv = torch.rand(B, generator=g, device=dev) * 20 + 10
                y = G.group_norm_apply_cuda(x, a, b, True)
                ry = G.group_norm_apply_plain(x, a, b, True)
                tol = 1e-5 if dtype == torch.float32 else 2e-2
                d = (y.float() - ry.float()).abs()
                same = torch.equal(y, G.group_norm_apply_simple(x, a, b, True))
                if not (d <= tol * ry.float().abs().clamp(min=1.0)).all() or not same:
                    raise AssertionError(f"group_norm_apply {tag}: max|d| {d.max().item():.3g} (bound "
                                         f"{tol}*max(1,|ref|)), bit-identical to the first version: {same}")
                flips = 0
                for out_dtype in (torch.int8, dtype):
                    q = G.group_norm_quant_apply_cuda(x, a, b, inv, True, out_dtype)
                    rq = G.group_norm_quant_apply_plain(x, a, b, inv, True, out_dtype)
                    dq = (q.float() - rq.float()).abs()
                    flips = int((dq > 0).sum())
                    same = torch.equal(q, G.group_norm_quant_apply_simple(x, a, b, inv, True, out_dtype))
                    if dq.max() > 1 or flips > max(1, 1e-4 * dq.numel()) or not same:
                        raise AssertionError(f"group_norm_quant_apply {tag} to {out_dtype}: q max|d| "
                                             f"{dq.max().item()}, {flips} off, bit-identical to the first "
                                             f"version: {same}")
                torch.cuda.synchronize()
                ran = {k: fn.launches - n0[k] for k, fn in entries.items()}
                if ran != {"stats": 2, "apply": 1, "quant_apply": 2}:
                    raise AssertionError(f"split entries {tag}: launches {ran}")
                plans = [G._split_plan(B, x.numel() // (B * C), C, G._vec(x, C), x.element_size(),
                                       torch.cuda.get_device_properties(dev).multi_processor_count, per_sm)
                         for per_sm in (G._STATS_PER_SM, G._APPLY_PER_SM)]
                log(f"  {tag}: {B * plans[0][0]} and {B * plans[1][0]} blocks of {plans[0][2]} (stats, applies); "
                    f"stats at {ratio:.3g} of 1e-5 x sum|x|, extremes "
                    f"equal, repeat bit-identical; applies bit-identical to the first versions, K3's max|d| "
                    f"{d.max().item():.3g} of the plain (bound {tol}*max(1,|ref|)), K4's q off by one on {flips}")
                if dtype == torch.bfloat16 and shape in SPLIT_TIMED:
                    records.update(split_timed(dev, G, x, groups, a, b, inv, shape == SP_HALF_SHAPE))
                del x, y, ry, q, rq

        for shape in (SP_HALF_SHAPE, (2, 64, 128, 512), (2, 4, 8, 1024)):
            for dtype in (torch.float32, torch.bfloat16):
                x = (torch.randn(shape, generator=g, device=dev) * 2 + 0.5).to(dtype)
                tag = f"x={shape} {str(dtype)[6:]}"
                s_w = torch.rand(256, generator=g, device=dev) * 0.01 + 1e-4
                bits = Q.absmax_cuda(x)
                amax = Q.absmax_plain(x)
                qq, sq, fq = Q.quantize_given_cuda(x, bits, s_w)
                rq2, rs2, rf2 = Q.quantize_per_tensor_cuda(x, s_w)
                torch.cuda.synchronize()
                if bits.view(torch.float32).item() != amax.item() or not (
                        torch.equal(qq, rq2) and torch.equal(sq, rs2) and torch.equal(fq, rf2)):
                    raise AssertionError(f"quantize split {tag}: amax {bits.view(torch.float32).item()} vs "
                                         f"{amax.item()}, or q/s/factors differ from the two-pass kernels")
                log(f"  quantize split {tag}: the amax equal to the plain amax, q, s, factors bit-identical to "
                    f"the two-pass kernels")
                if (shape, dtype) != (SP_HALF_SHAPE, torch.bfloat16):
                    continue
                ms = cuda_ms(lambda: Q.absmax_cuda(x))
                pms = cuda_ms(lambda: Q.absmax_plain(x))
                lms = cuda_ms(lambda: torch.linalg.vector_norm(x, ord=float("inf")))
                records["quantize_amax"] = rec = record(0.0, ms, pms, nbytes=x.numel() * x.element_size() + 4,
                                                        ops=2 * x.numel(), op_type="f32", library_ms=lms)
                log(f"  quantize_amax {tag}: kernel {ms:.4f} ms, plain {pms:.4f} ms, vector_norm(inf) {lms:.4f} "
                    f"ms, bound {rec['bound_ms']:.4f} ms ({rec['bound_by']})")
                ms = cuda_ms(lambda: Q.quantize_given_cuda(x, bits, s_w))
                pms = cuda_ms(lambda: Q.quantize_given_plain(x, amax))
                d = (qq.float() - Q.quantize_given_plain(x, amax)[0].float()).abs().max().item()
                records["quantize_apply"] = rec = record(d, ms, pms, nbytes=x.numel() * (x.element_size() + 1),
                                                         ops=4 * x.numel(), op_type="f32")
                log(f"  quantize_apply {tag}: max|q - plain| {d:.3g}; kernel {ms:.4f} ms, plain {pms:.4f} ms, "
                    f"bound {rec['bound_ms']:.4f} ms ({rec['bound_by']})")
        # the amax pass on the device: the kernel against vector_norm(inf) (the rest of one profile of both),
        # whose host times differ
        for shape in SPLIT_TIMED:
            x = (torch.randn(shape, generator=g, device=dev) * 2 + 0.5).to(torch.bfloat16)
            bound = 1e3 * x.numel() * x.element_size() / HBM_BYTES_PER_S
            dev_ms = device_parts(lambda: (Q.absmax_cuda(x), torch.linalg.vector_norm(x, ord=float("inf"))),
                                  {"kernel": ("absmax_kernel",), "library": ("reduce_kernel",)})
            log(f"  quantize_amax x={shape} bf16 on the device (profiler): kernel {dev_ms['kernel']:.4f} ms, "
                f"vector_norm(inf) {dev_ms['library']:.4f} ms (other kernels of the two calls {dev_ms['other']:.4f}), "
                f"byte bound {bound:.4f} ms; kernel {on_device(dev_ms['kernel'], bound)}")
            del x
    return records


def split_timed(dev, G, x, groups, a, b, inv, headline: bool) -> dict:
    """Phase 3h's timings at one map in bf16: each split entry's kernel, its
    first version and its plain version, host-inclusive (CUDA events around
    each call) and on the device (profiler), beside the bound; the split K3
    and K4 (stats, fold, apply; no collective) beside their one launch, with
    the fold's share. Returns the entries' records where ``headline``."""
    import torch

    B, C = x.shape[0], x.shape[-1]
    xb, n = x.numel() * x.element_size(), x.numel()
    cases = {
        # x read once, the (2, B, G) sums and the (2, B, C) extremes written; 5 operations a value
        "group_norm_stats": ((lambda: G.group_norm_stats_cuda(x, groups, True)),
                             (lambda: G.group_norm_stats_simple(x, groups, True)),
                             (lambda: G.group_norm_stats_plain(x, groups, True)),
                             dict(nbytes=xb + 4 * (2 * B * groups + 2 * B * C), ops=5 * n, op_type="f32"),
                             ("gn_split_stats_kernel",), ("gn_stats_kernel",)),
        "group_norm_apply": ((lambda: G.group_norm_apply_cuda(x, a, b, True)),
                             (lambda: G.group_norm_apply_simple(x, a, b, True)),
                             (lambda: G.group_norm_apply_plain(x, a, b, True)),
                             dict(nbytes=2 * xb + 8 * B * C, ops=6 * n, op_type="f32"),
                             ("gn_split_apply_kernel",), ("gn_apply_kernel",)),
        "group_norm_quant_apply": ((lambda: G.group_norm_quant_apply_cuda(x, a, b, inv, True)),
                                   (lambda: G.group_norm_quant_apply_simple(x, a, b, inv, True)),
                                   (lambda: G.group_norm_quant_apply_plain(x, a, b, inv, True)),
                                   dict(nbytes=xb + n + 8 * B * C + 4 * B, ops=8 * n, op_type="f32"),
                                   ("gn_split_apply_kernel",), ("gn_quant_apply_kernel",)),
    }
    records = {}
    for name, (kernel, simple, plain, size, kname, sname) in cases.items():
        got, ref = kernel(), plain()
        got, ref = (got[0], ref[0]) if isinstance(got, tuple) else (got, ref)
        err = (got.float() - ref.float()).abs().max().item()
        ms, sms_, pms = cuda_ms(kernel), cuda_ms(simple), cuda_ms(plain)
        rec = record(err, ms, pms, **size)
        # one profile of the three calls, split by kernel name (the plain version's kernels are the rest)
        dev_ms = device_parts(lambda: (kernel(), simple(), plain()), {"kernel": kname, "first": sname})
        bound = rec["bound_ms"]
        log(f"  {name} x={tuple(x.shape)} bf16: kernel {ms:.4f} ms, first version {sms_:.4f} ms, plain {pms:.4f} ms "
            f"(host-inclusive), bound {bound:.4f} ms ({rec['bound_by']}); on the device: kernel "
            f"{dev_ms['kernel']:.4f} ms ({on_device(dev_ms['kernel'], bound)}), first version {dev_ms['first']:.4f}, "
            f"plain {dev_ms['other']:.4f}")
        if headline:
            records[name] = rec
    dq = device_parts(lambda: G.group_norm_quant_apply_cuda(x, a, b, inv, False), {"kernel": ("gn_split_apply_kernel",)})
    log(f"  group_norm_quant_apply without SiLU on the device: kernel {dq['kernel']:.4f} ms "
        f"({on_device(dq['kernel'], cases['group_norm_quant_apply'][3]['nbytes'] * 1e3 / HBM_BYTES_PER_S)}); "
        f"SiLU's expf and IEEE division cost the rest")
    # the one launch the split replaces, at the same map: K3 and K4 with scale-shift and SiLU
    g = torch.Generator(device=dev).manual_seed(23)
    w = torch.randn(C, generator=g, device=dev) * 0.1 + 1
    bias = torch.randn(C, generator=g, device=dev) * 0.1
    ss = (a * 0.2, b * 0.2)
    one = cuda_ms(lambda: G.fused_group_norm(x, w, bias, groups, 1e-5, True, ss))
    one4 = cuda_ms(lambda: G.fused_group_norm_quant(x, w, bias, groups, 1e-5, True, ss))
    split3 = cuda_ms(lambda: G._group_norm_split(x, w, bias, groups, 1e-5, True, ss, False, None))
    split4 = cuda_ms(lambda: G._group_norm_split(x, w, bias, groups, 1e-5, True, ss, True, torch.int8))
    parts = {"stats": ("gn_split_stats_kernel",), "apply": ("gn_split_apply_kernel",)}
    d3 = device_parts(lambda: G._group_norm_split(x, w, bias, groups, 1e-5, True, ss, False, None), parts)
    d4 = device_parts(lambda: G._group_norm_split(x, w, bias, groups, 1e-5, True, ss, True, torch.int8), parts)
    for kname, one_ms, split_ms, d in (("K3", one, split3, d3), ("K4", one4, split4, d4)):
        total = sum(d.values())
        log(f"  {kname} at x={tuple(x.shape)} bf16, scale-shift + SiLU: one launch {one_ms:.4f} ms, split (stats, "
            f"fold, apply; no collective) {split_ms:.4f} ms host-inclusive; the split on the device {total:.4f} ms: "
            f"stats {d['stats']:.4f}, apply {d['apply']:.4f}, the fold's ops and the scratch's zeros {d['other']:.4f} "
            f"({d['other'] / total:.0%} of the device time; the host's share of the split "
            f"{max(0.0, split_ms - total) / split_ms:.0%})")
    if headline:
        records["split_vs_one"] = {"K3": (one, split3), "K4": (one4, split4)}
    return records


def phase3e_fused_conv(dev):
    """K6 against fused_conv3x3_plain at 256 px, 256 -> 256 and 32 px,
    512 -> 512, batch 8, f32 and bf16 inputs, both modes, and cuDNN's bf16
    conv timed at the same shapes; returns the headline record (quantized,
    256 px, f32 in)."""
    import torch
    import torch.nn.functional as F

    from guided_diffusion_clip_tpu_torch.ops import fused_conv as FC

    tf32_off()
    g = torch.Generator(device=dev).manual_seed(9)
    headline = None
    with torch.inference_mode():
        for H, C, K in ((256, 256, 256), (32, 512, 512)):
            B = 8
            w = torch.randn(3, 3, C, K, generator=g, device=dev) * 0.05
            bias = torch.randn(K, generator=g, device=dev) * 0.1
            wb = w.to(torch.bfloat16).permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
            for dtype in (torch.float32, torch.bfloat16):
                # rows of unequal range, so that a wrong band scale would show
                x = torch.randn(B, H, H, C, generator=g, device=dev)
                x = (x * torch.linspace(0.25, 4.0, H, device=dev)[None, :, None, None]).to(dtype)
                xb = x.to(torch.bfloat16).permute(0, 3, 1, 2)  # channels_last NCHW view
                cudnn_ms = cuda_ms(lambda: F.conv2d(xb, wb, bias.to(torch.bfloat16), padding=1))
                for quantized in (True, False):
                    tol = 1e-6 if quantized and dtype == torch.float32 else 2e-2
                    out = FC.fused_conv3x3_cuda(x, w, bias, quantized=quantized)
                    ref = FC.fused_conv3x3_plain(x, w, bias, quantized=quantized)
                    torch.cuda.synchronize()
                    diff = (out.float() - ref.float()).abs()
                    err = diff.max().item()
                    label = (f"K6 fused_conv3x3 {'quantized' if quantized else 'bf16 mode'} {H}px B={B} "
                             f"{C}->{K} in {str(dtype)[6:]}")
                    if (out.shape != ref.shape or out.dtype != dtype or not torch.isfinite(out.float()).all()
                            or not bool((diff <= tol * ref.float().abs().clamp(min=1)).all())):
                        raise AssertionError(f"{label}: max|d| {err:.3g} fails {tol:g}*max(1,|ref|)")
                    ms = cuda_ms(lambda: FC.fused_conv3x3_cuda(x, w, bias, quantized=quantized))
                    pms = cuda_ms(lambda: FC.fused_conv3x3_plain(x, w, bias, quantized=quantized), runs=5, warmup=1)
                    log(f"  {label}: max|d| {err:.3g} (bound {tol:g}*max(1,|ref|)); kernel {ms:.4f} ms "
                        f"({rate(2 * B * H * H * C * K * 9, ms)} T/s), plain {pms:.4f} ms, cuDNN bf16 conv "
                        f"{cudnn_ms:.4f} ms")
                    if (H, dtype, quantized) == (256, torch.float32, True):
                        headline = record(err, ms, pms, nbytes=B * H * H * (C + K) * 4 + 9 * C * K * 4,
                                          ops=2 * B * H * H * C * K * 9, op_type="s8", library_ms=cudnn_ms)
                del x, xb
    return headline


def phase3f_mma_probe(dev):
    """K7 against accumulating_dots_plain: s8 bit for bit at T = 1, 3, 64 and
    2000 (the last two pass the s32 range, so they hold the wrap-around), bf16
    within 1e-2 * max|ref| at T = 4; then the rate from T = 2000 and 6000.
    Returns the headline record (s8, T = 2000). No one library call repeats
    a product T times, so its library time is T times the measured time of
    one ``torch._int_mm`` of the same operands."""
    import torch

    from guided_diffusion_clip_tpu_torch.ops import mma_probe as MP

    g = torch.Generator(device=dev).manual_seed(10)
    x8 = torch.randint(-127, 128, (MP.BM, MP.BK), generator=g, device=dev, dtype=torch.int8)
    w8 = torch.randint(-127, 128, (MP.BK, MP.BN), generator=g, device=dev, dtype=torch.int8)
    xb = torch.randn(MP.BM, MP.BK, generator=g, device=dev).bfloat16()
    wb = torch.randn(MP.BK, MP.BN, generator=g, device=dev).bfloat16()
    for T in (1, 3, 64, 2000):
        out, ref = MP.accumulating_dots_cuda(x8, w8, T), MP.accumulating_dots_plain(x8, w8, T)
        torch.cuda.synchronize()
        bad = int((out != ref).sum())
        err_s8 = (out.long() - ref.long()).abs().max().item()  # the last T's is the headline's
        if out.dtype != torch.int32 or bad:
            raise AssertionError(f"K7 mma_probe s8 T={T}: {bad} of {out.numel()} entries differ from the plain "
                                 f"version, max|d| {err_s8}")
    log("  K7 mma_probe s8: bit-identical to the plain version (sum modulo 2^32) at T = 1, 3, 64, 2000")
    out, ref = MP.accumulating_dots_cuda(xb, wb, 4), MP.accumulating_dots_plain(xb, wb, 4)
    torch.cuda.synchronize()
    err_bf16 = (out - ref).abs().max().item()
    if not torch.isfinite(out).all() or not err_bf16 <= 1e-2 * ref.abs().max().item():
        raise AssertionError(f"K7 mma_probe bf16 T=4: max|d| {err_bf16:.3g} fails 1e-2*max|ref|")
    log(f"  K7 mma_probe bf16 T=4: max|d| {err_bf16:.3g} (bound 1e-2*max|ref| = {1e-2 * ref.abs().max().item():.3g})")
    t_lo, t_hi = 2000, 6000
    ops = 2 * MP.BM * MP.BK * MP.BN
    times = {}
    for name, (x, w) in (("s8", (x8, w8)), ("bf16", (xb, wb))):
        lo = cuda_ms(lambda: MP.accumulating_dots_cuda(x, w, t_lo), runs=5, warmup=1)
        hi = cuda_ms(lambda: MP.accumulating_dots_cuda(x, w, t_hi), runs=5, warmup=1)
        rate = (t_hi - t_lo) * ops / ((hi - lo) * 1e-3)
        if not hi > lo or rate > PEAK_OPS_PER_S[name]:
            raise AssertionError(f"K7 mma_probe {name}: T={t_lo} {lo:.3f} ms, T={t_hi} {hi:.3f} ms: no valid slope")
        times[name] = lo
        log(f"  K7 mma_probe {name}: T={t_lo} {lo:.4f} ms, T={t_hi} {hi:.4f} ms, slope {rate / 1e12:.2f} T/s "
            f"({100 * rate / PEAK_OPS_PER_S[name]:.1f} % of the data-sheet {PEAK_OPS_PER_S[name] / 1e12:.0f})")
    pms = cuda_ms(lambda: MP.accumulating_dots_plain(x8, w8, t_lo), runs=5, warmup=1)
    one_s8 = cuda_ms(lambda: torch._int_mm(x8, w8))
    one_bf16 = cuda_ms(lambda: torch.matmul(xb, wb))
    log(f"  one product: torch._int_mm {one_s8:.4f} ms ({ops / (one_s8 * 1e-3) / 1e12:.1f} TOP/s), torch.matmul bf16 "
        f"{one_bf16:.4f} ms ({ops / (one_bf16 * 1e-3) / 1e12:.1f} TFLOP/s); {t_lo} of them {t_lo * one_s8:.4f} ms and "
        f"{t_lo * one_bf16:.4f} ms, against K7's {times['s8']:.4f} ms and {times['bf16']:.4f} ms; plain version "
        f"(one f64 product times T) {pms:.4f} ms")
    # both operands read once, the sum written once
    return record(float(err_s8), times["s8"], pms, nbytes=MP.BM * MP.BK + MP.BK * MP.BN + 4 * MP.BM * MP.BN,
                  ops=t_lo * ops, op_type="s8", library_ms=t_lo * one_s8)


def counters() -> dict:
    """Every kernel wrapper's launch count, and as ``conv_s8_thin`` those of
    K5's that ran the stem and head kernels (which ``conv_s8`` counts too)."""
    from guided_diffusion_clip_tpu_torch.ops import kernel_wrappers
    from guided_diffusion_clip_tpu_torch.ops.quant import conv_s8_cuda

    return {**{fn_name: fn.launches for fn_name, fn in kernel_wrappers().items()},
            "conv_s8_thin": conv_s8_cuda.launches_thin}


def reset_counters() -> None:
    from guided_diffusion_clip_tpu_torch.ops import kernel_wrappers

    for fn in kernel_wrappers().values():
        fn.launches = 0
        for part in ("launches_mma", "launches_f32", "launches_thin"):
            if hasattr(fn, part):
                setattr(fn, part, 0)


def tensor_core_split(launches: dict) -> dict:
    """A path's ``counters()``, read just before with no launch since, plus the
    K1 and K2 launches on float32 input, which run the float32 tensor-core
    kernels (``attention_fwd_f32mma.cu``, ``attention_bwd_f32mma.cuh``), as
    ``attention_f32`` and ``attention_bwd_f32``; ``attention`` and
    ``attention_bwd`` keep counting both dtypes. Raises if a K1 or K2 launch of
    the path ran on the FMA-pipe kernels, which no call should reach."""
    from guided_diffusion_clip_tpu_torch.ops import attention as A

    for name, fn in (("K1", A.attention_fwd_cuda), ("K2", A.attention_bwd_cuda)):
        if fn.launches != fn.launches_mma:
            raise AssertionError(f"{fn.launches - fn.launches_mma} of {name}'s {fn.launches} launches ran on the FMA "
                                 f"pipes")
    return {**launches, "attention_f32": A.attention_fwd_cuda.launches_f32,
            "attention_bwd_f32": A.attention_bwd_cuda.launches_f32}


def f32_attention_calls(clf) -> int:
    """Attention calls of one classifier forward that are float32 by the
    reference's design: the attention pool keeps f32 in a bf16 classifier, so
    its K1 (and K2) runs the float32 tensor-core kernels, exact to 1e-4."""
    from guided_diffusion_clip_tpu_torch.models.unet import AttentionPool2d

    return sum(isinstance(m, AttentionPool2d) for m in clf.modules())


def check_tensor_core_launches(path: str, k1_f32: int = 0, k2_f32: int = 0) -> None:
    """After a main path (bf16 torsos): every K1 and K2 launch since the
    counts were reset ran on the tensor cores, none on the FMA-pipe kernels,
    and the float32 ones (the split-TF32 kernels) were the ``k1_f32`` and
    ``k2_f32`` float32 calls of the path's modules, no more and no fewer."""
    from guided_diffusion_clip_tpu_torch.ops import attention as A

    for name, fn, f32 in (("K1", A.attention_fwd_cuda, k1_f32), ("K2", A.attention_bwd_cuda, k2_f32)):
        if fn.launches != fn.launches_mma or fn.launches_f32 != f32:
            raise AssertionError(f"{path}: {fn.launches_mma} of {name}'s {fn.launches} launches ran on the tensor "
                                 f"cores, {fn.launches_f32} on float32 input, with {f32} float32 calls")
    log(f"  {path}: all {A.attention_fwd_cuda.launches} K1 and {A.attention_bwd_cuda.launches} K2 launches ran on the "
        f"tensor cores, float32 (split TF32) {k1_f32} and {k2_f32}: the modules' float32 calls")


def thin_convs(model) -> int:
    """The convs of ``model``'s structure (a module or a list of modules) that
    K5 runs on ``conv_s8_thin.cu`` under int8: the stems (3 channels in; 6, x
    and its partner or its upsampled low_res, in the SR models) and the head
    (6 channels out; 3 in the quality tools' proxies and their classifier's
    1x1 head), counted from the modules' channels alone and not by the
    wrapper's own dispatch rule (``ops/quant.py::uses_thin_kernel``), so that
    a rule that sent any other conv to the thin kernels, or one of these to
    another kernel, would fail the count."""
    from guided_diffusion_clip_tpu_torch.models.nn import Conv2d

    roots = model if isinstance(model, (list, tuple)) else [model]
    return sum(isinstance(m, Conv2d) and (m.in_channels in (3, 6) or m.out_channels in (3, 6))
               for root in roots for m in root.modules())


def check_conv_tensor_core_launches(path: str, thin: int) -> None:
    """After an int8 main path: every K5 launch since the counts were reset
    ran on the tensor cores, on ``conv_s8_mma.cu`` or on ``conv_s8_thin.cu``,
    none on ``__dp4a``, and the thin kernels' launches were the ``thin`` stem
    and head convs counted from the modules."""
    from guided_diffusion_clip_tpu_torch.ops.quant import conv_s8_cuda as k5

    if (k5.launches != k5.launches_mma + k5.launches_thin or k5.launches_thin != thin
            or (k5.launches and not k5.launches_mma)):
        raise AssertionError(f"{path}: of K5's {k5.launches} launches {k5.launches_mma} ran conv_s8_mma.cu and "
                             f"{k5.launches_thin} conv_s8_thin.cu, with {thin} stem and head convs")
    log(f"  {path}: K5's {k5.launches} launches: {k5.launches_mma} on conv_s8_mma.cu, {k5.launches_thin} on "
        f"conv_s8_thin.cu (the stem and head convs: 3 or 6 channels in or out), none on __dp4a")


def gn_conv_counts(model, int8: bool) -> dict:
    """K3, K4 and K5 launches and launches of the quantize kernels of one
    forward of ``model``'s structure (a module, or a list of the modules a
    partial forward runs) with ``int8`` or without, counted from its modules:
    under int8 every ResBlock's out_norm and every in_norm but a down
    block's quantizes (K4) and feeds one conv, every other GroupNorm is K3,
    every conv runs K5 once, and every conv that no K4 feeds quantizes its
    float input itself, and the stems and heads (``thin_convs``) run the
    thin kernels (``conv_s8_thin``); otherwise every GroupNorm is K3 and no
    conv runs K5."""
    from guided_diffusion_clip_tpu_torch.models.nn import Conv2d, GroupNorm32
    from guided_diffusion_clip_tpu_torch.models.unet import ResBlock

    roots = model if isinstance(model, (list, tuple)) else [model]
    mods = [m for root in roots for m in root.modules()]
    gn = sum(isinstance(m, GroupNorm32) for m in mods)
    if not int8:
        return {"group_norm": gn, "group_norm_quant": 0, "conv_s8": 0, "conv_s8_thin": 0, "quantize": 0}
    k4 = sum((1 if m.down else 2) for m in mods if isinstance(m, ResBlock))
    convs = sum(isinstance(m, Conv2d) for m in mods)
    return {"group_norm": gn - k4, "group_norm_quant": k4, "conv_s8": convs, "conv_s8_thin": thin_convs(roots),
            "quantize": convs - k4}


def shallow_roots(model, cut: int) -> list:
    """The modules that a ``cache_mode="shallow"`` forward of a UNetModel runs."""
    n_in = len(model.input_blocks)
    return [*list(model.input_blocks)[:cut], *list(model.output_blocks)[n_in - cut:], model.out]


def unet_counts(model, int8: bool, shallow_cut=None) -> dict:
    """K1, K3, K4 and K5 launches of one forward of a UNetModel, from its
    modules: the whole model, or with ``shallow_cut`` the blocks that a
    ``cache_mode="shallow"`` forward runs (``input_blocks[:cut]``, the last
    ``cut`` output blocks and the head)."""
    from guided_diffusion_clip_tpu_torch.models.unet import AttentionBlock

    roots = [model] if shallow_cut is None else shallow_roots(model, shallow_cut)
    attn = sum(isinstance(m, AttentionBlock) for root in roots for m in root.modules())
    return {"attention": attn, **gn_conv_counts(roots, int8)}


def random_state_dict(model):
    """N(0, 0.02) for every weight, from a seed (as bench.py fills its
    params): the module's zero-init output layers would make the UNet's
    output exactly 0."""
    import torch

    g = torch.Generator().manual_seed(WEIGHT_SEED)
    return {
        k: torch.randn(v.shape, generator=g, dtype=torch.float32) * 0.02
        for k, v in sorted(model.state_dict().items())
    }


def clip_unet(sd=None, **over):
    """The fork's CLIP-conditioned UNet at the ADM-256 widths (phases 4, 5, 11,
    11b), f32 unless ``over`` says otherwise, in eval mode with no gradient
    for its weights, loaded from ``sd`` when given."""
    from guided_diffusion_clip_tpu_torch.utils.script_util import create_model

    kw = dict(learn_sigma=True, class_cond=True, attention_resolutions="32,16,8", num_head_channels=64,
              use_scale_shift_norm=True, resblock_updown=True, use_fp16=False)
    kw.update(over)
    model = create_model(256, 256, 2, **kw).eval()
    if sd is not None:
        model.load_state_dict(sd, strict=True)
    return model.requires_grad_(False)


def phase4e_deep_cache(dev, sd):
    """The UNet's cache modes at full width, batch 1, f32: a ``full`` forward
    and a ``shallow`` one fed its deep feature, card against CPU; on the card
    the shallow forward against the plain (``off``) one at the same (x, t),
    which it must equal but for the order of the kernels' launches, and the
    plain forward against the CPU's full one (the same function; a phase 4 once
    ran a second CPU forward for it)."""
    import torch

    tf32_off()
    model = clip_unet(sd)
    g = torch.Generator().manual_seed(12)
    x = torch.randn(1, 3, 256, 256, generator=g)
    t = torch.tensor([500])
    feat = torch.randn(1, 512, generator=g)

    def run(m, to):
        kw = dict(clip_feat=feat.to(to))
        full, deep = m(x.to(to), t.to(to), cache_mode="full", **kw)
        shallow, deep_back = m(x.to(to), t.to(to), deep_cache=deep, cache_mode="shallow", **kw)
        if deep_back is not deep:
            raise AssertionError("a shallow forward must hand back the deep feature it was given")
        return full, deep, shallow

    with torch.inference_mode():
        ref = run(model, "cpu")
        model.to(dev)
        before = counters()
        out = run(model, dev)
        ran = {k: counters()[k] - before[k] for k in ("attention", "group_norm")}
        off = model(x.to(dev), t.to(dev), clip_feat=feat.to(dev))
    cut = model.config.num_res_blocks + 1
    per_full, per_shallow = unet_counts(model, False), unet_counts(model, False, cut)
    want = {k: per_full[k] + per_shallow[k] for k in ran}
    if ran != want:
        raise AssertionError(f"full + shallow forward launched {ran}, planned {want}")
    if tuple(out[1].shape) != (1, 256, 256, 256):
        raise AssertionError(f"deep feature {tuple(out[1].shape)}, not (1, 256, 256, 256)")
    for name, o, r in zip(("full output", "deep feature", "shallow output"), out, ref):
        rel = ((o.cpu().float() - r.float()).norm() / r.float().norm()).item()
        log(f"  {name} {tuple(o.shape)} f32: rel L2 err card vs CPU {rel:.3g} (bound 1e-3)")
        if not torch.isfinite(o).all() or not r.norm() > 0 or not rel <= 1e-3:
            raise AssertionError(f"card {name} differs from the CPU's: rel L2 {rel:.3g}")
    rel = ((out[2] - off).norm() / off.norm()).item()
    log(f"  shallow(deep from full) vs the plain forward on the card: rel L2 {rel:.3g} (bound 1e-5); a full "
        f"forward launches {per_full}, a shallow one {per_shallow} (cut {cut})")
    if not rel <= 1e-5:
        raise AssertionError(f"shallow forward differs from the plain forward: rel L2 {rel:.3g}")
    rel = ((off.cpu() - ref[0]).norm() / ref[0].norm()).item()
    log(f"  the plain forward (1, 3, 256, 256) f32 on the card against the CPU's: rel L2 {rel:.3g} (bound 1e-3)")
    if tuple(off.shape) != (1, 6, 256, 256) or not torch.isfinite(off).all() or not rel <= 1e-3:
        raise AssertionError(f"card forward {tuple(off.shape)} differs from the CPU forward: rel L2 {rel:.3g}")
    del model


def phase4b_guidance(dev):
    """The full-width classifier, batch 1, f32: logits and classifier_cond_fn's
    dx on the card (K1, K2, K3) against the CPU (plain versions)."""
    import torch

    from guided_diffusion_clip_tpu_torch.diffusion.guidance import classifier_cond_fn
    from guided_diffusion_clip_tpu_torch.ops import attention as A
    from guided_diffusion_clip_tpu_torch.utils.script_util import create_classifier

    tf32_off()
    clf = create_classifier(256, False, 128, 2, "32,16,8", True, True, "attention").eval()
    clf.load_state_dict(random_state_dict(clf), strict=True)
    clf.requires_grad_(False)
    cond = classifier_cond_fn(clf, 1.0)
    g = torch.Generator().manual_seed(4)
    x = torch.randn(1, 3, 256, 256, generator=g)
    t, y = torch.tensor([500]), torch.tensor([417])
    with torch.no_grad():
        t0 = time.perf_counter()
        ref_logits, ref_dx = clf(x, t), cond(x, t, y=y)
        cpu_s = time.perf_counter() - t0
        clf.to(dev)
        k2 = A.attention_bwd_cuda.launches
        logits = clf(x.to(dev), t.to(dev)).cpu()
        dx = cond(x.to(dev), t.to(dev), y=y.to(dev)).cpu()
    if A.attention_bwd_cuda.launches - k2 != CLF_ATTN_PER_FORWARD:
        raise AssertionError(f"guidance gradient ran K2 {A.attention_bwd_cuda.launches - k2} times, "
                             f"not {CLF_ATTN_PER_FORWARD}")
    for name, out, ref, shape in (("logits", logits, ref_logits, (1, 1000)), ("dx", dx, ref_dx, (1, 3, 256, 256))):
        if out.shape != shape or not torch.isfinite(out).all():
            raise AssertionError(f"guidance {name}: {tuple(out.shape)} not finite {shape}")
        rel = ((out - ref).norm() / ref.norm()).item()
        log(f"  classifier {name} {shape} f32: |ref| {ref.norm().item():.4g}, rel L2 err card vs CPU "
            f"{rel:.3g} (bound 1e-3)")
        if not ref.norm() > 0 or not rel <= 1e-3:
            raise AssertionError(f"card guidance {name} differs from the CPU: rel L2 {rel:.3g}")
    log(f"  CPU classifier forward + guidance gradient {cpu_s:.2f} s")


class Int8Forcing:
    """Teacher forcing of an int8 model's roundings, from the CPU to the card.

    ``record(model)``: forward hooks keep each quantizing GroupNorm's
    (q, s) and each per-tensor int8 conv's output of the next forwards (the
    plain versions on the CPU), in call order. ``force(model)``: in the same
    forwards on the card, each such output is checked against the recorded
    one (s to rtol 1e-5, for f32 sums in another order on the CPU, plus 8
    (mean / std)^2 ulps of the group; q within one level on at most ``share``
    of it, 1e-4 by default; the
    conv's relative L2 within 5e-3 and max within 1e-2 * max|ref|, as one
    flipped level of x_q moves a 3x3 patch by s_x * |w|) and replaced by it,
    keeping the card's gradient. Without it, a value that rounds the other
    way in the card's sums moves the next layer's inputs by a level's worth
    and the flips compound layer by layer. The output heads (``out.*``) are
    left alone: the caller compares what they give.

    Under spatial partitioning (phase 17) ``rows`` is ``sp.shard_rows``: the
    recorded forward ran unsharded on the card (kept there) and the forced
    one on the rank's rows, so a recorded map whose shape is not the
    shard's is cut to them, and a group's offset is read on the gathered
    input (``whole_of(x, ref)``, ``sp.gather_rows`` by default). Under
    tensor parallelism (phase 18) ``rows`` cuts the rank's channels and
    ``whole_of`` gathers them. ``worst`` is the largest ratio of a reading
    to its bound over the forced layers; not ``strict``, a ratio above 1
    raises nothing (a fault's reading is logged beside the clean one).
    """

    def __init__(self, share: float = 1e-4, rows=None, strict: bool = True, whole_of=None):
        self.share, self.rows, self.strict, self.whole_of = share, rows, strict, whole_of
        self.rec = []
        self.pos = 0
        self.flips = self.elems = 0
        self.s_err = self.conv_l2 = self.worst = 0.0
        self.handles = []

    def _judge(self, ratios: dict, what: str) -> None:
        self.worst = max(self.worst, *(v if v == v else math.inf for v in ratios.values()))
        if self.strict and not all(v <= 1 for v in ratios.values()):
            raise AssertionError(f"int8 forcing: {what}")

    def _hook(self, forcing):
        import torch

        from guided_diffusion_clip_tpu_torch.parallel import sp

        def hook(mod, args, kwargs, out):
            quant_gn = kwargs.get("quantize", False)
            if not quant_gn and (kwargs.get("prequant_scales") is not None or not getattr(mod, "int8", False)):
                return None
            if not forcing:
                self.rec.append(tuple((t.detach().clone() if self.rows else t.detach().cpu().clone())
                                      for t in (out if quant_gn else (out,))))
                return None
            ref = self.rec[self.pos]
            self.pos += 1
            if quant_gn:
                (q, sc), (rq, rsc) = out, ref
                x = args[0].detach()
                if rq.shape != q.shape:
                    rq, x = self.rows(rq), (self.whole_of or (lambda u, _: sp.gather_rows(u)))(x, rq)
                rq, rsc = rq.to(q.device), rsc.to(sc.device)
                d = (q.detach().float() - rq.float()).abs()
                flips = int((d > 0).sum())
                s_err = ((sc - rsc).abs() / rsc).max().item()
                # f32 sums of up to 2^21 terms in another order on the CPU
                # (~1e-6), and the one-pass variance E[x^2] - mean^2 loses
                # (mean / std)^2 ulps, a few times over, where a group is offset
                xg = x.movedim(1, -1).double().reshape(x.shape[0], -1, 32, x.shape[1] // 32)
                ratio = (xg.mean((1, 3)).abs() / xg.std((1, 3))).max().item()
                s_tol = 1e-5 + ratio**2 * 2.0**-20
                self._judge({"q": d.max().item(), "flips": flips / max(1, self.share * d.numel()),
                             "s": s_err / s_tol},
                            f"q max|d| {d.max().item()}, {flips} of {d.numel()} off (bound {self.share:g}), "
                            f"s rel err {s_err:.3g} (bound {s_tol:.3g})")
                self.flips += flips
                self.elems += d.numel()
                self.s_err = max(self.s_err, s_err)
                rq = rq.to(q.dtype).contiguous(memory_format=torch.channels_last)
                return (q + (rq - q).detach() if q.requires_grad else rq), rsc
            (r,) = ref
            r = (r if r.shape == out.shape else self.rows(r)).to(out.device)
            d = out.detach().float() - r.float()
            l2 = (d.norm() / r.float().norm()).item()
            top = (d.abs().max() / (1e-2 * r.float().abs().max())).item()
            self._judge({"l2": l2 / 5e-3, "max": top}, f"int8_conv output rel L2 {l2:.3g} (bound 5e-3), "
                        f"max|d| {top:.3g} of its bound 1e-2 * max|ref|")
            self.conv_l2 = max(self.conv_l2, l2)
            r = r.to(out.dtype).contiguous(memory_format=torch.channels_last)
            return out + (r - out).detach() if out.requires_grad else r

        return hook

    def _attach(self, model, forcing):
        from guided_diffusion_clip_tpu_torch.models.nn import Conv2d, GroupNorm32

        for name, m in model.named_modules():
            if isinstance(m, (GroupNorm32, Conv2d)) and not name.startswith("out."):
                self.handles.append(m.register_forward_hook(self._hook(forcing), with_kwargs=True))

    def record(self, model):
        self._attach(model, False)
        return self

    def force(self, model):
        self.pos, self.worst = 0, 0.0
        self._attach(model, True)
        return self

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        for h in self.handles:
            h.remove()
        self.handles = []
        if exc[0] is None and self.pos not in (0, len(self.rec)):
            raise AssertionError(f"int8 forcing: {self.pos} of {len(self.rec)} recorded outputs replayed")

    def summary(self) -> str:
        return (f"forced {len(self.rec)} roundings: q off by one on {self.flips} of {self.elems} "
                f"({self.flips / max(1, self.elems):.2g}), max s rel err {self.s_err:.3g}, "
                f"worst int8_conv rel L2 {self.conv_l2:.3g}")


def phase4c_int8_forward(dev, sd):
    """Full-width int8 forward, batch 1, f32: card (K4, K5) vs CPU (plain),
    teacher-forced; the free-running difference is reported."""
    import torch

    tf32_off()
    model = clip_unet(sd, conv_impl="int8")
    want = gn_conv_counts(model, True)
    g = torch.Generator().manual_seed(2)
    x = torch.randn(1, 3, 256, 256, generator=g)
    t = torch.tensor([500])
    feat = torch.randn(1, 512, generator=g)
    with torch.inference_mode():
        t0 = time.perf_counter()
        with Int8Forcing().record(model) as forcing:
            ref = model(x, t, clip_feat=feat)
        cpu_s = time.perf_counter() - t0
        model.to(dev)
        before = counters()
        with forcing.force(model):
            out = model(x.to(dev), t.to(dev), clip_feat=feat.to(dev)).cpu()
        ran = {k: counters()[k] - before[k] for k in want}
        free = model(x.to(dev), t.to(dev), clip_feat=feat.to(dev)).cpu()
    if ran != want:
        raise AssertionError(f"int8 forward launched {ran}, planned {want}")
    if out.shape != (1, 6, 256, 256) or not torch.isfinite(out).all():
        raise AssertionError(f"int8 forward output {tuple(out.shape)} not finite (1, 6, 256, 256)")
    rel = ((out - ref).norm() / ref.norm()).item()
    free_rel = ((free - ref).norm() / ref.norm()).item()
    log(f"  int8 forward (1, 3, 256, 256) f32, launches {ran} (planned from the modules); "
        f"{forcing.summary()}")
    log(f"  |ref| {ref.norm().item():.4g}, rel L2 err card vs CPU {rel:.3g} teacher-forced (bound 1e-3), "
        f"{free_rel:.3g} free-running (not bounded); CPU forward {cpu_s:.2f} s")
    if not ref.norm() > 0 or not rel <= 1e-3:
        raise AssertionError(f"card int8 forward differs from the CPU forward: rel L2 {rel:.3g}")
    del model


def phase4d_int8_guidance(dev):
    """The full-width int8 classifier, batch 1, f32: logits and
    classifier_cond_fn's dx, card (K1-K5) against the CPU (plain versions),
    teacher-forced. dx twice: with conv_prequant's straight-through convs
    in f32 (bound 1e-3: the algorithm), and in bf16 as shipped (bound 2e-2:
    cuDNN and the CPU round the bf16 convs' outputs at other places)."""
    import torch

    from guided_diffusion_clip_tpu_torch.diffusion.guidance import classifier_cond_fn
    from guided_diffusion_clip_tpu_torch.ops import quant as Q
    from guided_diffusion_clip_tpu_torch.utils.script_util import create_classifier

    tf32_off()
    clf = create_classifier(256, False, 128, 2, "32,16,8", True, True, "attention", conv_impl="int8").eval()
    clf.load_state_dict(random_state_dict(clf), strict=True)
    clf.requires_grad_(False)
    cond = classifier_cond_fn(clf, 1.0)
    g = torch.Generator().manual_seed(4)
    x = torch.randn(1, 3, 256, 256, generator=g)
    t, y = torch.tensor([500]), torch.tensor([417])
    stes = ((torch.float32, 1e-3), (torch.bfloat16, 2e-2))
    refs, forcings = {}, {}
    try:
        with torch.no_grad():
            t0 = time.perf_counter()
            with Int8Forcing().record(clf) as forcings["logits"]:
                refs["logits"] = clf(x, t)
            for ste, _ in stes:
                Q._STE_DTYPE = ste
                with Int8Forcing().record(clf) as forcings[ste]:
                    refs[ste] = cond(x, t, y=y)
            cpu_s = time.perf_counter() - t0
            clf.to(dev)
            with forcings["logits"].force(clf):
                logits = clf(x.to(dev), t.to(dev)).cpu()
            outs = {}
            for ste, _ in stes:
                Q._STE_DTYPE = ste
                with forcings[ste].force(clf):
                    outs[ste] = cond(x.to(dev), t.to(dev), y=y.to(dev)).cpu()
            free = cond(x.to(dev), t.to(dev), y=y.to(dev)).cpu()
    finally:
        Q._STE_DTYPE = torch.bfloat16
    log(f"  logits: {forcings['logits'].summary()}")
    checks = [("logits", logits, refs["logits"], (1, 1000), 1e-3)]
    for ste, bound in stes:
        log(f"  guidance gradient, {str(ste)[6:]} straight-through convs: {forcings[ste].summary()}")
        checks.append((f"dx ({str(ste)[6:]} straight-through convs)", outs[ste], refs[ste], (1, 3, 256, 256), bound))
    for name, out, ref, shape, bound in checks:
        if out.shape != shape or not torch.isfinite(out).all():
            raise AssertionError(f"int8 guidance {name}: {tuple(out.shape)} not finite {shape}")
        rel = ((out - ref).norm() / ref.norm()).item()
        log(f"  int8 classifier {name} {shape} f32: |ref| {ref.norm().item():.4g}, rel L2 err card vs CPU "
            f"{rel:.3g} teacher-forced (bound {bound:g})")
        if not ref.norm() > 0 or not rel <= bound:
            raise AssertionError(f"card int8 guidance {name} differs from the CPU: rel L2 {rel:.3g}")
    ref_dx = refs[torch.bfloat16]
    log(f"  dx free-running: rel L2 {((free - ref_dx).norm() / ref_dx.norm()).item():.3g} (not bounded); "
        f"CPU int8 classifier forward + 2 guidance gradients {cpu_s:.2f} s")


def start_server(sampler):
    """Serve ``sampler`` over HTTP on a free local port; returns (httpd,
    thread, base url)."""
    from http.server import ThreadingHTTPServer

    from guided_diffusion_clip_tpu_torch import serve

    httpd = ThreadingHTTPServer(("127.0.0.1", 0), serve.make_handler(sampler))
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    return httpd, thread, f"http://127.0.0.1:{httpd.server_address[1]}"


def get_healthz(url) -> dict:
    with urllib.request.urlopen(f"{url}/healthz", timeout=60) as r:
        return json.loads(r.read())


def post_sample(url, n, seed, feat=None, size=256):
    """POST /sample; returns (the n uint8 images of ``size`` px, the request's
    seconds)."""
    import numpy as np

    payload = {"num_samples": n, "seed": seed}
    if feat is not None:
        payload["clip_feat"] = feat.tolist()
    req = urllib.request.Request(
        f"{url}/sample", data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"}, method="POST",
    )
    t = time.perf_counter()
    with urllib.request.urlopen(req, timeout=600) as r:
        arr = np.load(io.BytesIO(r.read()))["arr_0"]
    dt = time.perf_counter() - t
    if arr.shape != (n, size, size, 3) or arr.dtype != np.uint8:
        raise AssertionError(f"/sample n={n}: got {arr.shape} {arr.dtype}")
    if not all(arr[i].std() > 0 for i in range(n)):
        raise AssertionError(f"/sample n={n}: a constant image")
    return arr, dt


def phase5_serve(dev, ckpt_path, conv_impl="auto"):
    """The serving path over HTTP; returns the kernels' launch counts. Under
    int8 the per-sample RNG contract across packings does not hold (the
    per-tensor scale of int8_conv spans the batch, in the JAX server too),
    so only the same request at the same bucket is held to the same bytes."""
    import numpy as np
    import torch

    from guided_diffusion_clip_tpu_torch import serve

    int8 = conv_impl == "int8"
    # PyTorch's defaults, which the server leaves as they are
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = True
    args = serve.parse_args([*SLICE_FLAGS, "--model_path", ckpt_path, "--device", dev.type,
                             "--conv_impl", conv_impl])
    size = args.image_size

    # the main path starts here: count every launch of its kernels
    reset_counters()
    t0 = time.perf_counter()
    sampler = serve.Sampler(args)
    sampler.warmup()
    log(f"  server built and warm in {time.perf_counter() - t0:.1f} s; warm chain latency "
        f"by bucket {{{', '.join(f'{b}: {s:.3f} s' for b, s in sorted(sampler.bucket_latency.items()))}}}")
    httpd, thread, url = start_server(sampler)


    def healthz():
        return get_healthz(url)

    def sample(n, seed, feat=None):
        return post_sample(url, n, seed, feat, size)

    try:
        h = healthz()
        if not (h["ok"] and h["compiled"] and h["batch_buckets"] == [1, 4, 8] and h["steps"] == 25):
            raise AssertionError(f"/healthz: {h}")
        log(f"  /healthz: {h}")
        rs = np.random.RandomState(3)
        feat4 = rs.standard_normal((4, 512)).astype(np.float32)
        lat = []
        a1, dt = sample(1, 11)
        lat.append((1, dt))
        a4, dt = sample(4, 12, feat4)
        lat.append((4, dt))
        a12, dt = sample(12, 13)
        lat.append((12, dt))
        for n, dt in lat:
            log(f"  /sample n={n}: {dt:.3f} s, {n / dt:.3f} samples/s")

        # the same request at the same bucket gives the same bytes
        a4b, _ = sample(4, 12, feat4)
        if not np.array_equal(a4, a4b):
            raise AssertionError("repeated /sample n=4 returned different bytes")
        log("  repeated /sample n=4: the same bytes")
        if not int8:  # coalescing, and the per-sample RNG across packings
            # two concurrent requests coalesce into one chain
            d0 = healthz()["dispatches"]
            with concurrent.futures.ThreadPoolExecutor(2) as pool:
                fa = pool.submit(sample, 2, 21)
                fb = pool.submit(sample, 2, 22)
                (ca, dta), (cb, dtb) = fa.result(), fb.result()
            h2 = healthz()
            if h2["dispatches"] != d0 + 1 or h2["coalesced_requests"] < 2:
                raise AssertionError(f"concurrent requests did not coalesce: {d0} -> {h2}")
            log(f"  coalesced 2 x /sample n=2 in one chain: {dta:.3f} s and {dtb:.3f} s")

            # per-sample RNG: the same (seed, subidx, clip_feat) solo, coalesced and
            # in another bucket; cuDNN may pick batch-dependent algorithms
            sa, _ = sample(2, 21)
            s1, _ = sample(1, 21)
            s13, _ = sample(1, 13)
            b1, b2, b8 = (sampler._bucket_for(n) for n in (1, 2, 8))
            diffs = {
                f"coalesced vs solo n=2 (bucket {b2})": np.abs(ca.astype(int) - sa.astype(int)).max(),
                f"n=1 (bucket {b1}) vs n=2 (bucket {b2})": np.abs(s1[0].astype(int) - sa[0].astype(int)).max(),
                f"n=1 (bucket {b1}) vs first chunk of n=12 (bucket {b8})":
                    np.abs(s13[0].astype(int) - a12[0].astype(int)).max(),
            }
            for k, v in diffs.items():
                log(f"  max |uint8 diff| {k}: {v} (bound 2)")
            if max(diffs.values()) > 2:
                raise AssertionError(f"per-sample RNG contract broken: {diffs}")
    finally:
        stop_server(sampler, httpd, thread)
    return check_serve_launches(sampler, int8)


def phase5c_serve_cfg(dev, ckpt_path):
    """``serve --cfg_scale 2.0 --cfg_cache 2 --sampler dpm++2m`` over HTTP, one
    bucket of 4, bf16, 25 steps; returns the kernels' launch counts. A chain
    runs the conditional branch every step and refreshes the unconditional
    one on steps 0, 2, ..., 24: 25 + 13 forwards."""
    import numpy as np
    import torch

    from guided_diffusion_clip_tpu_torch import serve

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = True
    flags = list(SLICE_FLAGS)
    for name, value in (("--batch_size", "4"), ("--batch_buckets", ""), ("--coalesce_ms", "0"), ("--use_ddim", "False")):
        flags[flags.index(name) + 1] = value
    args = serve.parse_args([*flags, "--sampler", "dpm++2m", "--cfg_scale", "2.0", "--cfg_cache", "2",
                             "--model_path", ckpt_path, "--device", dev.type])

    reset_counters()
    t0 = time.perf_counter()
    sampler = serve.Sampler(args)
    sampler.warmup()
    log(f"  CFG server built and warm in {time.perf_counter() - t0:.1f} s; warm chain latency "
        f"{sampler.bucket_latency[4]:.3f} s (batch 4, 25 dpm++2m steps, 38 forwards)")
    httpd, thread, url = start_server(sampler)
    try:
        h = get_healthz(url)
        if not (h["ok"] and h["compiled"] and h["sampler"] == "dpm++2m" and h["steps"] == 25):
            raise AssertionError(f"/healthz: {h}")
        feat = np.random.RandomState(5).standard_normal((4, 512)).astype(np.float32)
        a, dt = post_sample(url, 4, 31, feat)
        b, _ = post_sample(url, 4, 31, feat)
        if not np.array_equal(a, b):
            raise AssertionError("repeated CFG /sample n=4 returned different bytes")
        log(f"  /sample n=4 (cfg_scale 2.0, cfg_cache 2, dpm++2m): {dt:.3f} s, {4 / dt:.3f} samples/s; "
            f"repeated: the same bytes")
    finally:
        stop_server(sampler, httpd, thread)
    chains = sampler.dispatches
    if sampler.forwards != chains * (25 + 13):
        raise AssertionError(f"{sampler.forwards} forwards in {chains} chains, not 25 steps + 13 refreshes each")
    return check_serve_launches(sampler, False)


def stop_server(sampler, httpd, thread) -> None:
    httpd.shutdown()
    httpd.server_close()
    thread.join(timeout=30)
    sampler.close()


def check_serve_launches(sampler, int8: bool) -> dict:
    """The kernels' launch counts, checked against the forwards served."""
    forwards = sampler.forwards
    launches = counters()
    log(f"  {forwards} UNet forwards served; kernel launches {launches}")
    per = gn_conv_counts(sampler.model, int8)
    if not int8 and per["group_norm"] != GN_PER_FORWARD:
        raise AssertionError(f"{per['group_norm']} GroupNorms in the UNet, not {GN_PER_FORWARD}")
    want = {**dict.fromkeys(launches, 0), "attention": ATTN_PER_FORWARD * forwards,
            **{k: n * forwards for k, n in per.items()}}
    if launches != want:
        raise AssertionError(f"launch counts {launches} != {want} ({forwards} forwards)")
    check_tensor_core_launches("serving")
    if int8:
        check_conv_tensor_core_launches("serving", thin_convs(sampler.model) * forwards)
    return tensor_core_split(launches)


def phase6_guided(dev, tmp, conv_impl="auto", paths=None):
    """classifier_sample.main on ADM-G 256 + its classifier (random weights
    from .pt files, written on the first call); returns the kernels' launch
    counts over the run, the .pt paths and the samples."""
    import numpy as np
    import torch

    from guided_diffusion_clip_tpu_torch import classifier_sample
    from guided_diffusion_clip_tpu_torch.utils.script_util import args_to_dict, create_classifier, create_upstream_model

    int8 = conv_impl == "int8"
    flags = [*GUIDED_FLAGS, "--conv_impl", conv_impl]
    # PyTorch's defaults, as the CLI leaves them
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = True
    args = classifier_sample.create_argparser().parse_args(flags)
    per = {}
    new_paths = {}
    with torch.device("meta"):  # the structure only: the counts, and the random weights' shapes
        models = (("model", create_upstream_model(**args_to_dict(args, classifier_sample._UNET_KEYS))),
                  ("classifier",
                   create_classifier(**args_to_dict(args, classifier_sample.classifier_defaults().keys()))))
    for name, model in models:
        per[name] = gn_conv_counts(model, int8)
        per[name]["thin"] = thin_convs(model)
        pools = f32_attention_calls(model)  # the last model of the loop is the classifier
        if paths is None:
            new_paths[name] = os.path.join(tmp, f"{name}_random.pt")
            torch.save(random_state_dict(model), new_paths[name])
    del models, model
    paths = paths or new_paths
    argv = [*flags, "--model_path", paths["model"], "--classifier_path", paths["classifier"],
            "--main_path", os.path.join(tmp, f"runs_{conv_impl}"), "--device", dev.type]

    # the main path starts here: count every launch of its kernels
    reset_counters()
    t0 = time.perf_counter()
    out = classifier_sample.main(argv)
    wall = time.perf_counter() - t0
    launches = counters()

    data = np.load(out["path"])
    images, labels = data["arr_0"], data["arr_1"]
    if images.shape != (8, 256, 256, 3) or images.dtype != np.uint8:
        raise AssertionError(f"samples {images.shape} {images.dtype}, not (8, 256, 256, 3) uint8")
    if not all(images[i].std() > 0 for i in range(8)):
        raise AssertionError("a constant image among the guided samples")
    if labels.shape != (8,) or not ((labels >= 0) & (labels < 1000)).all():
        raise AssertionError(f"labels {labels} not 8 classes in [0, 1000)")
    steps = out["steps"] * out["batches"]
    if not int8 and (per["model"]["group_norm"], per["classifier"]["group_norm"]) != (GN_PER_FORWARD, CLF_GN_PER_FORWARD):
        raise AssertionError(f"GroupNorms {per}, not {GN_PER_FORWARD} and {CLF_GN_PER_FORWARD}")
    thin = (per["model"].pop("thin") + per["classifier"].pop("thin")) * steps
    want = {**dict.fromkeys(launches, 0), "attention": (ATTN_PER_FORWARD + CLF_ATTN_PER_FORWARD) * steps,
            "attention_bwd": CLF_ATTN_PER_FORWARD * steps,
            **{k: (per["model"][k] + per["classifier"][k]) * steps for k in per["model"]}}
    log(f"  {steps} guided steps ({conv_impl}); kernel launches {launches} (expected {want}: per step the "
        f"UNet's {per['model']} and the classifier's {per['classifier']})")
    if launches != want:
        raise AssertionError(f"launch counts {launches} != {want}")
    check_tensor_core_launches("guided sampling", pools * steps, pools * steps)
    if int8:
        check_conv_tensor_core_launches("guided sampling", thin)
    chain = sum(out["chain_seconds"])
    log(f"  guided chain ({conv_impl}, batch 8, {out['steps']} steps): {chain:.3f} s, "
        f"{8 * 60 / chain:.3f} samples/min, {1000 * chain / steps:.2f} ms a step; main() {wall:.1f} s "
        f"with model building and loading")
    return tensor_core_split(launches), paths, images, chain


PRESET_FLAGS = ["--conv_impl", "int8", "--deep_cache", "5", "--guidance_cache", "2",
                "--guidance_interval", "200,800"]


def phase6c_preset(dev, tmp, paths):
    """classifier_sample.main with the deploy preset's four knobs (the keys of
    configs/deploy256_fast.yaml, given as flags) on ADM-G 256 + classifier,
    ``GUIDED_STEPS`` ancestral steps at batch 8; returns the launch counts, the samples
    and the chain's seconds. The expected counts come from the modules (what
    a full and a shallow UNet forward and a classifier forward launch) and
    from the schedule (DeepCache refreshes on steps 0, 5, ...; the classifier
    runs on the even steps whose model timestep lies in [200, 800])."""
    import numpy as np
    import torch

    from guided_diffusion_clip_tpu_torch import classifier_sample
    from guided_diffusion_clip_tpu_torch.utils.script_util import create_gaussian_diffusion

    flags = [*GUIDED_FLAGS, *PRESET_FLAGS]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = True
    counts = adm_g_counts(True)
    per_full, per_shallow, per_clf, pools = counts["full"], counts["shallow"], counts["clf"], counts["pools"]
    thin_full, thin_shallow, thin_clf = (counts["thin"][k] for k in ("full", "shallow", "clf"))
    # the schedule says which steps guide: step i runs local timestep T - 1 - i
    tmap = create_gaussian_diffusion(steps=1000, learn_sigma=True,
                                     timestep_respacing=str(GUIDED_STEPS)).sched.timestep_map.tolist()
    steps = len(tmap)
    inside = [200 <= tmap[steps - 1 - i] <= 800 for i in range(steps)]
    n_clf = sum(1 for i in range(steps) if i % 2 == 0 and inside[i])
    n_full = len(range(0, steps, 5))
    n_shallow = steps - n_full

    argv = [*flags, "--model_path", paths["model"], "--classifier_path", paths["classifier"],
            "--main_path", os.path.join(tmp, "runs_preset"), "--device", dev.type]
    reset_counters()
    t0 = time.perf_counter()
    out = classifier_sample.main(argv)
    wall = time.perf_counter() - t0
    launches = counters()

    calls = out["calls"]
    want_calls = {"unet_full": n_full, "unet_shallow": n_shallow, "classifier": n_clf}
    log(f"  {steps} steps: {sum(inside)} inside the window [200, 800]; network calls {calls} "
        f"(expected {want_calls} from the schedule)")
    if calls != want_calls or out["steps"] != steps or out["batches"] != 1:
        raise AssertionError(f"network calls {calls} != {want_calls}")
    want = dict.fromkeys(launches, 0)
    for per, n in ((per_full, n_full), (per_shallow, n_shallow), (per_clf, n_clf)):
        for k, v in per.items():
            want[k] += v * n
    log(f"  kernel launches {launches} (expected {want}: a full UNet forward {per_full}, a shallow one "
        f"{per_shallow}, a classifier forward + backward {per_clf})")
    if launches != want:
        raise AssertionError(f"launch counts {launches} != {want}")
    check_tensor_core_launches("the preset", pools * n_clf, pools * n_clf)
    check_conv_tensor_core_launches("the preset", thin_full * n_full + thin_shallow * n_shallow + thin_clf * n_clf)
    images = np.load(out["path"])["arr_0"]
    if images.shape != (8, 256, 256, 3) or images.dtype != np.uint8 or not all(images[i].std() > 0 for i in range(8)):
        raise AssertionError(f"preset samples {images.shape} {images.dtype}: not 8 non-constant uint8 images")
    chain = sum(out["chain_seconds"])
    log(f"  preset chain (int8, deep_cache 5, guidance_cache 2, guidance_interval 200,800; batch 8, {steps} "
        f"steps): {chain:.3f} s, {8 * 60 / chain:.3f} samples/min, {1000 * chain / steps:.2f} ms a step; "
        f"main() {wall:.1f} s with model building and loading")
    return tensor_core_split(launches), images, chain


def phase7_tools():
    """The two tool entry points, called as their ``main()`` on the card: the
    paths that launch K6 and K7. Returns the kernels' launch counts."""
    from guided_diffusion_clip_tpu_torch.tools import conv_bench, mxu_ceiling

    os.environ["PCB_SHAPES"] = "8x256x256x256,8x32x512x512"
    for name in ("PCB_ONLY", "CMB_ITERS", "MXU_REPS"):  # the tools' defaults: 20 calls a timing, best of 3
        os.environ.pop(name, None)
    reset_counters()
    rows = conv_bench.main([])
    ceiling = mxu_ceiling.main([])
    launches = counters()
    if len(rows) != 2 or not all(isinstance(r.get(k), float) and r[k] > 0 for r in rows
                                 for k in ("cudnn_bf16", "k5_int8", "k6_bf16", "k6_int8")):
        raise AssertionError(f"conv_bench rows: {rows}")
    if not all(ceiling[k]["tf_per_sec_slope"] > 0 for k in ("s8", "bf16")):
        raise AssertionError(f"mxu_ceiling: {ceiling}")
    # per shape and K6 mode 1 warm-up call and 3 timings of 20 calls;
    # per type and T 1 warm-up call and 3 timings
    want = {**dict.fromkeys(launches, 0), "conv_fused": 2 * 2 * 61, "conv_s8": 2 * 61, "quantize": 2 * 61,
            "mma_probe": 2 * 2 * 4}
    log(f"  kernel launches {launches} (expected {want})")
    if launches != want:
        raise AssertionError(f"launch counts {launches} != {want}")
    check_conv_tensor_core_launches("conv_bench", 0)
    return tensor_core_split(launches)


def _kernel_group(name: str) -> str:
    if "attention_fwd_" in name:
        return "K1 attention"
    if "attention_bwd_" in name:
        return "K2 attention backward"
    if "gn_fused_kernel" in name:  # <T, Q, VEC, SILU, QUANT>, demangled or mangled
        args = re.search(r"gn_fused_kernel<([^>]*)>", name)
        quant = (args.group(1).split(",")[-1].strip() == "true" if args
                 else re.search(r"gn_fused_kernelI\w*?Lb[01]ELb1EE", name) is not None)
        return "K4 quantizing GroupNorm" if quant else "K3 GroupNorm"
    if "conv_s8_" in name:
        return "K5 s8 conv"
    if "absmax_kernel" in name or "quantize_kernel" in name:
        return "int8_conv's quantize kernels"
    if any(k in name for k in ("implicit_gemm", "dgrad", "wgrad", "conv", "cudnn")):
        return "cuDNN convs"
    if "gemm" in name or "cutlass" in name:
        return "cuBLAS matmuls"
    if "at::native" in name:
        return "PyTorch ops (elementwise, reductions, pools, copies)"
    if "nccl" in name.lower():
        return "NCCL"
    return "other"


def profile_guided_step(dev, paths, conv_impl="auto"):
    """One guided ancestral step at batch 8: CUDA-event times of its parts,
    and torch.profiler device time by kernel group for the UNet forward, the
    classifier forward and the classifier backward (cond_fn less the
    forward); returns (the parts' ms by CUDA events, their device ms by the
    profiler)."""
    import torch

    from guided_diffusion_clip_tpu_torch import classifier_sample
    from guided_diffusion_clip_tpu_torch.diffusion import sampling as S
    from guided_diffusion_clip_tpu_torch.diffusion.guidance import classifier_cond_fn
    from guided_diffusion_clip_tpu_torch.utils.checkpoint import load_model_weights
    from guided_diffusion_clip_tpu_torch.utils.profiling import kernel_times
    from guided_diffusion_clip_tpu_torch.utils.script_util import (
        args_to_dict, create_classifier, create_gaussian_diffusion, create_upstream_model,
    )

    args = classifier_sample.create_argparser().parse_args(GUIDED_FLAGS)
    model = create_upstream_model(**args_to_dict(args, classifier_sample._UNET_KEYS), conv_impl=conv_impl)
    model = load_model_weights(model, paths["model"]).to(dev).eval().requires_grad_(False)
    clf = create_classifier(**args_to_dict(args, classifier_sample.classifier_defaults().keys()),
                            conv_impl=conv_impl)
    clf = load_model_weights(clf, paths["classifier"]).to(dev).eval().requires_grad_(False)
    diffusion = create_gaussian_diffusion(steps=1000, learn_sigma=True, timestep_respacing="250")
    sched = diffusion.sched.to(dev)
    cfg = S.SamplerConfig(mean_type=diffusion.mean_type, var_type=diffusion.var_type)
    cond = classifier_cond_fn(clf, 1.0)
    g = torch.Generator(device=dev).manual_seed(6)
    x = torch.randn(8, 3, 256, 256, generator=g, device=dev)
    y = torch.randint(0, 1000, (8,), generator=g, device=dev)
    t = torch.full((8,), 125, dtype=torch.long, device=dev)
    tm = sched.model_timesteps(t)

    def unet_fwd():
        with torch.no_grad():
            model(x, tm, y=y)

    def clf_fwd():  # with grad on, as inside cond_fn
        with torch.enable_grad():
            clf(x.detach().requires_grad_(True), tm)

    def clf_fwd_bwd():
        with torch.no_grad():
            cond(x, tm, y=y)

    def step():
        with torch.no_grad():
            S.p_sample_step(sched, model, x, t, g, cfg=cfg, cond_fn=cond, model_kwargs={"y": y})

    parts = {name: cuda_ms(fn, runs=5, warmup=1) for name, fn in (
        ("UNet forward", unet_fwd), ("classifier forward", clf_fwd),
        ("classifier forward + backward", clf_fwd_bwd), ("guided step", step))}
    parts["classifier backward"] = parts["classifier forward + backward"] - parts["classifier forward"]
    log("  CUDA events, ms: " + ", ".join(f"{k} {v:.2f}" for k, v in parts.items()))

    prof = {"UNet forward": kernel_times(unet_fwd), "classifier forward": kernel_times(clf_fwd)}
    both, fwd = kernel_times(clf_fwd_bwd), prof["classifier forward"]
    prof["classifier backward"] = {
        k: (ms - fwd.get(k, (0, 0))[0], n - fwd.get(k, (0, 0))[1]) for k, (ms, n) in both.items()
    }
    busy = sum(ms for ms, _ in kernel_times(step).values())
    device = {"UNet forward": sum(ms for ms, _ in prof["UNet forward"].values()),
              "classifier forward": sum(ms for ms, _ in fwd.values()),
              "classifier forward + backward": sum(ms for ms, _ in both.values()), "guided step": busy}
    log(f"  profiler: device busy {busy:.2f} ms of the {parts['guided step']:.2f} ms step "
        f"(idle {100 * (1 - busy / parts['guided step']):.0f} %)")
    for part, kernels in prof.items():
        groups: dict = {}
        for k, (ms, n) in kernels.items():
            grp = groups.setdefault(_kernel_group(k), [0.0, 0.0])
            grp[0] += ms
            grp[1] += n
        total = sum(ms for ms, _ in groups.values())
        log(f"  {part}: device {total:.2f} ms; " + "; ".join(
            f"{k} {ms:.2f} ms ({n:.0f} launches)" for k, (ms, n) in sorted(groups.items(), key=lambda kv: -kv[1][0])))
    log("  classifier backward, top kernels (ms, launches):")
    for k, (ms, n) in sorted(prof["classifier backward"].items(), key=lambda kv: -kv[1][0])[:12]:
        log(f"    {ms:8.3f} x{n:<5.0f} {k[:110]}")
    return parts, device


# ---------------------------------------------------------------------------
# Phase 8: one-GPU training of the fork's recipe (configs/config.yaml: the
# CLIP-conditioned UNet at 128 px, 64 channels, mult (1,1,2,3,4), attention at
# 16 and 8 px with one head, learned sigma, bf16 torso, batch 48)
# ---------------------------------------------------------------------------

TRAIN_BATCH = 48  # the recipe's batch_size
TRAIN_ATTN_SHAPES = [(48, 256, 1, 192), (48, 64, 1, 256)]  # (B, T, heads, d) of its attention at 16 and 8 px


def recipe_args(**over):
    """configs/config.yaml as ``image_train`` reads it (the file's keys over
    the flags' defaults), then ``over``."""
    from guided_diffusion_clip_tpu_torch import image_train
    from guided_diffusion_clip_tpu_torch.utils.script_util import parse_yaml

    root = os.path.dirname(os.path.abspath(__file__))
    args = parse_yaml(image_train.create_argparser().parse_args(
        ["--config-file", os.path.join(root, "configs", "config.yaml")]))
    for k, v in over.items():
        setattr(args, k, v)
    return args


def recipe_model(sr=False, **over):
    """(args, model, diffusion) of the recipe; with ``sr`` the SR-delta model
    at its widths (``sr_create_model_and_diffusion``, large_size its
    image_size: x ++ img2, the CLIP delta as its label)."""
    from guided_diffusion_clip_tpu_torch.utils.script_util import (
        args_to_dict, create_model_and_diffusion, model_and_diffusion_defaults, sr_create_model_and_diffusion,
        sr_model_and_diffusion_defaults,
    )

    args = recipe_args(**over)
    if sr:
        kw = {k: getattr(args, k, v) for k, v in sr_model_and_diffusion_defaults().items()}
        return args, *sr_create_model_and_diffusion(**dict(kw, large_size=args.image_size),
                                                    conv_impl=args.train_conv_impl)
    return args, *create_model_and_diffusion(**args_to_dict(args, model_and_diffusion_defaults().keys()),
                                             conv_impl=args.train_conv_impl)


def recipe_loop(dev, sd, batch_size, tmp, **over):
    """A ``TrainLoop`` of the recipe on ``dev`` with the weights ``sd``, logging to ``tmp``."""
    from guided_diffusion_clip_tpu_torch.training.train_loop import TrainLoop
    from guided_diffusion_clip_tpu_torch.utils import logger

    args, model, diffusion = recipe_model(**over)
    model.load_state_dict(sd, strict=True)
    logger.configure_dir(tmp, format_strs=[])
    return TrainLoop(model=model.to(dev), diffusion=diffusion, data=None, batch_size=batch_size, microbatch=-1,
                     lr=args.lr, ema_rate=args.ema_rate, log_interval=10**9, save_interval=10**9,
                     weight_decay=args.weight_decay, tensor_shard=args.tensor_shard)


def recipe_batch(n, seed=0):
    """A host batch as ``load_data`` yields one for a CLIP dict: NCHW images
    in [-1, 1], clip_feat, and the pair img2 / clip_feat2."""
    import numpy as np

    rs = np.random.RandomState(seed)
    x = rs.uniform(-1, 1, (n, 3, 128, 128)).astype(np.float32)
    feat = rs.standard_normal((n, 512)).astype(np.float32)
    return x, {"clip_feat": feat, "img2": np.roll(x, 1, axis=0), "clip_feat2": np.roll(feat, 1, axis=0)}


def train_counts(model, remat: bool) -> dict:
    """K1, K2 and K3 launches of one train step (one microbatch) of a UNetModel,
    from its modules: every attention block runs K1 in the forward and K2 in
    the backward, every GroupNorm K3; under ``use_checkpoint`` the backward
    recomputes each ResBlock and AttentionBlock, so their K1 and K3 launch
    twice (the output head's GroupNorm is in no block). Under int8 (no
    ``use_checkpoint``) the forward's K3, K4, K5 and quantize launches are
    ``gn_conv_counts``'s; the backward launches none of them (straight-through
    convs on cuDNN, the GroupNorm backward in PyTorch ops)."""
    from guided_diffusion_clip_tpu_torch.models.nn import GroupNorm32
    from guided_diffusion_clip_tpu_torch.models.unet import AttentionBlock, ResBlock

    blocks = [m for m in model.modules() if isinstance(m, (ResBlock, AttentionBlock))]
    attn = sum(isinstance(m, AttentionBlock) for m in blocks)
    if model.int8:
        assert not remat, "the smoke trains int8 without use_checkpoint"
        return {"attention": attn, "attention_bwd": attn, **gn_conv_counts(model, True)}
    gn = sum(isinstance(m, GroupNorm32) for m in model.modules())
    gn_blocks = sum(isinstance(m, GroupNorm32) for b in blocks for m in b.modules())
    return {"attention": attn * (1 + remat), "attention_bwd": attn, "group_norm": gn + remat * gn_blocks}


def phase8a_attention(dev) -> None:
    """K1 and K2 at the recipe's shapes (batch 48, one head, d = 192 at T = 256
    and d = 256 at T = 64) against their plain versions, f32 (TF32 off) and
    bf16 (as the training path runs them), all on the tensor-core kernels, the
    same bits on a repeat, with the library call and the bound beside each,
    and the FMA kernels' time on the same input. In bf16 also: K1
    with 32 and with 64 query rows a block through its C entry point, and both
    kernels held to the float64 result beside the FMA kernels (``held_to_f64``)."""
    import torch
    import torch.nn.functional as F

    from guided_diffusion_clip_tpu_torch.ops import attention as A
    from guided_diffusion_clip_tpu_torch.ops import build

    tf32_off()
    g = torch.Generator(device=dev).manual_seed(8)
    for B, T, H, d in TRAIN_ATTN_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            qkv = torch.randn(B, T, 3 * H * d, generator=g, device=dev).to(dtype)
            do = torch.randn(B, T, H * d, generator=g, device=dev).to(dtype)
            q, k, v = (t.permute(0, 2, 1, 3).detach().requires_grad_(True) for t in A.split_qkv(qkv, H, False))
            with torch.enable_grad():
                o = F.scaled_dot_product_attention(q, k, v)
            dob = do.reshape(B, T, H, d).permute(0, 2, 1, 3)
            for name, fn, kernel, plain, library, fma, bound in (
                ("K1 attention", A.attention_fwd_cuda, lambda: A.attention_fwd_cuda(qkv, H),
                 lambda: A.qkv_attention_plain(qkv, H),
                 lambda: F.scaled_dot_product_attention(q.detach(), k.detach(), v.detach()),
                 lambda: fma_attention(qkv, H, False), attention_bound(B, T, H, d, False, dtype == torch.float32)),
                ("K2 attention_bwd", A.attention_bwd_cuda, lambda: A.attention_bwd_cuda(qkv, do, H),
                 lambda: A.qkv_attention_bwd_plain(qkv, do, H, False),
                 lambda: torch.autograd.grad(o, (q, k, v), dob, retain_graph=True),
                 lambda: fma_attention(qkv, H, False, do), attention_bound(B, T, H, d, True, dtype == torch.float32)),
            ):
                label = f"{name} B={B} T={T} heads={H} d={d} {str(dtype)[6:]}"
                n_mma, n_f32 = fn.launches_mma, fn.launches_f32
                out, ref = kernel(), plain()
                torch.cuda.synchronize()
                check_attention_launch(label, fn, dtype, n_mma, n_f32)
                diff = (out.float() - ref.float()).abs()
                if dtype == torch.float32 and name.startswith("K1"):
                    tol, ok = "max|d| <= 1e-4", bool(diff.max() <= 1e-4)
                else:
                    rtol = 1e-4 if dtype == torch.float32 else 2e-2
                    tol, ok = f"|d| <= {rtol:g}*max(1,|ref|)", bool((diff <= rtol * ref.float().abs().clamp(min=1.0)).all())
                if not torch.isfinite(out.float()).all() or not ok:
                    raise AssertionError(f"{label}: max|d| {diff.max().item():.3g} fails {tol}")
                if not torch.equal(kernel(), out):
                    raise AssertionError(f"{label}: a repeat run gave other bits")
                ms, pms, lib = cuda_ms(kernel), cuda_ms(plain), cuda_ms(library)
                rec = record(diff.max().item(), ms, pms, **bound, library_ms=lib)
                log(f"  {label}: max|d| {rec['max_abs_err']:.3g} ({tol}), repeat bit-identical; kernel {ms:.4f} ms "
                    f"(mma.sync{' TF32 x3' if dtype == torch.float32 else ''}), plain {pms:.4f} ms, library "
                    f"{lib:.4f} ms, bound {rec['bound_ms']:.4f} ms ({rec['bound_by']}), {ms / rec['bound_ms']:.1f}x "
                    f"the bound")
                fma_out, fma_ms = fma(), cuda_ms(fma)
                line = f"    the FMA kernel on the same input {fma_ms:.4f} ms ({fma_ms / ms:.2f}x the tensor-core kernel)"
                if dtype == torch.float32:
                    log(line)
                    continue
                if name.startswith("K1"):
                    lib_c, stream, scale = build.load(), torch.cuda.current_stream(dev).cuda_stream, 1 / math.sqrt(math.sqrt(d))

                    def rows(n):
                        res = torch.empty(B, T, H * d, dtype=dtype, device=dev)
                        build.check(lib_c.gdc_attention_fwd_mma(qkv.data_ptr(), res.data_ptr(), B, T, H, d, 0, n,
                                                                scale, stream), "gdc_attention_fwd_mma")
                        return res

                    picked = A.fwd_q_rows(T, B * H, d, torch.cuda.get_device_properties(dev).multi_processor_count)
                    line += (f"; through the C entry point, 32 query rows a block {cuda_ms(lambda: rows(32)):.4f} ms, "
                             f"64 rows {cuda_ms(lambda: rows(64)):.4f} ms (fwd_q_rows picks {picked}; "
                             f"{math.ceil(T / 32) * B * H} and {math.ceil(T / 64) * B * H} blocks)")
                    ref64 = attention_fwd_f64(qkv, H, False)
                else:
                    ref64 = attention_bwd_f64(qkv, do, H, False)
                log(line)
                held_to_f64(label, out, fma_out, ref64)


# The bf16-torso step, card against CPU (both bf16), in relative L2 (step_errors). Readings on an H100
# (the card's step is deterministic; the CPU's is oneDNN's): loss 3.5e-7, grad_norm 2.8e-5, updated
# params 1.0e-5, gradient 6.3e-4, attention qkv/norm 6.1e-3, proj_out 5.6e-3, GroupNorms 4.2e-4; the
# control, the CPU's bf16 step against its f32 step: 1.2e-6, 2.2e-4, 1.6e-3, 2.0e-3, 8.6e-3, 8.1e-3,
# 2.1e-3. Faults injected on the card only gave: K2's output x 1.01, qkv/norm 1.1e-2; K1's x 1.05,
# proj_out 1.5e-2; K3's saved rstd x 1.002, grad_norm 9.0e-4, gradient 2.2e-3, GroupNorms 2.1e-3.
TRAIN_BF16_TOL = {"loss": 1e-5, "grad_norm": 1e-4, "updated params": 5e-5, "gradient": 1.5e-3,
                  "gradient, attention qkv, norm": 1e-2, "gradient, attention proj_out": 1e-2,
                  "gradient, GroupNorms": 1e-3}


def train_step_on(d, sd, x, cond, noise, tmp, forcing=None, **over) -> dict:
    """One ``run_step`` of the recipe (dropout 0) on device ``d`` from the
    weights ``sd``: its metrics, the updated parameters and the summed
    gradient (Adam's first moment after one update is 0.1 x the gradient), on
    the host, the parameters' ``param_groups``, and the step's seconds (the
    first, with its set-up). With an ``Int8Forcing``, the step's roundings
    are recorded on the CPU and forced on the card."""
    loop = recipe_loop(d, sd, len(x), tmp, dropout=0.0, **over)
    t0 = time.perf_counter()
    if forcing is None:
        loop.run_step(x, cond, noise=noise)
    else:
        with forcing.record(loop.model) if d.type == "cpu" else forcing.force(loop.model):
            loop.run_step(x, cond, noise=noise)
    met = loop._fetch(loop._pending_log[2])
    secs = time.perf_counter() - t0
    return {"met": met, "params": {n: p.detach().cpu() for n, p in zip(loop.names, loop.params)},
            "grad": {n: 10 * loop.opt.state[p]["exp_avg"].cpu() for n, p in zip(loop.names, loop.params)},
            "groups": param_groups(loop.model), "secs": secs}


def param_groups(model) -> dict:
    """The names of ``model``'s parameters in three groups: the attention
    blocks' qkv and norm, which K2's gradient reaches first; their
    proj_out, which K1's output reaches; the GroupNorms (K3)."""
    from guided_diffusion_clip_tpu_torch.models.nn import GroupNorm32
    from guided_diffusion_clip_tpu_torch.models.unet import AttentionBlock

    groups: dict = {"attention qkv, norm": set(), "attention proj_out": set(), "GroupNorms": set()}
    for m, mod in model.named_modules():
        parts = ((("qkv", "attention qkv, norm"), ("norm", "attention qkv, norm"), ("proj_out", "attention proj_out"))
                 if isinstance(mod, AttentionBlock) else (("", "GroupNorms"),) if isinstance(mod, GroupNorm32) else ())
        for part, label in parts:
            sub = getattr(mod, part) if part else mod
            groups[label].update(".".join(filter(None, (m, part, n))) for n, _ in sub.named_parameters())
    return groups


def step_errors(a: dict, b: dict) -> dict:
    """How far step ``a`` is from step ``b``: loss and grad_norm relative; the
    updated parameters and the gradient in relative L2 over all parameters;
    and the gradient over each of ``train_step_on``'s groups of parameters
    (K1, K2 and K3 reach these first, and they hold a small share of the
    whole gradient), each in relative L2."""
    def rel(x, y, names):
        return (sum(float((x[k] - y[k]).double().square().sum()) for k in names)
                / sum(float(y[k].double().square().sum()) for k in names)) ** 0.5

    return {"loss": abs(float(a["met"]["loss"]) / float(b["met"]["loss"]) - 1),
            "grad_norm": abs(float(a["met"]["grad_norm"]) / float(b["met"]["grad_norm"]) - 1),
            "updated params": rel(a["params"], b["params"], b["params"]),
            "gradient": rel(a["grad"], b["grad"], b["grad"]),
            **{f"gradient, {g}": rel(a["grad"], b["grad"], names) for g, names in b["groups"].items()}}


def phase8b_train_step(dev, tmp):
    """One train step of the full-width recipe (dropout 0, batch 4) on the CPU
    and on the card from the same weights, batch, t and noise, twice: in f32
    with TF32 off, where loss, grad_norm, the updated parameters and the
    gradient agree within 1e-3 relative L2; and with the recipe's bf16 torso
    (f32 parameters, bf16 activations, K1/K2/K3 in bf16 under autograd),
    held to ``TRAIN_BF16_TOL``, beside the control: the CPU's bf16 step
    against its f32 step."""
    import torch

    tf32_off()
    sd = random_state_dict(recipe_model(use_fp16=False)[1])
    x, cond = recipe_batch(4, seed=1)
    noise = torch.randn(4, 3, 128, 128, generator=torch.Generator().manual_seed(3))
    steps = {(fp16, d.type): train_step_on(d, sd, x, cond, noise, os.path.join(tmp, f"step_{fp16}_{d.type}"),
                                           use_fp16=fp16)
             for fp16 in (False, True) for d in (torch.device("cpu"), dev)}
    ref = steps[False, "cpu"]

    def show(errs):
        return ", ".join(f"{k} {v:.3g}" for k, v in errs.items())

    f32 = step_errors(steps[False, "cuda"], ref)
    log(f"  train step (4, 3, 128, 128) f32: loss {float(ref['met']['loss']):.6g}, grad_norm "
        f"{float(ref['met']['grad_norm']):.6g} (CPU); card vs CPU: {show(f32)} (bound 1e-3); CPU step {ref['secs']:.2f} s, card step {steps[False, 'cuda']['secs']:.2f} s (first, with set-up)")
    bad = {k: v for k, v in f32.items() if not v <= 1e-3}
    if bad or not float(ref["met"]["loss"]) > 0:
        raise AssertionError(f"card train step (f32) differs from the CPU's: {bad}")

    bf16 = step_errors(steps[True, "cuda"], steps[True, "cpu"])
    control = step_errors(steps[True, "cpu"], ref)
    log(f"  train step bf16 torso: card vs CPU (both bf16): {show(bf16)}; control, CPU bf16 vs CPU f32: "
        f"{show(control)}; bound {TRAIN_BF16_TOL}; CPU step {steps[True, 'cpu']['secs']:.2f} s, card step "
        f"{steps[True, 'cuda']['secs']:.2f} s")
    bad = {k: bf16[k] for k, tol in TRAIN_BF16_TOL.items() if not bf16[k] <= tol}
    if bad or not math.isfinite(float(steps[True, "cuda"]["met"]["loss"])):
        raise AssertionError(f"card train step (bf16 torso) differs from the CPU's: {bad}")


def train_folder(tmp):
    """64 generated 128 px PNGs and their CLIP dict (.pt, one embedding a
    flip): (folder, dict path)."""
    import numpy as np
    import torch
    from PIL import Image

    data = os.path.join(tmp, "images")
    os.makedirs(data)
    rs = np.random.RandomState(4)
    clip = {}
    for i in range(64):
        name = f"{i:05d}.png"
        Image.fromarray(rs.randint(0, 256, (128, 128, 3), dtype=np.uint8)).save(os.path.join(data, name))
        clip[name] = torch.from_numpy(rs.standard_normal((2, 512)).astype(np.float32))
    clip_path = os.path.join(tmp, "clip_dict.pt")
    torch.save(clip, clip_path)
    return data, clip_path


def train_config(tmp, name, data, clip_path, main_path, **over) -> str:
    """configs/config.yaml with save_interval 10, log_interval 5, the folder
    as both training and test set and ``main_path``, then ``over``, written to
    ``tmp`` (a config file's keys win over the command line's)."""
    import yaml

    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)), "configs", "config.yaml")) as f:
        cfg = yaml.safe_load(f)
    cfg.update(save_interval=10, log_interval=5, data_dir=data, clip_file_path=clip_path, data_dir_test=data,
               clip_file_path_test=clip_path, main_path=main_path)
    cfg.update(over)
    path = os.path.join(tmp, f"{name}.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return path


def phase8c_cli(dev, tmp):
    """``python -m guided_diffusion_clip_tpu_torch.image_train --config-file``
    on 64 generated 128 px PNGs and a .pt CLIP dict: configs/config.yaml with
    save_interval 10 and log_interval 5 and the paths pointed here, stopped by
    DIFFUSION_TRAINING_TEST=1 after the save at step 10; then resumed from
    model000010.pt for 2 more steps. The throughput of the entry point, its
    loader included, is the 5 steps between the log rows of steps 5 and 10
    (each row is printed after its step's metrics came back, so the card has
    finished that step), timed by the arrival of the rows on the child's
    stdout; ``progress.csv``'s ``wait_data`` and ``wait_step`` split them
    into the time the loop waited for the loader and the time in
    ``run_step``. The resume runs with ``--profile_dir``, whose trace must
    hold the ``train_step`` scope. Returns the first run's directory.

    ``GDC_NATIVE_LOADER=1`` is not run: ``native/gdc_loader.cpp`` compiles
    only where libjpeg's and libpng's headers are installed, which a card's
    host need not have; the CPU tests hold the native loader's batches to
    the Python loader's bit for bit."""
    import csv
    import math

    import torch

    from guided_diffusion_clip_tpu_torch.utils.checkpoint import load_model_weights, load_state_dict

    root = os.path.dirname(os.path.abspath(__file__))
    data, clip_path = train_folder(tmp)
    runs = os.path.join(tmp, "runs")
    # respaced so that the save's two validation chains are VAL_STEPS steps each, not 1000
    cfg_path = train_config(tmp, "config", data, clip_path, runs, timestep_respacing=str(VAL_STEPS))

    def run(argv, env):
        """Run image_train: (seconds, {step: seconds from the start to its log row})."""
        env = {**{k: v for k, v in os.environ.items() if k not in ("DIFFUSION_TRAINING_TEST", "DIFFUSION_BLOB_LOGDIR")},
               "OPENAI_LOG_FORMAT": "stdout,log,csv", "PYTHONUNBUFFERED": "1", **env}
        rows, lines = {}, []
        t0 = time.perf_counter()
        with tempfile.TemporaryFile("w+") as err:
            proc = subprocess.Popen([sys.executable, "-m", "guided_diffusion_clip_tpu_torch.image_train",
                                     "--config-file", cfg_path, *argv], stdout=subprocess.PIPE, stderr=err,
                                    text=True, cwd=root, env=env)
            watchdog = threading.Timer(600, proc.kill)
            watchdog.start()
            try:
                for line in proc.stdout:
                    lines.append(line)
                    found = re.match(r"\| step +\| (\d+) ", line)
                    if found:
                        rows[int(found.group(1))] = time.perf_counter() - t0
                proc.wait()
            finally:
                watchdog.cancel()
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
            if proc.returncode != 0:
                err.seek(0)
                raise AssertionError(f"image_train exited {proc.returncode}:\n{''.join(lines)[-3000:]}\n"
                                     f"{err.read()[-3000:]}")
        return time.perf_counter() - t0, rows

    secs, row_at = run([], {"DIFFUSION_TRAINING_TEST": "1"})
    (first,) = os.listdir(runs)
    run_dir = os.path.join(runs, first)
    files = set(os.listdir(run_dir))
    want = {"model000010.pt", "ema_0.9999_000010.pt", "opt000010.pt", "progress.csv", "log.txt",
            "val_samples_0_000010.png", "val_samples_1_000010.png"}
    if not want <= files:
        raise AssertionError(f"run directory {run_dir} lacks {sorted(want - files)}")
    with open(os.path.join(run_dir, "progress.csv")) as f:
        rows = list(csv.DictReader(f))
    losses = [float(r["loss"]) for r in rows]
    if [int(r["step"]) for r in rows] != [0, 5, 10] or not all(math.isfinite(v) and v > 0 for v in losses):
        raise AssertionError(f"progress.csv: steps {[r['step'] for r in rows]}, losses {losses}")
    sampler = recipe_model()[1]
    load_model_weights(sampler, os.path.join(run_dir, "model000010.pt"))
    log(f"  image_train --config-file (batch 48, 128 px, save at step 10 with two {VAL_STEPS}-step validation chains "
        f"of 8): "
        f"{secs:.1f} s; {run_dir}: {', '.join(sorted(files))}; progress.csv losses {losses}; model000010.pt "
        f"loads strict=True into the sampler model (bf16 torso)")
    if sorted(row_at) != [0, 5, 10]:
        raise AssertionError(f"log rows on stdout for steps {sorted(row_at)}, want [0, 5, 10]")
    span = row_at[10] - row_at[5]
    wait_data, wait_step = float(rows[2]["wait_data"]), float(rows[2]["wait_step"])
    log(f"  image_train throughput, steps 6-10 (between the log rows of steps 5 and 10, loader included): "
        f"{1e3 * span / 5:.2f} ms a step, {5 * TRAIN_BATCH / span:.1f} samples/s; per step the loop waited "
        f"{1e3 * wait_data / 5:.2f} ms for the loader and spent {1e3 * wait_step / 5:.2f} ms in run_step "
        f"(progress.csv wait_data, wait_step)")

    # the resume, traced (--profile_dir: its steps 1 to 3, here the last of its 2)
    prof_dir = os.path.join(tmp, "profile")
    secs, _ = run(["--resume_checkpoint", os.path.join(run_dir, "model000010.pt"), "--lr_anneal_steps", "12",
                   "--profile_dir", prof_dir], {})
    (second,) = set(os.listdir(runs)) - {first}
    res_dir = os.path.join(runs, second)
    traces = [os.path.join(prof_dir, n) for n in os.listdir(prof_dir) if n.endswith(".pt.trace.json")]
    with open(traces[0]) as f:
        trace = f.read() if len(traces) == 1 else ""
    if '"train_step"' not in trace or '"data"' not in trace:
        raise AssertionError(f"--profile_dir {prof_dir}: {os.listdir(prof_dir)} holds no trace of a train step")
    log(f"  --profile_dir: {os.path.basename(traces[0])}, {len(trace) / 2**20:.1f} MiB, with the train_step and "
        f"data scopes")
    with open(os.path.join(res_dir, "log.txt")) as f:
        text = f.read()
    # step 0 is an update too: the save at step 10 follows 11 of them
    count10, count12 = (torch.load(os.path.join(d, n), map_location="cpu", weights_only=True)["count"]
                        for d, n in ((run_dir, "opt000010.pt"), (res_dir, "opt000012.pt")))
    e10, e12, m10 = (load_state_dict(os.path.join(d, n)) for d, n in (
        (run_dir, "ema_0.9999_000010.pt"), (res_dir, "ema_0.9999_000012.pt"), (run_dir, "model000010.pt")))
    moved = sum(float((e12[k] - e10[k]).double().norm() ** 2) for k in e10) ** 0.5
    apart = sum(float((m10[k] - e10[k]).double().norm() ** 2) for k in e10) ** 0.5
    if "(step 10)" not in text or "loading EMA from checkpoint" not in text or "loading optimizer state" not in text:
        raise AssertionError(f"the resumed run did not restore step 10, the EMA and the optimizer:\n{text[-2000:]}")
    if (count10, count12) != (11, 13) or not moved < 1e-2 * apart:
        raise AssertionError(f"Adam count {count10} at step 10 (want 11), {count12} after the resumed run's 2 steps "
                             f"(want 13); EMA moved {moved:.3g} against {apart:.3g} between the model and its EMA")
    log(f"  resumed from model000010.pt for 2 steps ({secs:.1f} s): resume_step 10, Adam count {count10} -> "
        f"{count12}, |EMA(12) - EMA(10)| {moved:.3g} against |model(10) - EMA(10)| {apart:.3g} (EMA restored)")
    return run_dir


TIMED_STEPS = 5  # the timed steps of 8d, 8e and 12b (10 until PR 20)
# the respaced steps of 8c's and 12b's validation chains at their save (100 until PR 20, 1000 before PR 15)
VAL_STEPS = 25


def time_train_steps(dev, tmp, sd, x, cond, tag, n_steps=TIMED_STEPS, **over) -> dict:
    """``n_steps`` ``run_step`` calls of the recipe (``over`` on top) at batch 48 after 5
    of warm-up (and 2 under ``torch.cuda.set_sync_debug_mode("error")``: no
    step waits for the card), the kernels' launches of those ``n_steps`` against
    ``train_counts`` (every K1/K2 launch on the tensor cores; under int8 every
    K5 launch but the stem's and the head's too), ms a step (median, CUDA
    events) and its split into forward, backward and optimizer + EMA,
    samples/s, peak memory and the profiler's device time by kernel group.
    Returns {"launches": the ``n_steps`` steps' counts, "step_ms", "parts", "busy_ms",
    "peak_gib"}."""
    import torch

    from guided_diffusion_clip_tpu_torch.utils.profiling import kernel_times

    loop = recipe_loop(dev, sd, TRAIN_BATCH, os.path.join(tmp, f"time_{tag}".replace(" ", "_")), **over)
    remat = bool(over.get("use_checkpoint"))
    for _ in range(5):
        loop.run_step(x, cond)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(2):
            loop.run_step(x, cond)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counters()
    steps = []
    for _ in range(n_steps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        loop.run_step(x, cond)
        end.record()
        end.synchronize()
        steps.append(start.elapsed_time(end))
    counts = counters()
    split = tensor_core_split(counts)
    peak = torch.cuda.max_memory_allocated() / 2**30
    per_step = train_counts(loop.model, remat)
    want = {k: n_steps * v for k, v in per_step.items()}
    got = {k: counts[k] for k in want}
    if got != want or any(v for k, v in counts.items() if k not in want):
        raise AssertionError(f"{tag}: launches {counts} over {n_steps} steps, want {want} and no other kernel")
    if split["attention_f32"] or split["attention_bwd_f32"]:
        raise AssertionError(f"{tag}: K1/K2 at d = 192 and 256 ran on float32 input: {split}")
    if loop.model.int8:
        check_conv_tensor_core_launches(tag, n_steps * thin_convs(loop.model))
    loop.flush_metrics()

    # forward, backward and optimizer + EMA of the same step, by events between them
    xb, cb = loop._upload(x).float(), {k: loop._upload(v) for k, v in cond.items()}
    parts = {"forward": [], "backward": [], "optimizer + EMA": []}
    for _ in range(n_steps):
        t_np, w_np = loop.schedule_sampler.sample(TRAIN_BATCH, loop.np_rng)
        t, w = loop._upload(t_np).long(), loop._upload(w_np)
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        loop.opt.zero_grad(set_to_none=True)
        ev[0].record()
        loss, _ = loop.micro_loss(xb, cb, t, w)
        ev[1].record()
        loss.backward()
        ev[2].record()
        loop.update()
        ev[3].record()
        ev[3].synchronize()
        for (k, lst), a, b in zip(parts.items(), ev, ev[1:]):
            lst.append(a.elapsed_time(b))
    med = {k: sorted(v)[len(v) // 2] for k, v in parts.items()}
    step_ms = sorted(steps)[len(steps) // 2]

    prof = kernel_times(lambda: loop.run_step(x, cond))
    loop.flush_metrics()
    busy = sum(ms for ms, _ in prof.values())
    groups: dict = {}
    for k, (ms, n) in prof.items():
        grp = groups.setdefault(_kernel_group(k), [0.0, 0.0])
        grp[0] += ms
        grp[1] += n
    log(f"  {tag}, batch {TRAIN_BATCH}, bf16 torso, f32 parameters, fused AdamW (either opt_impl): step {step_ms:.2f} ms "
        f"(median of {n_steps}, CUDA events; range {min(steps):.2f}-{max(steps):.2f}), {1e3 * TRAIN_BATCH / step_ms:.1f} "
        f"samples/s; forward {med['forward']:.2f}, backward {med['backward']:.2f}, optimizer + EMA "
        f"{med['optimizer + EMA']:.2f} ms; peak memory {peak:.2f} GiB")
    log(f"  {tag}: launches a step {per_step} (from the modules; {n_steps} steps counted {got}); no host sync in 2 steps "
        f"under set_sync_debug_mode('error')")
    log(f"  {tag}, profiler: device busy {busy:.2f} ms of the {step_ms:.2f} ms step "
        f"({100 * busy / step_ms:.0f} %); " + "; ".join(
            f"{k} {ms:.2f} ms ({n:.0f})" for k, (ms, n) in sorted(groups.items(), key=lambda kv: -kv[1][0])))
    log(f"  {tag}, top kernels (ms, launches):")
    for k, (ms, n) in sorted(prof.items(), key=lambda kv: -kv[1][0])[:10]:
        log(f"    {ms:8.3f} x{n:<5.0f} {k[:110]}")
    del loop
    torch.cuda.empty_cache()
    return {"launches": split, "step_ms": step_ms, "parts": med, "busy_ms": busy, "peak_gib": peak}


def phase8d_time(dev, tmp):
    """The recipe at batch 48 in bf16, without and with ``use_checkpoint``
    (``time_train_steps``). Returns the launch counts of the timed steps."""
    import torch

    # torch's defaults, as image_train runs: no TF32 in matmuls, TF32 in cuDNN's f32 convs
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = True
    sd = random_state_dict(recipe_model()[1])
    x, cond = recipe_batch(TRAIN_BATCH, seed=2)
    return {remat: time_train_steps(dev, tmp, sd, x, cond, "use_checkpoint" if remat else "plain backward",
                                    use_checkpoint=remat)
            for remat in (False, True)}


# The int8 step (the recipe's bf16 torso, the convs on the int8 path, straight-through convs in bf16 as
# shipped), card against CPU (both int8, teacher-forced), in relative L2 (step_errors). Readings on an H100
# (two calls): loss 1.2e-7, grad_norm 7.6e-6, updated params 4.8e-6, gradient 6.9e-5, attention qkv/norm
# 5.4e-3-5.8e-3, proj_out 4.4e-3-4.5e-3, GroupNorms 4.0e-5; free-running (not forced) 1.9e-6, 4.9e-5,
# 2.2e-5, 7.0e-4, 1.5e-2, 1.4e-2, 9.5e-4; the control, the CPU's bf16 int8 step against its f32 one:
# 2.2e-6, 2.5e-5, 5.2e-4, 1.0e-3, 1.2e-2, 1.1e-2, 1.4e-3. Faults injected on the card only gave: K5's
# prequantized outputs x 1.002, grad_norm 3.3e-5, gradient 1.7e-4, GroupNorms 1.5e-4; x 1.01 fails the
# forcing's own check (an int8_conv output 1.2e-2 off); K2's output x 1.01, qkv/norm 1.09e-2.
INT8_TRAIN_TOL = {"loss": 1e-5, "grad_norm": 2e-5, "updated params": 1e-5, "gradient": 1.2e-4,
                  "gradient, attention qkv, norm": 8e-3, "gradient, attention proj_out": 8e-3,
                  "gradient, GroupNorms": 1e-4}


def int8_step_pair(dev, sd, x, cond, noise, tmp, share=1e-4, **over) -> tuple:
    """One int8 ``run_step`` of the recipe on the CPU, then on the card
    teacher-forced to the CPU's roundings (``Int8Forcing`` with ``share``):
    (CPU step, card step, the forcing's summary), each as ``train_step_on``
    returns it."""
    import torch

    forcing = Int8Forcing(share)
    cpu = train_step_on(torch.device("cpu"), sd, x, cond, noise, os.path.join(tmp, "cpu"), forcing=forcing,
                        train_conv_impl="int8", **over)
    card = train_step_on(dev, sd, x, cond, noise, os.path.join(tmp, "card"), forcing=forcing,
                         train_conv_impl="int8", **over)
    return cpu, card, forcing.summary()


def phase8e_int8_train(dev, tmp) -> dict:
    """``--train_conv_impl int8``: one step of the full-width recipe (dropout
    0, batch 4) on the CPU and on the card, teacher-forced, twice: in f32
    (TF32 off, the straight-through convs in f32) within 1e-3 relative L2, as
    8b's f32 step; with the recipe's bf16 torso and the bf16 straight-through
    convs as shipped within ``INT8_TRAIN_TOL``. Then ``TIMED_STEPS`` timed int8 steps at
    batch 48 (``time_train_steps``). Returns the timed steps' record."""
    import torch

    from guided_diffusion_clip_tpu_torch.ops import quant as Q

    tf32_off()
    sd = random_state_dict(recipe_model(use_fp16=False)[1])
    x, cond = recipe_batch(4, seed=5)
    noise = torch.randn(4, 3, 128, 128, generator=torch.Generator().manual_seed(6))

    def show(errs):
        return ", ".join(f"{k} {v:.3g}" for k, v in errs.items())

    try:
        Q._STE_DTYPE = torch.float32
        cpu, card, forced = int8_step_pair(dev, sd, x, cond, noise, os.path.join(tmp, "f32"), use_fp16=False)
    finally:
        Q._STE_DTYPE = torch.bfloat16
    f32 = step_errors(card, cpu)
    log(f"  int8 train step (4, 3, 128, 128) f32: loss {float(cpu['met']['loss']):.6g}, grad_norm "
        f"{float(cpu['met']['grad_norm']):.6g} (CPU); card vs CPU teacher-forced: {show(f32)} (bound 1e-3); "
        f"{forced}; CPU step {cpu['secs']:.2f} s")
    bad = {k: v for k, v in f32.items() if not v <= 1e-3}
    if bad or not float(cpu["met"]["loss"]) > 0:
        raise AssertionError(f"card int8 train step (f32) differs from the CPU's: {bad}")
    # bf16 activations: K1's bf16 output differs from the plain version's by bf16 roundings (phase 3's bound is
    # 2e-2 * max(1, |ref|)), and the blocks after an attention block see inputs an ulp (2^-8 relative) off in
    # many places, which moves a GroupNorm's q by a level wherever it lies at a rounding boundary: 1.1e-3 of
    # q at 8 px on an H100, against 5.8e-6 over the whole f32 step. Forcing replaces those levels;
    # the step's gradient is then held to INT8_TRAIN_TOL
    cpu, card, forced = int8_step_pair(dev, sd, x, cond, noise, os.path.join(tmp, "bf16"), share=1e-2, use_fp16=True)
    bf16 = step_errors(card, cpu)
    log(f"  int8 train step, bf16 torso and straight-through convs: card vs CPU teacher-forced: {show(bf16)}; "
        f"bound {INT8_TRAIN_TOL}; {forced}; CPU step {cpu['secs']:.2f} s")
    bad = {k: bf16[k] for k, tol in INT8_TRAIN_TOL.items() if not bf16[k] <= tol}
    if bad or not math.isfinite(float(card["met"]["loss"])):
        raise AssertionError(f"card int8 train step (bf16 torso) differs from the CPU's: {bad}")

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = True
    sd = random_state_dict(recipe_model()[1])
    xb, condb = recipe_batch(TRAIN_BATCH, seed=2)
    return time_train_steps(dev, tmp, sd, xb, condb, "int8 (--train_conv_impl int8)", train_conv_impl="int8")


# ---------------------------------------------------------------------------
# Phase 9: sampling the trained recipe through the fork's CLIs
# (configs/image_sample_config.yaml: batch 8, 100 respaced steps)
# ---------------------------------------------------------------------------

# the respaced steps of phase 9's and 9b's chains (the config's 100 until PR 20)
SAMPLE_STEPS = 25
SAMPLE_MODES = [  # (name, flags, the config's keys changed)
    ("bf16", [], {}),
    ("int8", ["--conv_impl", "int8"], {}),
    ("cfg 3, cfg_cache 2", ["--cfg_scale", "3", "--cfg_cache", "2"], {}),
    ("denoise_start_point 800", [], {"denoise_start_point": 800}),
]


def sample_test_set(tmp, n=16):
    """``n`` generated 256 px PNGs (the size of the config's CelebA-HQ test
    set; the loader halves them to 128) and their CLIP dict (.pt, one
    embedding a flip)."""
    import numpy as np
    import torch
    from PIL import Image

    data = os.path.join(tmp, "test_images")
    os.makedirs(data)
    rs = np.random.RandomState(11)
    clip = {}
    for i in range(n):
        name = f"{i:05d}.png"
        Image.fromarray(rs.randint(0, 256, (256, 256, 3), dtype=np.uint8)).save(os.path.join(data, name))
        clip[name] = torch.from_numpy(rs.standard_normal((2, 512)).astype(np.float32))
    clip_path = os.path.join(tmp, "test_clip_dict.pt")
    torch.save(clip, clip_path)
    return data, clip_path


def sample_config(tmp, name, run_dir, data, clip, **over) -> str:
    """configs/image_sample_config.yaml with its paths pointed at ``run_dir``'s
    EMA checkpoint (``main_path``, ``f``, ``load_file``) and the test set, 16
    samples, then ``over``; written to ``tmp`` (a config file's keys win over
    the command line's)."""
    import yaml

    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)), "configs", "image_sample_config.yaml")) as f:
        cfg = yaml.safe_load(f)
    cfg.update(main_path=os.path.dirname(run_dir), f=os.path.basename(run_dir), load_file="ema_0.9999_000010.pt",
               data_dir_test=data, clip_file_path_test=clip, num_samples=16)
    cfg.update(over)
    path = os.path.join(tmp, f"{name}.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return path


def sampling_model(cfg_path, *flags):
    """(args, model, diffusion) as ``image_sample`` builds them from a config file and flags."""
    from guided_diffusion_clip_tpu_torch import image_sample
    from guided_diffusion_clip_tpu_torch.utils.script_util import (
        args_to_dict, create_model_and_diffusion, model_and_diffusion_defaults, parse_yaml,
    )

    args = parse_yaml(image_sample.create_argparser().parse_args(["--config-file", cfg_path, *flags]))
    return args, *create_model_and_diffusion(**args_to_dict(args, model_and_diffusion_defaults().keys()),
                                             conv_impl=args.conv_impl)


def check_samples(path, n) -> "np.ndarray":
    import numpy as np

    images = np.load(path)["arr_0"]
    if images.shape != (n, 128, 128, 3) or images.dtype != np.uint8:
        raise AssertionError(f"{path}: samples {images.shape} {images.dtype}, not ({n}, 128, 128, 3) uint8")
    if not all(images[i].std() > 0 for i in range(n)):
        raise AssertionError(f"{path}: a constant image among the samples")
    return images


# The checkpoint the modes below sample, written beside 8c's: N(0, 0.02) weights (random_state_dict). 8c's EMA of
# 11 steps at rate 0.9999 is the initialization, whose zero output convs make eps 0 whatever the kernels give
RANDOM_CKPT = "ema_random.pt"
# Short DDIM chains of image_sample.make_chain, card against CPU from the same x_T: (name, flags, the config's
# keys changed, batch, bound on the larger of the samples' and the UNet outputs' relative L2). f32 runs with TF32
# off; bf16 is the recipe's torso (K1, K3 on the card; the plain versions on the CPU); int8 is teacher-forced
# (Int8Forcing, 1e-2 of q may flip, as 8e's bf16 step), which holds K4, K5 and the quantize kernels at each call.
# Readings on an H100 (samples, UNet outputs): f32 2.6e-8, 3.8e-6; bf16 3.6e-6, 1.2e-3; int8 8.5e-7, 3.2e-4 (2.6e-5
# of q off by one, worst int8_conv 2.8e-3). Faults injected on the card only gave: bf16, K3's output x 1.01, UNet
# outputs 2.6e-3; K1's x 1.01, 1.2e-3 (the attention blocks' share of the output is below the bf16 torso's
# roundings with N(0, 0.02) weights: phase 3 holds K1 at these shapes); int8, K5's x 1.002 and K1's x 1.01 fail
# the forcing's own check (an int8_conv output 8.4e-3 and 6.4e-3 off).
SAMPLE_CHAINS = [  # the bf16 and int8 chains at batch 4 since PR 20 (8 before; the CPU's 28 s of phase 9)
    ("f32", [], {"use_fp16": False}, 2, 1e-3),
    ("bf16", [], {}, 4, 2e-3),
    ("int8", ["--conv_impl", "int8"], {}, 4, 1e-3),
]


def chain_card_vs_cpu(dev, tmp, run_dir, data, clip, sd, name, flags, over, batch) -> tuple:
    """A 5-step DDIM chain of ``image_sample.make_chain`` from ``sd`` on the
    CPU, then on the card from the same x_T, img2 and conditioning
    (teacher-forced under int8): (the larger of the samples' relative L2 and
    the UNet outputs' worst, |ref|, a line to log)."""
    import torch

    from guided_diffusion_clip_tpu_torch import image_sample

    # 5 of 50 DDIM steps from img2 noised to t = 100 (--denoise_start_point 100): a chain from t = 999 clips
    # every value of x_0 to -1 or 1 at its first step, and its samples are signs that hardly follow eps
    cfg = sample_config(tmp, f"ddim5_{name}", run_dir, data, clip, use_ddim=True, timestep_respacing=50,
                        denoise_start_point=100, **over)
    args, model, diffusion = sampling_model(cfg, *flags)
    model.load_state_dict(sd, strict=True)
    model.eval().requires_grad_(False)
    shape = (batch, 3, model.config.image_size, model.config.image_size)
    g = torch.Generator().manual_seed(12)
    x_T = torch.randn(shape, generator=g)
    kw = {"clip_feat": torch.randn(batch, 512, generator=g), "img2": torch.rand(shape, generator=g) * 2 - 1}
    int8 = args.conv_impl == "int8"
    forcing = Int8Forcing(1e-2)
    outs, unet_outs, secs = [], ([], []), []
    for i, d in enumerate((torch.device("cpu"), dev)):
        model.to(d)
        run_chain = image_sample.make_chain(model, diffusion, args)
        hooks = (forcing.force if i else forcing.record)(model) if int8 else contextlib.nullcontext()
        keep = model.register_forward_hook(lambda m, a, o, i=i: unet_outs[i].append(o.float().cpu()))
        t0 = time.perf_counter()
        with torch.inference_mode(), hooks:
            outs.append(run_chain(batch, {k: v.to(d) for k, v in kw.items()}, None, kw["img2"].to(d),
                                  noise=x_T.to(d)).float().cpu())
        secs.append(time.perf_counter() - t0)
        keep.remove()
    del model
    ref, out = outs
    if not torch.isfinite(out).all() or out.shape != ref.shape or len(unet_outs[0]) != len(unet_outs[1]):
        raise AssertionError(f"the card's 5-step DDIM chain ({name}): {tuple(out.shape)}, finite: "
                             f"{bool(torch.isfinite(out).all())}, {len(unet_outs[1])} forwards")
    rel = ((out - ref).norm() / ref.norm()).item()
    # the UNet's outputs along the chain: the samples follow eps by sqrt(1 - alpha_bar) <= 0.2 at t <= 100
    rel_unet = max(((o - r).norm() / r.norm()).item() for r, o in zip(*unet_outs))
    line = (f"{shape} {name}: card vs CPU from the same x_T{', teacher-forced' if int8 else ''}: samples' rel L2 "
            f"{rel:.3g} (|ref| {ref.norm().item():.4g}), the UNet's outputs' worst rel L2 {rel_unet:.3g} over "
            f"{len(unet_outs[0])} forwards; CPU {secs[0]:.2f} s, card {secs[1]:.2f} s"
            f"{'; ' + forcing.summary() if int8 else ''}")
    return max(rel, rel_unet), ref.norm().item(), line


def phase9_image_sample(dev, tmp, run_dir) -> list:
    """``image_sample.main`` on 16 generated test images (two batches of 8,
    ``SAMPLE_STEPS`` respaced ancestral steps) from ``RANDOM_CKPT``, written into 8c's run
    directory, in each of ``SAMPLE_MODES``: the UNet's forwards against the
    schedule, the kernels' launches against the modules' counts times those
    forwards (every K1 on the tensor cores; under int8 every K5 but the stem's
    and the head's), seconds a batch (CUDA events), the PNGs and the uint8
    npz, each mode's samples other than bf16's. Then ``SAMPLE_CHAINS``: short
    DDIM chains card against CPU. Returns each mode's launch counts."""
    import numpy as np
    import torch

    from guided_diffusion_clip_tpu_torch import image_sample
    from guided_diffusion_clip_tpu_torch.utils import logger

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = True
    data, clip = sample_test_set(tmp)
    sd = random_state_dict(recipe_model(use_fp16=False)[1])
    torch.save(sd, os.path.join(run_dir, RANDOM_CKPT))
    runs, images = [], {}
    for name, flags, over in SAMPLE_MODES:
        cfg = sample_config(tmp, name.replace(" ", "_"), run_dir, data, clip, load_file=RANDOM_CKPT,
                            timestep_respacing=SAMPLE_STEPS, **over)
        args, model, diffusion = sampling_model(cfg, *flags)
        int8 = args.conv_impl == "int8"
        steps = diffusion.num_timesteps if args.denoise_start_point == -1 else round(
            args.denoise_start_point * diffusion.num_timesteps / 1000)
        cfg_cache = args.cfg_scale > 0 and args.cfg_cache > 1
        # CFG with its cache: the conditional half every step, the unconditional one every other step
        forwards = 2 * (steps + -(-steps // 2) if cfg_cache else steps)
        per = unet_counts(model, int8)
        reset_counters()  # the main path starts here
        t0 = time.perf_counter()
        out = image_sample.main(["--config-file", cfg, "--device", dev.type, "-d", name.replace(" ", "_"), *flags])
        wall = time.perf_counter() - t0
        launches = counters()
        logger.reset()
        run = os.path.dirname(out["path"])
        images[name] = check_samples(out["path"], 16)
        pngs = {"samples_test0.png", "samples_test1.png", "target_0.png", "target_1.png"}
        if not pngs <= set(os.listdir(run)):
            raise AssertionError(f"{run} lacks {sorted(pngs - set(os.listdir(run)))}")
        if out["calls"] != {"unet_full": forwards, "unet_shallow": 0} or out["steps"] != steps:
            raise AssertionError(f"image_sample {name}: {out['calls']} forwards over {out['steps']} steps, want "
                                 f"{forwards} over {steps}")
        want = {**dict.fromkeys(launches, 0), **{k: forwards * v for k, v in per.items()}}
        log(f"  image_sample {name}: 2 batches of 8, {steps} steps, {forwards} UNet forwards; kernel launches "
            f"{launches} (expected {want}: per forward {per})")
        if launches != want:
            raise AssertionError(f"image_sample {name}: launch counts {launches} != {want}")
        check_tensor_core_launches(f"image_sample {name}")
        if int8:
            check_conv_tensor_core_launches(f"image_sample {name}", forwards * thin_convs(model))
        secs = out["batch_seconds"]
        log(f"  image_sample {name}: seconds a batch {', '.join(f'{v:.3f}' for v in secs)} (CUDA events; the "
            f"second overlaps the first's host work), {1e3 * secs[-1] / steps:.2f} ms a step; main() "
            f"{wall:.1f} s with the model's building and loading; {run}")
        runs.append(tensor_core_split(launches))
        del model
    base = images["bf16"].astype(np.float64)
    for name, imgs in images.items():
        sd_ = imgs.astype(np.float64).std()
        diff = np.abs(imgs.astype(np.float64) - base).mean()
        log(f"  samples' std: {name} {sd_:.3f} (bound: within 0.5 relative of bf16's); mean |uint8 diff| against "
            f"bf16 {diff:.3f} (bound: > 0 but for bf16)")
        if not abs(sd_ - base.std()) <= 0.5 * base.std():
            raise AssertionError(f"image_sample {name}: samples' std {sd_:.3f} not within 0.5 of bf16's {base.std():.3f}")
        if name != "bf16" and not diff > 0:
            raise AssertionError(f"image_sample {name}: the same samples as bf16's")

    tf32_off()
    for name, flags, over, batch, bound in SAMPLE_CHAINS:
        rel, norm, line = chain_card_vs_cpu(dev, tmp, run_dir, data, clip, sd, name, flags, over, batch)
        log(f"  5-step DDIM chain {line} (bound {bound})")
        if not norm > 0 or not rel <= bound:
            raise AssertionError(f"the card's 5-step DDIM chain ({name}) differs from the CPU's: rel L2 {rel:.3g}")
    return runs


def phase9b_repeat(dev, tmp, run_dir) -> dict:
    """``image_sample_repeat.main --repeats 2`` (8 samples each, seeds 0 and
    1): two run directories with ``_rep0`` and ``_rep1``, different samples,
    and the launches of 2 x ``SAMPLE_STEPS`` forwards. Returns the launch counts."""
    import numpy as np

    from guided_diffusion_clip_tpu_torch import image_sample_repeat

    data, clip = os.path.join(tmp, "test_images"), os.path.join(tmp, "test_clip_dict.pt")
    cfg = sample_config(tmp, "repeat", run_dir, data, clip, num_samples=8, sub_dir_tstsave="repeats",
                        timestep_respacing=SAMPLE_STEPS)
    _, model, diffusion = sampling_model(cfg)
    reset_counters()
    t0 = time.perf_counter()
    outs = image_sample_repeat.main(["--config-file", cfg, "--device", dev.type, "--repeats", "2", "-d", "rep"])
    wall = time.perf_counter() - t0
    launches = counters()
    dirs = sorted(os.path.basename(os.path.dirname(o["path"])) for o in outs)
    a, b = (check_samples(o["path"], 8) for o in outs)
    forwards = 2 * diffusion.num_timesteps
    want = {**dict.fromkeys(launches, 0), **{k: forwards * v for k, v in unet_counts(model, False).items()}}
    log(f"  image_sample_repeat --repeats 2: {dirs}, {wall:.1f} s; {np.mean(a != b) * 100:.1f} % of the values "
        f"differ between the seeds; launches {launches} (expected {want})")
    if len(dirs) != 2 or not (dirs[0].endswith("_rep_rep0") and dirs[1].endswith("_rep_rep1")) or np.array_equal(a, b):
        raise AssertionError(f"image_sample_repeat: run directories {dirs}, samples equal: {np.array_equal(a, b)}")
    if launches != want:
        raise AssertionError(f"image_sample_repeat: launch counts {launches} != {want}")
    check_tensor_core_launches("image_sample_repeat")
    return tensor_core_split(launches)


NLL_STEPS = 50  # 9c's schedule


def phase9c_nll(dev, tmp, run_dir) -> dict:
    """``image_nll.main`` on the 8 first test images (batch 8) with the recipe's
    model and a ``NLL_STEPS``-step cosine schedule: ``calc_bpd_loop``'s
    ``NLL_STEPS`` UNet forwards, the kernels' launches against them, a finite
    positive bpd and the three (``NLL_STEPS``,) term files. Returns the launch
    counts."""
    import numpy as np

    from guided_diffusion_clip_tpu_torch import image_nll
    from guided_diffusion_clip_tpu_torch.utils import logger

    data, clip = os.path.join(tmp, "test_images"), os.path.join(tmp, "test_clip_dict.pt")
    model = recipe_model()[1]
    argv = ["--image_size", "128", "--num_channels", "64", "--num_res_blocks", "2", "--learn_sigma", "True",
            "--class_cond", "True", "--num_heads", "1", "--use_fp16", "True", "--noise_schedule", "cosine",
            "--diffusion_steps", str(NLL_STEPS), "--model_path", os.path.join(run_dir, "ema_0.9999_000010.pt"),
            "--data_dir", data, "--clip_file_path", clip, "--batch_size", "8", "--num_samples", "8",
            "--main_path", os.path.join(tmp, "nll"), "--device", dev.type]
    reset_counters()
    t0 = time.perf_counter()
    out = image_nll.main(argv)
    wall = time.perf_counter() - t0
    launches = counters()
    run = logger.get_dir()
    logger.reset()
    want = {**dict.fromkeys(launches, 0), **{k: NLL_STEPS * v for k, v in unet_counts(model, False).items()}}
    terms = {n: np.load(os.path.join(run, f"{n}_terms.npz"))["arr_0"] for n in ("vb", "mse", "xstart_mse")}
    log(f"  image_nll on 8 images: bpd {out['bpd']}, {wall:.1f} s with the model's building ({1e3 * wall / NLL_STEPS:.2f} "
        f"ms a forward of batch 8); launches {launches} (expected {want}); terms {', '.join(f'{k} {v.shape}' for k, v in terms.items())}")
    if out["samples"] != 8 or not all(math.isfinite(b) and b > 0 for b in out["bpd"]):
        raise AssertionError(f"image_nll: {out['samples']} samples, bpd {out['bpd']}")
    if any(v.shape != (NLL_STEPS,) or not np.isfinite(v).all() for v in terms.values()):
        raise AssertionError(f"image_nll terms: {[(k, v.shape) for k, v in terms.items()]}")
    if launches != want:
        raise AssertionError(f"image_nll: launch counts {launches} != {want}")
    check_tensor_core_launches("image_nll")
    return tensor_core_split(launches)



# ---------------------------------------------------------------------------
# Phase 12: the fork's SR models through the four SR CLIs (the SR-delta model
# SRImageModel_Feat at the recipe's widths, the upstream SuperResModel 64 ->
# 128 px, the depth sweep of the recipe's CLIP UNet), inside phases 8-9's
# directory
# ---------------------------------------------------------------------------

# super_res_train's and super_res_sample's model: the recipe's widths through the SR factory (128 px from
# 64, mult (1, 1, 2, 3, 4), one head at 16 and 8 px, learned sigma, bf16 torso), class_cond off: the upstream
# cascade conditions on low_res, and the loader's batches carry no class labels
SR_FLAGS = ["--large_size", "128", "--small_size", "64", "--num_channels", "64", "--num_res_blocks", "2",
            "--num_heads", "1", "--learn_sigma", "True", "--use_fp16", "True", "--noise_schedule", "cosine",
            "--diffusion_steps", "1000"]
SR_SAMPLE_BATCH = 16  # super_res_sample's default batch
SR_SAMPLE_STEPS = 25


def run_counted(main, argv, env=None) -> tuple:
    """A CLI's ``main(argv)`` in this process, ``env`` set around it: (its
    return, the kernels' launches of the run, ``tensor_core_split``, and its
    seconds). The counts are set to 0 just before it."""
    from guided_diffusion_clip_tpu_torch.utils import logger

    env = env or {}
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    reset_counters()
    t0 = time.perf_counter()
    try:
        out = main(argv)
        launches = tensor_core_split(counters())
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        logger.reset()
    return out, launches, time.perf_counter() - t0


def expected(launches: dict, *terms) -> dict:
    """Every kernel of ``launches`` at 0, plus n x each (n, counts) of ``terms``."""
    want = dict.fromkeys(launches, 0)
    for n, counts in terms:
        for k, v in counts.items():
            want[k] += n * v
    return want


def phase12a_sr_card_vs_cpu(dev, tmp) -> None:
    """The SR-delta model at the recipe's widths from N(0, 0.02) weights, card
    against CPU: a forward (batch 2, f32, TF32 off) within 1e-3 relative L2;
    one train step (batch 4, dropout 0) with the bf16 torso within
    ``TRAIN_BF16_TOL``, as 8b; one ``--train_conv_impl int8`` step,
    teacher-forced, in f32 (TF32 off, f32 straight-through convs) within
    ``INT8_TRAIN_TOL``, the bf16 step's bound and tighter than 8e's f32 1e-3.

    Not in bf16: there an output block's per-tensor ``int8_conv`` reads a
    bf16 input that differs from the CPU's by the roundings of the unforced
    float path (K1's bf16 output, the residual adds), and the levels it
    flips moved that conv's output by 9.8e-3 relative L2 on an H100, past
    the forcing's own 5e-3 check (8e's recipe, other weights and batch,
    stays under it)."""
    import torch

    from guided_diffusion_clip_tpu_torch.ops import quant as Q

    tf32_off()
    model = recipe_model(sr=True, use_fp16=False)[1]
    sd = random_state_dict(model)
    model.load_state_dict(sd, strict=True)
    model.eval().requires_grad_(False)
    x, cond = recipe_batch(2, seed=7)
    xt, ct, t = torch.from_numpy(x), {k: torch.from_numpy(v) for k, v in cond.items()}, torch.tensor([100, 700])
    with torch.inference_mode():
        t0 = time.perf_counter()
        ref = model(xt, t, **ct)
        cpu_s = time.perf_counter() - t0
        model.to(dev)
        out = model(xt.to(dev), t.to(dev), **{k: v.to(dev) for k, v in ct.items()}).cpu()
    del model
    rel = ((out - ref).norm() / ref.norm()).item()
    log(f"  SR-delta forward (2, 3 + 3, 128, 128) f32: |ref| {ref.norm().item():.4g}, rel L2 err card vs CPU {rel:.3g} "
        f"(bound 1e-3); CPU forward {cpu_s:.2f} s")
    if out.shape != (2, 6, 128, 128) or not torch.isfinite(out).all() or not ref.norm() > 0 or not rel <= 1e-3:
        raise AssertionError(f"SR-delta forward {tuple(out.shape)}: card vs CPU rel L2 {rel:.3g}")

    def show(errs):
        return ", ".join(f"{k} {v:.3g}" for k, v in errs.items())

    x, cond = recipe_batch(4, seed=8)
    noise = torch.randn(4, 3, 128, 128, generator=torch.Generator().manual_seed(9))
    cpu, card = (train_step_on(d, sd, x, cond, noise, os.path.join(tmp, f"sr_step_{d.type}"), sr=True)
                 for d in (torch.device("cpu"), dev))
    bf16 = step_errors(card, cpu)
    log(f"  SR-delta train step (4, 3, 128, 128), bf16 torso: loss {float(cpu['met']['loss']):.6g} (CPU); card vs "
        f"CPU: {show(bf16)}; bound {TRAIN_BF16_TOL}; CPU step {cpu['secs']:.2f} s")
    bad = {k: bf16[k] for k, tol in TRAIN_BF16_TOL.items() if not bf16[k] <= tol}
    if bad or not math.isfinite(float(card["met"]["loss"])) or not float(cpu["met"]["loss"]) > 0:
        raise AssertionError(f"card SR-delta train step (bf16 torso) differs from the CPU's: {bad}")
    try:
        Q._STE_DTYPE = torch.float32
        cpu, card, forced = int8_step_pair(dev, sd, x, cond, noise, os.path.join(tmp, "sr_int8"), sr=True,
                                           use_fp16=False)
    finally:
        Q._STE_DTYPE = torch.bfloat16
    int8 = step_errors(card, cpu)
    log(f"  SR-delta int8 train step (4, 3, 128, 128) f32: loss {float(cpu['met']['loss']):.6g} (CPU); card vs CPU "
        f"teacher-forced: {show(int8)}; bound {INT8_TRAIN_TOL}; {forced}; CPU step {cpu['secs']:.2f} s")
    bad = {k: int8[k] for k, tol in INT8_TRAIN_TOL.items() if not int8[k] <= tol}
    if bad or not math.isfinite(float(card["met"]["loss"])):
        raise AssertionError(f"card SR-delta int8 train step differs from the CPU's: {bad}")


def phase12b_sr_unsup(dev, tmp, data, clip_path) -> list:
    """``super_res_unsup.main`` on 8c's folder and dict, ``--data_dir_test``
    the same folder: the recipe's file (batch 48) respaced to 100 steps, so
    that the save at step 10 runs its two validation chains (``--data_dir``,
    ``--data_dir_test``, 8 samples each) over 100 steps and not 1000; 11
    steps, the save, launches against the modules' counts. Then ``--load``
    of that run with ``--train_conv_impl int8`` for 5 steps (resume_step 10).
    Then ``TIMED_STEPS`` timed steps at batch 48 each way (``time_train_steps``). Returns
    the launch counts of the four."""
    import csv

    import torch

    from guided_diffusion_clip_tpu_torch import super_res_unsup
    from guided_diffusion_clip_tpu_torch.utils.checkpoint import load_state_dict

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = True
    runs_dir = os.path.join(tmp, "sr_runs")
    cfg = train_config(tmp, "sr_unsup", data, clip_path, runs_dir, timestep_respacing=str(VAL_STEPS))
    with torch.device("meta"):  # the modules alone, for their counts
        bf16_model, int8_model = (recipe_model(sr=True, train_conv_impl=impl)[1] for impl in ("xla", "int8"))
    per_step, per_fwd = train_counts(bf16_model, False), unet_counts(bf16_model, False)

    _, launches, secs = run_counted(super_res_unsup.main, ["--config-file", cfg, "--device", dev.type, "-d", "sr_unsup"],
                                    {"DIFFUSION_TRAINING_TEST": "1", "OPENAI_LOG_FORMAT": "log,csv"})
    check_tensor_core_launches("super_res_unsup")
    (first,) = os.listdir(runs_dir)
    run_dir = os.path.join(runs_dir, first)
    files = set(os.listdir(run_dir))
    want_files = {"model000010.pt", "ema_0.9999_000010.pt", "opt000010.pt", "progress.csv", "val_samples_0_000010.png",
                  "val_samples_1_000010.png"}
    with open(os.path.join(run_dir, "progress.csv")) as f:
        rows = list(csv.DictReader(f))
    losses = [float(r["loss"]) for r in rows]
    sd = load_state_dict(os.path.join(run_dir, "model000010.pt"))
    if (not want_files <= files or [int(r["step"]) for r in rows] != [0, 5, 10]
            or not all(math.isfinite(v) and v > 0 for v in losses)
            or sd["bias_feat"].shape != (512,) or sd["input_blocks.0.0.weight"].shape[1] != 6):
        raise AssertionError(f"super_res_unsup: {run_dir} holds {sorted(files)}, progress.csv steps "
                             f"{[r['step'] for r in rows]}, losses {losses}")
    # 11 steps (step 0 is an update), then 2 validation chains of VAL_STEPS forwards at batch 8
    want = expected(launches, (11, per_step), (2 * VAL_STEPS, per_fwd))
    log(f"  super_res_unsup (batch 48, 128 px, {VAL_STEPS} respaced steps; the save at step 10 with two "
        f"{VAL_STEPS}-step validation chains of 8): {secs:.1f} s in all; {first}: {', '.join(sorted(files))}; losses "
        f"{losses}; launches {launches} (expected {want}: 11 steps of {per_step}, {2 * VAL_STEPS} forwards of "
        f"{per_fwd})")
    if launches != want:
        raise AssertionError(f"super_res_unsup: launch counts {launches} != {want}")
    log(f"  super_res_unsup steps 6-10 (progress.csv): the loop waited {1e3 * float(rows[2]['wait_data']) / 5:.2f} ms "
        f"a step for the loader and spent {1e3 * float(rows[2]['wait_step']) / 5:.2f} ms in run_step")

    per8 = train_counts(int8_model, False)
    _, launches8, secs8 = run_counted(super_res_unsup.main, [
        "--config-file", cfg, "--device", dev.type, "-d", "sr_unsup_int8", "--load", "sr_unsup", "--load_file",
        "model000010.pt", "--lr_anneal_steps", "15", "--train_conv_impl", "int8"], {"OPENAI_LOG_FORMAT": "log,csv"})
    check_tensor_core_launches("super_res_unsup --train_conv_impl int8")
    check_conv_tensor_core_launches("super_res_unsup --train_conv_impl int8", 5 * thin_convs(int8_model))
    second = next(d for d in os.listdir(runs_dir) if d.endswith("_sr_unsup_int8"))
    with open(os.path.join(runs_dir, second, "log.txt")) as f:
        text = f.read()
    want8 = expected(launches8, (5, per8))
    log(f"  super_res_unsup --load {first} --train_conv_impl int8, 5 steps: {secs8:.1f} s; {second}: "
        f"{', '.join(sorted(os.listdir(os.path.join(runs_dir, second))))}; launches {launches8} (expected {want8})")
    if ("(step 10)" not in text or "model000015.pt" not in os.listdir(os.path.join(runs_dir, second))
            or launches8 != want8):
        raise AssertionError(f"super_res_unsup --load: launches {launches8} != {want8}, or it did not resume step 10 "
                             f"and save step 15:\n{text[-2000:]}")

    sd = random_state_dict(bf16_model)
    x, cond = recipe_batch(TRAIN_BATCH, seed=2)
    timed = {impl: time_train_steps(dev, tmp, sd, x, cond, f"SR-delta {label}", sr=True, train_conv_impl=impl)
             for impl, label in (("xla", "bf16"), ("int8", "int8"))}
    log(f"  SR-delta train step at batch {TRAIN_BATCH}: bf16 {timed['xla']['step_ms']:.2f} ms (busy "
        f"{timed['xla']['busy_ms']:.2f}, peak {timed['xla']['peak_gib']:.2f} GiB), int8 {timed['int8']['step_ms']:.2f} "
        f"ms (busy {timed['int8']['busy_ms']:.2f}, peak {timed['int8']['peak_gib']:.2f} GiB)")
    return [launches, launches8, timed["xla"]["launches"], timed["int8"]["launches"]]


def phase12c_sr_train_sample(dev, tmp, data, samples_npz) -> list:
    """``super_res_train.main`` (``SR_FLAGS``: the upstream model, low_res
    area-downsampled by its loader) 3 steps at batch 48 on 8c's folder, its
    checkpoint loading strict=True into ``super_res_sample``'s model; then
    ``super_res_sample.main`` from N(0, 0.02) weights (an EMA of 3 steps is
    the initialization, whose zero output convs make eps 0) on phase 9's
    samples area-downsampled to 64 px, batch 16, 100 ancestral steps, bf16 and
    ``--conv_impl int8``. Returns the launch counts of the three runs."""
    import numpy as np
    import torch

    from guided_diffusion_clip_tpu_torch import super_res_sample, super_res_train
    from guided_diffusion_clip_tpu_torch.utils.checkpoint import load_model_weights
    from guided_diffusion_clip_tpu_torch.utils.script_util import (
        args_to_dict, sr_create_model_and_diffusion, sr_model_and_diffusion_defaults, upstream_super_res,
    )

    def sr_model(*flags):
        args = super_res_sample.create_argparser().parse_args([*SR_FLAGS, *flags])
        model = sr_create_model_and_diffusion(**args_to_dict(args, sr_model_and_diffusion_defaults().keys()),
                                              conv_impl=args.conv_impl)[0]
        return upstream_super_res(model, args.class_cond)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = True
    with torch.device("meta"):
        models = {"bf16": sr_model(), "int8": sr_model("--conv_impl", "int8")}
    train_dir = os.path.join(tmp, "sr_train")
    _, launches, secs = run_counted(super_res_train.main, [
        *SR_FLAGS, "--data_dir", data, "--batch_size", str(TRAIN_BATCH), "--lr_anneal_steps", "3", "--main_path",
        train_dir, "--device", dev.type, "-d", "sr_train"], {"OPENAI_LOG_FORMAT": "log,csv"})
    check_tensor_core_launches("super_res_train")
    (run,) = os.listdir(train_dir)
    want = expected(launches, (3, train_counts(models["bf16"], False)))
    load_model_weights(sr_model(), os.path.join(train_dir, run, "model000003.pt"))
    log(f"  super_res_train (batch 48, 128 px from 64): 3 steps in {secs:.1f} s with the model's building; {run}: "
        f"{', '.join(sorted(os.listdir(os.path.join(train_dir, run))))}; model000003.pt loads strict=True into "
        f"super_res_sample's model; launches {launches} (expected {want})")
    if launches != want:
        raise AssertionError(f"super_res_train: launch counts {launches} != {want}")

    ckpt = os.path.join(tmp, "sr_random.pt")
    torch.save(random_state_dict(models["bf16"]), ckpt)
    big = np.load(samples_npz)["arr_0"]
    n = len(big)
    base = os.path.join(tmp, "sr_base_64.npz")
    np.savez(base, big.astype(np.float32).reshape(n, 64, 2, 64, 2, 3).mean(axis=(2, 4)).round().astype(np.uint8))
    runs, images = [launches], {}
    for name, flags in (("bf16", []), ("int8", ["--conv_impl", "int8"])):
        model = models[name]
        per = unet_counts(model, name == "int8")
        out, launches, wall = run_counted(super_res_sample.main, [
            *SR_FLAGS, *flags, "--model_path", ckpt, "--base_samples", base, "--timestep_respacing",
            str(SR_SAMPLE_STEPS), "--batch_size", str(SR_SAMPLE_BATCH), "--num_samples", str(SR_SAMPLE_BATCH),
            "--main_path", os.path.join(tmp, "sr_samples"), "--device", dev.type, "-d", f"sr_{name}"],
            {"OPENAI_LOG_FORMAT": "log"})
        check_tensor_core_launches(f"super_res_sample {name}")
        if name == "int8":
            check_conv_tensor_core_launches(f"super_res_sample {name}", SR_SAMPLE_STEPS * thin_convs(model))
        want = expected(launches, (SR_SAMPLE_STEPS, per))
        images[name] = np.load(out["path"])["arr_0"]
        secs = out["batch_seconds"][0]
        log(f"  super_res_sample {name} (batch {SR_SAMPLE_BATCH}, {SR_SAMPLE_STEPS} ancestral steps, 64 -> 128 px): "
            f"{secs:.3f} s a batch (CUDA events), {1e3 * secs / SR_SAMPLE_STEPS:.2f} ms a step; main() {wall:.1f} s with "
            f"the model's building and loading; {os.path.basename(out['path'])}; calls {out['calls']}; launches "
            f"{launches} (expected {want}: per forward {per})")
        if (launches != want or out["calls"] != {"unet": SR_SAMPLE_STEPS} or images[name].shape != (SR_SAMPLE_BATCH, 128, 128, 3)
                or images[name].dtype != np.uint8 or not all(im.std() > 0 for im in images[name])):
            raise AssertionError(f"super_res_sample {name}: calls {out['calls']}, samples {images[name].shape} "
                                 f"{images[name].dtype}, launches {launches} != {want}")
        runs.append(launches)
    sd_bf16, sd_int8 = (images[k].astype(np.float64).std() for k in ("bf16", "int8"))
    diff = np.abs(images["int8"].astype(np.int64) - images["bf16"].astype(np.int64))
    log(f"  super_res_sample samples' std: int8 {sd_int8:.3f}, bf16 {sd_bf16:.3f} (bound: within 0.5 relative); int8 "
        f"vs bf16 (same seeds and weights): mean |uint8 diff| {diff.mean():.3f} (bound: > 0)")
    if not abs(sd_int8 - sd_bf16) <= 0.5 * sd_bf16 or not diff.mean() > 0:
        raise AssertionError(f"super_res_sample: int8 samples' std {sd_int8:.3f} against bf16's {sd_bf16:.3f}, "
                             f"mean |diff| {diff.mean():.3f}")
    return runs


def phase12d_depth_sweep(dev, tmp, run_dir, data, clip) -> dict:
    """``super_res_depth_sweep_sample.main`` from ``RANDOM_CKPT`` in 8c's run
    directory on phase 9's test set (configs/image_sample_config.yaml: batch 8,
    100 respaced steps): chains of 50, 70 and 90 steps from img2 (depths 500,
    699 and 898), the PNGs, the forwards and launches against the schedule
    and the modules. Returns the launch counts."""
    import torch

    from guided_diffusion_clip_tpu_torch import super_res_depth_sweep_sample as sweep
    from guided_diffusion_clip_tpu_torch.image_sample import respaced_start

    cfg = sample_config(tmp, "sr_sweep", run_dir, data, clip, load_file=RANDOM_CKPT)
    with torch.device("meta"):
        _, model, diffusion = sampling_model(cfg)
    steps = [respaced_start(diffusion, d) for d in sweep.DEPTHS]
    per = unet_counts(model, False)
    out, launches, wall = run_counted(sweep.main, ["--config-file", cfg, "--device", dev.type, "-d", "sr_sweep"],
                                      {"OPENAI_LOG_FORMAT": "log"})
    check_tensor_core_launches("super_res_depth_sweep_sample")
    want = expected(launches, (sum(steps), per))
    pngs = {*(f"depth_{d}.png" for d in sweep.DEPTHS), "target.png", "start.png"}
    log(f"  super_res_depth_sweep_sample (batch 8): " + ", ".join(
        f"depth {d} -> {st} steps {secs:.3f} s" for d, (st, secs) in out["depths"].items())
        + f" (CUDA events); main() {wall:.1f} s; calls {out['calls']}; launches {launches} (expected {want})")
    if (launches != want or out["calls"] != {"unet": sum(steps)} or [st for st, _ in out["depths"].values()] != steps
            or not pngs <= set(os.listdir(out["dir"]))):
        raise AssertionError(f"super_res_depth_sweep_sample: {sorted(os.listdir(out['dir']))}, calls {out['calls']}, "
                             f"launches {launches} != {want}")
    return launches


# ---------------------------------------------------------------------------
# Phase 10: training ADM-G 256's classifier (classifier_train), then guiding
# with what it saved; phases 11 and 11b: the fork's CLIP at ViT-B/32's widths
# (compute_clip_embeddings, the encoders, clip_guided_sample)
# ---------------------------------------------------------------------------

# ADM-G 256's classifier (bench.py:170-198: width 128, depth 2, attention at 32/16/8 px, attention pool,
# scale-shift, resblock up/down, bf16 torso), trained as classifier_train's recipe: noised, annealed
CLF_TRAIN_FLAGS = [
    "--image_size", "256", "--classifier_width", "128", "--classifier_depth", "2",
    "--classifier_attention_resolutions", "32,16,8", "--classifier_use_scale_shift_norm", "True",
    "--classifier_resblock_updown", "True", "--classifier_pool", "attention", "--classifier_use_fp16", "True",
    "--diffusion_steps", "1000", "--noise_schedule", "linear", "--batch_size", "32", "--microbatch", "16",
    "--noised", "True", "--anneal_lr", "True", "--iterations", "10", "--log_interval", "1",
    "--eval_interval", "5", "--save_interval", "10000",
]
CLF_TRAIN_CLASSES = 4
# The bf16-torso classifier step (batch 2, microbatches of 1), card against CPU (both bf16), in relative L2
# (step_errors). Readings on an H100 (python3 chip_smoke.py --faults; the same in three calls): loss 3.5e-7,
# grad_norm 6.9e-6, updated params 2.3e-4, gradient 3.1e-4, attention qkv/norm 2.3e-3, proj_out 2.0e-3,
# GroupNorms 1.1e-3; the control, the
# CPU's bf16 step against its f32 step: 9.7e-7, 6.2e-6, 1.6e-3, 6.1e-4, 3.9e-3, 3.2e-3, 2.5e-3. Faults injected
# on the card only, and what caught them: K2's output x 1.01, grad_norm 1.8e-3, qkv/norm 2.0e-2; K1's x 1.01,
# grad_norm 1.6e-3, proj_out 5.1e-3, GroupNorms 2.6e-3; K3's saved rstd x 1.002, grad_norm 5.6e-5, qkv/norm
# 4.3e-3, proj_out 3.8e-3, GroupNorms 2.3e-3; K3's output x 1.002, loss 1.5e-6, grad_norm 6.1e-5; the GroupNorm
# backward's dx x 1.002, grad_norm 3.5e-5, qkv/norm 4.0e-3, proj_out 3.6e-3.
CLF_BF16_TOL = {"loss": 1e-6, "grad_norm": 2e-5, "updated params": 5e-4, "gradient": 1e-3,
                "gradient, attention qkv, norm": 3.5e-3, "gradient, attention proj_out": 3e-3,
                "gradient, GroupNorms": 1.8e-3}


def class_folder(tmp, name, n, seed) -> str:
    """``n`` generated 256 px PNGs named ``c{class}_{i}.png``, CLF_TRAIN_CLASSES classes."""
    import numpy as np
    from PIL import Image

    data = os.path.join(tmp, name)
    os.makedirs(data)
    rs = np.random.RandomState(seed)
    for i in range(n):
        img = rs.randint(0, 256, (256, 256, 3), dtype=np.uint8)
        Image.fromarray(img).save(os.path.join(data, f"c{i % CLF_TRAIN_CLASSES}_{i:04d}.png"))
    return data


def clf_train_counts(clf) -> dict:
    """K1, K2 and K3 launches of one classifier microbatch's forward and
    backward, from its modules: every attention block and the attention pool
    run K1 forward and K2 backward, every GroupNorm K3 (its backward is
    PyTorch ops); the pool is float32, on the float32 tensor-core kernels."""
    from guided_diffusion_clip_tpu_torch.models.nn import GroupNorm32
    from guided_diffusion_clip_tpu_torch.models.unet import AttentionBlock, AttentionPool2d

    attn = sum(isinstance(m, (AttentionBlock, AttentionPool2d)) for m in clf.modules())
    return {"attention": attn, "attention_bwd": attn, "group_norm": sum(isinstance(m, GroupNorm32)
                                                                         for m in clf.modules())}


def clf_step_batch():
    """The card-vs-CPU classifier step's batch (2 images, in microbatches of 1), labels, t and noise."""
    import torch

    g = torch.Generator().manual_seed(23)
    return (torch.rand(2, 3, 256, 256, generator=g) * 2 - 1, torch.randint(0, 1000, (2,), generator=g),
            torch.randint(0, 1000, (2,), generator=g), torch.randn(2, 3, 256, 256, generator=g))


def clf_step_on(d, sd, x, y, t, noise, fp16: bool, microbatch: int) -> dict:
    """One ``ClassifierTrainer.step`` (dropout 0) of the classifier on ``d``
    from ``sd``, as ``train_step_on``'s record: loss and grad_norm, updated
    parameters, the gradient, the parameter groups, the step's seconds."""
    import torch

    from guided_diffusion_clip_tpu_torch import classifier_train
    from guided_diffusion_clip_tpu_torch.utils.script_util import create_classifier, create_gaussian_diffusion

    clf = create_classifier(256, fp16, 128, 2, "32,16,8", True, True, "attention")
    clf.load_state_dict(sd, strict=True)
    trainer = classifier_train.ClassifierTrainer(clf.to(d), create_gaussian_diffusion(steps=1000),
                                                 batch_size=len(x), microbatch=microbatch, lr=3e-4)
    t0 = time.perf_counter()
    ce, _ = trainer.step(x, y, t=t, noise=noise)
    names, params = zip(*trainer.model.named_parameters())
    grads = [p.grad.detach().float() for p in params]
    met = {"loss": ce.mean().item(), "grad_norm": torch.linalg.vector_norm(torch.stack([g.norm() for g in grads])).item()}
    secs = time.perf_counter() - t0
    out = {"met": met, "params": {n: p.detach().cpu() for n, p in zip(names, params)},
           "grad": {n: g.cpu() for n, g in zip(names, grads)}, "groups": param_groups(trainer.model), "secs": secs}
    del trainer, clf
    return out


def phase10_classifier_train(dev, tmp, paths) -> list:
    """``classifier_train.main`` on ADM-G 256's classifier (``CLF_TRAIN_FLAGS``:
    batch 32 in microbatches of 16, noised, annealed, 10 iterations, a
    validation batch every 5) over generated class-named folders; then one
    step card against CPU in f32 (TF32 off) and with the bf16 torso
    (``CLF_BF16_TOL``); timed steps with each step's launches and the
    profiler's busy share; last, ``classifier_sample.main`` guiding 5 steps of
    ADM-G 256 with the saved ``model000009.pt`` (strict=True). Returns the
    launch counts of the two main paths."""
    import numpy as np
    import torch

    from guided_diffusion_clip_tpu_torch import classifier_sample, classifier_train
    from guided_diffusion_clip_tpu_torch.utils.profiling import kernel_times
    from guided_diffusion_clip_tpu_torch.utils.script_util import (
        args_to_dict, classifier_and_diffusion_defaults, create_classifier_and_diffusion,
    )

    train, val = class_folder(tmp, "clf_train", 64, 20), class_folder(tmp, "clf_val", 32, 21)
    args = classifier_train.create_argparser().parse_args(CLF_TRAIN_FLAGS)
    clf, diffusion = create_classifier_and_diffusion(**args_to_dict(args, classifier_and_diffusion_defaults().keys()))
    per = clf_train_counts(clf)
    n_micro = args.batch_size // args.microbatch
    # PyTorch's defaults, as the CLI leaves them
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = True
    run_dir = os.path.join(tmp, "clf_run")
    os.environ.update(OPENAI_LOGDIR=run_dir, OPENAI_LOG_FORMAT="log,csv")
    torch.cuda.reset_peak_memory_stats()
    reset_counters()
    try:
        t0 = time.perf_counter()
        out = classifier_train.main([*CLF_TRAIN_FLAGS, "--data_dir", train, "--val_data_dir", val])
        wall = time.perf_counter() - t0
    finally:
        os.environ.pop("OPENAI_LOGDIR")
        os.environ.pop("OPENAI_LOG_FORMAT")
    launches = counters()
    peak = torch.cuda.max_memory_allocated() / 2**30
    steps, evals = out["steps"], out["evals"]
    want = {**dict.fromkeys(launches, 0), "attention": (n_micro * steps + evals) * per["attention"],
            "attention_bwd": n_micro * steps * per["attention_bwd"],
            "group_norm": (n_micro * steps + evals) * per["group_norm"]}
    log(f"  classifier_train.main: {steps} steps at batch {args.batch_size} ({n_micro} microbatches), {evals} "
        f"validation batches; launches {launches} (expected {want}: a microbatch {per}, a validation forward "
        f"{per['attention']} K1 and {per['group_norm']} K3); main() {wall:.1f} s")
    if (steps, evals) != (10, 2) or launches != want:
        raise AssertionError(f"classifier_train: {steps} steps, {evals} evals, launches {launches} != {want}")
    pools = f32_attention_calls(clf)
    check_tensor_core_launches("classifier_train", pools * (n_micro * steps + evals), pools * n_micro * steps)
    import csv

    with open(os.path.join(run_dir, "progress.csv")) as f:
        rows = list(csv.DictReader(f))
    keys = {"step", "samples", "loss", "acc@1", "acc@5", "val_loss", "val_acc@1", "val_acc@5"}
    if len(rows) != 10 or set(rows[0]) != keys or not all(math.isfinite(float(r["loss"])) for r in rows):
        raise AssertionError(f"progress.csv: {len(rows)} rows, keys {sorted(rows[0]) if rows else None}")
    saved = sorted(p for p in os.listdir(run_dir) if p.endswith(".pt"))
    if saved != ["model000009.pt", "opt000009.pt"]:
        raise AssertionError(f"classifier_train saved {saved}")
    timed = sorted(out["step_ms"][2:])
    log(f"  steps 3-10: {timed[len(timed) // 2]:.2f} ms a step (median of {len(timed)}, CUDA events around each "
        f"update; range {timed[0]:.2f}-{timed[-1]:.2f}), {1e3 * args.batch_size / timed[len(timed) // 2]:.1f} "
        f"samples/s; peak memory {peak:.2f} GiB; loss {rows[0]['loss']} -> {rows[-1]['loss']}")
    runs = [tensor_core_split(launches)]

    # each step's launches, and the device's busy share, on the same trainer outside the CLI
    rs = np.random.RandomState(22)
    x = rs.uniform(-1, 1, (args.batch_size, 3, 256, 256)).astype(np.float32)
    y = rs.randint(0, CLF_TRAIN_CLASSES, args.batch_size)
    clf = clf.to(dev)
    trainer = classifier_train.ClassifierTrainer(clf, diffusion, batch_size=args.batch_size,
                                                 microbatch=args.microbatch, anneal_lr=True, iterations=10)
    for _ in range(2):
        trainer.step(x, y)
    times = []
    for _ in range(5):
        before = counters()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        trainer.step(x, y)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
        got = {k: counters()[k] - before[k] for k in per}
        if got != {k: n_micro * v for k, v in per.items()}:
            raise AssertionError(f"a classifier step launched {got}, not {n_micro} x {per}")
    step_ms = sorted(times)[2]
    prof = kernel_times(lambda: trainer.step(x, y))
    busy = sum(ms for ms, _ in prof.values())
    groups: dict = {}
    for k, (ms, n) in prof.items():
        grp = groups.setdefault(_kernel_group(k), [0.0, 0.0])
        grp[0] += ms
        grp[1] += n
    log(f"  a step outside the CLI: {step_ms:.2f} ms (median of 5), each launching {n_micro} x {per}; profiler: "
        f"device busy {busy:.2f} ms ({100 * busy / step_ms:.0f} %); " + "; ".join(
            f"{k} {ms:.2f} ms ({n:.0f})" for k, (ms, n) in sorted(groups.items(), key=lambda kv: -kv[1][0])))
    del trainer, clf
    torch.cuda.empty_cache()

    # one step card against CPU: f32 (TF32 off), then the bf16 torso against the CPU's bf16 step
    tf32_off()
    from guided_diffusion_clip_tpu_torch.utils.script_util import create_classifier

    sd = random_state_dict(create_classifier(256, False, 128, 2, "32,16,8", True, True, "attention"))
    g = torch.Generator().manual_seed(23)
    xs, ys, ts, noise = clf_step_batch()
    st = {(fp16, d.type): clf_step_on(d, sd, xs, ys, ts, noise, fp16, 1)
          for fp16 in (False, True) for d in (torch.device("cpu"), dev)}

    def show(errs):
        return ", ".join(f"{k} {v:.3g}" for k, v in errs.items())

    ref = st[False, "cpu"]
    f32 = step_errors(st[False, "cuda"], ref)
    log(f"  classifier step {tuple(xs.shape)}, microbatch 1, f32: loss {ref['met']['loss']:.6g} (CPU); card vs CPU: "
        f"{show(f32)} (bound 1e-3); CPU step {ref['secs']:.2f} s")
    if any(not v <= 1e-3 for v in f32.values()) or not ref["met"]["loss"] > 0:
        raise AssertionError(f"card classifier step (f32) differs from the CPU's: {f32}")
    bf16 = step_errors(st[True, "cuda"], st[True, "cpu"])
    control = step_errors(st[True, "cpu"], ref)
    log(f"  classifier step, bf16 torso: card vs CPU (both bf16): {show(bf16)}; control, CPU bf16 vs CPU f32: "
        f"{show(control)}; bound {CLF_BF16_TOL}; CPU step {st[True, 'cpu']['secs']:.2f} s")
    bad = {k: bf16[k] for k, tol in CLF_BF16_TOL.items() if not bf16[k] <= tol}
    if bad:
        raise AssertionError(f"card classifier step (bf16 torso) differs from the CPU's: {bad}")
    del st

    # train -> guide: the saved classifier steers ADM-G 256 for 5 steps through classifier_sample
    torch.backends.cudnn.allow_tf32 = True
    flags = [*GUIDED_FLAGS, "--timestep_respacing", "5"]
    argv = [*flags, "--model_path", paths["model"], "--classifier_path", os.path.join(run_dir, "model000009.pt"),
            "--main_path", os.path.join(tmp, "runs_trained_clf"), "--device", dev.type]
    reset_counters()
    guided = classifier_sample.main(argv)
    launches = counters()
    n = guided["steps"] * guided["batches"]
    want = {**dict.fromkeys(launches, 0), "attention": (ATTN_PER_FORWARD + CLF_ATTN_PER_FORWARD) * n,
            "attention_bwd": CLF_ATTN_PER_FORWARD * n, "group_norm": (GN_PER_FORWARD + CLF_GN_PER_FORWARD) * n}
    images = np.load(guided["path"])["arr_0"]
    log(f"  classifier_sample.main with model000009.pt (strict=True): {n} guided steps, launches {launches} "
        f"(expected {want}); samples {images.shape} {images.dtype}")
    if n != 5 or launches != want or images.shape != (8, 256, 256, 3) or not images.std() > 0:
        raise AssertionError(f"train -> guide: {n} steps, launches {launches} != {want}, samples {images.shape}")
    check_tensor_core_launches("train -> guide", pools * n, pools * n)
    runs.append(tensor_core_split(launches))
    return runs


def clip_random_state_dict(model):
    """N(0, 0.02) for every weight of a CLIP, LayerNorm scales 1 (zero scales
    would make every token 0) and OpenAI's logit scale, from a seed."""
    import torch

    g = torch.Generator().manual_seed(WEIGHT_SEED + 1)
    sd = {}
    for k, v in sorted(model.state_dict().items()):
        ln = k.endswith(".weight") and any(p in k for p in ("ln_", "ln_final"))
        sd[k] = torch.ones(v.shape) if ln else torch.randn(v.shape, generator=g, dtype=torch.float32) * 0.02
    sd["logit_scale"] = torch.tensor(math.log(1 / 0.07))
    return sd


def clip_unet_fn(model, target, through_unet: list):
    """The model_fn of a CLIP-guided step: ``model`` with ``target`` as each
    row's clip_feat. Under autograd the gradient at the UNet's input is
    appended to ``through_unet``: the part of the pred-x0 guidance gradient
    that the UNet's backward makes (the direct path of pred-x0 bypasses it,
    and with N(0, 0.02) weights it is ~7e-5 of the whole in phase 11)."""
    import torch

    def model_fn(a, b, **kw):
        if torch.is_grad_enabled() and a.requires_grad:
            a = a + 0  # a node of its own: what reaches it is the UNet's backward alone
            a.register_hook(through_unet.append)
        return model(a, b, clip_feat=target.expand(a.shape[0], -1))

    return model_fn


def phase11_clip(dev, tmp, unet_path) -> str:
    """ViT-B/32 at its full widths with N(0, 0.02) weights in OpenAI's names
    (a .pt written here): both encoders in f32 (TF32 off) card against CPU,
    and the vision encoder's forward + backward at batch 8 profiled
    (``clip_fwd_bwd_ms``); ``compute_clip_embeddings.main`` over 16 generated 256 px images, card
    against CPU, and its .pt fed to ``image_train`` for 2 steps; the CLIP
    guidance gradient in pred-x0 mode through the ADM-256 CLIP UNet (f32,
    batch ``CLIP_GRAD_BATCH``, model timestep 500 of a 100-step schedule), card against CPU.
    Returns the CLIP .pt's path."""
    import numpy as np
    import torch
    import yaml
    from PIL import Image

    from guided_diffusion_clip_tpu_torch import compute_clip_embeddings, image_train
    from guided_diffusion_clip_tpu_torch.models.clip_vit import (
        CLIP, CLIPConfig, clip_guidance_cond_fn, load_clip_params,
    )
    from guided_diffusion_clip_tpu_torch.utils.checkpoint import load_state_dict
    from guided_diffusion_clip_tpu_torch.utils.script_util import create_gaussian_diffusion

    tf32_off()
    cfg = CLIPConfig()
    clip_path = os.path.join(tmp, "clip_vitb32_random.pt")
    t0 = time.perf_counter()
    torch.save(clip_random_state_dict(CLIP(cfg)), clip_path)
    vision, text = load_clip_params(clip_path, cfg)
    n_vision = sum(p.numel() for p in vision.parameters())
    log(f"  ViT-B/32: {n_vision / 1e6:.1f} M vision and {(sum(p.numel() for p in text.parameters()) - n_vision) / 1e6:.1f}"
        f" M text parameters, written in OpenAI's names and loaded strict=True in {time.perf_counter() - t0:.1f} s")
    g = torch.Generator().manual_seed(30)
    pixels = torch.randn(2, 3, 224, 224, generator=g)
    ids = torch.randint(1, cfg.vocab_size - 1, (2, cfg.context_length), generator=g)
    ids[0, 9], ids[1, 40] = cfg.vocab_size - 1, cfg.vocab_size - 1  # the end-of-text token: the pooled position
    with torch.no_grad():
        refs = [vision(pixels), text(ids)]
        text.to(dev)
        outs = [vision(pixels.to(dev)).cpu(), text(ids.to(dev)).cpu()]
    for name, o, r in zip(("image", "text"), outs, refs):
        rel = ((o - r).norm() / r.norm()).item()
        log(f"  {name} encoder {tuple(o.shape)} f32: rel L2 err card vs CPU {rel:.3g} (bound 1e-3)")
        if o.shape != (2, 512) or not torch.isfinite(o).all() or not r.norm() > 0 or not rel <= 1e-3:
            raise AssertionError(f"card {name} encoder differs from the CPU's: rel L2 {rel:.3g}")
    clip_fwd_bwd_ms(dev, vision)

    # image folder -> embeddings, card and CPU
    data = os.path.join(tmp, "clip_images")
    os.makedirs(data)
    rs = np.random.RandomState(31)
    for i in range(16):
        Image.fromarray(rs.randint(0, 256, (256, 256, 3), dtype=np.uint8)).save(os.path.join(data, f"{i:05d}.png"))
    embs, secs = {}, {}
    for d in ("cpu", "cuda", "cuda"):
        out = compute_clip_embeddings.main(["--data_dir", data, "--out", os.path.join(tmp, f"clip_dict_{d}.pt"),
                                            "--clip_model_path", clip_path, "--batch_size", "16", "--device", d])
        secs.setdefault(f"first {d}", out["seconds"])
        embs[d], secs[d] = torch.load(out["path"]), out["seconds"]
    if sorted(embs["cuda"]) != sorted(os.listdir(data)) or any(v.shape != (2, 512) for v in embs["cuda"].values()):
        raise AssertionError("compute_clip_embeddings: not one (2, 512) pair an image")
    card, cpu = (torch.stack([e[k] for k in sorted(e)]) for e in (embs["cuda"], embs["cpu"]))
    rel = ((card - cpu).norm() / cpu.norm()).item()
    flip = ((card[:, 0] - card[:, 1]).norm() / card[:, 0].norm()).item()
    log(f"  compute_clip_embeddings.main, 16 images (32 rows with the flips): rel L2 err card vs CPU {rel:.3g} "
        f"(bound 1e-3); plain vs flipped rel L2 {flip:.3g}; {1e3 * secs['cuda'] / 16:.2f} ms an image on the card "
        f"(second call; the first {1e3 * secs['first cuda'] / 16:.2f}), {1e3 * secs['cpu'] / 16:.1f} on the CPU")
    if not rel <= 1e-3 or not flip > 0:
        raise AssertionError(f"embeddings card vs CPU: rel L2 {rel:.3g}")

    # embed -> train: the .pt as image_train's CLIP dict for 2 steps of the recipe
    root = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(root, "configs", "config.yaml")) as f:
        rcfg = yaml.safe_load(f)
    runs = os.path.join(tmp, "clip_train_runs")
    rcfg.update(data_dir=data, clip_file_path=os.path.join(tmp, "clip_dict_cuda.pt"), data_dir_test="",
                clip_file_path_test="", main_path=runs, batch_size=8, lr_anneal_steps=2, log_interval=1,
                save_interval=10**6)
    cfg_path = os.path.join(tmp, "clip_train.yaml")
    with open(cfg_path, "w") as f:
        yaml.safe_dump(rcfg, f)
    torch.backends.cudnn.allow_tf32 = True
    image_train.main(["--config-file", cfg_path, "--device", dev.type])
    run = os.path.join(runs, sorted(os.listdir(runs))[-1])
    import csv

    with open(os.path.join(run, "progress.csv")) as f:
        rows = list(csv.DictReader(f))
    if len(rows) != 2 or not all(math.isfinite(float(r["loss"])) for r in rows):
        raise AssertionError(f"image_train on the computed CLIP dict: {rows}")
    log(f"  image_train on the computed dict, 2 steps at batch 8: losses {[r['loss'] for r in rows]}, saved "
        f"{sorted(p for p in os.listdir(run) if p.endswith('.pt'))}")

    # the guidance gradient through the UNet at full width, f32
    tf32_off()
    text.cpu()
    model = clip_unet(load_state_dict(unet_path))
    diffusion = create_gaussian_diffusion(steps=1000, learn_sigma=True, timestep_respacing="100")
    target = embs["cpu"][sorted(embs["cpu"])[0]][0]
    x = torch.randn(CLIP_GRAD_BATCH, 3, 256, 256, generator=g)
    t = torch.full((CLIP_GRAD_BATCH,), 500, dtype=torch.long)
    grads = []
    for d in ("cpu", dev):
        model.to(d), vision.to(d)
        through_unet = []
        cond = clip_guidance_cond_fn(
            vision, target.to(d), 100.0, sched=diffusion.sched, mean_type=diffusion.mean_type,
            var_type=diffusion.var_type, model_fn=clip_unet_fn(model, target.to(d), through_unet), use_pred_xstart=True)
        t0 = time.perf_counter()
        with torch.no_grad():
            grads.append((cond(x.to(d), t.to(d)).cpu(), through_unet[0].cpu()))
        secs[d] = time.perf_counter() - t0
    (ref, ref_u), (out, out_u) = grads
    rel, rel_u = (((o - r).norm() / r.norm()).item() for o, r in ((out, ref), (out_u, ref_u)))
    log(f"  CLIP guidance gradient, pred-x0 mode, {tuple(x.shape)} f32 at model timestep 500 of 100 steps: "
        f"|ref| {ref.norm().item():.4g}, rel L2 err card vs CPU {rel:.3g}; its part through the UNet's backward "
        f"|ref| {ref_u.norm().item():.4g}, rel L2 err {rel_u:.3g} (bounds 1e-3); CPU {secs['cpu']:.2f} s")
    if not torch.isfinite(out).all() or not ref_u.norm() > 0 or not max(rel, rel_u) <= 1e-3:
        raise AssertionError(f"card CLIP guidance gradient differs from the CPU's: rel L2 {rel:.3g}, "
                             f"through the UNet {rel_u:.3g}")
    del model, vision, text
    torch.cuda.empty_cache()
    return clip_path


# phase 11's pred-x0 guidance gradient, card against CPU (2 until PR 20; the CPU took 40 s of it at batch 2)
CLIP_GRAD_BATCH = 1
# ADM-256's CLIP UNet as phase 5 serves it, guided by ViT-B/32: 5 respaced ancestral steps at batch 8
# (cut from 100 to 40, 20, 10 and 5 to pay for phases 12, 13, 14 and 17 within the smoke's time limit)
CLIP_GUIDED_FLAGS = [
    "--image_size", "256", "--num_channels", "256", "--num_res_blocks", "2",
    "--attention_resolutions", "32,16,8", "--num_head_channels", "64", "--resblock_updown", "True",
    "--use_scale_shift_norm", "True", "--learn_sigma", "True", "--class_cond", "True", "--use_fp16", "True",
    "--noise_schedule", "linear", "--diffusion_steps", "1000", "--timestep_respacing", "5",
    "--clip_scale", "100", "--batch_size", "8", "--seed", "0",
]
CLIP_GUIDED_MODES = [("bf16", []), ("int8", ["--conv_impl", "int8"]), ("bf16, guidance_cache 2", ["--guidance_cache", "2"])]


# The int8 CLIP-guided step (batch 1, f32, teacher-forced), card against CPU, in relative L2: the sample, the
# guidance gradient and its part through the UNet's backward (clip_unet_fn; the whole gradient barely sees the
# UNet). Its CPU step takes ~40 s at batch 1; the path's batch-8 shapes of K2 and K3 are held in phases 3 and 3b.
# Readings on an NVIDIA H100 80GB HBM3 at 700 W (python3 chip_smoke.py --faults, twice clean): 2.44e-7, 8.45e-6
# (8.58e-6 in another call), 2.33e-4. Faults injected on the card only: K3's saved rstd x 1.002, 2.44e-7, 1.6e-5,
# 2.1e-3; K4's saved rstd x 1.002, 2.44e-7, 9.65e-6, 7.5e-4; the GroupNorm backward's dx x 1.002, 2.44e-7,
# 1.72e-5, 2.3e-3; K1's and K3's outputs x 1.01 and x 1.002 fail the forcing's own checks; K2's x 1.01 moves
# nothing at 3 digits (with N(0, 0.02) weights the attention blocks' share of the UNet's backward is that small),
# so phase 3b holds K2 at this path's shapes. The sample's bound is the other int8 checks' 1e-3.
CLIP_INT8_TOL = {"sample": 1e-3, "gradient": 2e-5, "gradient through the UNet": 5e-4}


def clip_int8_step_input():
    """x and the step's noise of the int8 CLIP-guided step held card against CPU."""
    import torch

    g = torch.Generator().manual_seed(34)
    return torch.randn(1, 3, 256, 256, generator=g), torch.randn(1, 3, 256, 256, generator=g)


def clip_int8_step(d, model, vision, target, diffusion, xs, z, ctx) -> tuple:
    """One CLIP-guided ancestral step in pred-x0 mode (scale 100, step 50 of
    ``diffusion``'s schedule) of the int8 ``model`` and ``vision``, moved to
    ``d``, from ``xs`` with noise ``z``, under ``ctx(model)`` (an
    ``Int8Forcing``'s ``record`` or ``force``): the sample, the guidance
    gradient and its part through the UNet's backward (the gradient at the
    UNet's input, which the direct path of pred-x0 bypasses) on the CPU, and
    the step's seconds."""
    import torch

    from guided_diffusion_clip_tpu_torch.diffusion import sampling as S
    from guided_diffusion_clip_tpu_torch.models.clip_vit import clip_guidance_cond_fn

    model.to(d), vision.to(d)
    sched, tgt = diffusion.sched.to(d), target.to(d)
    through_unet = []
    model_fn = clip_unet_fn(model, tgt, through_unet)
    cond = clip_guidance_cond_fn(vision, tgt, 100.0, sched=sched, mean_type=diffusion.mean_type,
                                 var_type=diffusion.var_type, model_fn=model_fn, use_pred_xstart=True)
    grads = []
    t = sched.chain_timesteps(50, len(xs), d)
    t0 = time.perf_counter()
    with torch.no_grad(), ctx(model):
        sample, _ = S.p_sample_step(sched, model_fn, xs.to(d), t, None, noise=z.to(d),
                                    cond_fn=lambda a, b, **kw: grads.append(cond(a, b)) or grads[-1],
                                    cfg=S.SamplerConfig(mean_type=diffusion.mean_type, var_type=diffusion.var_type))
    return {"sample": sample.cpu(), "gradient": grads[0].cpu(), "gradient through the UNet": through_unet[0].cpu(),
            "seconds": time.perf_counter() - t0}


def clip_int8_errors(out: dict, ref: dict) -> dict:
    """``CLIP_INT8_TOL``'s distances of step ``out`` from step ``ref``, each in relative L2."""
    return {k: ((out[k] - ref[k]).norm() / ref[k].norm()).item() for k in CLIP_INT8_TOL}


def phase11b_clip_guided(dev, tmp, unet_path, clip_path) -> list:
    """``clip_guided_sample.main`` on the ADM-256 CLIP UNet (phase 5's N(0,
    0.02) weights) and the random ViT-B/32, ``--target_image`` a generated
    image, 5 ancestral steps at batch 8, in each of ``CLIP_GUIDED_MODES``:
    the calls and the kernels' launches against the modules' counts and the
    schedule, seconds a chain, peak memory, the samples. Returns each mode's
    launch counts."""
    import numpy as np
    import torch
    from PIL import Image

    from guided_diffusion_clip_tpu_torch import clip_guided_sample

    target_image = os.path.join(tmp, "clip_target.png")
    yy, xx = np.mgrid[0:256, 0:256]
    Image.fromarray(np.stack([xx, yy, (xx + yy) // 2], -1).astype(np.uint8)).save(target_image)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = True
    runs, samples = [], {}
    for name, flags in CLIP_GUIDED_MODES:
        int8 = "int8" in flags
        with torch.device("meta"):
            model = clip_unet(use_fp16=True, conv_impl="int8" if int8 else "auto")
        per = unet_counts(model, int8)
        thin = thin_convs(model)
        del model
        cache = 2 if "--guidance_cache" in flags else 1
        steps = int(CLIP_GUIDED_FLAGS[CLIP_GUIDED_FLAGS.index("--timestep_respacing") + 1])
        n_cond = len(range(0, steps, cache))
        argv = [*CLIP_GUIDED_FLAGS, *flags, "--model_path", unet_path, "--clip_model_path", clip_path,
                "--target_image", target_image, "--main_path", os.path.join(tmp, "clip_runs"), "--device", dev.type]
        torch.cuda.reset_peak_memory_stats()
        reset_counters()
        t0 = time.perf_counter()
        out = clip_guided_sample.main(argv)
        wall = time.perf_counter() - t0
        launches = counters()
        peak = torch.cuda.max_memory_allocated() / 2**30
        want_calls = {"unet": steps + n_cond, "clip": n_cond}
        want = {**dict.fromkeys(launches, 0), **{k: v * (steps + n_cond) for k, v in per.items()},
                "attention_bwd": per["attention"] * n_cond}
        log(f"  {name}: calls {out['calls']} (expected {want_calls}); launches {launches} (expected {want}: a "
            f"forward {per}, {steps + n_cond} forwards, {n_cond} backwards)")
        if out["calls"] != want_calls or out["steps"] != steps or launches != want:
            raise AssertionError(f"clip_guided_sample {name}: calls {out['calls']}, launches {launches} != {want}")
        check_tensor_core_launches(f"CLIP-guided sampling ({name})")
        if int8:
            check_conv_tensor_core_launches(f"CLIP-guided sampling ({name})", thin * (steps + n_cond))
        images = np.load(out["paths"][0])["arr_0"]
        if images.shape != (8, 256, 256, 3) or images.dtype != np.uint8 or not all(im.std() > 0 for im in images):
            raise AssertionError(f"{name}: samples {images.shape} {images.dtype}, not 8 non-constant uint8 images")
        samples[name] = images
        chain = out["chain_seconds"][0]
        log(f"  {name}: chain {chain:.3f} s ({1e3 * chain / steps:.2f} ms a step, {8 * 60 / chain:.3f} samples/min), "
            f"peak memory {peak:.2f} GiB; main() {wall:.1f} s with model building and loading")
        runs.append(tensor_core_split(launches))
    for name in samples:
        if name != "bf16":
            diff = np.abs(samples[name].astype(np.int64) - samples["bf16"].astype(np.int64))
            log(f"  {name} vs bf16 (same seeds and weights): mean |uint8 diff| {diff.mean():.3f}")
            if not diff.mean() > 0:
                raise AssertionError(f"{name}'s samples equal bf16's")
    return runs


def clip_fwd_bwd_ms(dev, vision) -> float:
    """CLIP's part of a CLIP-guided step, the CLIP layer's metric: the
    vision encoder's forward and backward on batch 8 of pred-x0 images (the
    cond_fn's ``preprocess_for_clip`` at 224 px, the cosine objective), the
    profiler's device ms by kernel group (one call after a warm-up). Phase
    11b split a whole guided step by part until phase 17 came (~20 s)."""
    import torch

    from guided_diffusion_clip_tpu_torch.models.clip_vit import preprocess_for_clip
    from guided_diffusion_clip_tpu_torch.utils.profiling import kernel_times

    vision.requires_grad_(False)
    target = torch.randn(512, generator=torch.Generator().manual_seed(32)).to(dev)
    x = torch.randn(8, 3, 256, 256, generator=torch.Generator(device=dev).manual_seed(33), device=dev)

    def fwd_bwd():
        with torch.enable_grad():
            x0 = x.detach().requires_grad_(True)
            emb = vision(preprocess_for_clip(x0, 224))
            torch.autograd.grad((emb / emb.norm(dim=-1, keepdim=True) * target).sum(), x0)

    fwd_bwd()
    groups: dict = {}
    for k, (ms, n) in kernel_times(fwd_bwd, 1).items():
        grp = groups.setdefault(_kernel_group(k), [0.0, 0.0])
        grp[0] += ms
        grp[1] += n
    total = sum(ms for ms, _ in groups.values())
    log(f"  CLIP forward + backward (ViT-B/32 f32, TF32 off, batch 8 at 224 px): device {total:.2f} ms; "
        + "; ".join(f"{k} {ms:.2f} ms ({n:.0f} launches)"
                    for k, (ms, n) in sorted(groups.items(), key=lambda kv: -kv[1][0]) if abs(ms) >= 0.005))
    return total


# ---------------------------------------------------------------------------
# Phase 13: more than one process, at world 1 (parallel/: DDP, FSDP2, ZeRO-1, DCP)
# ---------------------------------------------------------------------------

DIST_MODES = [("DDP", {}), ("FSDP2", {"param_sharding": "fsdp"}), ("ZeRO-1", {"opt_impl": "zero1"})]
# What a mode's step may add to the plain steps' spread: f32 sums taken in another order (FSDP2's global norms are
# sums of its shards' squares, and the time embedding's gradient gathers its terms in another order)
DIST_FLOOR = 1e-6


def fsdp_association(model) -> list:
    """An autograd identity on each ``TimestepEmbedSequential`` block's tensor
    inputs, as FSDP2 puts one on each unit's inputs
    (``RegisterPostBackwardFunction``); returns the hooks. A block's input
    then sums its gradient from the block's own layers first and adds the
    skip connection's after, where the plain graph adds the three terms in
    the order they arrive. In the bf16 torso that reassociation moves the
    gradient by bf16 roundings: the plain step with it is the spread that
    FSDP2's step is held to."""
    import torch

    from guided_diffusion_clip_tpu_torch.models.unet import TimestepEmbedSequential

    class Identity(torch.autograd.Function):
        @staticmethod
        def forward(ctx, *xs):
            return tuple(x.view_as(x) for x in xs)

        @staticmethod
        def backward(ctx, *grads):
            return grads

    return [m.register_forward_pre_hook(lambda mod, args: Identity.apply(*args))
            for m in model.modules() if isinstance(m, TimestepEmbedSequential)]


@contextlib.contextmanager
def world1_group():
    """The port's process group of one rank (``parallel/dist.py::one_rank_group``:
    torchrun's variables for a world of 1, NCCL for CUDA tensors, gloo beside
    it) for the block; both gone after it."""
    from guided_diffusion_clip_tpu_torch.parallel import dist as pdist

    with pdist.one_rank_group("cuda"):
        if not pdist.is_initialized() or pdist.world_size() != 1:
            raise AssertionError("one_rank_group did not start a process group of one rank")
        yield


def dist_loop(dev, sd, tmp, batch, int8=False, **kw):
    """A ``TrainLoop`` of the recipe (dropout 0) on ``dev`` from ``sd``, with
    the loop's options ``kw`` (``param_sharding``, ``opt_impl``)."""
    from guided_diffusion_clip_tpu_torch.training.train_loop import TrainLoop
    from guided_diffusion_clip_tpu_torch.utils import logger

    args, model, diffusion = recipe_model(dropout=0.0, **({"train_conv_impl": "int8"} if int8 else {}))
    model.load_state_dict(sd, strict=True)
    logger.configure_dir(tmp, format_strs=[])
    return TrainLoop(model=model.to(dev), diffusion=diffusion, data=None, batch_size=batch, microbatch=-1,
                     lr=args.lr, ema_rate=args.ema_rate, log_interval=10**9, save_interval=10**9,
                     weight_decay=args.weight_decay, **kw)


def dist_step(loop, x, cond, noise, t, forcing=None, record=False) -> dict:
    """One ``run_step`` with the counts set to 0 just before and read just
    after: the metrics, the full updated parameters and gradient on the host,
    ``param_groups`` and the launches (``tensor_core_split``)."""
    from guided_diffusion_clip_tpu_torch.parallel.mesh import full_tensor

    reset_counters()
    ctx = contextlib.nullcontext() if forcing is None else (
        forcing.record(loop.model) if record else forcing.force(loop.model))
    with ctx:
        loop.run_step(x, cond, noise=noise, t=t)
    met = loop._fetch(loop._pending_log[2])
    launches = tensor_core_split(counters())
    return {"met": met, "launches": launches, "groups": param_groups(loop.model),
            "params": {n: full_tensor(p.detach(), p).cpu() for n, p in zip(loop.names, loop.params)},
            "grad": {n: full_tensor(p.grad, p).cpu() for n, p in zip(loop.names, loop.params)}}


def dist_step_ms(loop, x, cond, n=5) -> tuple:
    """(median ms of ``n`` steps after one of warm-up, by CUDA events; the
    profiler's kernel time of one more step by kernel group, ms: NCCL's
    kernels run on a stream of their own, beside the backward's)."""
    import torch

    from guided_diffusion_clip_tpu_torch.utils.profiling import kernel_times

    loop.run_step(x, cond)
    times = []
    for _ in range(n):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        loop.run_step(x, cond)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    groups: dict = {}
    prof = kernel_times(lambda: loop.run_step(x, cond), reps=1)
    for k, (kernel_ms, _) in prof.items():
        groups[_kernel_group(k)] = groups.get(_kernel_group(k), 0.0) + kernel_ms
    others = sorted(((kernel_ms, k) for k, (kernel_ms, _) in prof.items() if _kernel_group(k) == "other"), reverse=True)
    groups.update({f"other: {k[:60]}": kernel_ms for kernel_ms, k in others[:2]})
    loop.flush_metrics()
    return sorted(times)[len(times) // 2], groups


def check_dist_launches(tag, loop, launches) -> dict:
    """One step's launches against ``train_counts`` (every K1/K2 launch on
    the tensor cores; under int8 every K5 but the stems' and the head's)."""
    want = train_counts(loop.model, False)
    got = {k: launches[k] for k in want}
    if got != want or any(v for k, v in launches.items() if k not in want and not k.endswith("_f32")):
        raise AssertionError(f"13a {tag}: launches {launches}, want {want} and no other kernel")
    if launches["attention_f32"] or launches["attention_bwd_f32"]:
        raise AssertionError(f"13a {tag}: K1/K2 at d = 192 and 256 ran on float32 input: {launches}")
    if loop.model.int8:
        check_conv_tensor_core_launches(f"13a {tag}", thin_convs(loop.model))
    return launches


def stale_w_q(loop, weights: dict) -> list:
    """The int8 convs whose cached ``w_q`` is not the quantization of
    ``weights``, the parameters their last forward read."""
    import torch

    from guided_diffusion_clip_tpu_torch.models.nn import Conv2d
    from guided_diffusion_clip_tpu_torch.ops.quant import quantize_per_out_channel

    def fresh(name, m):
        return m._wq is not None and torch.equal(m._wq[0], quantize_per_out_channel(
            weights[f"{name}.weight"].to(m._wq[0].device).permute(2, 3, 1, 0))[0])

    return [name for name, m in loop.model.named_modules() if isinstance(m, Conv2d) and not fresh(name, m)]


def phase13a_dist_steps(dev, tmp) -> list:
    """The recipe's step under DDP, FSDP2 and ZeRO-1 at world 1 against the
    plain step (see the module's docstring). Returns each mode's launches."""
    import numpy as np
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = True
    sd = random_state_dict(recipe_model()[1])
    x, cond = recipe_batch(TRAIN_BATCH, seed=13)
    noise = torch.randn(TRAIN_BATCH, 3, 128, 128, generator=torch.Generator().manual_seed(14))
    t = np.random.default_rng(15).integers(0, 1000, TRAIN_BATCH)

    def show(errs):
        return ", ".join(f"{k} {v:.3g}" for k, v in errs.items())

    steps, ms, runs = {}, {}, []
    for i, tag in enumerate(("plain 0", "plain 1", "plain, FSDP2's association")):
        loop = dist_loop(dev, sd, os.path.join(tmp, f"plain{i}"), TRAIN_BATCH)
        hooks = fsdp_association(loop.model) if i == 2 else []
        steps[tag] = dist_step(loop, x, cond, noise, t)
        check_dist_launches("plain", loop, steps[tag]["launches"])
        if i == 1:
            ms["plain"] = dist_step_ms(loop, x, cond)
        for h in hooks:
            h.remove()
        del loop
        torch.cuda.empty_cache()
    runs_apart = step_errors(steps["plain 1"], steps["plain 0"])
    assoc = step_errors(steps["plain, FSDP2's association"], steps["plain 0"])
    spread = {k: max(runs_apart[k], assoc[k]) for k in runs_apart}
    per_step = {k: steps["plain 0"]["launches"][k] for k in ("attention", "attention_bwd", "group_norm")}
    log(f"  plain step (batch {TRAIN_BATCH}, bf16 torso): loss {float(steps['plain 0']['met']['loss']):.6g}, "
        f"grad_norm {float(steps['plain 0']['met']['grad_norm']):.6g}; two plain steps apart: {show(runs_apart)}; "
        f"the plain step with FSDP2's association of the gradient sums against it: {show(assoc)}; launches a step "
        f"{per_step} (from the modules)")
    # int8, batch 4 (the forcing keeps every rounding of a step on the host): the plain step records
    sd8 = random_state_dict(recipe_model(train_conv_impl="int8")[1])
    x8, cond8 = recipe_batch(4, seed=16)
    noise8 = torch.randn(4, 3, 128, 128, generator=torch.Generator().manual_seed(17))
    forcing = Int8Forcing(1e-2)
    loop = dist_loop(dev, sd8, os.path.join(tmp, "plain_int8"), 4, int8=True)
    steps["plain int8"] = dist_step(loop, x8, cond8, noise8, t[:4], forcing, record=True)
    loop = dist_loop(dev, sd8, os.path.join(tmp, "plain_int8_assoc"), 4, int8=True)
    fsdp_association(loop.model)
    steps["plain int8, FSDP2's association"] = dist_step(loop, x8, cond8, noise8, t[:4], forcing)
    del loop

    with world1_group():
        for name, kw in DIST_MODES:
            loop = dist_loop(dev, sd, os.path.join(tmp, name), TRAIN_BATCH, **kw)
            got = steps[name] = dist_step(loop, x, cond, noise, t)
            runs.append(check_dist_launches(name, loop, got["launches"]))
            errs = step_errors(got, steps["plain 0"])
            same = step_errors(got, steps["plain, FSDP2's association" if kw.get("param_sharding") else "plain 0"])
            bound = {k: min(tol, spread[k] + DIST_FLOOR) for k, tol in TRAIN_BF16_TOL.items()}
            log(f"  {name} (world 1): against the plain step {show(errs)}; bound {show(bound)} (TRAIN_BF16_TOL, and "
                f"the plain steps' spread plus {DIST_FLOOR:g}); against the plain step of its association {show(same)} "
                f"(bound {DIST_FLOOR:g})")
            bad = {k: errs[k] for k, b in bound.items() if not errs[k] <= b}
            bad.update({f"{k}, same association": v for k, v in same.items() if not v <= DIST_FLOOR})
            if bad or not math.isfinite(float(got["met"]["loss"])):
                raise AssertionError(f"13a {name}: the step differs from the plain step's: {bad}")
            ms[name] = dist_step_ms(loop, x, cond)
            del loop
            torch.cuda.empty_cache()
        for name, kw in DIST_MODES[:2]:
            loop = dist_loop(dev, sd8, os.path.join(tmp, f"{name}_int8"), 4, int8=True, **kw)
            got = dist_step(loop, x8, cond8, noise8, t[:4], forcing)
            runs.append(check_dist_launches(f"{name} int8", loop, got["launches"]))
            ref = "plain int8, FSDP2's association" if kw else "plain int8"
            errs, plain = step_errors(got, steps[ref]), step_errors(got, steps["plain int8"])
            log(f"  {name} int8 (world 1, batch 4), teacher-forced to the plain int8 step's roundings: against the "
                f"plain int8 step of its association {show(errs)}; bound {INT8_TRAIN_TOL}; against the plain int8 step "
                f"{show(plain)}; {forcing.summary()}")
            bad = {k: errs[k] for k, tol in INT8_TRAIN_TOL.items() if not errs[k] <= tol}
            if bad:
                raise AssertionError(f"13a {name} int8: the step differs from the plain int8 step's: {bad}")
            if kw:  # FSDP2: a second step reads the updated weights, refilled in place
                loop.run_step(x8, cond8)
                stale = stale_w_q(loop, got["params"])
                if stale:
                    raise AssertionError(f"13a FSDP2 int8: {len(stale)} convs kept a stale w_q: {stale[:4]}")
                log("  FSDP2 int8, a second step: every conv's cached w_q is the quantization of the updated weights")
                loop.flush_metrics()
            del loop
            torch.cuda.empty_cache()
    log(f"  step at batch {TRAIN_BATCH}, world 1, median of 5 (CUDA events): " + ", ".join(
        f"{k} {v:.2f} ms" for k, (v, _) in ms.items()))
    for k, (_, groups) in ms.items():
        total = sum(t for g, t in groups.items() if not g.startswith("other: "))
        log(f"    {k}, kernel time of one step by group (profiler): {total:.2f} ms; " + "; ".join(
            f"{g} {t:.2f}" for g, t in sorted(groups.items(), key=lambda kv: -kv[1])))
    return runs


def torchrun(module, argv, env=None) -> subprocess.Popen:
    """Start ``python -m torch.distributed.run --standalone --nproc_per_node 1
    -m module argv`` from the checkout's root; ``finish`` waits for it."""
    env = {**{k: v for k, v in os.environ.items() if k not in ("DIFFUSION_TRAINING_TEST", "DIFFUSION_BLOB_LOGDIR")},
           "PYTHONUNBUFFERED": "1", **(env or {})}
    return subprocess.Popen([sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node", "1",
                             "-m", module, *argv], cwd=os.path.dirname(os.path.abspath(__file__)), env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def finish(proc, what, timeout=600) -> float:
    """Wait for a ``torchrun`` child; its seconds from now, or an error with its output."""
    t0 = time.perf_counter()
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        out, err = proc.communicate()
        raise AssertionError(f"torchrun {what} ran past {timeout} s:\n{out[-3000:]}\n{err[-5000:]}") from None
    if proc.returncode:
        raise AssertionError(f"torchrun {what} exited {proc.returncode}:\n{out[-3000:]}\n{err[-5000:]}")
    return time.perf_counter() - t0


def dcp_save_times(log_txt) -> list:
    """(step, seconds blocking the loop, seconds until written) of each DCP save a run's log.txt records."""
    with open(log_txt) as f:
        return [(int(m.group(1)), float(m.group(2)), float(m.group(3))) for m in re.finditer(
            r"orbax \(DCP\) save of step (\d+): ([\d.]+) s blocking the loop, written ([\d.]+) s", f.read())]


def phase13b_torchrun(dev, tmp, data, clip_path) -> dict:
    """``image_train`` under FSDP2 with DCP saves, its resume under ZeRO-1,
    and ``image_sample`` from the DCP directory with and without torchrun
    (see the module's docstring). Returns the launches of the last run, in
    this process."""
    import numpy as np
    import torch

    from guided_diffusion_clip_tpu_torch import image_sample

    root = os.path.join(tmp, "dist")
    os.makedirs(root)
    init = os.path.join(root, "model_random.pt")
    torch.save(random_state_dict(recipe_model()[1]), init)
    runs = os.path.join(root, "runs")
    cfg = train_config(root, "config13", data, clip_path, runs, save_interval=3, log_interval=1,
                       timestep_respacing="25", data_dir_test="", clip_file_path_test="")
    secs = finish(torchrun("guided_diffusion_clip_tpu_torch.image_train",
                           ["--config-file", cfg, "--param_sharding", "fsdp", "--ckpt_backend", "orbax",
                            "--resume_checkpoint", init], {"DIFFUSION_TRAINING_TEST": "1"}), "image_train (FSDP2)")
    (first,) = os.listdir(runs)
    run_dir = os.path.join(runs, first)
    orbax = os.path.join(run_dir, "orbax")
    if sorted(os.listdir(orbax)) != ["3"] or ".metadata" not in os.listdir(os.path.join(orbax, "3")):
        raise AssertionError(f"{orbax}: {os.listdir(orbax)}, want one DCP step, 3")
    saves = dcp_save_times(os.path.join(run_dir, "log.txt"))
    log(f"  image_train --param_sharding fsdp --ckpt_backend orbax under torchrun, 4 steps and the DCP save at step 3 "
        f"with a 25-step validation chain: {secs:.1f} s; {orbax}/3: {sorted(os.listdir(os.path.join(orbax, '3')))}; "
        f"DCP saves (step, s blocking the loop, s until written): {saves}")

    # the resume and the sampling under torchrun read the first run's DCP directory and write apart: they run at
    # once, most of each child's time its start (the card's kernels run while the other starts)
    cfgs = [sample_config(root, f"sample13_{where}", run_dir, os.path.join(tmp, "test_images"),
                          os.path.join(tmp, "test_clip_dict.pt"), f="", load_file="", sub_dir_tstsave="",
                          main_path=os.path.join(root, where), model_path=orbax + "@ema_0.9999", num_samples=8,
                          timestep_respacing="25") for where in ("sampled_torchrun", "sampled")]
    t0 = time.perf_counter()
    resume = torchrun("guided_diffusion_clip_tpu_torch.image_train",
                      ["--config-file", cfg, "--opt_impl", "zero1", "--ckpt_backend", "orbax", "--resume_checkpoint",
                       orbax, "--lr_anneal_steps", "6"])
    sample = torchrun("guided_diffusion_clip_tpu_torch.image_sample", ["--config-file", cfgs[0]])
    try:
        finish(sample, "image_sample")
        secs_sample = time.perf_counter() - t0
        finish(resume, "image_train (ZeRO-1)")
        secs = time.perf_counter() - t0
    finally:
        for proc in (resume, sample):
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    (second,) = set(os.listdir(runs)) - {first}
    res_dir = os.path.join(runs, second)
    with open(os.path.join(res_dir, "log.txt")) as f:
        text = f.read()
    res_saves = dcp_save_times(os.path.join(res_dir, "log.txt"))
    steps = sorted(int(n) for n in os.listdir(os.path.join(res_dir, "orbax")))
    if "orbax (DCP) checkpoint" not in text or "(step 3)" not in text or steps != [6]:
        raise AssertionError(f"the zero1 resume did not restore step 3 from {orbax} or save step 6: {steps}\n"
                             f"{text[-2000:]}")
    log(f"  resumed from {orbax} under --opt_impl zero1 for 3 steps and a DCP save at step 6 (beside the sampling "
        f"below): {secs:.1f} s; DCP saves {res_saves}")
    (path_tr,) = glob.glob(os.path.join(root, "sampled_torchrun", "*", "samples_8x128x128x3.npz"))
    out, launches, secs1 = run_counted(image_sample.main, ["--config-file", cfgs[1]])
    a, b = check_samples(path_tr, 8), check_samples(out["path"], 8)
    if not np.array_equal(a, b) or path_tr == out["path"]:
        raise AssertionError(f"image_sample from {orbax}@ema_0.9999: {path_tr} under torchrun and {out['path']} "
                             f"without it differ on {int((a != b).sum())} values")
    log(f"  image_sample from {orbax}@ema_0.9999 (25 steps, batch 8): under torchrun {secs_sample:.1f} s (beside the "
        f"resume), in this process {secs1:.1f} s; the same bytes")
    return launches


# ---------------------------------------------------------------------------
# Phase 14: the measuring tools (tools/train_step_bench, perf_breakdown, serve_bench, block_microbench) and the
# FLOP counts (utils/flops.py), each tool through its main() at its headline configuration, the repeats and
# windows cut by its own environment variables
# ---------------------------------------------------------------------------

TOOL_AGREEMENT = (0.8, 1.25)  # a tool's device ms over the phase's that measures the same work in this run

# one window of the tool's default length, ended by the metrics' flush and a sync (a second window repeated
# the first's measurement)
TSB_ENV = {"TSB_CONFIG": "fork128", "TSB_REPEATS": "1", "TSB_WINDOW": "5"}  # a window of 10 until PR 20
BD_BATCH, BD_REPS = 8, 4  # perf_breakdown at phase 6's batch, half its default repeats
SB_ENV = {"SB_REQUESTS": "3"}
# the parts of perf_breakdown against profile_guided_step's
BD_PARTS = {"unet_fwd_ms": "UNet forward", "cls_fwd_ms": "classifier forward",
            "cls_grad_ms": "classifier forward + backward", "full_step_ms": "guided step"}
PEAK_BF16 = PEAK_OPS_PER_S["bf16"]


def check_row(tool: str, row: dict, keys) -> None:
    """Every key of ``keys`` in ``row``, each number finite and positive."""
    bad = {k: row.get(k) for k in keys
           if not (isinstance(row.get(k), (int, float)) and math.isfinite(row[k]) and row[k] > 0)}
    if bad:
        raise AssertionError(f"{tool}: keys missing, not finite or not positive: {bad} in {row}")


def agreement(tool: str, ours: float, phase: str, theirs: float) -> float:
    """``ours`` over ``theirs`` (device ms), printed, within ``TOOL_AGREEMENT``."""
    ratio = ours / theirs
    log(f"  {tool} {ours:.2f} ms against {phase} {theirs:.2f} ms on the card in this run: ratio {ratio:.3f} "
        f"(bound {TOOL_AGREEMENT})")
    if not TOOL_AGREEMENT[0] <= ratio <= TOOL_AGREEMENT[1]:
        raise AssertionError(f"{tool} and {phase} disagree: {ours:.2f} ms against {theirs:.2f} ms")
    return ratio


def phase14a_train_step_bench(timed: dict) -> list:
    """``train_step_bench.main`` on the recipe (``TSB_CONFIG fork128``, batch
    48, its whole batch a microbatch) in bf16 and with ``TSB_CONV_IMPL int8``,
    right after 8e: the row, the launches of its 1 + TSB_WINDOW timed steps and
    3 profiled against ``train_counts``, its device ms a step against 8d's
    (bf16; 8e's, int8, logged), its window's ms a step against 8d's and 8e's
    medians and its own device ms logged, the FLOP count equal both ways. ``timed`` holds 8d's and 8e's records by
    ``TSB_CONV_IMPL``. Returns the two runs' launch counts."""
    import torch

    from guided_diffusion_clip_tpu_torch.tools import train_step_bench

    window = int(TSB_ENV["TSB_WINDOW"])
    steps = 1 + int(TSB_ENV["TSB_REPEATS"]) * window + 3  # kernel_times: a warm-up step and two
    runs, rows = [], {}
    for impl in ("xla", "int8"):
        with torch.device("meta"):
            model = recipe_model(train_conv_impl=impl)[1]
        per_step, thin = train_counts(model, False), thin_convs(model)
        row, launches, secs = run_counted(train_step_bench.main, [], {**TSB_ENV, "TSB_CONV_IMPL": impl})
        check_row(f"train_step_bench {impl}", row, ("ms_per_step", "samples_per_sec_per_chip", "compile_sec",
                                                     "window_steps", "flops_per_step", "model_tflops_per_s",
                                                     "device_ms_per_step"))
        want = expected(launches, (steps, per_step))
        want.update(attention_f32=0, attention_bwd_f32=0)
        log(f"  train_step_bench {impl}: {row} ({secs:.1f} s in all); launches {launches} (expected {want}: "
            f"{steps} steps of {per_step})")
        if launches != want or row["card"] != smi() or row["window_steps"] != window:
            raise AssertionError(f"train_step_bench {impl}: launches {launches} != {want}, or row {row}")
        if impl == "int8":
            check_conv_tensor_core_launches("train_step_bench int8", steps * thin)
        rows[impl] = row
        runs.append(launches)
    agreement("train_step_bench bf16 device_ms_per_step", rows["xla"]["device_ms_per_step"],
              "8d's plain busy", timed["xla"]["busy_ms"])
    for impl, phase in (("xla", "8d's plain"), ("int8", "8e's")):
        tool, ref = rows[impl], timed[impl]
        log(f"  train_step_bench {impl}, logged only: device {tool['device_ms_per_step']:.2f} ms against {phase} busy "
            f"{ref['busy_ms']:.2f} ms (ratio {tool['device_ms_per_step'] / ref['busy_ms']:.3f}); window "
            f"{tool['ms_per_step']:.2f} ms a step against {phase} median {ref['step_ms']:.2f} ms (ratio "
            f"{tool['ms_per_step'] / ref['step_ms']:.3f}; host clock, sustained over {window} steps, against CUDA "
            f"events around one synchronized step) and against its own device ms (ratio "
            f"{tool['ms_per_step'] / tool['device_ms_per_step']:.3f})")
    flops = rows["xla"]["flops_per_step"]
    if rows["int8"]["flops_per_step"] != flops:
        raise AssertionError(f"the recipe's step counts {flops} in bf16 and {rows['int8']['flops_per_step']} in int8")
    for impl in ("xla", "int8"):
        ms = timed[impl]["step_ms"]
        log(f"  the recipe's train step at batch 48: {flops / 1e12:.4f} TFLOP (utils/flops.py, counted on the CPU at "
            f"batch 1); {'bf16' if impl == 'xla' else 'int8'} at the tool's {rows[impl]['ms_per_step']:.2f} ms "
            f"{rows[impl]['model_tflops_per_s']:.2f} TFLOP/s ({100e12 * rows[impl]['model_tflops_per_s'] / PEAK_BF16:.2f}"
            f" % of 989 TFLOP/s bf16), at 8d/8e's {ms:.2f} ms {flops / ms / 1e9:.2f} TFLOP/s")
    return runs


def phase14b_perf_breakdown(guided_parts: dict, guided_device: dict) -> dict:
    """``perf_breakdown.main`` at batch 8, bf16 (ADM-G 256 and its classifier,
    random weights): the row, the launches (each part 1 + 5 x ``BD_REPS``
    timed calls and 1 + 2 profiled) against the modules, each part's device
    ms against phase 6's profile of the same part (``guided_device``), its
    CUDA-event ms against phase 6's (``guided_parts``) logged. Returns the
    launch counts."""
    import torch

    from guided_diffusion_clip_tpu_torch import classifier_sample
    from guided_diffusion_clip_tpu_torch.tools import perf_breakdown
    from guided_diffusion_clip_tpu_torch.utils.script_util import args_to_dict, create_classifier, create_upstream_model

    args = classifier_sample.create_argparser().parse_args(GUIDED_FLAGS)
    with torch.device("meta"):
        unet = unet_counts(create_upstream_model(**args_to_dict(args, classifier_sample._UNET_KEYS)), False)
        clf = create_classifier(**args_to_dict(args, classifier_sample.classifier_defaults().keys()))
    pools = f32_attention_calls(clf)
    clf_fwd = {"attention": CLF_ATTN_PER_FORWARD, **gn_conv_counts(clf, False)}
    clf_grad = {**clf_fwd, "attention_bwd": CLF_ATTN_PER_FORWARD}
    calls = 1 + 5 * BD_REPS + 1 + 2  # a warm-up call and five runs in turns, kernel_times' warm-up and two
    row, launches, secs = run_counted(perf_breakdown.main, [str(BD_BATCH)], {"BD_REPS": str(BD_REPS)})
    check_row("perf_breakdown", row, [*BD_PARTS, *perf_breakdown.DEVICE_KEYS.values(), "batch",
                                      "per_sample_step_ms", "proj_samples_per_min_250"])
    # the parts: a UNet forward; a classifier forward; its forward and backward; the whole step (all of them)
    want = expected(launches, (calls, unet), (calls, clf_fwd), (calls, clf_grad), (calls, unet), (calls, clf_grad))
    want.update(attention_f32=3 * calls * pools, attention_bwd_f32=2 * calls * pools)
    log(f"  perf_breakdown {BD_BATCH}: {row} ({secs:.1f} s in all); launches {launches} (expected {want}: "
        f"{calls} calls a part)")
    if launches != want or row["card"] != smi() or row["batch"] != BD_BATCH:
        raise AssertionError(f"perf_breakdown: launches {launches} != {want}, or row {row}")
    ratios = {k: agreement(f"perf_breakdown {perf_breakdown.DEVICE_KEYS[k]}", row[perf_breakdown.DEVICE_KEYS[k]],
                           f"6's {v}", guided_device[v]) for k, v in BD_PARTS.items()}
    log("  perf_breakdown's CUDA-event ms against phase 6's, logged only (host-bound parts follow the host): " + ", ".join(
        f"{k} {row[k]:.2f}/{guided_parts[v]:.2f} = {row[k] / guided_parts[v]:.3f}" for k, v in BD_PARTS.items()))
    log(f"  device ratios {ratios}")
    return launches


def phase14c_serve_bench(tmp) -> dict:
    """``serve_bench.main`` at its headline (ADM-256, batch 8, ddim25, int8),
    3 requests a measure: the row, and the server's launches (its /healthz,
    from its own process) against its forwards and the modules. Returns them
    as ``tensor_core_split`` lays out a run's counts."""
    import torch

    from guided_diffusion_clip_tpu_torch import serve
    from guided_diffusion_clip_tpu_torch.tools import serve_bench
    from guided_diffusion_clip_tpu_torch.utils.script_util import args_to_dict, create_model_and_diffusion, model_and_diffusion_defaults

    args = serve.create_argparser().parse_args(serve_bench.model_flags(256, 256))
    with torch.device("meta"):
        model = create_model_and_diffusion(**args_to_dict(args, model_and_diffusion_defaults().keys()),
                                           conv_impl="int8")[0]
    per, thin = unet_counts(model, True), thin_convs(model)
    n_req = int(SB_ENV["SB_REQUESTS"])
    out, here, secs = run_counted(serve_bench.main, [], {**SB_ENV, "SB_CKPT_DIR": tmp})
    if any(here.values()):
        raise AssertionError(f"serve_bench launched kernels in this process, not its server's: {here}")
    server = out.pop("server")
    check_row("serve_bench", out, ("compile_to_healthy_s", "first_request_s", "warm_latency_best_s",
                                   "warm_latency_median_s", "sustained_sec_per_request", "requests_per_min",
                                   "samples_per_min"))
    got = server["kernel_launches"]
    launches = {k: v for k, v in got.items() if not k.endswith(("_mma", "_f32"))}
    forwards = server["forwards"]
    want = expected(launches, (forwards, per))
    log(f"  serve_bench: {out} ({secs:.1f} s in all); the server's /healthz: {server['dispatches']} chains, "
        f"{forwards} forwards, launches {got} (expected {want}: a forward {per})")
    # two warm-up chains, the first request, and n_req timed and n_req back-to-back ones, 25 steps each
    if (server["dispatches"] != 3 + 2 * n_req or forwards != 25 * server["dispatches"] or launches != want
            or got["attention_mma"] != got["attention"] or got["attention_f32"]
            or got["conv_s8"] != got["conv_s8_mma"] + got["conv_s8_thin"] or got["conv_s8_thin"] != forwards * thin
            or out["card"] != smi()):
        raise AssertionError(f"serve_bench: the server ran {server}, want {want}")
    return {**launches, "attention_f32": 0, "attention_bwd_f32": 0}


def phase14d_block_microbench() -> dict:
    """``block_microbench.main`` at its four shapes: the rows, and each row's
    1 + 3 x 20 calls' launches (K3 in bf16_block and gn_only, K4 in
    int8_block and gnq_only, K5 on the tensor cores in int8_block)."""
    from guided_diffusion_clip_tpu_torch.tools import block_microbench

    rows, launches, secs = run_counted(block_microbench.main, [], {"CMB_ITERS": "20"})
    for row in rows:
        check_row("block_microbench", row, [k for k in row if k not in ("shape", "card")])
    n = len(block_microbench.SHAPES) * 61
    want = expected(launches, (n, {"group_norm": 2, "group_norm_quant": 2, "conv_s8": 1}))
    want.update(attention_f32=0, attention_bwd_f32=0)
    log(f"  block_microbench ({secs:.1f} s): launches {launches} (expected {want})")
    if len(rows) != 4 or launches != want or any(r["card"] != smi() for r in rows):
        raise AssertionError(f"block_microbench: launches {launches} != {want}, or rows {rows}")
    check_conv_tensor_core_launches("block_microbench", 0)
    return launches


# ---------------------------------------------------------------------------
# Phase 15: the sampling benches (tools/int8_quality_check, sampler_family_bench, deep_cache_bench,
# guidance_interval_bench, sample_overlap_bench) through their main() at a cut depth
# ---------------------------------------------------------------------------

PHASE15_BATCH, PHASE15_STEPS = 4, 10
PHASE15_ENV = {  # int8 is every tool's default
    "SFB": {"SFB_BATCH": str(PHASE15_BATCH), "SFB_SAMPLERS": f"ddim{PHASE15_STEPS};dpm{PHASE15_STEPS};"
            f"ancestral{PHASE15_STEPS}"},
    "SFB_CFG": {"SFB_BATCH": str(PHASE15_BATCH), "SFB_SAMPLERS": f"ddim{PHASE15_STEPS}", "SFB_GUIDANCE": "cfg",
                "SFB_CFG_CACHE": "2"},
    # N = 1 refreshes every step and the window [0, 1000] holds every step: each repeats its tool's reference chain
    "DCB": {"DCB_BATCH": str(PHASE15_BATCH), "DCB_STEPS": str(PHASE15_STEPS), "DCB_INTERVALS": "1,2,5"},
    "GIB": {"GIB_BATCH": str(PHASE15_BATCH), "GIB_STEPS": str(PHASE15_STEPS), "GIB_WINDOWS": "0,1000;200,800"},
    "OB": {"OB_BATCH": str(PHASE15_BATCH), "OB_BATCHES": "1"},
}


def adm_g_counts(int8: bool) -> dict:
    """Launches of one call of each network of ADM-G 256 and its classifier
    (``GUIDED_FLAGS``), from the modules: ``full`` and ``shallow`` UNet
    forwards (the default DeepCache cut), ``clf`` a classifier forward and
    backward; ``pools`` its float32 attention pools; ``thin`` each call's
    convs on ``conv_s8_thin.cu`` under int8."""
    import torch

    from guided_diffusion_clip_tpu_torch import classifier_sample
    from guided_diffusion_clip_tpu_torch.utils.script_util import args_to_dict, create_classifier, create_upstream_model

    args = classifier_sample.create_argparser().parse_args(GUIDED_FLAGS)
    impl = "int8" if int8 else "auto"
    with torch.device("meta"):
        model = create_upstream_model(**args_to_dict(args, classifier_sample._UNET_KEYS), conv_impl=impl)
        clf = create_classifier(**args_to_dict(args, classifier_sample.classifier_defaults().keys()), conv_impl=impl)
    cut = model.config.num_res_blocks + 1
    return {
        "full": unet_counts(model, int8), "shallow": unet_counts(model, int8, cut),
        "clf": {"attention": CLF_ATTN_PER_FORWARD, "attention_bwd": CLF_ATTN_PER_FORWARD, **gn_conv_counts(clf, int8)},
        "pools": f32_attention_calls(clf),
        "thin": {"full": thin_convs(model), "shallow": thin_convs(shallow_roots(model, cut)), "clf": thin_convs(clf)}
        if int8 else {"full": 0, "shallow": 0, "clf": 0},
    }


def check_bench(tool: str, launches: dict, calls: list, counts: dict) -> dict:
    """A tool's launches against the networks' calls: ``calls`` holds (int8,
    {"full": n, "shallow": n, "clf": n}) for each conv path the run took,
    ``counts`` ``adm_g_counts`` by int8. Checks the tensor-core split too
    (read from the live counters, so right after the run). Returns
    ``launches``."""
    terms, pools, thin = [], 0, 0
    for int8, n in calls:
        c = counts[int8]
        terms += [(n.get(k, 0), c[k]) for k in ("full", "shallow", "clf")]
        pools += c["pools"] * n.get("clf", 0)
        thin += sum(c["thin"][k] * n.get(k, 0) for k in ("full", "shallow", "clf"))
    want = expected(launches, *terms)
    want.update(attention_f32=pools, attention_bwd_f32=pools)
    log(f"  {tool}: launches {launches} (expected {want}: network calls {calls})")
    if launches != want:
        raise AssertionError(f"{tool}: launch counts {launches} != {want}")
    check_tensor_core_launches(tool, pools, pools)
    check_conv_tensor_core_launches(tool, thin)
    return launches


def check_bench_row(tool: str, row: dict, keys, deviation=None) -> None:
    """``check_row`` for each of ``row``'s nested rows (or the row itself),
    and its card the one ``nvidia-smi`` names. ``deviation`` is (the key of
    the samples' rel_rmse against the reference chain's, the row that
    repeats the reference chain): that row's rel_rmse must be exactly 0, so
    the chain is repeatable bit for bit on the card, and every other row's
    above it."""
    nested = {k: v for k, v in row.items() if isinstance(v, dict)} or {"": row}
    for name, r in nested.items():
        check_row(tool, r, [k for k in keys if deviation is None or name != deviation[1] or k != deviation[0]])
    if deviation is not None:
        key, repeat = deviation
        if nested[repeat][key] != 0 or any(not r[key] > 0 for name, r in nested.items() if name != repeat):
            raise AssertionError(f"{tool}: {key} of {repeat} (the reference chain again) is not 0, or another "
                                 f"chain's is not above it: {row}")
    if row["card"] != smi():
        raise AssertionError(f"{tool}: card {row['card']!r} is not {smi()!r}")


def phase15_sampling_benches() -> list:
    """The five sampling benches through their ``main()`` (see the module's
    docstring): each row, its launches against the modules and the
    schedule, the cached and windowed chains' samples against their
    reference chains' (``check_bench_row``'s ``deviation``: the reference
    chain run again equal bit for bit, the others not). Returns each run's
    launch counts."""
    from guided_diffusion_clip_tpu_torch.tools import (
        deep_cache_bench, guidance_interval_bench, int8_quality_check, sample_overlap_bench, sampler_family_bench,
    )
    from guided_diffusion_clip_tpu_torch.utils.script_util import create_gaussian_diffusion

    T, counts = PHASE15_STEPS, {int8: adm_g_counts(int8) for int8 in (False, True)}
    tmap = create_gaussian_diffusion(steps=1000, learn_sigma=True,
                                     timestep_respacing=str(T)).sched.timestep_map.tolist()
    inside = sum(200 <= tmap[T - 1 - i] <= 800 for i in range(T))  # step i runs local timestep T - 1 - i
    log(f"  {inside} of the {T} steps lie inside the window [200, 800] (model timesteps {tmap[::-1]})")
    refreshes = {n: len(range(0, T, n)) for n in (1, 2, 5)}  # DeepCache's full forwards a chain at N = 1, 2 and 5
    chain_keys = ("secs_per_chain", "samples_per_min_per_chip", "steps", "peak_memory_gib")
    # (label, main, argv, env, the keys of each row, (the deviation's key, the row repeating the reference chain),
    # the networks' calls: each chain runs twice)
    benches = [
        ("15a int8_quality_check at batch 1", int8_quality_check.main, ["1"], None,
         ("rel_rmse_vs_signal_std", "max_abs_rel", "corr"), None,
         [(False, {"full": 1, "clf": 1}), (True, {"full": 1, "clf": 1})]),
        ("15b sampler_family_bench, classifier", sampler_family_bench.main, [], PHASE15_ENV["SFB"], chain_keys, None,
         [(True, {"full": 2 * 3 * T, "clf": 2 * 3 * T})]),
        # the conditional branch every step, the unconditional one on the steps 0, 2, ...
        ("15b sampler_family_bench, cfg with its cache 2", sampler_family_bench.main, [], PHASE15_ENV["SFB_CFG"],
         chain_keys, None, [(True, {"full": 2 * (T + len(range(0, T, 2)))})]),
        ("15c deep_cache_bench", deep_cache_bench.main, [], PHASE15_ENV["DCB"],
         ("samples_per_min", "secs_per_chain", "speedup", "corr", "rel_rmse"), ("rel_rmse", "dc1"),
         [(True, {"full": 2 * (T + sum(refreshes.values())), "shallow": 2 * sum(T - r for r in refreshes.values()),
                  "clf": 2 * 4 * T})]),
        ("15d guidance_interval_bench", guidance_interval_bench.main, [], PHASE15_ENV["GIB"],
         ("samples_per_min", "secs_per_chain", "speedup", "corr_vs_full_context_only", "rel_rmse_vs_full"),
         ("rel_rmse_vs_full", "interval[0,1000]"), [(True, {"full": 2 * 3 * T, "clf": 2 * (2 * T + inside)})]),
        # six ddim25 chains: the warm-up, the host-only write's, two serial and two overlapped
        ("15e sample_overlap_bench", sample_overlap_bench.main, [], PHASE15_ENV["OB"],
         ("host_s", "serial_a", "overlap_a", "overlap_b", "serial_b", "serial", "overlapped"), None,
         [(True, {"full": 6 * 25})]),
    ]
    runs = []
    for label, main, argv, env, keys, deviation, calls in benches:
        row, launches, secs = run_counted(main, argv, env)
        tool = main.__module__.rsplit(".", 1)[1]
        check_bench_row(tool, row, keys, deviation)
        log(f"  {label} ({secs:.1f} s): {row}")
        if main is sampler_family_bench.main and {r["steps"] for r in row.values() if isinstance(r, dict)} != {T}:
            raise AssertionError(f"sampler_family_bench: steps {row}")
        runs.append(check_bench(tool, launches, calls, counts))
    return runs


# ---------------------------------------------------------------------------
# Phase 16: the quality tools (tools/_proxies.py's blob proxies, trained on the
# card), each through its main() at a cut depth
# ---------------------------------------------------------------------------

PHASE16_TRAIN = 24  # train steps of each proxy (the tools' 400 and 600 cut)
PHASE16_STEPS = 10  # respaced steps a chain (the tools' 100 and 250 cut)
# one batch a set of 36 images: a 32-d feature covariance of fewer samples is singular, and the Frechet
# distance's sqrtm refuses it, as the evaluator's does
PHASE16_BATCH = 36
PHASE16_ENV = {
    "int8_chain_quality": {"INT8Q_TRAIN_STEPS": str(PHASE16_TRAIN), "INT8Q_SAMPLES": str(PHASE16_BATCH),
                           "INT8Q_BATCH": str(PHASE16_BATCH), "INT8Q_RESPACING": str(PHASE16_STEPS),
                           "INT8Q_FEAT_STEPS": "20", "INT8Q_VARIANT": "int8+dc5+gc2"},
    "guidance_quality_sweep": {"GQS_TRAIN_STEPS": str(PHASE16_TRAIN), "GQS_SAMPLES": str(PHASE16_BATCH),
                               "GQS_BATCH": str(PHASE16_BATCH), "GQS_RESPACING": str(PHASE16_STEPS),
                               "GQS_FEAT_STEPS": "20", "GQS_SWEEP": "off:gc1,200:800:gc2"},
    "opt_long_horizon": {"OLH_STEPS": str(PHASE16_TRAIN), "OLH_BATCH": "16"},
}
# the keys of the JAX tools' lines (tools/int8_chain_quality.py:431-448, guidance_quality_sweep.py:257-306,
# opt_long_horizon.py:86-109 at OLH_IMPLS tree,flat,zero1)
PHASE16_KEYS = {
    "int8_chain_quality": {"config", "variant", "same_seed_pixel_corr_mean", "same_seed_pixel_corr_min",
                           "same_seed_rel_rmse_mean", "same_seed_rel_rmse_max", "set_frechet",
                           "feat_extractor_final_loss", "posctrl_separated", "variant_within_floor", "wall_s"},
    "guidance_quality_sweep": {"config", "feat_extractor_final_loss", "floor_real_vs_real", "sweep",
                               "unguided_frechet_to_real_mean", "unguided_classifier_acc", "wall_s"},
    "opt_long_horizon": {"config", "impls", "tree_final_third_loss_mean", "tree_step_noise_sd",
                         *(f"{i}_{k}" for i in ("flat", "zero1")
                           for k in ("final_third_loss_mean", "mean_abs_delta_vs_tree", "delta_over_step_noise",
                                     "mean_diff_in_sems"))},
}


def proxy_counts(size: int) -> dict:
    """Launches of one call of each network of the quality tools' proxies at
    ``size`` px, from the modules (built on ``meta``): ``train`` a float32
    generator train step, ``clf_train`` a classifier train step, ``full``
    and ``shallow`` bf16 or int8 generator forwards (the default DeepCache
    cut), ``clf`` a guidance call of the float32 classifier (forward and
    backward; xla or int8), ``clf_fwd`` its forward alone; ``attn`` the
    classifier's attention blocks (float32: the float32 tensor-core kernels), ``thin``
    each int8 call's convs on ``conv_s8_thin.cu``."""
    import torch

    from guided_diffusion_clip_tpu_torch.models.unet import AttentionBlock, EncoderUNetModel, UNetModel
    from guided_diffusion_clip_tpu_torch.tools import _proxies as P

    with torch.device("meta"):
        gen = {impl: UNetModel(P.generator_config(size), conv_impl=impl) for impl in ("auto", "int8")}
        clf = {impl: EncoderUNetModel(P.classifier_config(size), pool="adaptive", conv_impl=impl)
               for impl in ("auto", "int8")}
    cut = gen["auto"].config.num_res_blocks + 1
    attn = sum(isinstance(m, AttentionBlock) for m in clf["auto"].modules())
    out = {"train": train_counts(gen["auto"], False), "clf_train": clf_train_counts(clf["auto"]),
           "clf_fwd": {"attention": attn, **gn_conv_counts(clf["auto"], False)}, "attn": attn}
    for int8, impl in ((False, "auto"), (True, "int8")):
        tag = "int8" if int8 else "xla"
        out[f"full_{tag}"] = unet_counts(gen[impl], int8)
        out[f"shallow_{tag}"] = unet_counts(gen[impl], int8, cut)
        out[f"clf_{tag}"] = {"attention": attn, "attention_bwd": attn, **gn_conv_counts(clf[impl], int8)}
    out["thin"] = {"full": thin_convs(gen["int8"]), "shallow": thin_convs(shallow_roots(gen["int8"], cut)),
                   "clf": thin_convs(clf["int8"])}
    return out


def finite_numbers(tool: str, value, path: str = "") -> None:
    """Every number in ``value`` (nested dicts and lists) finite."""
    if isinstance(value, dict):
        for k, v in value.items():
            finite_numbers(tool, v, f"{path}.{k}")
    elif isinstance(value, list):
        for i, v in enumerate(value):
            finite_numbers(tool, v, f"{path}[{i}]")
    elif isinstance(value, (int, float)) and not isinstance(value, bool) and not math.isfinite(value):
        raise AssertionError(f"{tool}: {path} is {value}")


def phase16_quality_tools() -> list:
    """The quality tools through their ``main()`` (see the module's
    docstring): each row's keys the JAX tool's plus ``card``, every number
    finite, the card the one ``nvidia-smi`` names, and the launches equal to
    those derived from the modules, the train steps and the schedule.
    Returns each run's launch counts."""
    from guided_diffusion_clip_tpu_torch.tools import guidance_quality_sweep, int8_chain_quality, opt_long_horizon
    from guided_diffusion_clip_tpu_torch.utils.script_util import create_gaussian_diffusion

    n, T = PHASE16_TRAIN, PHASE16_STEPS
    small, big = proxy_counts(16), proxy_counts(64)
    tmap = create_gaussian_diffusion(steps=1000, noise_schedule="cosine",
                                     timestep_respacing=str(T)).sched.timestep_map.tolist()
    # the window's cached gradient: refreshed on the steps 0, 2, ..., computed where step i's model timestep
    # tmap[T - 1 - i] lies in [200, 800]
    windowed = sum(200 <= tmap[T - 1 - i] <= 800 for i in range(0, T, 2))
    log(f"  guidance_quality_sweep's 200:800:gc2 runs the classifier on {windowed} of its {T} steps "
        f"(model timesteps {tmap[::-1]})")
    refresh, cached = len(range(0, T, 5)), len(range(0, T, 2))  # int8+dc5+gc2's full forwards, classifier calls
    # (terms: (n, counts) of each network's calls; float32 K1 calls: training and the classifier)
    plans = {
        # training (generator, classifier), 4 base-chain sets (a, b, c, the positive control), the variant
        "int8_chain_quality": (
            [(n, small["train"]), (n, small["clf_train"]), (4 * T, small["full_xla"]), (4 * T, small["clf_xla"]),
             (refresh, small["full_int8"]), (T - refresh, small["shallow_int8"]), (cached, small["clf_int8"])],
            n * (small["train"]["attention"] + small["attn"]) + (4 * T + cached) * small["attn"],
            refresh * small["thin"]["full"] + (T - refresh) * small["thin"]["shallow"] + cached * small["thin"]["clf"]),
        # training, two sweep points and the unguided set (T generator forwards each), their guidance, the
        # classifier's accuracy on each set (one forward of the batch)
        "guidance_quality_sweep": (
            [(n, big["train"]), (n, big["clf_train"]), (3 * T, big["full_xla"]), (T + windowed, big["clf_xla"]),
             (3, big["clf_fwd"])],
            n * (big["train"]["attention"] + big["attn"]) + (T + windowed + 3) * big["attn"], 0),
        # three layouts' training
        "opt_long_horizon": ([(3 * n, small["train"])], 3 * n * small["train"]["attention"], 0),
    }
    runs = []
    for main in (int8_chain_quality.main, guidance_quality_sweep.main, opt_long_horizon.main):
        tool = main.__module__.rsplit(".", 1)[1]
        row, launches, secs = run_counted(main, [], PHASE16_ENV[tool])
        log(f"  {tool} ({secs:.1f} s): {json.dumps(row)}")
        if set(row) != PHASE16_KEYS[tool] | {"card"} or row["card"] != smi():
            raise AssertionError(f"{tool}: keys {sorted(row)} (want the JAX tool's and card), card {row['card']!r}")
        finite_numbers(tool, row)
        terms, k1_f32, thin = plans[tool]
        want = expected(launches, *terms)
        want.update(attention_f32=k1_f32, attention_bwd_f32=want["attention_bwd"])
        log(f"  {tool}: launches {launches} (expected {want})")
        if launches != want:
            raise AssertionError(f"{tool}: launch counts {launches} != {want}")
        check_tensor_core_launches(tool, k1_f32, want["attention_bwd"])
        check_conv_tensor_core_launches(tool, thin)
        runs.append(launches)
    return runs


# ---------------------------------------------------------------------------
# Phase 17: spatial partitioning (--spatial_shard 2, parallel/sp.py). The
# card's machine has one GPU and NCCL refuses two ranks on one device, so the
# phase starts two processes itself (torch.multiprocessing, gloo), both on
# cuda:0, after this process has built the kernels: a test arrangement only
# (the CLIs keep one GPU a rank and NCCL). Each rank holds half of every
# image's rows; each output is held to the same model unsharded on the card.
# Two processes share one card and gloo stages through the host: the times
# are recorded, not claimed.
# ---------------------------------------------------------------------------

SP_BATCH = 2  # the serving model's batch
# bounds on each comparison's reading (rel L2 of the rank's rows against the unsharded run's), set from the
# readings and from a fault on one rank, both logged beside each bound (on an NVIDIA H100 80GB HBM3 at 700 W:
# f32 1.8e-7 against 8.2e-4 under K3's stats x 1.01 and 5.4e-3 under a dropped halo row; bf16 6.6e-4 against
# 1.2e-3 and 5.4e-3, bf16's roundings hiding the 1 % stats fault; the bf16 classifier's gradient 9.2e-3-9.9e-3
# against 1.1e-2 and 5.2e-2-9.8e-2; in f32 (TF32 off) 4.6e-7 against 3.6e-3 under the stats fault; PERF.md)
SP_BOUNDS = {"f32": 1e-5, "bf16": 2e-3, "guidance": 2e-2, "guidance f32": 1e-5}
# the fault each comparison is run under (with both, bf16's and the gradient's roundings hid the 1 % stats
# fault, and a dropped halo row showed in all); the f32 gradient holds the split GroupNorm's backward (its sums
# all-reduced) to K3's statistics
SP_FAULTS = {"f32": "stats", "bf16": "halo", "int8": "stats", "guidance": "halo", "guidance f32": "stats"}
# the sharded bf16 train step against the world-1 step on the card (the same run: gradient 2.18e-3, grad_norm
# 1.4e-4, updated params 6.9e-6, the attention groups 2.2e-3-2.4e-3, the GroupNorms 2.0e-4, the loss equal;
# under K3's stats x 1.01 on rank 1: 6.8e-3, 1.0e-3, 5.3e-5, 2.4e-2-2.6e-2, 5.5e-3, 1.4e-6)
SP_TRAIN_TOL = {"loss": 1e-5, "grad_norm": 5e-4, "updated params": 2e-5, "gradient": 4e-3,
                "gradient, attention qkv, norm": 1e-2, "gradient, attention proj_out": 1e-2,
                "gradient, GroupNorms": 1e-3}


def sp_unet(dev, dtype: str, conv_impl: str = "xla"):
    """The fork's CLIP UNet at ADM-256's widths (phase 4's), N(0, 0.02)
    weights filled on the card (``tools/_timing.built_on``)."""
    from guided_diffusion_clip_tpu_torch.tools._timing import built_on
    from guided_diffusion_clip_tpu_torch.utils.script_util import create_model

    def factory():
        return create_model(256, 256, 2, learn_sigma=True, class_cond=True, attention_resolutions="32,16,8",
                            num_head_channels=64, use_scale_shift_norm=True, resblock_updown=True,
                            use_fp16=dtype == "bf16", conv_impl=conv_impl)

    return built_on(factory, dev, WEIGHT_SEED).eval().requires_grad_(False)


def sp_classifier(dev, use_fp16: bool = True):
    """ADM-G 256's 128-wide classifier (GUIDED_FLAGS), bf16 torso (or f32),
    its pool in f32."""
    from guided_diffusion_clip_tpu_torch.tools._timing import built_on
    from guided_diffusion_clip_tpu_torch.utils.script_util import create_classifier

    return built_on(lambda: create_classifier(
        image_size=256, classifier_use_fp16=use_fp16, classifier_width=128, classifier_depth=2,
        classifier_attention_resolutions="32,16,8", classifier_use_scale_shift_norm=True,
        classifier_resblock_updown=True, classifier_pool="attention"), dev, 1).eval().requires_grad_(False)


def sp_counts(model, int8: bool, backward: bool = False) -> dict:
    """The launches of one sharded forward of ``model`` (and with
    ``backward`` its K2s), from its modules: every attention block and the
    attention pool run K1 (and K2) whole on the gathered map, so their
    norms stay one K3 launch each; every other GroupNorm runs the split
    entries (stats, then K3's apply or, quantizing, K4's); under int8 every
    conv runs K5 (the stems and heads on its thin kernels, on the halo'd
    shard) and every conv that no K4 feeds quantizes its input by the split
    quantize entries."""
    from guided_diffusion_clip_tpu_torch.models.nn import Conv2d, GroupNorm32
    from guided_diffusion_clip_tpu_torch.models.unet import AttentionBlock, AttentionPool2d, ResBlock

    mods = list(model.modules())
    blocks = sum(isinstance(m, AttentionBlock) for m in mods)
    attn = blocks + sum(isinstance(m, AttentionPool2d) for m in mods)
    split = sum(isinstance(m, GroupNorm32) for m in mods) - blocks
    out = {"attention": attn, "group_norm": blocks, "group_norm_stats": split, "group_norm_apply": split}
    if backward:
        out["attention_bwd"] = attn
    if int8:
        k4 = sum(1 if m.down else 2 for m in mods if isinstance(m, ResBlock))
        convs = sum(isinstance(m, Conv2d) for m in mods)
        out.update(group_norm_apply=split - k4, group_norm_quant_apply=k4, conv_s8=convs,
                   conv_s8_thin=thin_convs(model), quantize_amax=convs - k4, quantize_apply=convs - k4)
    return out


@contextlib.contextmanager
def sp_fault(kind, rank: int):
    """A fault on rank 1 for the phase's comparisons to catch: ``stats``
    scales the sums of K3's and K4's stats entry by 1.01, ``halo`` drops the
    first halo row a conv receives (zeros in its place)."""
    from guided_diffusion_clip_tpu_torch.ops import groupnorm as G
    from guided_diffusion_clip_tpu_torch.parallel import sp

    if kind is None or rank != 1:
        yield
        return
    name, orig = {"stats": ("group_norm_stats", G.group_norm_stats), "halo": ("halo", sp.halo)}[kind]
    if kind == "stats":
        def faulty(x, groups, minmax=False):
            sums, ext = orig(x, groups, minmax)
            return sums * 1.01, ext
        mod = G
    else:
        def faulty(x, above, below):
            out = orig(x, above, below)
            if above:
                out = out.clone()
                out[:, :, 0] = 0
            return out
        mod = sp
    setattr(mod, name, faulty)
    try:
        yield
    finally:
        setattr(mod, name, orig)


def rel_l2(a, b) -> float:
    return ((a.float() - b.float()).norm() / b.float().norm()).item()


def phase17_child(rank: int, port: int, tmp: str) -> None:
    """One of phase 17's two ranks on cuda:0 (gloo)."""
    import torch
    import torch.distributed as dist

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from guided_diffusion_clip_tpu_torch.diffusion.guidance import classifier_cond_fn
    from guided_diffusion_clip_tpu_torch.ops import build
    from guided_diffusion_clip_tpu_torch.parallel import sp

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank, world_size=2)
    build.load()
    tf32_off()
    sp.set_spatial_sharding(2)
    dev = torch.device("cuda", 0)
    out = {"readings": {}, "ms": {}, "launches": [], "want": []}
    g = torch.Generator(device=dev).manual_seed(17)
    x = torch.randn(SP_BATCH, 3, 256, 256, generator=g, device=dev).contiguous(memory_format=torch.channels_last)
    t = torch.tensor([3, 700], device=dev)
    feat = torch.randn(SP_BATCH, 512, generator=g, device=dev)
    h = 256 // 2
    xs = x[:, :, h * rank:h * (rank + 1)].contiguous(memory_format=torch.channels_last)
    rows = sp.shard_rows

    def counted(fn, want):
        """``fn()`` with the counts set to 0 just before and read just after."""
        reset_counters()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        res = fn()
        end.record()
        end.synchronize()
        got = tensor_core_split(counters())
        out["launches"].append(got)
        out["want"].append(want)
        bad = {k: (got.get(k), v) for k, v in want.items() if got.get(k) != v}
        if bad or got["group_norm_quant"] or got["quantize"]:
            raise AssertionError(f"rank {rank}: launches (got, planned) {bad}; unsplit K4 {got['group_norm_quant']}, "
                                 f"unsplit quantize {got['quantize']}")
        return res, start.elapsed_time(end)

    with torch.no_grad():
        for case, dtype, impl in (("f32", "f32", "xla"), ("bf16", "bf16", "xla"), ("int8", "bf16", "int8")):
            model = sp_unet(dev, dtype, impl)
            forcing = Int8Forcing(1e-3, rows=rows, strict=False)
            with sp.whole():  # the same model unsharded: every SP hook the identity
                if impl == "int8":
                    with forcing.record(model):
                        ref = model(x, t, clip_feat=feat)
                else:
                    ref = model(x, t, clip_feat=feat)
                whole_ms = cuda_ms(lambda: model(x, t, clip_feat=feat), runs=1, warmup=0)
            reading = {}
            for fault in (None, SP_FAULTS[case]):
                with sp_fault(fault, rank), contextlib.ExitStack() as stack:
                    if impl == "int8":
                        stack.enter_context(forcing.force(model))
                    run = lambda: model(xs, t, clip_feat=feat)  # noqa: E731
                    got, ms = counted(run, sp_counts(model, impl == "int8")) if fault is None else (run(), None)
                reading[fault or "clean"] = forcing.worst if impl == "int8" else rel_l2(got, rows(ref))
                if fault is None:
                    out["ms"][case] = (ms, whole_ms)
                    if not torch.isfinite(got).all() or tuple(got.shape) != (SP_BATCH, 6, h, 256):
                        raise AssertionError(f"rank {rank} {case}: output {tuple(got.shape)} not finite")
                    if impl == "int8":
                        reading["head rel L2"] = rel_l2(got, rows(ref))
            out["readings"][case] = reading
            del model, ref, got
            torch.cuda.empty_cache()

        y = torch.tensor([1, 500], device=dev)
        for case, use_fp16 in (("guidance", True), ("guidance f32", False)):
            clf = sp_classifier(dev, use_fp16)
            cond = classifier_cond_fn(lambda u, tt: clf(u, tt), 1.0)
            with sp.whole():
                ref = cond(x, t, y=y)
                whole_ms = cuda_ms(lambda: cond(x, t, y=y), runs=1, warmup=0)
            reading = {}
            for fault in (None, SP_FAULTS[case]):
                with sp_fault(fault, rank):
                    if fault is None:
                        got, ms = counted(lambda: cond(xs, t, y=y), sp_counts(clf, False, backward=True))
                        out["ms"][case] = (ms, whole_ms)
                    else:
                        got = cond(xs, t, y=y)
                reading[fault or "clean"] = rel_l2(got, rows(ref))
            out["readings"][case] = reading
            del clf, cond

    # one bf16 train step of the recipe at batch 48 under DDP (world 2, SP 2), and with the stats fault
    import numpy as np

    sd = torch.load(os.path.join(tmp, "recipe_sd.pt"), weights_only=True)
    xb, cb = recipe_batch(TRAIN_BATCH, seed=1)
    noise = torch.randn(TRAIN_BATCH, 3, 128, 128, generator=torch.Generator().manual_seed(3))
    for fault in (None, "stats"):
        with sp_fault(fault, rank):
            reset_counters()
            step = train_step_on(dev, sd, xb, cb, noise, os.path.join(tmp, f"sp_step_{fault}_{rank}"), use_fp16=True)
            launches = tensor_core_split(counters())
        if fault is None:
            if not (launches["group_norm_stats"] and launches["group_norm_apply"] and launches["attention_bwd"]):
                raise AssertionError(f"rank {rank}: the sharded train step launched {launches}")
            out["launches"].append(launches)
            out["ms"]["train step"] = (1e3 * step["secs"], None)
        if rank == 0:
            step["met"] = {k: np.asarray(v) for k, v in step["met"].items()}
            torch.save(step, os.path.join(tmp, f"sp_step_{fault}.pt"))
    torch.save(out, os.path.join(tmp, f"sp_rank{rank}.pt"))
    sp.clear_spatial_sharding()
    phase18_child(rank, dev, tmp, x, t, feat, y)
    dist.barrier()
    dist.destroy_process_group()


# ---------------------------------------------------------------------------
# Phase 18: tensor parallelism (--tensor_shard 2, parallel/tp.py), inside phase
# 17's two processes on cuda:0 (gloo), after their SP cases: the same test
# arrangement, no second start-up or kernel load. Each rank holds half of every
# activation's channels; each output is held to the same model unsharded on
# the card (``tp.whole()``). The times are recorded, not claimed.
# ---------------------------------------------------------------------------

# bounds on each comparison's reading (rel L2 of the rank's output against the unsharded run's), SP_BOUNDS's
# values, which the readings and the faults below bear out (on an NVIDIA H100 80GB HBM3 at 700 W: f32 1.7e-7
# against 1.1e-3 under K3's statistics x 1.01; bf16 6.5e-4 against 7.4e-2 with one ResBlock's scale and shift
# swapped; the bf16 classifier's gradient 5.7e-3 against 5.3e-2; in f32 5.1e-7 against 5.1e-3; PERF.md). The
# train step is held to SP_TRAIN_TOL: its readings are SP's (gradient 2.0e-3, under the stats fault 7.6e-3).
TP_BOUNDS = {"f32": 1e-5, "bf16": 2e-3, "guidance": 2e-2, "guidance f32": 1e-5}
# the fault each comparison is run under on rank 1: K3's statistics x 1.01 (``stats``), the scale and shift
# slices of one ResBlock's emb projection swapped (``scale_shift``), K4's per-image bound left unreduced
# (``bound``: the all-reduce runs, its result is dropped)
TP_FAULTS = {"f32": "stats", "bf16": "scale_shift", "int8": "bound", "guidance": "scale_shift",
             "guidance f32": "stats", "train step": "stats"}
TP_FAULT_NAMES = {"stats": "K3's statistics x 1.01", "scale_shift": "one ResBlock's scale and shift swapped",
                  "bound": "K4's per-image bound unreduced"}


def tp_counts(model, int8: bool, backward: bool = False) -> dict:
    """The launches of one forward of ``model`` under TP 2 (and with
    ``backward`` its K2s), from its modules: K1 once for every attention
    block (on the rank's heads where two divide them, else whole) and the
    attention pool (whole); K3 once for every GroupNorm (on the rank's 16
    whole groups, or whole on a gathered head); under int8 every ResBlock's
    quantizing GroupNorm runs K4 split at its statistics (the stats entry,
    then the quant-apply entry, no unsplit K4), every conv runs K5 once (on
    the rank's output channels, or whole: the head; the stems and heads on
    its thin kernels), and every conv that no K4 feeds quantizes its gathered
    input with the quantize kernels."""
    from guided_diffusion_clip_tpu_torch.models.nn import Conv2d, GroupNorm32
    from guided_diffusion_clip_tpu_torch.models.unet import AttentionBlock, AttentionPool2d, ResBlock

    mods = list(model.modules())
    attn = sum(isinstance(m, (AttentionBlock, AttentionPool2d)) for m in mods)
    gn = sum(isinstance(m, GroupNorm32) for m in mods)
    out = {"attention": attn, "group_norm": gn, "group_norm_quant": 0, "group_norm_stats": 0, "group_norm_apply": 0,
           "group_norm_quant_apply": 0, "quantize_amax": 0, "quantize_apply": 0}
    if backward:
        out["attention_bwd"] = attn
    if int8:
        k4 = sum(1 if m.down else 2 for m in mods if isinstance(m, ResBlock))
        convs = sum(isinstance(m, Conv2d) for m in mods)
        out.update(group_norm=gn - k4, group_norm_stats=k4, group_norm_quant_apply=k4, conv_s8=convs,
                   conv_s8_thin=thin_convs(model), quantize=convs - k4)
    return out


def tp_heads(model) -> list:
    """(heads of the block, heads a rank) of every attention block of
    ``model`` under TP 2, in order."""
    from guided_diffusion_clip_tpu_torch.models.unet import AttentionBlock

    return [(m.num_heads, m.num_heads // 2 if m.num_heads % 2 == 0 else m.num_heads)
            for m in model.modules() if isinstance(m, AttentionBlock)]


@contextlib.contextmanager
def tp_fault(kind, rank: int, model=None):
    """A fault on rank 1 for phase 18's comparisons to catch (``TP_FAULTS``):
    ``stats`` runs K3 as its split entries with the sums x 1.01, ``bound``
    drops the all-reduced per-image bound of K4 for the local one, and
    ``scale_shift`` swaps the scale and shift slices of ``model``'s last
    scale-shift ResBlock."""
    import torch

    from guided_diffusion_clip_tpu_torch.models.unet import ResBlock
    from guided_diffusion_clip_tpu_torch.ops import groupnorm as G
    from guided_diffusion_clip_tpu_torch.parallel import tp

    if kind is None or rank != 1:
        yield
        return
    if kind == "scale_shift":
        block = [m for m in model.modules() if isinstance(m, ResBlock) and m.use_scale_shift_norm][-1]
        clean = block._emb_out

        def swapped(emb, channels):
            scale, shift = clean(emb, channels).chunk(2, dim=1)
            return torch.cat([shift, scale], dim=1)

        block._emb_out = swapped
        try:
            yield
        finally:
            del block._emb_out
        return
    if kind == "stats":
        mod, name = G, "_fused_group_norm_stats"

        def faulty(x, scale, bias, groups, eps, silu, scale_shift):
            sums, _ = G.group_norm_stats(x, groups)
            mean, rstd, a, b = G._fold(sums * 1.01, x.numel() // (x.shape[0] * groups), scale, bias, groups, eps,
                                       scale_shift)
            return G.group_norm_apply(x, a, b, silu), torch.stack([mean, rstd])
    else:
        mod, name = tp, "reduce_max_"

        def faulty(t):
            local = t.clone()
            clean(t)
            return t.copy_(local)
    clean = getattr(mod, name)
    setattr(mod, name, faulty)
    try:
        yield
    finally:
        setattr(mod, name, clean)


@contextlib.contextmanager
def k1_heads(seen: list):
    """Append to ``seen`` the number of heads of each attention call in the
    block (the dispatcher that K1's wrapper sits under)."""
    from guided_diffusion_clip_tpu_torch.ops import attention as A

    clean = A._attention_fwd

    def spy(qkv, num_heads, new_order):
        seen.append(num_heads)
        return clean(qkv, num_heads, new_order)

    A._attention_fwd = spy
    try:
        yield
    finally:
        A._attention_fwd = clean


def phase18_child(rank: int, dev, tmp: str, x, t, feat, y) -> None:
    """Phase 18 on one of phase 17's two ranks: TP 2 over both (one data
    group), SP cleared. The forwards (f32 with TF32 off, bf16, int8
    teacher-forced on the rank's channels) of ADM-256's CLIP UNet at batch 2,
    the classifier's guidance gradient (bf16 and f32), one bf16 train step of
    the recipe at batch 48 under DDP; each against the same call unsharded
    (the train step against phase 17's world-1 step) and under its fault."""
    import numpy as np
    import torch

    from guided_diffusion_clip_tpu_torch.diffusion.guidance import classifier_cond_fn
    from guided_diffusion_clip_tpu_torch.parallel import tp

    t0 = time.perf_counter()
    tp.set_tensor_sharding(2)
    out = {"readings": {}, "ms": {}, "launches": [], "heads": None, "k1_heads": []}

    def counted(fn, want):
        reset_counters()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        res = fn()
        end.record()
        end.synchronize()
        got = tensor_core_split(counters())
        out["launches"].append(got)
        bad = {k: (got.get(k), v) for k, v in want.items() if got.get(k) != v}
        if bad:
            raise AssertionError(f"rank {rank} TP: launches (got, planned) {bad}")
        return res, start.elapsed_time(end)

    with torch.no_grad():
        for case, dtype, impl in (("f32", "f32", "xla"), ("bf16", "bf16", "xla"), ("int8", "bf16", "int8")):
            model = sp_unet(dev, dtype, impl)
            out["heads"] = tp_heads(model)
            forcing = Int8Forcing(1e-3, rows=tp.shard_channels, strict=False,
                                  whole_of=lambda u, ref: tp.gather_channels(u, ref.shape[1]))
            with tp.whole():  # the same model unsharded: every TP hook the identity
                if impl == "int8":
                    with forcing.record(model):
                        ref = model(x, t, clip_feat=feat)
                else:
                    ref = model(x, t, clip_feat=feat)
                whole_ms = cuda_ms(lambda: model(x, t, clip_feat=feat), runs=1, warmup=0)
            reading = {}
            for fault in (None, TP_FAULTS[case]):
                with tp_fault(fault, rank, model), contextlib.ExitStack() as stack:
                    if impl == "int8":
                        stack.enter_context(forcing.force(model))
                    elif fault is None and case == "bf16":  # the heads each K1 call takes
                        stack.enter_context(k1_heads(out["k1_heads"]))
                    run = lambda: model(x, t, clip_feat=feat)  # noqa: E731
                    got, ms = counted(run, tp_counts(model, impl == "int8")) if fault is None else (run(), None)
                reading[fault or "clean"] = forcing.worst if impl == "int8" else rel_l2(got, ref)
                if fault is None:
                    out["ms"][case] = (ms, whole_ms)
                    if not torch.isfinite(got).all() or tuple(got.shape) != (SP_BATCH, 6, 256, 256):
                        raise AssertionError(f"rank {rank} TP {case}: output {tuple(got.shape)} not finite")
                    if impl == "int8":
                        reading["head rel L2"] = rel_l2(got, ref)
            out["readings"][case] = reading
            del model, ref, got
            torch.cuda.empty_cache()

        for case, use_fp16 in (("guidance", True), ("guidance f32", False)):
            clf = sp_classifier(dev, use_fp16)
            cond = classifier_cond_fn(lambda u, tt: clf(u, tt), 1.0)
            with tp.whole():
                ref = cond(x, t, y=y)
                whole_ms = cuda_ms(lambda: cond(x, t, y=y), runs=1, warmup=0)
            reading = {}
            for fault in (None, TP_FAULTS[case]):
                with tp_fault(fault, rank, clf):
                    if fault is None:
                        got, ms = counted(lambda: cond(x, t, y=y), tp_counts(clf, False, backward=True))
                        out["ms"][case] = (ms, whole_ms)
                    else:
                        got = cond(x, t, y=y)
                reading[fault or "clean"] = rel_l2(got, ref)
            out["readings"][case] = reading
            del clf, cond

    sd = torch.load(os.path.join(tmp, "recipe_sd.pt"), weights_only=True)
    xb, cb = recipe_batch(TRAIN_BATCH, seed=1)
    noise = torch.randn(TRAIN_BATCH, 3, 128, 128, generator=torch.Generator().manual_seed(3))
    for fault in (None, TP_FAULTS["train step"]):
        with tp_fault(fault, rank):
            reset_counters()
            step = train_step_on(dev, sd, xb, cb, noise, os.path.join(tmp, f"tp_step_{fault}_{rank}"), use_fp16=True,
                                 tensor_shard=2)
            launches = tensor_core_split(counters())
        if fault is None:
            if not (launches["group_norm"] and launches["attention"] and launches["attention_bwd"]) or \
                    launches["group_norm_stats"]:
                raise AssertionError(f"rank {rank}: the TP train step launched {launches}")
            out["launches"].append(launches)
            out["ms"]["train step"] = (1e3 * step["secs"], None)
        if rank == 0:
            step["met"] = {k: np.asarray(v) for k, v in step["met"].items()}
            torch.save(step, os.path.join(tmp, f"tp_step_{fault}.pt"))
    tp.clear_tensor_sharding()
    out["seconds"] = time.perf_counter() - t0
    torch.save(out, os.path.join(tmp, f"tp_rank{rank}.pt"))


def phase18_check(tmp: str, ref) -> dict:
    """Phase 18's readings from both ranks against ``TP_BOUNDS`` and
    ``SP_TRAIN_TOL`` (``ref``: phase 17's world-1 train step); every fault
    must cross its bound on rank 1. Returns the run's launches (both
    ranks')."""
    import torch

    ranks = [torch.load(os.path.join(tmp, f"tp_rank{r}.pt"), weights_only=False) for r in range(2)]
    log(f"  phase 18 took {ranks[0]['seconds']:.1f} s on rank 0; attention blocks (heads, heads a rank): "
        f"{ranks[0]['heads']}; K1's heads a call in the bf16 forward: {ranks[0]['k1_heads']}")
    problems = []
    for r, res in enumerate(ranks):
        if res["k1_heads"] != [local for _, local in res["heads"]]:
            problems.append(f"rank {r}: K1 ran on {res['k1_heads']} heads, the modules give {res['heads']}")
    for case, bound in (*TP_BOUNDS.items(), ("int8", 1.0)):
        fault = TP_FAULTS[case]
        for r, res in enumerate(ranks):
            rd = res["readings"][case]
            ms, whole = res["ms"][case]
            unit = "worst ratio to its bound over the forced layers" if case == "int8" else "rel L2 vs unsharded"
            log(f"  TP rank {r} {case}: {unit} {rd['clean']:.3g} (bound {bound:g}); with {TP_FAULT_NAMES[fault]} on "
                f"rank 1 {rd[fault]:.3g}" + (f"; the unforced head's output rel L2 {rd['head rel L2']:.3g}"
                                             if case == "int8" else "")
                + f"; sharded {ms:.2f} ms, unsharded {whole:.2f} ms")
            if not rd["clean"] <= bound:
                problems.append(f"{case} on rank {r}: {rd['clean']:.3g} over its bound {bound:g}")
        if not ranks[1]["readings"][case][fault] > bound:
            problems.append(f"{case}: {TP_FAULT_NAMES[fault]} on rank 1 stays within the bound")
    fault = TP_FAULTS["train step"]
    steps = {f: torch.load(os.path.join(tmp, f"tp_step_{f}.pt"), weights_only=False) for f in (None, fault)}
    errs = {f: step_errors(st, ref) for f, st in steps.items()}
    log("  TP train step bf16 (48, 3, 128, 128), world 2 x TP 2 vs world 1 on the card: "
        + ", ".join(f"{k} {v:.3g}" for k, v in errs[None].items()) + f"; bound {SP_TRAIN_TOL}")
    log(f"  with {TP_FAULT_NAMES[fault]} on rank 1: " + ", ".join(f"{k} {v:.3g}" for k, v in errs[fault].items()))
    log(f"  step seconds (first, with set-up): TP rank 0 {ranks[0]['ms']['train step'][0] / 1e3:.2f}")
    bad = {k: errs[None][k] for k, tol in SP_TRAIN_TOL.items() if not errs[None][k] <= tol}
    if bad or not math.isfinite(float(steps[None]["met"]["loss"])):
        problems.append(f"the TP train step differs from the world-1 step: {bad}")
    if all(errs[fault][k] <= tol for k, tol in SP_TRAIN_TOL.items()):
        problems.append(f"the TP train step's bounds do not catch {TP_FAULT_NAMES[fault]} on one rank")
    if problems:
        raise AssertionError("phase 18: " + "; ".join(problems))
    run = {}
    for res in ranks:
        for launches in res["launches"]:
            for k, v in launches.items():
                run[k] = run.get(k, 0) + v
    log(f"  launches of phase 18's main paths, both ranks: {run}")
    return run


def phase17_spatial(dev, tmp) -> list:
    """Phase 17: the sharded forwards (f32 with TF32 off, bf16, int8
    teacher-forced) of ADM-256's CLIP UNet at batch 2, the guidance gradient
    of ADM-G 256's classifier (bf16, and f32 with TF32 off), and one bf16 train step of the recipe under
    DDP at world 2 with SP 2 against the world-1 step taken here first; each
    comparison beside its bound and the reading under a fault on rank 1
    (``SP_FAULTS``; K3's stats for the train step). Then phase 18, which ran
    the same under TP 2 in the same two processes (``phase18_check``).
    Returns both phases' launches (both ranks')."""
    import socket

    import torch
    import torch.multiprocessing as mp

    sd = random_state_dict(recipe_model(use_fp16=False)[1])
    torch.save(sd, os.path.join(tmp, "recipe_sd.pt"))
    xb, cb = recipe_batch(TRAIN_BATCH, seed=1)
    noise = torch.randn(TRAIN_BATCH, 3, 128, 128, generator=torch.Generator().manual_seed(3))
    ref = train_step_on(dev, sd, xb, cb, noise, os.path.join(tmp, "step_world1"), use_fp16=True)
    torch.cuda.empty_cache()
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    t0 = time.perf_counter()
    mp.spawn(phase17_child, args=(port, tmp), nprocs=2, join=True)
    log(f"  the two ranks took {time.perf_counter() - t0:.1f} s")
    ranks = [torch.load(os.path.join(tmp, f"sp_rank{r}.pt"), weights_only=False) for r in range(2)]
    problems = []
    for case, bound in (*SP_BOUNDS.items(), ("int8", 1.0)):
        for r, res in enumerate(ranks):
            rd = res["readings"][case]
            ms, whole = res["ms"][case]
            unit = "worst ratio to its bound over the forced layers" if case == "int8" else "rel L2 vs unsharded"
            fault = SP_FAULTS[case]
            what = "K3's stats x 1.01" if fault == "stats" else "a dropped halo row"
            log(f"  rank {r} {case}: {unit} {rd['clean']:.3g} (bound {bound:g}); with {what} on rank 1 {rd[fault]:.3g}"
                + (f"; the unforced head's output rel L2 {rd['head rel L2']:.3g}" if case == "int8" else "")
                + f"; sharded {ms:.2f} ms" + (f", unsharded {whole:.2f} ms" if whole else ""))
            if not rd["clean"] <= bound:
                problems.append(f"{case} on rank {r}: {rd['clean']:.3g} over its bound {bound:g}")
        if not ranks[1]["readings"][case][SP_FAULTS[case]] > bound:  # a fault on rank 1 crosses the bound there
            problems.append(f"{case}: {SP_FAULTS[case]} on rank 1 stays within the bound")
    steps = {fault: torch.load(os.path.join(tmp, f"sp_step_{fault}.pt"), weights_only=False) for fault in (None, "stats")}
    errs = {fault: step_errors(st, ref) for fault, st in steps.items()}
    log(f"  train step bf16 (48, 3, 128, 128), world 2 x SP 2 vs world 1 on the card: "
        + ", ".join(f"{k} {v:.3g}" for k, v in errs[None].items()) + f"; bound {SP_TRAIN_TOL}")
    log("  with K3's stats x 1.01 on rank 1: " + ", ".join(f"{k} {v:.3g}" for k, v in errs["stats"].items()))
    log(f"  step seconds (first, with set-up): world 1 {ref['secs']:.2f}, SP rank 0 {ranks[0]['ms']['train step'][0] / 1e3:.2f}")
    bad = {k: errs[None][k] for k, tol in SP_TRAIN_TOL.items() if not errs[None][k] <= tol}
    if bad or not math.isfinite(float(steps[None]["met"]["loss"])):
        problems.append(f"the sharded train step differs from the world-1 step: {bad}")
    if all(errs["stats"][k] <= tol for k, tol in SP_TRAIN_TOL.items()):
        problems.append("the train step's bounds do not catch K3's stats x 1.01 on one rank")
    if problems:
        raise AssertionError("phase 17: " + "; ".join(problems))
    run = {}
    for res in ranks:
        for launches in res["launches"]:
            for k, v in launches.items():
                run[k] = run.get(k, 0) + v
    log(f"  launches of the phase's main paths, both ranks: {run}")
    log("phase 18: --tensor_shard 2 in the same two processes: ADM-256's CLIP UNet in f32, bf16 and int8, ADM-G "
        "256's classifier gradient in bf16 and f32, a recipe train step under DDP")
    return [run, phase18_check(tmp, ref)]


def _scaled_rstd(stats, k: float):
    """A GroupNorm kernel's (2, B, G) mean and rstd with the rstd scaled by ``k``."""
    import torch

    return torch.stack((stats[0], stats[1] * k))


# Faults for ``--faults``: (ops module, function, what is done to its result), on the card only; a saved rstd
# reaches only the backward (the forward's output is the kernel's own)
FAULTS = {
    "K1's output x 1.01": ("attention", "attention_fwd_cuda", lambda out: out * 1.01),
    "K2's output x 1.01": ("attention", "attention_bwd_cuda", lambda out: out * 1.01),
    "K3's output x 1.002": ("groupnorm", "_fused_group_norm_stats", lambda out: (out[0] * 1.002, out[1])),
    "K3's saved rstd x 1.002": ("groupnorm", "_fused_group_norm_stats",
                                lambda out: (out[0], _scaled_rstd(out[1], 1.002))),
    "K4's saved rstd x 1.002": ("groupnorm", "_fused_group_norm_quant_stats",
                                lambda out: (*out[:2], _scaled_rstd(out[2], 1.002))),
    "the GroupNorm backward's dx x 1.002": ("groupnorm", "group_norm_bwd", lambda out: (out[0] * 1.002, *out[1:])),
}


@contextlib.contextmanager
def injected(fault: str):
    """``FAULTS[fault]`` in place for the block (the function restored after it)."""
    import importlib

    mod, name, alter = FAULTS[fault]
    module = importlib.import_module(f"guided_diffusion_clip_tpu_torch.ops.{mod}")
    clean = getattr(module, name)

    def faulty(*a, **k):
        return alter(clean(*a, **k))

    faulty.__dict__ = clean.__dict__  # the launch counters, which the clean function counts by its global name
    setattr(module, name, faulty)
    try:
        yield
    finally:
        setattr(module, name, clean)


def fault_probe(dev) -> None:
    """``--faults``: the bf16-torso classifier step of phase 10 and the int8
    CLIP-guided step (phase 11b's until phase 14 came), each once on the CPU, then on the card
    twice clean and once under each of its faults; each run's distances from
    the CPU and the bounds they break."""
    import torch

    from guided_diffusion_clip_tpu_torch.models.clip_vit import CLIP, CLIPConfig
    from guided_diffusion_clip_tpu_torch.utils.script_util import create_classifier, create_gaussian_diffusion

    tf32_off()
    cpu = torch.device("cpu")

    def show(errs):
        return ", ".join(f"{k} {v:.3g}" for k, v in errs.items())

    def runs(faults):
        yield "none", contextlib.nullcontext
        yield "none, again", contextlib.nullcontext
        for fault in faults:
            yield fault, lambda fault=fault: injected(fault)

    log("the bf16-torso classifier step (batch 2, microbatches of 1), card vs CPU, against CLF_BF16_TOL")
    sd = random_state_dict(create_classifier(256, False, 128, 2, "32,16,8", True, True, "attention"))
    batch = clf_step_batch()
    ref = clf_step_on(cpu, sd, *batch, True, 1)
    log(f"  control, CPU bf16 vs CPU f32: {show(step_errors(ref, clf_step_on(cpu, sd, *batch, False, 1)))}")
    for name, ctx in runs([f for f in FAULTS if not f.startswith("K4")]):
        with ctx():
            errs = step_errors(clf_step_on(dev, sd, *batch, True, 1), ref)
        broken = [k for k, tol in CLF_BF16_TOL.items() if not errs[k] <= tol]
        log(f"  {name}: {show(errs)}; breaks {broken or 'nothing'}")
    del ref
    torch.cuda.empty_cache()

    log("the int8 CLIP-guided step (batch 1, f32, teacher-forced), card vs CPU, against CLIP_INT8_TOL")
    clip = CLIP(CLIPConfig())
    clip.load_state_dict(clip_random_state_dict(clip), strict=True)
    vision = clip.eval().visual.requires_grad_(False)
    del clip
    target = torch.randn(512, generator=torch.Generator().manual_seed(32))
    diffusion = create_gaussian_diffusion(steps=1000, learn_sigma=True, timestep_respacing="100")
    model = clip_unet(random_state_dict(clip_unet()), conv_impl="int8")
    xs, z = clip_int8_step_input()
    forcing = Int8Forcing()
    ref = clip_int8_step(cpu, model, vision, target, diffusion, xs, z, forcing.record)
    log(f"  CPU step {ref['seconds']:.2f} s")
    for name, ctx in runs(FAULTS):
        try:
            with ctx():
                out = clip_int8_step(dev, model, vision, target, diffusion, xs, z, forcing.force)
        except AssertionError as e:  # Int8Forcing's own checks of q, s and the convs
            log(f"  {name}: the teacher forcing's check fails: {e}")
            continue
        errs = clip_int8_errors(out, ref)
        broken = [k for k, tol in CLIP_INT8_TOL.items() if not errs[k] <= tol]
        log(f"  {name}: {show(errs)}; breaks {broken or 'nothing'}")
    log(f"  {forcing.summary()} (all card runs)")


def check_ptxas(build_log: str) -> None:
    """Print ptxas's registers and spills by kernel; raise on a spill in a kernel the main paths launch."""
    # the kernel ptxas is reporting on: a tensor-core attention kernel as name<d> (K1's as name<d, warps>),
    # any other by its (mangled) name; a spill fails the run in the former at d = 64 (the sampling paths),
    # 192 and 256 (training), in K1's at d = 96 (the 64 px quality proxies' bf16 sampling; their K2 runs in
    # float32, and K2's bf16 dK/dV kernel spills at d = 96 as at 128), in the float32 ones at every d, and in
    # a kernel of the convs',
    # the quantizer's and the GroupNorms' sources (the split entries' too), which were built without any
    entry, on_path = "", False
    for line in build_log.splitlines():
        if "Compiling entry function" in line:
            found = re.search(r"\d(attention_[a-z0-9_]+_kernel)I((?:Li\d+E)+)E", line)
            mangled = re.search(r"Compiling entry function '(\w+)'", line)
            args = re.findall(r"\d+", found.group(2)) if found else []
            entry = f"{found.group(1)}<{', '.join(args)}>" if found else mangled.group(1) if mangled else ""
            on_path = bool(args) and (args[0] in ("64", "192", "256") or "f32mma" in found.group(1)
                                      or (args[0] == "96" and found.group(1) == "attention_fwd_mma_kernel"))
            found = re.search(r"\d+(conv_s8_mma_kernel|conv_s8_finish_kernel|conv_s8_stem_kernel|conv_s8_head_kernel|"
                              r"conv_fused_mma_kernel|absmax_kernel|quantize_kernel|gn_fused_kernel|gn_split_stats_kernel|"
                              r"gn_split_apply_kernel)(\w*)'", line)
            if found:
                entry, on_path = found.group(1) + found.group(2), True
        spills = "spill stores" in line and not line.strip().startswith("0 bytes stack frame, 0 bytes spill")
        if "registers" in line or spills:
            log(f"  ptxas: {line.strip()}" + (f" ({entry})" if entry else ""))
        if spills and on_path:
            raise AssertionError(f"{entry}, a kernel the main paths launch and that was built without spills, "
                                 f"spills: {line.strip()}")


def main(argv=None) -> int:
    import torch

    argv = sys.argv[1:] if argv is None else argv
    if argv not in ([], ["--faults"]):
        print(f"chip_smoke: takes no arguments but --faults, got {argv}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke test needs an H100", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from guided_diffusion_clip_tpu_torch.ops import build

    dev = torch.device("cuda", 0)
    log("phase 1: device")
    card = smi()
    cap = torch.cuda.get_device_capability(0)
    log(f"  nvidia-smi: {card}; torch: {torch.cuda.get_device_name(0)}, capability {cap}, "
        f"torch {torch.__version__}, CUDA {torch.version.cuda}; {os.cpu_count()} CPUs, torch's CPU ops on "
        f"{torch.get_num_threads()} threads")
    if cap != (9, 0):
        raise SystemExit(f"chip_smoke: needs compute capability (9, 0) (sm_90a), found {cap}")

    log("phase 2: build")
    t0 = time.perf_counter()
    build.load()
    log(f"  kernels built and loaded in {time.perf_counter() - t0:.2f} s "
        f"(nvcc {build.build_seconds:.2f} s): {build.library_path()}")
    check_ptxas(build.build_log)
    if argv:
        fault_probe(dev)
        print(smi())
        return 0

    t3 = time.perf_counter()
    log("phase 3: kernels vs plain versions on the card")
    records = phase3_kernels(dev)
    log("phase 3b: K2 (attention backward) vs its plain version on the card")
    records.update(phase3b_attention_bwd(dev))
    log("phase 3c: K4 (quantizing GroupNorm) vs its plain version on the card")
    records["group_norm_quant"] = phase3c_group_norm_quant(dev)
    log("phase 3d: K5 (s8 conv) vs its plain version, the __dp4a kernel and cuDNN's bf16 conv on the card")
    records.update(phase3d_conv_s8(dev))
    log("phase 3e: K6 (fused quantizing conv) vs its plain version and cuDNN's bf16 conv on the card")
    records["conv_fused"] = phase3e_fused_conv(dev)
    log("phase 3f: K7 (tensor-core probe) vs its plain version on the card")
    records["mma_probe"] = phase3f_mma_probe(dev)
    log("phase 3g: int8_conv's quantize kernels vs quantize_per_tensor on the card")
    records["quantize"] = phase3g_quantize(dev)
    log("phase 3h: the split entries of K3, K4 and the quantize kernels (spatial partitioning) vs their plain "
        "versions on the card")
    t3h = time.perf_counter()
    split_records = phase3h_split_entries(dev)
    split_vs_one = split_records.pop("split_vs_one")
    records.update(split_records)
    log(f"  phase 3h took {time.perf_counter() - t3h:.1f} s; phases 3-3h {time.perf_counter() - t3:.1f} s")

    t4 = time.perf_counter()
    sd = random_state_dict(clip_unet())
    log("phase 4b: full-width guidance gradient, card vs CPU")
    phase4b_guidance(dev)
    log("phase 4c: full-width int8 forward, card vs CPU")
    phase4c_int8_forward(dev, sd)
    log("phase 4d: full-width int8 guidance gradient, card vs CPU")
    phase4d_int8_guidance(dev)
    log("phase 4e: full-width forwards (full, shallow and plain), card vs CPU")
    phase4e_deep_cache(dev, sd)
    log(f"  phases 4b-4e took {time.perf_counter() - t4:.1f} s")

    import numpy as np

    runs = []  # each main path's launch counts
    with tempfile.TemporaryDirectory() as tmp:
        t5 = time.perf_counter()
        log("phase 5: the slice, served over HTTP")
        ckpt = os.path.join(tmp, "clip_unet_random.pt")  # phase 6 writes the ADM-G UNet's model_random.pt
        torch.save(sd, ckpt)
        del sd
        runs.append(phase5_serve(dev, ckpt))
        log("phase 5b: the slice served over HTTP with --conv_impl int8")
        runs.append(phase5_serve(dev, ckpt, "int8"))
        log("phase 5c: the slice served with --cfg_scale 2.0 --cfg_cache 2 --sampler dpm++2m")
        runs.append(phase5c_serve_cfg(dev, ckpt))
        log("phase 6: classifier-guided sampling, ADM-G 256 + classifier")
        launches, paths, bf16_images, bf16_chain = phase6_guided(dev, tmp)
        runs.append(launches)
        log("phase 6, profile: one guided step at batch 8")
        guided_parts, guided_device = profile_guided_step(dev, paths)
        bf16_step = guided_parts["guided step"]
        t14b = time.perf_counter()
        log("phase 14b: tools.perf_breakdown at batch 8, bf16, against phase 6's split just taken")
        runs.append(phase14b_perf_breakdown(guided_parts, guided_device))
        log(f"  phase 14b took {time.perf_counter() - t14b:.1f} s")
        log("phase 6b: classifier-guided sampling with --conv_impl int8")
        launches, _, int8_images, int8_chain = phase6_guided(dev, tmp, "int8", paths)
        runs.append(launches)
        sd_bf16, sd_int8 = bf16_images.astype(np.float64).std(), int8_images.astype(np.float64).std()
        diff = np.abs(int8_images.astype(np.int64) - bf16_images.astype(np.int64))
        saturated = ((bf16_images == 0) | (bf16_images == 255)).mean()
        log(f"  samples' std: int8 {sd_int8:.3f}, bf16 {sd_bf16:.3f} (bound: within 0.5 relative); "
            f"int8 vs bf16 (same seeds and weights): mean |uint8 diff| {diff.mean():.3f}, "
            f"{100 * (diff > 0).mean():.2f} % of values differ; {100 * saturated:.1f} % of bf16 values at 0 or 255")
        if not abs(sd_int8 - sd_bf16) <= 0.5 * sd_bf16:
            raise AssertionError(f"int8 samples' std {sd_int8:.3f} not within 0.5 of bf16's {sd_bf16:.3f}")
        log("phase 6b, profile: one int8 guided step at batch 8")
        int8_step = profile_guided_step(dev, paths, "int8")[0]["guided step"]
        log(f"  guided step at batch 8: int8 {int8_step:.2f} ms, bf16 {bf16_step:.2f} ms (CUDA events, "
            f"this run)")
        log("phase 6c: classifier-guided sampling with the deploy preset's knobs")
        launches, preset_images, preset_chain = phase6c_preset(dev, tmp, paths)
        runs.append(launches)
        sd_preset = preset_images.astype(np.float64).std()
        diff = np.abs(preset_images.astype(np.int64) - int8_images.astype(np.int64))
        log(f"  samples' std: preset {sd_preset:.3f}, plain int8 {sd_int8:.3f} (bound: within 0.5 relative); "
            f"preset vs plain int8 (same seeds and weights): mean |uint8 diff| {diff.mean():.3f}, "
            f"{100 * (diff > 0).mean():.2f} % of values differ")
        if not abs(sd_preset - sd_int8) <= 0.5 * sd_int8:
            raise AssertionError(f"preset samples' std {sd_preset:.3f} not within 0.5 of plain int8's {sd_int8:.3f}")
        per_step = 1000 / GUIDED_STEPS
        log(f"  {GUIDED_STEPS}-step chains at batch 8, this run: preset {preset_chain:.3f} s "
            f"({480 / preset_chain:.3f} samples/min, {per_step * preset_chain:.2f} ms a step), plain int8 "
            f"{int8_chain:.3f} s ({480 / int8_chain:.3f} samples/min, {per_step * int8_chain:.2f} ms a step), bf16 "
            f"{bf16_chain:.3f} s ({480 / bf16_chain:.3f} samples/min, {per_step * bf16_chain:.2f} ms a step)")
        log(f"  phases 5-6c took {time.perf_counter() - t5:.1f} s")

        t10 = time.perf_counter()
        log("phase 10: python -m guided_diffusion_clip_tpu_torch.classifier_train on ADM-G 256's classifier, then "
            "classifier_sample with what it saved")
        runs.extend(phase10_classifier_train(dev, tmp, paths))
        log(f"  phase 10 took {time.perf_counter() - t10:.1f} s")
        t11 = time.perf_counter()
        log("phase 11: ViT-B/32 (random weights in OpenAI's names): the encoders, compute_clip_embeddings and "
            "image_train on its dict, the guidance gradient through the UNet, card vs CPU")
        clip_path = phase11_clip(dev, tmp, ckpt)
        log(f"  phase 11 took {time.perf_counter() - t11:.1f} s")
        t11 = time.perf_counter()
        log("phase 11b: python -m guided_diffusion_clip_tpu_torch.clip_guided_sample on the ADM-256 CLIP UNet")
        runs.extend(phase11b_clip_guided(dev, tmp, ckpt, clip_path))
        log(f"  phase 11b took {time.perf_counter() - t11:.1f} s")

    t7 = time.perf_counter()
    log("phase 7: the tool entry points (conv_bench, mxu_ceiling)")
    runs.append(phase7_tools())
    log(f"  phase 7 took {time.perf_counter() - t7:.1f} s")

    t8 = time.perf_counter()
    log("phase 8a: K1 and K2 at the training recipe's shapes (batch 48, one head, d = 192 and 256)")
    phase8a_attention(dev)
    with tempfile.TemporaryDirectory() as tmp:
        log("phase 8b: one train step of the full-width recipe, card vs CPU")
        phase8b_train_step(dev, tmp)
        log("phase 8c: python -m guided_diffusion_clip_tpu_torch.image_train --config-file, then a resume with "
            "--profile_dir")
        run_dir = phase8c_cli(dev, tmp)
        log("phase 8d: train steps of the recipe at batch 48, without and with use_checkpoint")
        timed = phase8d_time(dev, tmp)
        runs.extend(t["launches"] for t in timed.values())
        log("phase 8e: --train_conv_impl int8: one step card vs CPU, then train steps at batch 48")
        int8_timed = phase8e_int8_train(dev, tmp)
        runs.append(int8_timed["launches"])
        log(f"  train step at batch {TRAIN_BATCH}, this run: int8 {int8_timed['step_ms']:.2f} ms (busy "
            f"{int8_timed['busy_ms']:.2f}), bf16 {timed[False]['step_ms']:.2f} ms (busy {timed[False]['busy_ms']:.2f})")
        log(f"  phase 8 took {time.perf_counter() - t8:.1f} s")
        t14a = time.perf_counter()
        log("phase 14a: tools.train_step_bench on the recipe at batch 48, bf16 and int8, against 8d and 8e just taken")
        runs.extend(phase14a_train_step_bench({"xla": timed[False], "int8": int8_timed}))
        log(f"  phase 14a took {time.perf_counter() - t14a:.1f} s")
        t9 = time.perf_counter()
        log("phase 9: python -m guided_diffusion_clip_tpu_torch.image_sample from random weights in 8c's run directory")
        runs.extend(phase9_image_sample(dev, tmp, run_dir))
        log("phase 9b: image_sample_repeat --repeats 2")
        runs.append(phase9b_repeat(dev, tmp, run_dir))
        log("phase 9c: image_nll on 8 images")
        runs.append(phase9c_nll(dev, tmp, run_dir))
        log(f"  phase 9 took {time.perf_counter() - t9:.1f} s")
        t12 = time.perf_counter()
        data, clip_path = os.path.join(tmp, "images"), os.path.join(tmp, "clip_dict.pt")
        (samples_npz,) = glob.glob(os.path.join(tmp, "**", "*_bf16", "samples_16x128x128x3.npz"), recursive=True)
        log("phase 12a: the SR-delta model (SRImageModel_Feat) at the recipe's widths, card vs CPU")
        phase12a_sr_card_vs_cpu(dev, tmp)
        log("phase 12b: python -m guided_diffusion_clip_tpu_torch.super_res_unsup on 8c's folder, then --load with "
            "--train_conv_impl int8; train steps at batch 48")
        runs.extend(phase12b_sr_unsup(dev, tmp, data, clip_path))
        log("phase 12c: super_res_train, then super_res_sample on phase 9's samples at 64 px, bf16 and int8")
        runs.extend(phase12c_sr_train_sample(dev, tmp, data, samples_npz))
        log("phase 12d: super_res_depth_sweep_sample from phase 9's checkpoint")
        runs.append(phase12d_depth_sweep(dev, tmp, run_dir, os.path.join(tmp, "test_images"),
                                         os.path.join(tmp, "test_clip_dict.pt")))
        log(f"  phase 12 took {time.perf_counter() - t12:.1f} s")
        t13 = time.perf_counter()
        log("phase 13a: the recipe's step under DDP, FSDP2 and ZeRO-1 at world 1 against the plain step, bf16 and int8")
        runs.extend(phase13a_dist_steps(dev, tmp))
        log("phase 13b: image_train under torchrun (FSDP2, DCP), resumed under ZeRO-1, image_sample from its DCP "
            "directory with and without torchrun")
        runs.append(phase13b_torchrun(dev, tmp, data, clip_path))
        log(f"  phase 13 took {time.perf_counter() - t13:.1f} s")

    t14 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        log("phase 14c: tools.serve_bench, ADM-256 at batch 8, ddim25, int8, in a server process")
        runs.append(phase14c_serve_bench(tmp))
        log("phase 14d: tools.block_microbench at its four shapes")
        runs.append(phase14d_block_microbench())
    log(f"  phase 14 took {time.perf_counter() - t14:.1f} s")
    t15 = time.perf_counter()
    log(f"phase 15: the sampling benches at batch {PHASE15_BATCH}, {PHASE15_STEPS} steps, int8")
    runs.extend(phase15_sampling_benches())
    log(f"  phase 15 took {time.perf_counter() - t15:.1f} s")
    t16 = time.perf_counter()
    log(f"phase 16: the quality tools at {PHASE16_TRAIN} train steps, one batch of {PHASE16_BATCH} a set, "
        f"{PHASE16_STEPS} steps")
    runs.extend(phase16_quality_tools())
    log(f"  phase 16 took {time.perf_counter() - t16:.1f} s")
    t17 = time.perf_counter()
    log("phase 17: --spatial_shard 2 on two processes (gloo) on the one card: ADM-256's CLIP UNet in f32, bf16 and "
        "int8, ADM-G 256's classifier gradient in bf16 and f32, a recipe train step under DDP; then phase 18, "
        "--tensor_shard 2, in the same processes")
    with tempfile.TemporaryDirectory() as tmp:
        runs.extend(phase17_spatial(dev, tmp))
    log(f"  K3 one launch against split at {SP_HALF_SHAPE} bf16 (phase 3h): {split_vs_one['K3'][0]:.4f} ms, "
        f"{split_vs_one['K3'][1]:.4f} ms; K4 {split_vs_one['K4'][0]:.4f} ms, {split_vs_one['K4'][1]:.4f} ms")
    log(f"  phases 17 and 18 took {time.perf_counter() - t17:.1f} s")

    # K1 and K2 run on two tensor-core kernels each: bf16 (the sampling paths at d = 64, training at d = 192 and
    # 256) and float32 (split TF32: the classifier's attention pool, the quality tools' f32 training); K5 on
    # conv_s8_mma.cu and, for the stems and heads, conv_s8_thin.cu
    for run in runs:
        run["attention"] -= run["attention_f32"]
        run["attention_bwd"] -= run["attention_bwd_f32"]
        run["conv_s8"] -= run["conv_s8_thin"]
    kernels = []
    for name, src, replaces in (
        ("attention", "guided_diffusion_clip_tpu_torch/ops/csrc/attention_fwd_mma.cu",
         "guided_diffusion_clip_tpu/ops/pallas_attention.py:27"),
        ("attention_f32", "guided_diffusion_clip_tpu_torch/ops/csrc/attention_fwd_f32mma.cu",
         "guided_diffusion_clip_tpu/ops/pallas_attention.py:27"),
        ("attention_bwd", "guided_diffusion_clip_tpu_torch/ops/csrc/attention_bwd_mma.cu",
         "guided_diffusion_clip_tpu/ops/pallas_attention.py:46"),
        ("attention_bwd_f32", "guided_diffusion_clip_tpu_torch/ops/csrc/attention_bwd_f32mma.cuh",
         "guided_diffusion_clip_tpu/ops/pallas_attention.py:46"),
        ("group_norm", "guided_diffusion_clip_tpu_torch/ops/csrc/groupnorm.cu",
         "guided_diffusion_clip_tpu/ops/pallas_groupnorm.py:29"),
        ("group_norm_quant", "guided_diffusion_clip_tpu_torch/ops/csrc/groupnorm.cu",
         "guided_diffusion_clip_tpu/ops/pallas_groupnorm.py:50"),
        ("conv_s8", "guided_diffusion_clip_tpu_torch/ops/csrc/conv_s8_mma.cu",
         "guided_diffusion_clip_tpu/ops/pallas_conv.py:258"),
        ("conv_s8_thin", "guided_diffusion_clip_tpu_torch/ops/csrc/conv_s8_thin.cu",
         "guided_diffusion_clip_tpu/ops/pallas_conv.py:258"),
        # no TPU kernel: XLA fuses this pass of the JAX package's quantize_per_tensor
        ("quantize", "guided_diffusion_clip_tpu_torch/ops/csrc/quantize.cu",
         "guided_diffusion_clip_tpu/ops/quant.py:34"),
        ("conv_fused", "guided_diffusion_clip_tpu_torch/ops/csrc/conv_fused.cu",
         "guided_diffusion_clip_tpu/ops/pallas_conv.py:71"),
        ("mma_probe", "guided_diffusion_clip_tpu_torch/ops/csrc/mma_probe.cu",
         "tools/pallas_mxu_ceiling.py:39"),
        # K3 and K4 split at their statistics on a row shard (phase 17), K4 on a channel shard (phase 18): the
        # stats entry (both), the applies
        ("group_norm_stats", "guided_diffusion_clip_tpu_torch/ops/csrc/groupnorm_split.cu",
         "guided_diffusion_clip_tpu/ops/pallas_groupnorm.py:29"),
        ("group_norm_apply", "guided_diffusion_clip_tpu_torch/ops/csrc/groupnorm_split.cu",
         "guided_diffusion_clip_tpu/ops/pallas_groupnorm.py:42"),
        ("group_norm_quant_apply", "guided_diffusion_clip_tpu_torch/ops/csrc/groupnorm_split.cu",
         "guided_diffusion_clip_tpu/ops/pallas_groupnorm.py:73"),
        # the quantize kernels' two passes apart: no TPU kernel, as the quantize row
        ("quantize_amax", "guided_diffusion_clip_tpu_torch/ops/csrc/quantize.cu",
         "guided_diffusion_clip_tpu/ops/quant.py:34"),
        ("quantize_apply", "guided_diffusion_clip_tpu_torch/ops/csrc/quantize.cu",
         "guided_diffusion_clip_tpu/ops/quant.py:34"),
    ):
        launched = sum(run.get(name, 0) for run in runs)
        if launched == 0:
            raise AssertionError(f"kernel {name} was never launched by a main path")
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": launched, **records[name],
        })
    print(json.dumps({"kernels": kernels}))
    print(smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
