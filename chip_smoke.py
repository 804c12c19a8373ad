#!/usr/bin/env python3
"""Smoke test of flocoder_torch on one CUDA card (an H100).

    python3 chip_smoke.py [--parent DIR]

1. Checks for a CUDA device and prints the card's name and power limit.
2. Builds the hand-written kernels from the sources in this checkout, one
   nvcc each, started together: K1, the NA2D forward
   (flocoder_torch/csrc/na2d_fwd.cu), K2, the NA2D backward
   (flocoder_torch/csrc/na2d_bwd.cu), and K3 (fp32 h and its bf16 case,
   counted apart), K4 and K5, the fused compression tail and RVQ search
   (flocoder_torch/csrc/fused_vq.cu), and prints each fused kernel's
   registers and spills from ptxas's report.
3. Holds K1 against its plain PyTorch version (na2d_banded) on the card, TF32
   off: the codec's shapes at B=8 (32²×512 with head dim 64, 16²×1024 with
   head dim 128, 16²×128 with head dim 16) and at the main paths' batches
   (64 for the serving decode, 1 for img2img's encode, 32 for the
   pre-encode's encoder and 128 for the flow evaluation's decode, fp32
   only), a non-square map, a map smaller than
   the window, a ragged one; fp32 (max |Δ| < 1e-4) and bf16 (against the
   plain version in fp32 on the same bf16 values, max |Δ| < 2e-2: one bf16
   rounding of outputs of magnitude up to ~4).
4. Holds K2 against its plain twin (na2d_bwd_banded) at the training shapes
   at B=8 and the same non-square, smaller-than-window and ragged maps: fp32
   max |Δ| < 1e-4·max(1, max|ref|), bf16 < 3e-2·max(1, max|ref|) against the
   twin in fp32 on the same bf16 values; that two K2 calls on the same
   inputs are bitwise equal; and the gradients of na2d on the card
   (NA2DFunction: K1 forward, K2 backward) against torch autograd of
   na2d_banded.
5. Times K1 and K2 at the decoder's shape (B=64, 32², C=512, fp32), by
   CUDA events over back-to-back calls and by the profiler's device time of
   the kernels alone, beside the plain versions, the least time the card
   could take, and
   F.scaled_dot_product_attention with the neighborhood mask (forward for
   K1, forward + backward against K1 + K2 for K2: a yardstick only; the
   port never calls it). Then times K1 at every NATTEN shape of the codec
   (32²×512, 16²×1024, 16²×128) at B=64 and B=32 and K2 at B=64, fp32 and
   bf16, beside each shape's bound (time_na2d_shapes; the same function
   times another checkout's kernels in benchmarks/na2d_shapes.py).
6. Serves flowers_vqgan at full width through the port's entry point
   (flocoder_torch.generate_samples.main) from seeded random-init
   checkpoints (the npz contract's keys, written uncompressed by np.savez): unconditional, class-conditional with CFG (n_classes=102),
   and img2img from an init image (which runs the encoder). The kernels'
   launch counts are zeroed before and read after these runs. Then times
   the parts of a serving batch: a U-Net forward, a decode, an encode.
7. Trains flowers_vqgan at full width (128², hidden 256, batch 64, VGG16
   perceptual loss, patch discriminator) through the port's entry point
   (flocoder_torch.train_vqgan.main): one warmup and one GAN epoch over a
   folder of 320 seeded random PNGs (4 steps per epoch, then one validation
   batch). The launch counts are zeroed before and read after, and must be
   6 K1 and 6 K2 per training step plus 6 K1 per validation batch. Prints
   samples/s per phase (over the steady steps, and over the whole epoch
   with the loader's wait and the copy to the card), peak memory and the
   losses; then a GAN step's breakdown by CUDA events and its device idle
   share under the profiler. Its metrics log (utils/logging.py; the phases
   run from the temporary directory, so runs/ lands there) must hold
   train/…, val/… and demo/recon records; then the codebook analysis the
   trainer runs every 10th epoch runs on this run's tracker and the trained
   codebooks on the card (no codec forward): codebook/… records in a log of
   its own and, where matplotlib is installed, the JAX module's figures by
   name (PNGs and the interactive HTML twins); without matplotlib the phase
   says that they were skipped.
8. (After step 33's ranks, beside the end of its NCCL run, with step 26's
   bf16 card-vs-CPU check.) Checks small
   inputs end to end against the same models on the CPU, TF32
   off: the RK4 + CFG sampler and decode, the encoder, and one warmup step
   and one GAN step of a small codec (hidden 64): losses and parameters
   within 1e-3·max(1, |ref|), and the gradients (Adam's first moments of
   the codec and of the discriminator) within 1e-3·max|ref| of each model.
9. Holds K4, K3 and K5 against their plain twins (flocoder_torch.ops.fused_vq)
   on the card, TF32 off: each token's picks equal the twin's or ε-optimal
   under an fp64 oracle (relative distance gap < 1e-5), z_q within
   1e-5·max(1, |ref|) where the picks agree, K5's intermediates within
   1e-5·max(1, |ref|) of the twin and of the fp64 oracle; K4 at a
   pre-encode batch of tokens, the probe's shape, a ragged N, D=3 and 8 and
   Din=30; K3 at a pre-encode batch (both layouts of h, every cluster
   size), a ragged 5×7 map, 20×20 maps, D=3 with one group and D=8 with
   two, a 1×1 map, B=1 and a 3-row map in a cluster of 8; K5 at every
   cluster size; codebooks with duplicated codes (the first index exactly),
   a NaN token (z_q 0, index 0, as the TPU kernels), two calls bitwise equal,
   and a map too large for a
   cluster refused before any launch. Times each at its main shape (device
   time by the profiler, CUDA events, the wrapper's host µs a call) beside
   its twin, the unfused torch path (the yardstick) and its bound; K3 and
   K5 at every cluster size, K3's empty-launch floor, and with --parent DIR
   another checkout's kernels on the same inputs in turns (parent, this,
   this, parent). Then K3's bf16 case against its twin on the same bf16 h
   (picks and z_q equal) and against K3 fp32 on h widened (bit for bit) at
   the pre-encode shape, both layouts, every cluster size, and a ragged
   map; the W8A8 int8 convolution (im2col + torch._int_mm, not a TPU
   kernel) against its float64 twin (codes equal, within 1e-6 of the
   largest |ref|) at an SD-decoder and a VQGAN-decoder shape; K3 bf16 timed
   in turns with K3 fp32 on h widened, and the int8 convolution beside
   cuDNN's bf16 and fp32 convolutions at the SD decoder's 3×3 shapes.
10. Pre-encodes flowers_vqgan at full width through the port's entry point
   (flocoder_torch.preencode_data.main) with preencoding.quantize=true
   preencoding.fused_vq=true, batch 32, augs_per 4, over 320 seeded random
   500² PNGs (4 val and 36 train batches). The launch counts are zeroed
   before and read after: 5 K1 and 1 K3 per batch, no K2, K4 or K5. Reads
   the latents back, rebuilds the first batch from the same config and
   holds its fused picks against the unfused path's, and prints latents/s
   per split, encode ms per batch fused and unfused, peak memory and one
   batch's device idle share.
11. Pre-encodes a small codec's (hidden 64) batches on the card and on the
   CPU through the same entry point: on each rebuilt batch the picks equal
   or ε-optimal, the latent files within 1e-4·max(1, |ref|) elsewhere.
12. Trains flowers_vqgan's flow at full width through the port's entry point
   (flocoder_torch.train_flow.main) on the latents step 10 wrote (1,152
   train, 128 val): U-Net dim 16, dim_mults 1,2,4,8, 102 classes, batch 256,
   parallel OT, EMA, cosine warm restarts, 1 epoch (the recipe's 10,000)
   with an RK4 + CFG evaluation at n_steps 20 (the recipe's
   100). The launch counts are zeroed before and read after: K1 twice per
   evaluation (the sampled and the target latents' decodes, one chunk of
   128 each), nothing else. Serves the trained EMA checkpoint through
   generate_samples (one K1). Prints flow samples/s over the steady steps
   (CUDA events recorded after each step; the loop synchronises once an
   epoch) and per epoch, the OT pairing's rounds a step and ms a pairing, each
   evaluation's seconds split into sampler, decode, metrics and grids, peak
   memory and one step's device idle share. The evaluation scores FID on
   Inception features: a seeded random init of the port's FID-Inception net
   written as weights/fid_inception.npz in the working directory (removed
   after this phase), FID_feature_backend fid_inception; the run's metrics
   log must hold Loss/train, Learning Rate, Loss/val, metrics/…, codebook/…
   and demo/… records; the Inception features of 16 images on the card
   within 1e-3 of the largest |CPU| (TF32 off) and 64 timed;
   utils/profiling's print_mem, step_timer and trace run once each around a
   flow step. Holds the parallel OT
   permutation at B=256 on the card to the CPU's, and one flow step on the
   card to the CPU's with the same draws: in fp32 with TF32 off, the loss,
   parameters, Adam's first moments and EMA within 1e-3·max(1, |ref|); in
   float64, the step's changes to the parameters and the EMA and Adam's
   first moments within 1e-3 of the largest on the CPU.
13. Holds K1 and K2 at HDiT's neighborhood-attention shapes (flowers_hdit
   with flow.hdit_patch_size=2 and na:7: 8x8 tokens of width 256, 4 heads
   of 64, k 7, at B=256 and B=128; and the 4x4 map of na:7 at patch 4)
   against their plain twins, fp32 and bf16, with the gates of steps 3 and
   4, and times them (profiler, CUDA events) beside the bound and SDPA with
   the window mask; these rows join the kernels line's per_shape rows.
14. sd_preencode: pre-encodes flowers_sd at full width (the SD VAE, 128²
   images, 16x16x4 latents) through flocoder_torch.preencode_data.main,
   batch 32, augs_per 4 (the recipe's 128), over step 10's PNGs: no kernel
   launches; latents/s per split, encode ms a batch, one batch's idle
   share, peak memory; two images on the card and on the CPU, TF32 off,
   within 1e-4·max(1, |ref|).
15. sd_serve: serves flowers_sd (seeded U-Nets, unconditional and CFG with
   102 classes, batch 64, 20 grid points) through generate_samples: no
   kernel launches; samples/s, the decode ms a batch; two samples on the
   card and on the CPU within 1e-3·max(1, |ref|).
16. hdit_flow: trains flowers_hdit with the NA variant at full width (bf16,
   batch 256) for 1 epoch on step 14's latents, with an RK4 + CFG
   evaluation (20 grid points, decoded through the SD VAE), then
   serves the EMA checkpoint as trained, in bf16. K1 and K2 are counted
   exactly: 4 K1 (K2) per HDiT forward (backward), 4·NFE K1 per sampler
   call. Steady samples/s, per-epoch samples/s, evaluation seconds by part,
   one step's idle share, peak memory; one fp32 step, zero-init weights
   perturbed, on the card against the CPU (B=64) within 1e-3·max(1, |ref|)
   on the loss, parameters, Adam's first moments and EMA.
17. hdit_recipe (flowers_hdit as composed: global attention, patch 4) and
   hdit_moe (step 16's variant with flow.hdit_moe_experts=[8,0]): one epoch
   each, no evaluation: steady samples/s, 0 NA2D launches for the recipe
   and 4 K1 and 4 K2 a step for MoE, its auxiliary loss and dropped
   fraction.
18. midi_train: midi_vqgan's codec at full width (128² RGB piano rolls,
   flowers' widths) through flocoder_torch.train_vqgan.main on a seeded
   corpus of 108 two-track songs written by the port's
   write_synthetic_corpus (each rolls to three 128² PNGs; the loader
   converts them): one warmup epoch of 4 steps at B=64 (the GAN step at
   these widths runs in steps 7 and 26), one validation batch with the
   note metrics and their 10 grids; 6 K1 and 6 K2 a step, 6 K1 a
   validation batch, exactly. Its checkpoint (written uncompressed, as the
   port writes every checkpoint) is the codec of the steps after it.
19. midi_preencode: inpainting=true pre-encode of the 324 roll PNGs from
   step 18's checkpoint, B=32, augs_per 2 (the recipe's 1024): 2 val and
   18 train batches of triplets, two encodes a batch (10 K1), read back.
20. midi_flow: the inpainting flow on those triplets (576 train, 64 val):
   masked U-Net and MaskEncoder, B=256, OTF curriculum with blank_latents
   (5 K1), 1 epoch of 2 steps with an RK4 inpainting evaluation at 20
   grid points (3 decodes, 3 K1); serving the EMA with .mid export
   (64 samples, 1 K1, every .mid parsed back); one step profiled; one step
   of B=64 with the mask encoder on the card against the CPU (fp32 within
   1e-3·max(1, |ref|), float64 changes within 1e-3 of the largest).
21. midi_inpainting_codec: K1 and K2 at head dim 256 (B=64 and 32, 8x8x2048,
   8 heads, k 7) against their twins (step 13's gates) and timed beside the
   bound and SDPA + mask; midi_inpainting's codec (1 channel, 4
   downsamples, 609.9 M parameters, seeded): create_inpainting_triplet on 32
   grayscale rolls (10 K1), two held to the CPU at 1e-4·max(1, |ref|), and
   two reconstruction-only training steps at B=64 (6 K1 and 6 K2 each),
   timed with peak memory.
22. pe_host (after step 10): step 10's pre-encode again through the host
   pipeline, preencoding.device_augs=true preencoding.format=shard (fused_vq,
   B=32, augs_per 4, the same 320 500² PNGs): the host decodes each image
   once to 160² (the C++ decoder of flocoder_torch/csrc/fcimage.cpp where it
   builds, else PIL; the decoder is printed), the card augments to 128²
   and encodes, and each split is one packed shard. 5 K1 and 1 K3 a batch,
   exactly; the augment on the card against its CPU twin on the same draws
   (max |Δ| < 1e-5); the native gather (csrc/fcloader.cpp) against its
   memmap twin on every record, bitwise; latents/s per split printed beside
   step 10's files-format PIL path of the same run.
23. flow_shard (after step 12): flowers_vqgan's flow (B=256, 2 epochs of 4
   steps, no evaluation in the loop) on pe_host's shards, then its one RK4
   + CFG evaluation at 20 grid points by flocoder_torch.evaluate_model on
   the val shard; no kernel in training, K1 twice in the evaluation,
   exactly; that evaluation scores FID on the default rp2048 features (the
   flow phase's Inception weights file is gone).
24. tpu_demo (last): configs/tpu_demo.yaml as composed (the resize codec,
   synthetic 128² data, device_augs at augs_per 6 of its 48, shard; the
   U-Net in bf16 at B=256,
   1 epoch of its 40, evaluation at 20 of its 50 grid points), then its
   EMA served as trained, in bf16; no kernel launches.
25. tpu_vqgan (after step 26): configs/tpu_vqgan.yaml as composed
   (codec.bf16) at full width on the codec checkpoint step 26 trained:
   pre-encode with preencoding.fused_vq=true (B=32, augs_per 1: 1 val and
   9 train batches; 5 K1 in bf16 and 1 K3 bf16 a batch, exactly), again
   with +quant=int8 (W8A8 encoder convolutions) over 96 PNGs, one flow epoch
   (flow.bf16, B=256) with its evaluation decoded in bf16 (2 K1), and the
   EMA served as trained (bf16, 1 K1) and with +quant=int8; latents/s
   and s/batch printed. Then flowers_vqgan and flowers_sd served with
   +quant=int8 (1 and 0 K1), the decode of 64 by both codecs in fp32,
   fp32 + int8, bf16 and bf16 + int8, and K1 held inside the VQGAN's bf16
   decode (against na2d_banded in fp32 on the same bf16 values, 2e-2).
26. tpu_vqgan_train (after step 23): configs/tpu_vqgan.yaml as composed
   (codec.bf16: the codec, its discriminator and the VGG16 perceptual net
   compute in bf16 over fp32 parameters) at flowers' full widths, B=64,
   through flocoder_torch.train_vqgan.main over step 7's PNGs: one warmup
   and one GAN epoch of 4 steps, one validation batch; 6 K1 and 6 K2 a
   step and 6 K1 a validation batch, exactly, every launch in bf16; K2 in
   bf16 held against na2d_bwd_banded (fp32 on the same bf16 values, within
   3e-2 of the largest |ref|) on the inputs of the run's last backward at
   the decoder's shape, and bitwise equal across two calls; the card's bf16
   mean against the fp32 mean rounded once; samples/s over the steady
   steps, peak memory and a GAN step's breakdown, printed beside step 7's
   fp32 ones. Earlier (beside step 33's NCCL run, with step 8): one bf16
   warmup and one bf16 GAN step of a small codec
   (hidden 64) on the card against the CPU on the same RVQ picks (the
   card's own differing only at near ties): losses within 3e-2·max(1,
   |ref|) with equal dtypes, Adam's first moments per tensor within 3e-2
   of its largest |ref| plus 2.5 times its spread (the largest |CPU bf16
   − CPU fp32| on the same picks; tensors nought to rounding, spread ≥
   half, left out and counted, at most a tenth), spectral norm's u and σ
   within 1e-4, each gamma within two bf16 spacings where its gradient's
   sign is not rounding's; and the card's steps again with na2d's plain
   twin in place of K1 and K2, read beside. Its checkpoint is step 25's
   codec.
27. audio (last): configs/audio_dac.yaml as composed, fp32, at full width
   (16 kHz, crop_len 32,768, strides 2,4,4,4, base 32, RVQ 4×512×8; the
   waveform discriminators with periods 2,3,5,7,11, 3 scales, base 16; the
   U-Net at dim_mults 1,2,4 over 16×16×8 latents), on synthetic chords.
   Cut in depth only: synthetic_n 64 (4 codec steps an epoch at B=16), 2
   codec epochs (1 reconstruction, 1 GAN; the recipe's 200 with 50
   reconstruction), pre-encode augs_per 4 (its 8: 6 val and 57 train
   batches of 16 over the 256 synthetic chords), 1 flow epoch (its 100;
   14 steps at B=64) with flow.ckpt_every=1 (its 25). Through the port's
   entry points: train_audio_codec (clips/s over the steady steps of each
   phase by CUDA events, peak memory, the losses, validation WAV pairs read
   back), a GAN step's parts by CUDA events and its idle share,
   preencode_data with the trained codec (latents/s; 16×16×8 latents read
   back), train_flow with evaluate_model_audio (RK4, 50 grid points, CFG
   3.0; samples/s over steady steps, sinkhorn_mel), and generate_samples of
   16 clips from the EMA: every WAV reads back through stdlib wave as
   16-bit, 16,000 Hz, 32,768 frames, not all zero, and the decoded samples
   are finite. K1–K5 launch 0 times on each of the four sub-phases
   (audio_train, audio_preencode, audio_flow, audio_serve). Then a small
   DAC (strides 2,4, base 8) and small discriminators, every weight random,
   on the card and on the CPU, TF32 off, on the same weights, batches and
   injected RVQ picks: one reconstruction and one GAN step, losses and
   parameters within 1e-3·max(1, |ref|), Adam's first moments within 1e-3
   of the largest |ref| of each model; the multi-scale STFT and mel losses
   of 4 × 32,768 samples within 1e-4·max(1, |ref|).
28. reflow (after step 17): reflow distillation on flowers_hdit's NA
   variant, bf16, with step 16's EMA checkpoint as the teacher. Through
   flocoder_torch.make_reflow_pairs.main: 1,280 pairs (the tool's 10,000)
   at B=256, RK4 over 20 grid points (76 NFE; the tool's 50) + CFG 3.0, 5
   batches: 1,216 train and 64 val pairs, K1 exactly 4·76·5 times; then
   train_flow.main with +reflow=true for 1 epoch (4 steps, no OT) with its
   evaluation (20 grid points), K1 and K2 held to step 16's formula; then
   generate_samples of the reflowed EMA with Euler at 4 NFE (128 samples
   in 2 batches, K1 4·4 a batch). Prints pairs/s, the reflow samples/s
   over steady steps (CUDA events), a serving batch of 64 by CUDA events at
   4 NFE beside the teacher's at 76, and peak memory. The card against the
   CPU, TF32 off: an fp32 copy of the teacher, its weights perturbed (after
   4 steps its EMA sits near its zero-init output projections, so its own
   pairs lie near their noise), integrates 8 injected noises (RK4, 3 grid
   points, CFG) within 1e-3·max(1, |ref|); one paired fp32
   reflow step (B=64) within 1e-3·max(1, |ref|) on the loss, parameters,
   Adam's first moments and EMA.
29. vqgan_plus (after step 28): flowers_vqgan.yaml with
   codec.choice=vqgan_plus, discriminator=vqgan_plus and lecam_weight
   0.001 at the recipe's widths (hidden 256, 3 downsamples, internal 128,
   RVQ 4×96×4) on step 7's 320 PNGs: train_vqgan.main for 1 warmup and 1
   GAN epoch of 4 steps at B=64 (samples/s over steady steps, a GAN step's
   parts by CUDA events and its idle share, peak memory);
   preencode_data.main with preencoding.quantize=true and fused_vq=true
   over step 10's 500² PNGs at augs_per 1 (1 val and 9 train batches of 32;
   the codec has no fused path, so the unfused RVQ runs and each split
   says so; latents/s); generate_samples of 64 samples from a seeded U-Net
   checkpoint whose codec it is, in fp32 and with +quant=int8, and the
   decode of 64 latents in both (CUDA events). K1–K5 launch 0 times on each
   sub-phase (vqgan_plus_train, vqgan_plus_preencode, vqgan_plus_serve).
   Then one warmup and one GAN step with LeCAM of a small VQGAN+ codec
   (hidden 32) and a base-16 VQGANPlusDiscriminator on the card against
   the CPU, held as step 8 holds the VQGAN's.
30. audio_bf16 (after step 27): step 27 again with the DAC codec in bf16
   (codec.bf16: its convolutions and Snake compute in bf16 over fp32
   parameters; the RVQ, the losses, the waveform discriminators and Adam
   stay fp32), on a data path and checkpoints of its own: codec training
   (1 reconstruction and 1 GAN epoch of 4 steps), its GAN step's parts,
   pre-encoding with the bf16 codec, one flow epoch with flow.bf16=true and
   the bf16 evaluation, and 16 clips served from the EMA checkpoint as
   trained (in bf16, no +bf16 flag), every WAV read back. K1–K5 launch 0
   times on each sub-phase (audio_bf16_train, audio_bf16_preencode,
   audio_bf16_flow, audio_bf16_serve). The bf16 codec's forward on the
   trained weights on the card against the same bf16 codec on the CPU, op
   by op (each of its 118 ops fed the CPU's input) and end to end, and
   against an fp32 codec's on the card (hold_bf16_codec_forward's
   docstring); step 27's small reconstruction and GAN steps with the codec
   in bf16, card against CPU, under a gate that the card's fp32 step
   fails (check_audio_small's docstring). Prints clips/s, the GAN
   step's time, peak memory, latents/s and flow samples/s beside step 27's.
31. webapp (after step 6): the sampler's web UI (flocoder_torch.ui.webapp,
   what generate_samples serves with +use_gradio=true) in a thread on
   127.0.0.1, on flowers_vqgan's CFG checkpoint of step 6: the form's
   fields and methods; one POST of 16 samples, RK4 over 20 grid points,
   CFG 3.0, whose status must not start with ERROR; every written PNG
   served back byte for byte as image/png, a missing file a 404; the
   request's images within 1e-4·max(1, |ref|) of a direct generate_samples
   call with the same config; K1 once for each decoder call of the request
   (one batch of 16), exactly. Prints the request's seconds beside the
   generation's own batch_seconds. K1 at the decode's B=16 joins step 3.
32. quality (first, while nvcc builds the kernels, beside the fixtures
   of step 6): flocoder_torch.quality_runs' five families
   (unet_vs_hdit, meanflow, reflow, audio, image) on the card at tiny
   budgets (8 flow steps, 4 codec and 4 GAN steps, 1 pair batch,
   hdit_budget_x 1, RK4 over 4 grid points) into the temporary directory:
   each payload holds every key of the JAX artifact in eval_out/quality/,
   every number finite, the image family's FID on rp2048; K1–K5 launch 0
   times. The measured quality figures come from the tool's own run
   (eval_out/quality_torch/), not from this phase.
33. dp (after step 23): the parallel layer's data axis
   (flocoder_torch/parallel/mesh.py) at flowers_vqgan's full width. Two
   ranks on the one card, started by torch.multiprocessing.spawn with
   torchrun's variables, join through maybe_init_distributed, which takes
   gloo (CUDA tensors) as the host runs more ranks than it has cards (NCCL
   takes one rank a device); TF32 off in the training parts. Each rank:
   a codec GAN step on its 32 of 64 images (deterministic, the RVQ
   initialised with three codes a level that start dead, its k-means seeds
   and reseed picks injected); the data-parallel
   and the FSDP flow steps on its 128 of 256 latents (FSDP2 by the JAX
   rule), the FSDP state's sharded checkpoint; generate_samples.main of 64
   samples sharded (RK4 + CFG, 20 grid points); the fused encode of its 16
   rows of a batch of 32 (gathered). Rank 0 then computes one process's
   references, the other rank idle: the GAN step on all 64 with the ranks'
   RVQ picks (its own nearest codes must differ only at near ties,
   relative gap under 1e-4: the halves' encodes differ from the whole's in
   the last bits), the data-parallel flow step's documented function (each
   rank's rows with its draws as one microbatch, gradients averaged) and
   the FSDP step's (the one-device step on all 256). Held: parameters
   (codec, discriminator, U-Net) within 1e-3·max(1, |ref|), the losses
   too; Adam's first moments each tensor within 1e-3 of its own largest
   |μ_ref| plus 1e-5 of its model's largest; the GAN step's gradient norms
   before clipping (G's and D's) within 1e-4 relative; the VQ indices
   equal, the RVQ statistics within
   1e-5 relative, every replicated state the same on both ranks hash for
   hash; the checkpoint read back by one process equals the whole state the
   ranks gathered; the served images within 1e-4·max(1, |ref|) of one
   process's given each rank's noise; the encoded latents and indices
   equal one process's encodes of each rank's rows, bit for bit. Launches a
   rank, exactly: 6 K1 and 6 K2 in the GAN step, 1 K1 in the decode, 5 K1
   and 1 K3 in the encode, none in the flow steps. Once the ranks'
   data-parallel GAN steps are timed, train_flow under torchrun --standalone
   --nproc_per_node=1 (NCCL) with flow.fsdp=true and
   flow.sharded_checkpoints=true starts beside them (its ~35 s of start-up
   is imports), 1 epoch of 4 steps on the pre-encode phase's latents, no
   evaluation; step 8 runs beside its end, and then: its FSDP step ran,
   its checkpoint reads back whole and finite. Prints each rank's launches, the step times by CUDA events
   beside one process's, and the phase's
   seconds. A rank that fails makes the join raise and the script exit
   non-zero.

34. ring (last): the model axis's ring attention
   (flocoder_torch/parallel/ring_attention.py) on two ranks of the one
   card, a 1×2 mesh of the model axis, started as step 33's (gloo, CUDA
   tensors; the ring's hops staged through host memory, as gloo's
   point-to-point calls take CPU tensors only). Each rank: the ring op
   (S = 2) at HDiT's global shape (B=256, 16 tokens, 8 heads of 64) and at
   the VQGAN decoder's non-local shape (B=64, 256 tokens, one head, q and k
   of width 2, v of width 4), fp32 and bf16, its forward and the gradients
   of sum(out·w) for q, k, v against plain attention on the same inputs
   (fp32, TF32 off: 1e-5 and 1e-4·max(1, |ref|); bf16 2e-2·max(1, |ref|)),
   two hops a forward and two a backward; flowers_hdit's NA variant at full
   width (the recipe's bf16) and flowers_vqgan's U-Net (fp32), a step each
   through the ring twin (models/flow_model.py:ring_twin), timed by CUDA
   events beside one process's plain step; one fp32 ring step of each, TF32
   off, its parameter changes and Adam's first moments each tensor within
   1e-4 of its own largest |ref| of one process's plain step on the same
   batch and draws (a change also within fp32's spacing at its parameter
   and what Adam's first update, lr·g/(|g| + ε), makes of the two held
   gradients: _ring_hold), the two model replicas' parameters, moments and
   EMA equal bit for bit; K1 and K2 4 a step on each rank, as one
   process's.
   Once the ranks' steps are timed, train_flow under torchrun --standalone
   --nproc_per_node=2 with flow.n_model=2 flow.ring_attention=true on
   flowers_hdit's NA variant (1 epoch of 4 steps on step 14's latents, no
   evaluation) starts beside the holds; its EMA checkpoint is then served
   by generate_samples here (64 samples, RK4 over 20 grid points, K1 4·76
   times, exactly).

Prints a ``{"kernels": [...]}`` JSON line, the card line, and as its last
line ``{"ok": true, "device": {...}}``. Any failure exits non-zero before
that line. Imports nothing of JAX or of flocoder_tpu.
"""
import atexit
import collections
import contextlib
import copy
import json
import os
import shutil
import socket
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
FP32_FLOPS_PER_S = 67e12       # H100 SXM fp32 outside the tensor cores
BF16_FLOPS_PER_S = 989e12      # H100 SXM bf16 tensor cores, dense
FLOW_BATCH = 256               # flowers_vqgan's flow batch
PE_VAL_LATENTS = 4 * 32        # the pre-encode phase's 4 val batches of 32


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def _counts(kernels: dict) -> dict:
    """Each kernel's launches since the last ``_zero``."""
    return {name: k.launches for name, k in kernels.items()}


def _zero(kernels: dict) -> None:
    for k in kernels.values():
        k.launches = 0


def _expect(kernels: dict, path: str, got: dict, **expected) -> None:
    """Fails unless ``got`` holds ``expected`` launches and none of the
    other kernels."""
    want = dict.fromkeys(kernels, 0)
    want.update(expected)
    print(f"{path} launches: {got} (expected {want})", flush=True)
    if got != want:
        fail(f"{path} launched {got}, expected {want}")


def card_line() -> str:
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean milliseconds per call over ``iters`` back-to-back calls, by CUDA
    events, after ``warmup`` calls."""
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


def device_ms(fn, key: str, iters: int = 10) -> float:
    """Device milliseconds per call of ``fn`` spent in the kernels whose
    name holds ``key``, by the profiler over ``iters`` calls after a warm
    one: the kernels' own time, whatever the host spends between launches.
    A window in which the profiler did not see the same number of such
    kernels in each call is taken again (at most twice more). Where it never
    saw one, the time is ``queued_ms``'s, and a line says so."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    ms = 0.0
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        hits = [e for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA and key in e.key]
        ms = sum(e.self_device_time_total for e in hits) / 1e3 / iters
        count = sum(e.count for e in hits)
        if count and count % iters == 0:
            return ms
    if count == 0:
        ms = queued_ms(fn, iters)
        print(f"device_ms({key}): the profiler saw no such kernel in 3 windows; "
              f"{ms:.4f} ms by events around {iters} calls queued behind a spin kernel",
              flush=True)
    return ms


def queued_ms(fn, iters: int) -> float:
    """Milliseconds per call by CUDA events around ``iters`` calls that
    wait behind a spin kernel of ~50 ms, so the card runs them back to
    back whatever the host spends launching them: the device's time."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(100_000_000)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _window_mask(H: int, W: int, ks: int):
    """The (H·W, H·W) clamped-window mask of NA2D, for the SDPA yardstick."""
    r = torch.arange(H, device="cuda")
    c = torch.arange(W, device="cuda")
    rs = (r - ks // 2).clamp(0, H - ks)
    cs = (c - ks // 2).clamp(0, W - ks)
    row_ok = (r[None, :] >= rs[:, None]) & (r[None, :] < rs[:, None] + ks)
    col_ok = (c[None, :] >= cs[:, None]) & (c[None, :] < cs[:, None] + ks)
    return (row_ok[:, None, :, None] & col_ok[None, :, None, :]).reshape(H * W, H * W)


def _steady(events: list) -> list:
    """Seconds between consecutive steps' CUDA events within an epoch (the
    first step of each epoch, with the loader's start, is excluded)."""
    return [b.elapsed_time(a) / 1e3 for (ea, a), (eb, b) in zip(events[1:], events)
            if ea == eb]


def _hooked():
    events = []

    def step_hook(epoch):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        events.append((epoch, ev))
    return events, step_hook


def na2d_bound_ms(B, H, W, C, ks, dtype) -> tuple:
    """(least ms, 'bytes' or 'operations'): q, k, v read once and the output
    written once, against 4·ks²·C FLOPs per pixel (QKᵀ and PV)."""
    n = B * H * W * C
    elem = torch.tensor([], dtype=dtype).element_size()
    t_bytes = 4 * n * elem / HBM_BYTES_PER_S
    t_ops = 4 * ks * ks * n / (FP32_FLOPS_PER_S if dtype == torch.float32
                               else BF16_FLOPS_PER_S)
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def flow_decode_chunks(chunk: int) -> list:
    """The batch of each decoder call in one of the flow phase's evaluation
    decodes: the validation batch (min(FLOW_BATCH, PE_VAL_LATENTS) latents)
    in chunks of ``chunk`` (``evaluation.DECODE_CHUNK``)."""
    n = min(FLOW_BATCH, PE_VAL_LATENTS)
    return [min(chunk, n - i) for i in range(0, n, chunk)]


def check_k1(na2d_fwd, na2d_banded, flow_decode_batches) -> dict:
    """K1 against na2d_banded at every shape the main path gives it (the
    serving decode at B=64 is held in time_k1) and at edge shapes.
    ``flow_decode_batches``: the decoder's batches in the flow phase's
    evaluations."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    g = torch.Generator("cuda").manual_seed(0)
    both = ((torch.float32, 1e-4), (torch.bfloat16, 2e-2))
    cases = [  # (label, (B, H, W, C), heads, kernel_size, dtypes)
        ("decoder/encoder 32x32 C512 dh64", (8, 32, 32, 512), 8, 7, both),
        ("encoder 16x16 C1024 dh128", (8, 16, 16, 1024), 8, 7, both),
        ("encoder 16x16 C128 dh16", (8, 16, 16, 128), 8, 7, both),
        # the serving runs' own shapes: decode at batch 64, img2img's encode
        # of one image (the decode at 64 is held in time_k1)
        ("serving encode 32x32 C512 dh64 B1", (1, 32, 32, 512), 8, 7, both),
        ("serving encode 16x16 C1024 dh128 B1", (1, 16, 16, 1024), 8, 7, both),
        ("serving encode 16x16 C128 dh16 B1", (1, 16, 16, 128), 8, 7, both),
        # the pre-encode's own shapes: the encoder at batch 32, in fp32
        ("pre-encode 32x32 C512 dh64 B32", (32, 32, 32, 512), 8, 7, both[:1]),
        ("pre-encode 16x16 C1024 dh128 B32", (32, 16, 16, 1024), 8, 7, both[:1]),
        ("pre-encode 16x16 C128 dh16 B32", (32, 16, 16, 128), 8, 7, both[:1]),
        # the web UI's decode of one request's batch, in fp32
        (f"web UI decode 32x32 C512 dh64 B{WEBAPP_SAMPLES}", (WEBAPP_SAMPLES, 32, 32, 512),
         8, 7, both[:1]),
        # the flow phase's evaluation decodes, in fp32
        *((f"flow eval decode 32x32 C512 dh64 B{b}", (b, 32, 32, 512), 8, 7, both[:1])
          for b in sorted(set(flow_decode_batches))),
        ("non-square 24x40 dh32", (2, 24, 40, 64), 2, 7, both),
        ("smaller than k 5x6 dh8 (ks=5)", (2, 5, 6, 32), 4, 7, both),
        ("ragged tiles 17x13 dh24", (2, 17, 13, 48), 2, 7, both),
    ]
    errs = {torch.float32: 0.0, torch.bfloat16: 0.0}
    for label, shape, heads, ks, dtypes in cases:
        for dtype, tol in dtypes:
            q, k, v = (torch.randn(shape, device="cuda", generator=g).to(dtype)
                       for _ in range(3))
            out = na2d_fwd(q, k, v, kernel_size=ks, heads=heads)
            torch.cuda.synchronize()
            ref = na2d_banded(q.float(), k.float(), v.float(),
                              kernel_size=ks, heads=heads)
            err = (out.float() - ref).abs().max().item()
            ok = bool(np.isfinite(err)) and err < tol
            print(f"K1 check {label} {str(dtype)[6:]}: max_abs_err={err:.3e} "
                  f"(tol {tol:g}) {'ok' if ok else 'FAIL'}", flush=True)
            if not ok:
                fail(f"K1 disagrees with its plain version at {label} {dtype}")
            errs[dtype] = max(errs[dtype], err)
    return errs


def time_k1(na2d_fwd, na2d_banded, card: str) -> dict:
    import torch.nn.functional as F
    B, H, W, C, heads, ks = 64, 32, 32, 512, 8, 7
    dh = C // heads
    g = torch.Generator("cuda").manual_seed(1)
    q, k, v = (torch.randn(B, H, W, C, device="cuda", generator=g)
               for _ in range(3))
    out = na2d_fwd(q, k, v, kernel_size=ks, heads=heads)
    torch.cuda.synchronize()
    err = (out - na2d_banded(q, k, v, kernel_size=ks, heads=heads)).abs().max().item()
    print(f"K1 check serving decode {H}x{W} C{C} dh{dh} B{B} float32: "
          f"max_abs_err={err:.3e} (tol 0.0001) {'ok' if err < 1e-4 else 'FAIL'}",
          flush=True)
    if not err < 1e-4:
        fail("K1 disagrees with its plain version at the serving decode shape")
    ms = cuda_ms(lambda: na2d_fwd(q, k, v, kernel_size=ks, heads=heads), 50)
    dev_ms = device_ms(lambda: na2d_fwd(q, k, v, kernel_size=ks, heads=heads), "na2d_fwd")
    plain_ms = cuda_ms(lambda: na2d_banded(q, k, v, kernel_size=ks,
                                           heads=heads), 5, warmup=1)
    qb, kb, vb = (bf.to(torch.bfloat16) for bf in (q, k, v))
    bf16_ms = cuda_ms(lambda: na2d_fwd(qb, kb, vb, kernel_size=ks,
                                       heads=heads), 50)

    # yardstick: one SDPA call over the 1024 tokens with the NATTEN mask
    mask = _window_mask(H, W, ks)
    qs, ks_, vs = (t.reshape(B, H * W, heads, dh).transpose(1, 2).contiguous()
                   for t in (q, k, v))
    sdpa = lambda: F.scaled_dot_product_attention(qs, ks_, vs, attn_mask=mask)  # noqa: E731
    lib = sdpa().transpose(1, 2).reshape(B, H, W, C)
    lib_err = (lib - out).abs().max().item()
    if not lib_err < 1e-3:
        fail(f"the SDPA yardstick disagrees with K1 ({lib_err:.3e})")
    library_ms = cuda_ms(sdpa, 10, warmup=2)
    bound_ms, bound_by = na2d_bound_ms(B, H, W, C, ks, torch.float32)
    bf16_bound, _ = na2d_bound_ms(B, H, W, C, ks, torch.bfloat16)
    print(f"K1 time (B={B}, {H}x{W}, C={C}, {heads} heads, k={ks}) fp32: "
          f"kernel_ms={ms:.4f} device_ms={dev_ms:.4f} plain_ms={plain_ms:.4f} "
          f"library_ms={library_ms:.4f} "
          f"bound_ms={bound_ms:.4f} ({bound_by}) | bf16: kernel_ms={bf16_ms:.4f} "
          f"bound_ms={bf16_bound:.4f} | card: {card}", flush=True)
    del q, k, v, qb, kb, vb, qs, ks_, vs, lib, out
    torch.cuda.empty_cache()
    return dict(ms=ms, device_ms=dev_ms, plain_ms=plain_ms, library_ms=library_ms,
                bound_ms=bound_ms, bound_by=bound_by), err


def na2d_bwd_bound_ms(B, H, W, C, ks, dtype) -> tuple:
    """(least ms, 'bytes' or 'operations') of K2: q, k, v, o and g read
    once, dq, dk and dv written once, against 10·ks²·C FLOPs per pixel
    (the QKᵀ recompute, dP, dQ, dK and dV)."""
    n = B * H * W * C
    elem = torch.tensor([], dtype=dtype).element_size()
    t_bytes = 8 * n * elem / HBM_BYTES_PER_S
    t_ops = 10 * ks * ks * n / (FP32_FLOPS_PER_S if dtype == torch.float32
                                else BF16_FLOPS_PER_S)
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def check_k2(na2d_fwd, na2d_bwd, na2d_bwd_banded) -> dict:
    """K2 against its plain twin on the same q, k, v, g and K1's output."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    g = torch.Generator("cuda").manual_seed(3)
    cases = [  # (label, (B, H, W, C), heads, kernel_size)
        ("decoder/encoder 32x32 C512 dh64", (8, 32, 32, 512), 8, 7),
        ("encoder 16x16 C1024 dh128", (8, 16, 16, 1024), 8, 7),
        ("encoder 16x16 C128 dh16", (8, 16, 16, 128), 8, 7),
        ("non-square 24x40 dh32", (2, 24, 40, 64), 2, 7),
        ("smaller than k 5x6 dh8 (ks=5)", (2, 5, 6, 32), 4, 7),
        ("ragged tiles 17x13 dh24", (2, 17, 13, 48), 2, 7),
    ]
    errs = {torch.float32: 0.0, torch.bfloat16: 0.0}
    for label, shape, heads, ks in cases:
        for dtype, rel in ((torch.float32, 1e-4), (torch.bfloat16, 3e-2)):
            q, k, v, gr = (torch.randn(shape, device="cuda", generator=g).to(dtype)
                           for _ in range(4))
            o = na2d_fwd(q, k, v, kernel_size=ks, heads=heads)
            grads = na2d_bwd(q, k, v, o, gr, kernel_size=ks, heads=heads)
            torch.cuda.synchronize()
            refs = na2d_bwd_banded(*(t.float() for t in (q, k, v, o, gr)),
                                   kernel_size=ks, heads=heads)
            for name, a, ref in zip(("dq", "dk", "dv"), grads, refs):
                err = (a.float() - ref).abs().max().item()
                tol = rel * max(1.0, ref.abs().max().item())
                ok = bool(np.isfinite(err)) and err < tol
                print(f"K2 check {label} {str(dtype)[6:]} {name}: max_abs_err="
                      f"{err:.3e} (tol {tol:.3e}) {'ok' if ok else 'FAIL'}", flush=True)
                if not ok:
                    fail(f"K2 disagrees with its plain twin at {label} {dtype} {name}")
                errs[dtype] = max(errs[dtype], err)
            if label.startswith("decoder"):     # no atomics: a second call is bitwise equal
                again = na2d_bwd(q, k, v, o, gr, kernel_size=ks, heads=heads)
                same = all(torch.equal(a, b) for a, b in zip(grads, again))
                print(f"K2 determinism {label} {str(dtype)[6:]}: two calls bitwise equal: "
                      f"{same}", flush=True)
                if not same:
                    fail(f"K2 gave two different results on the same inputs ({dtype})")
    return errs


def check_function(na2d, na2d_banded) -> None:
    """The gradients of na2d on the card (NA2DFunction: K1 forward, K2
    backward) against torch autograd through the plain na2d_banded."""
    g = torch.Generator("cuda").manual_seed(4)
    for shape, heads in (((2, 16, 16, 128), 8), ((2, 17, 13, 48), 2)):
        q, k, v, gr = (torch.randn(shape, device="cuda", generator=g) for _ in range(4))
        grads = []
        for fn in (na2d, na2d_banded):
            leaves = [t.clone().requires_grad_() for t in (q, k, v)]
            out = fn(*leaves, kernel_size=7, heads=heads)
            grads.append(torch.autograd.grad(out, leaves, gr))
        for name, a, ref in zip(("dq", "dk", "dv"), *grads):
            err = (a - ref).abs().max().item()
            tol = 1e-4 * max(1.0, ref.abs().max().item())
            print(f"NA2DFunction {shape} {name}: max_abs_err={err:.3e} (tol {tol:.3e})",
                  flush=True)
            if not (np.isfinite(err) and err < tol):
                fail(f"na2d's gradient on the card disagrees with autograd ({name})")


def time_k2(na2d_fwd, na2d_bwd, na2d_bwd_banded, na2d, card: str) -> tuple:
    import torch.nn.functional as F
    B, H, W, C, heads, ks = 64, 32, 32, 512, 8, 7
    dh = C // heads
    g = torch.Generator("cuda").manual_seed(5)
    q, k, v, gr = (torch.randn(B, H, W, C, device="cuda", generator=g)
                   for _ in range(4))
    o = na2d_fwd(q, k, v, kernel_size=ks, heads=heads)
    grads = na2d_bwd(q, k, v, o, gr, kernel_size=ks, heads=heads)
    torch.cuda.synchronize()
    refs = na2d_bwd_banded(q, k, v, o, gr, kernel_size=ks, heads=heads)
    err = max((a - r).abs().max().item() for a, r in zip(grads, refs))
    tol = 1e-4 * max(1.0, max(r.abs().max().item() for r in refs))
    print(f"K2 check training decode {H}x{W} C{C} dh{dh} B{B} float32: "
          f"max_abs_err={err:.3e} (tol {tol:.3e})", flush=True)
    if not err < tol:
        fail("K2 disagrees with its plain twin at the decoder's training shape")
    del refs
    ms = cuda_ms(lambda: na2d_bwd(q, k, v, o, gr, kernel_size=ks, heads=heads), 20)
    dev_ms = device_ms(lambda: na2d_bwd(q, k, v, o, gr, kernel_size=ks, heads=heads),
                       "na2d_bwd")
    plain_ms = cuda_ms(lambda: na2d_bwd_banded(q, k, v, o, gr, kernel_size=ks,
                                               heads=heads), 3, warmup=1)
    qb, kb, vb, ob, gb = (t.to(torch.bfloat16) for t in (q, k, v, o, gr))
    bf16_fn = lambda: na2d_bwd(qb, kb, vb, ob, gb, kernel_size=ks, heads=heads)  # noqa: E731
    bf16_ms = cuda_ms(bf16_fn, 20)
    bf16_dev_ms = device_ms(bf16_fn, "na2d_bwd")
    bf16_plain_ms = cuda_ms(lambda: na2d_bwd_banded(qb, kb, vb, ob, gb, kernel_size=ks,
                                                    heads=heads), 3, warmup=1)

    # yardstick: SDPA forward + backward with the NATTEN mask, against K1 + K2
    mask = _window_mask(H, W, ks)
    heads_first = lambda t: (t.reshape(B, H * W, heads, dh).transpose(1, 2)  # noqa: E731
                             .contiguous().requires_grad_())
    qs, ks_, vs = (heads_first(t) for t in (q, k, v))
    gs = gr.reshape(B, H * W, heads, dh).transpose(1, 2).contiguous()
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    sdpa_grads = torch.autograd.grad(
        F.scaled_dot_product_attention(qs, ks_, vs, attn_mask=mask), (qs, ks_, vs), gs)
    lib_err = max((a.transpose(1, 2).reshape(B, H, W, C) - b).abs().max().item()
                  for a, b in zip(sdpa_grads, grads))
    if not lib_err < 1e-3:
        fail(f"the SDPA yardstick's gradients disagree with K2 ({lib_err:.3e})")
    library_ms = cuda_ms(lambda: torch.autograd.grad(
        F.scaled_dot_product_attention(qs, ks_, vs, attn_mask=mask),
        (qs, ks_, vs), gs), 5, warmup=2)
    qs, ks_, vs = (t.detach().bfloat16().requires_grad_() for t in (qs, ks_, vs))
    gs = gs.bfloat16()
    bf16_library_ms = cuda_ms(lambda: torch.autograd.grad(
        F.scaled_dot_product_attention(qs, ks_, vs, attn_mask=mask),
        (qs, ks_, vs), gs), 5, warmup=2)
    fwd_bwd_ms = cuda_ms(lambda: torch.autograd.grad(
        na2d(*leaves, kernel_size=ks, heads=heads), leaves, gr), 20)
    bound_ms, bound_by = na2d_bwd_bound_ms(B, H, W, C, ks, torch.float32)
    bf16_bound, bf16_bound_by = na2d_bwd_bound_ms(B, H, W, C, ks, torch.bfloat16)
    print(f"K2 time (B={B}, {H}x{W}, C={C}, {heads} heads, k={ks}) fp32: "
          f"kernel_ms={ms:.4f} device_ms={dev_ms:.4f} plain_ms={plain_ms:.4f} "
          f"bound_ms={bound_ms:.4f} "
          f"({bound_by}) | K1+K2 fwd+bwd_ms={fwd_bwd_ms:.4f} SDPA fwd+bwd "
          f"library_ms={library_ms:.4f} | bf16 (the bf16 codec step's): kernel_ms="
          f"{bf16_ms:.4f} device_ms={bf16_dev_ms:.4f} plain_ms={bf16_plain_ms:.4f} "
          f"bound_ms={bf16_bound:.4f} ({bf16_bound_by}) SDPA fwd+bwd library_ms="
          f"{bf16_library_ms:.4f} | card: {card}", flush=True)
    del q, k, v, gr, o, grads, qb, kb, vb, ob, gb, qs, ks_, vs, gs, leaves, sdpa_grads
    torch.cuda.empty_cache()
    return dict(ms=ms, device_ms=dev_ms, plain_ms=plain_ms, library_ms=library_ms,
                bound_ms=bound_ms, bound_by=bound_by, fwd_bwd_ms=fwd_bwd_ms,
                bf16=dict(ms=bf16_ms, device_ms=bf16_dev_ms, plain_ms=bf16_plain_ms,
                          library_ms=bf16_library_ms, bound_ms=bf16_bound,
                          bound_by=bf16_bound_by)), err


# (B, H, W, C, heads) of the codec's NATTEN blocks (k=7) at the main paths'
# batches: 64 (serving decode, training), 32 (pre-encode's encoder).
NA2D_SHAPES = [(64, 32, 32, 512, 8), (64, 16, 16, 1024, 8), (64, 16, 16, 128, 8),
               (32, 32, 32, 512, 8), (32, 16, 16, 1024, 8), (32, 16, 16, 128, 8)]


def time_na2d_shapes(na2d_fwd, na2d_bwd, card: str, bwd_batch: int = 64) -> list:
    """K1 at every shape of NA2D_SHAPES and K2 at those of batch
    ``bwd_batch``, fp32 and bf16: the kernels' device time by the profiler
    (10 calls), CUDA events over 20 back-to-back calls, and the bound.
    Takes the kernels as arguments, so that benchmarks/na2d_shapes.py can
    time another checkout's kernels with it."""
    rows = []
    g = torch.Generator("cuda").manual_seed(6)
    for B, H, W, C, heads in NA2D_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v, gr = (torch.randn(B, H, W, C, device="cuda", generator=g).to(dtype)
                           for _ in range(4))
            fwd = lambda: na2d_fwd(q, k, v, kernel_size=7, heads=heads)  # noqa: E731
            runs = [("na2d_fwd", fwd, na2d_bound_ms)]
            if B == bwd_batch:
                o = fwd()
                runs.append(("na2d_bwd", lambda: na2d_bwd(q, k, v, o, gr, kernel_size=7,
                                                          heads=heads), na2d_bwd_bound_ms))
            for name, fn, bound in runs:
                row = dict(kernel=name, shape=[B, H, W, C], heads=heads,
                           dtype=str(dtype)[6:], device_ms=device_ms(fn, name),
                           ms=cuda_ms(fn, 20), bound_ms=bound(B, H, W, C, 7, dtype)[0])
                rows.append(row)
                print(f"{name} shape B={B} {H}x{W} C={C} {row['dtype']}: device_ms="
                      f"{row['device_ms']:.4f} ms={row['ms']:.4f} bound_ms="
                      f"{row['bound_ms']:.4f} | card: {card}", flush=True)
            del q, k, v, gr
    torch.cuda.empty_cache()
    return rows


def scale_codebooks(codec, image_size: int) -> None:
    """Scales the codec's N(0, 0.02²) codebooks to the spread of its
    encoder's output on seeded random images, so that the RVQ picks spread
    over the codes (as the JAX package's fused VQ test does)."""
    g = torch.Generator(codec.vq.codebooks.device).manual_seed(9)
    x = torch.rand(4, image_size, image_size, 3, device=g.device, generator=g) * 2 - 1
    with torch.inference_mode():
        spread = codec.encode(x).std().item()
    codec.vq.codebooks.data.mul_(spread / 0.02)


def write_checkpoints(tmp: str, config_dir: str, recipe: str = "flowers_vqgan"):
    """Seeded random-init checkpoints in the npz contract for ``recipe`` as
    composed: an unconditional U-Net (dim 16, dim_mults 1,2,4,8 on
    16×16×4 latents) and a class-conditional one (n_classes 102), and for
    flowers_vqgan the VQGAN codec (128², hidden 256, 3 downsamples; its
    codebooks scaled by ``scale_codebooks``; NATTEN gates set to 1 so that
    K1's output reaches the images). flowers_sd's SD VAE has no checkpoint
    file: serving seeds it as pre-encoding does. The files hold the
    contract's keys (training/checkpoint.py:checkpoint_payload) written by
    np.savez, uncompressed: seeded random floats barely compress, and
    zlib on the codec's weights took most of the serving phase."""
    from flocoder_torch.config import load_config
    from flocoder_torch.models.codecs import NATTENBlock, setup_codec
    from flocoder_torch.models.layers import init_params
    from flocoder_torch.models.unet import Unet
    from flocoder_torch.training.checkpoint import (
        UNET_PREFIXES, VQVAE_PREFIXES, checkpoint_payload, to_jax_flat)

    def write(path, params, config=None):
        t0 = time.time()
        np.savez(path, **checkpoint_payload(params, 0, config))
        print(f"fixture {os.path.basename(path)}: {os.path.getsize(path) / 2**20:.1f} MiB "
              f"written in {time.time() - t0:.2f} s (np.savez)", flush=True)
        return path

    gen = torch.Generator("cuda")
    paths, over = {}, []
    if recipe == "flowers_vqgan":
        paths["codec"] = os.path.join(tmp, "vqgan_0.npz")
        over = [f"codec.checkpoint={paths['codec']}"]
        codec = init_params(setup_codec(load_config(recipe, config_dir, over), device="cuda"),
                            gen.manual_seed(0))
        for m in codec.modules():
            if isinstance(m, NATTENBlock):
                m.gamma.data.fill_(1.0)
        scale_codebooks(codec, 128)
        write(paths["codec"], to_jax_flat(codec, VQVAE_PREFIXES))
    for name, n_classes in (("uncond", 0), ("cfg", 102)):
        cfg = load_config(recipe, config_dir, over + [f"flow.unet.n_classes={n_classes}"])
        unet = Unet(dim=16, channels=4, dim_mults=(1, 2, 4, 8),
                    n_classes=n_classes).cuda()
        init_params(unet, gen.manual_seed(1))
        paths[name] = write(os.path.join(tmp, f"flowema_{recipe}_{name}_0.npz"),
                            to_jax_flat(unet, UNET_PREFIXES), cfg)
    return paths


def serve(tmp: str, paths: dict, card: str, kernels: dict) -> tuple:
    from PIL import Image
    from flocoder_torch import generate_samples as gs

    init_png = os.path.join(tmp, "init.png")
    rng = np.random.default_rng(0)
    Image.fromarray(rng.integers(0, 256, (128, 128, 3), dtype=np.uint8)).save(init_png)
    runs = [  # (label, checkpoint, extra args, samples, decodes, encodes)
        ("unconditional", paths["uncond"], [], 128, 2, 0),
        ("CFG n_classes=102", paths["cfg"], [], 128, 2, 0),
        ("img2img (encoder)", paths["uncond"],
         [f"+init_image={init_png}", "+init_strength=0.5"], 64, 1, 1),
    ]
    results = []
    _zero(kernels)
    expected = 0
    for label, ckpt, extra, n, decodes, encodes in runs:
        torch.cuda.reset_peak_memory_stats()
        res = gs.main(["--config-name", "flowers_vqgan.yaml",
                       f"+flow_checkpoint={ckpt}", f"+n_samples={n}",
                       "+n_steps=20", "flow.batch_size=64", "+seed=0",
                       f"+output_dir={os.path.join(tmp, 'out')}", *extra])
        imgs = res["images"]
        if imgs.shape != (n, 128, 128, 3) or not np.isfinite(imgs).all():
            fail(f"serving {label}: images {imgs.shape}, finite="
                 f"{bool(np.isfinite(imgs).all())}")
        secs = res["batch_seconds"]
        peak = torch.cuda.max_memory_allocated() / 2**30
        rec = dict(run=label, samples=n, nfe=res["nfe"], batch=64,
                   s_per_batch=secs, samples_per_s=n / sum(secs),
                   steady_samples_per_s=64 / secs[-1], peak_mem_gib=peak,
                   card=card)
        print(f"serve {label}: {n} samples, nfe={res['nfe']}, s/batch="
              f"{[round(s, 4) for s in secs]}, {rec['samples_per_s']:.2f} samples/s "
              f"(last batch {rec['steady_samples_per_s']:.2f}), peak "
              f"{peak:.2f} GiB | card: {card}", flush=True)
        results.append(rec)
        expected += decodes + 5 * encodes   # 1 NATTEN block per decode, 5 per encode
    launches = _counts(kernels)
    _expect(kernels, "serving", launches, na2d_fwd=expected)
    return results, launches


def breakdown(paths: dict, card: str) -> dict:
    """Where a serving batch's time goes, by CUDA events on the served
    models: one U-Net forward at the batch the sampler gives it (64, or 128
    with CFG), the decode of 64 latents, and the encode of one image; then
    one unconditional batch of 64 (20 grid points) under the profiler."""
    from flocoder_torch import generate_samples as gs
    from flocoder_torch.config import Config
    from flocoder_torch.evaluation import sampler

    dev = torch.device("cuda")
    unc = gs.load_models_once(Config({}), paths["uncond"], dev)
    cls = gs.load_models_once(Config({}), paths["cfg"], dev)
    g = torch.Generator("cuda").manual_seed(2)
    x64 = torch.randn(64, 16, 16, 4, device="cuda", generator=g)
    x128 = torch.cat([x64, x64])
    t64, t128 = (torch.full((n,), 500.0, device="cuda") for n in (64, 128))
    cc = torch.cat([torch.arange(64, device="cuda"),
                    torch.full((64,), -1, device="cuda")])
    img = torch.rand(1, 128, 128, 3, device="cuda", generator=g)
    with torch.inference_mode():
        out = dict(
            unet_b64_ms=cuda_ms(lambda: unc["model"](x64, t64, None), 20),
            unet_cfg_b128_ms=cuda_ms(lambda: cls["model"](
                x128, t128, {"class_cond": cc}), 20),
            decode_b64_ms=cuda_ms(lambda: unc["codec"].decode(x64), 5),
            encode_b1_ms=cuda_ms(lambda: unc["codec"].encode(img), 5))
        out.update(profile_batch(lambda: sampler(
            unc["model"], unc["codec"], torch.Generator("cuda").manual_seed(0),
            batch_size=64, n_steps=20, latent_shape=(16, 16, 4))))
    top = out.pop("top_kernels")
    print("serving breakdown: " + " ".join(f"{k}={v:.4f}" for k, v in out.items())
          + f" | card: {card}", flush=True)
    print("  device time by kernel (ms): " + "; ".join(
        f"{name[:60]}={ms:.2f}" for name, ms in top), flush=True)
    out["top_kernels"] = top
    return out


def profile_batch(fn) -> dict:
    """One call of ``fn`` under torch.profiler, tracing the device only (a
    trace of every host-side op cost seconds a call and slowed the call it
    measured): wall seconds (profiler on), the device's busy seconds (sum of
    kernel times on the card), its idle share, the device time of the NA2D
    kernels (K1, K2), and the kernels that took the most device time. Where
    the profiler saw no kernel the shares are None, and a line says so."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        fn()
        torch.cuda.synchronize()
        wall = time.time() - t0
    # the device's activities as the tracer recorded them, summed by name
    # (key_averages builds the host's event tree first: ~2 s a serving batch)
    ms = collections.defaultdict(float)
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA and not e.is_user_annotation():
            ms[e.name()] += e.duration_ns() / 1e6
    busy = sum(ms.values()) / 1e3
    if not ms:
        print("profile_batch: the profiler saw no kernel; no idle share", flush=True)
    top = sorted(ms.items(), key=lambda kv: -kv[1])[:6]
    return dict(profiled_batch_s=wall, device_busy_s=busy if ms else None,
                device_idle_share=1.0 - busy / wall if ms else None,
                na2d_kernels_ms=sum(v for k, v in ms.items() if "na2d" in k),
                top_kernels=top)


def check_small_input(ckpt: str, label: str = "") -> dict:
    """The served model of checkpoint ``ckpt`` (class-conditional, 16×16×4
    latents) and its codec on the card against copies on the CPU, TF32
    off: RK4 + CFG (4 grid points) and decode for 2 samples, and the encode
    of an image, within 1e-3·max(1, |ref|). Returns the errors."""
    from flocoder_torch import generate_samples as gs
    from flocoder_torch.evaluation import sampler
    from flocoder_torch.config import Config

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    b = gs.load_models_once(Config({}), ckpt, torch.device("cuda"))
    cpu_model = copy.deepcopy(b["model"]).to("cpu")
    cpu_codec = copy.deepcopy(b["codec"]).to("cpu")
    rng = np.random.default_rng(5)
    src = torch.from_numpy(rng.normal(size=(2, 16, 16, 4)).astype(np.float32))
    img = torch.from_numpy(rng.uniform(size=(1, 128, 128, 3)).astype(np.float32))
    cc = torch.tensor([3, 77])
    kw = dict(method="rk4", batch_size=2, n_steps=4, n_classes=102,
              latent_shape=(16, 16, 4), cfg_strength=3.0)
    out = {}
    for dev, model, codec in (("cuda", b["model"], b["codec"]),
                              ("cpu", cpu_model, cpu_codec)):
        lat, dec, _ = sampler(model, codec, torch.Generator(dev),
                              cond={"class_cond": cc.to(dev)},
                              source=src.to(dev), **kw)
        with torch.inference_mode():
            enc = codec.encode(img.to(dev))
        out[dev] = [t.float().cpu() for t in (lat, dec, enc)]
    errs = {}
    for name, a, ref in zip(("latents", "images", "encoded"), out["cuda"], out["cpu"]):
        err = errs[name] = (a - ref).abs().max().item()
        tol = 1e-3 * max(1.0, ref.abs().max().item())
        print(f"card vs CPU {label}{name} {tuple(a.shape)}: max_abs_err={err:.3e} "
              f"(tol {tol:.3e})", flush=True)
        if not (np.isfinite(err) and err < tol):
            fail(f"card and CPU disagree on {label}{name}")
    return errs


def write_pngs(folder: str, n: int = 320, size: int = 128, seed: int = 3) -> str:
    """``n`` seeded random RGB PNGs (at 128², 10% go to validation, the rest
    give 4 training steps of 64 per epoch), drawn in order and encoded on
    8 threads."""
    from PIL import Image
    os.makedirs(folder)
    rng = np.random.default_rng(seed)
    images = [rng.integers(0, 256, (size, size, 3), dtype=np.uint8) for _ in range(n)]

    def save(i):
        Image.fromarray(images[i]).save(os.path.join(folder, f"img_{i:04d}.png"),
                                        compress_level=1)

    with ThreadPoolExecutor(8) as pool:
        list(pool.map(save, range(n)))
    return folder


def train_flowers(tmp: str, card: str, kernels: dict) -> tuple:
    """flowers_vqgan at full width through flocoder_torch.train_vqgan.main:
    one warmup and one GAN epoch of 4 steps at batch 64, one validation
    batch. Checks the kernels' launch counts, the losses and the
    checkpoint."""
    from flocoder_torch import train_vqgan as tv

    data = write_pngs(os.path.join(tmp, "flowers"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = True      # PyTorch's default for convs
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _zero(kernels)
    t0 = time.time()
    res = tv.main(["--config-name", "flowers_vqgan.yaml", f"data={data}",
                   "codec.epochs=2", "codec.warmup_epochs=1", "+seed=0",
                   f"+ckpt_dir={os.path.join(tmp, 'ckpt')}",
                   f"+output_dir={os.path.join(tmp, 'train_out')}"])
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = _counts(kernels)
    n_steps = {ph: len(t) for ph, t in res["step_seconds"].items()}
    steps = sum(n_steps.values())
    _expect(kernels, f"train ({n_steps} steps, {len(res['val'])} validation batch)", launches,
            na2d_fwd=6 * steps + 6 * len(res["val"]), na2d_bwd=6 * steps)
    if min(n_steps.values()) < 4:
        fail(f"training ran {n_steps} steps")
    losses = [v for e in res["epochs"] + res["val"] for k, v in e.items()
              if k not in ("epoch", "phase")]
    if not np.isfinite(losses).all():
        fail(f"training losses are not finite: {res['epochs']} {res['val']}")
    if res["checkpoint"] is None or not os.path.exists(res["checkpoint"]):
        fail("training wrote no checkpoint")
    rec = train_record(res, wall, card)
    rec["metrics_log"] = check_codec_train_log(tmp, res)
    return res["state"], rec, launches


def check_metrics_log(path: str, must: list, label: str) -> dict:
    """A trainer's ``metrics.jsonl``: a ``_config`` record first, then
    records each with ``_step`` and ``_t`` that hold every key of ``must``
    between them (a key ending in ``*``: one with that prefix). Returns the
    record count and the keys."""
    if not path or not os.path.exists(path):
        fail(f"{label}: no metrics log ({path})")
    with open(path) as f:
        recs = [json.loads(line) for line in f]
    keys = set().union(*map(set, recs[1:])) if len(recs) > 1 else set()
    missing = [k for k in must if not any(x == k or (k.endswith("*") and x.startswith(k[:-1]))
                                          for x in keys)]
    if list(recs[0]) != ["_config"] or missing or \
            not all({"_step", "_t"} <= set(r) for r in recs[1:]):
        fail(f"{label}: metrics log {path} lacks {missing} (first record {list(recs[0])})")
    print(f"{label} metrics log {os.path.relpath(path)}: {len(recs) - 1} records, keys "
          f"{sorted(k for k in keys if not k.startswith('_'))}", flush=True)
    return dict(path=os.path.relpath(path), records=len(recs) - 1, keys=sorted(keys))


CODEBOOK_FIGURES = ["codebook_usage_epoch{e}.png", "codebook_combos_epoch{e}.png",
                    "codebook_vectors_epoch{e}.png", "codebook_3d_epoch{e}.png",
                    "zq_3d_scatter_epoch{e}.png", "zq_3d_scatter_epoch{e}.html",
                    "zq_3d_freq_train_log_epoch{e}.png", "zq_3d_freq_train_log_epoch{e}.html",
                    "zq_3d_freq_val_log_epoch{e}.png", "zq_3d_freq_val_log_epoch{e}.html"]


def check_codec_train_log(tmp: str, res: dict) -> dict:
    """The codec training's metrics log (train/…, val/…, demo/recon; the
    working directory is the temporary one, so runs/ lands there), then
    the analysis the trainer runs every 10th epoch, on the run's tracker and
    the trained codec's codebooks on the card, into a log of its own:
    the codebook/… records and, where matplotlib is installed, the figures
    under the JAX module's names (PNG and HTML); without it the analysis
    prints that it skipped them and the phase says why. No codec forward
    runs here."""
    import importlib.util
    from flocoder_torch.utils import logging as wblog
    from flocoder_torch.utils.codebook_analysis import analyze_codebooks

    out = dict(train=check_metrics_log(res["metrics_log"], [
        "train/total", "train/mse", "samples_per_sec", "val/total", "demo/recon"],
        "codec training"))
    epoch = len(res["epochs"])
    figures_dir = os.path.join(tmp, "train_out")
    path = wblog.init(project="chip_smoke", name="codebooks",
                      config={"checkpoint": res["checkpoint"], "epoch": epoch},
                      output_dir=os.path.join(tmp, "runs"))
    numbers = analyze_codebooks(res["codebook_tracker"], res["state"].codec.vq, epoch,
                                use_wandb=True, output_dir=figures_dir)
    wblog.finish()
    has_mpl = importlib.util.find_spec("matplotlib") is not None
    must = ["codebook/train_usage_pct_level0", "codebook/val_usage_pct_level0",
            "codebook/val_only_codes"]
    if has_mpl:
        must += ["codebook/usage_hist", "codebook/combination_usage_map", "codebook/vectors",
                 "codebook/zq_3d_scatter", "codebook/train_3d_frequency_scatter_log"]
    out["codebooks"] = check_metrics_log(path, must, "codebook analysis")
    out["codebook_numbers"] = numbers
    if has_mpl:
        names = [f.format(e=epoch) for f in CODEBOOK_FIGURES]
        missing = [n for n in names if not os.path.exists(os.path.join(figures_dir, n))]
        if missing:
            fail(f"codebook figures missing: {missing}")
        out["figures"] = names
        print(f"codebook figures written: {names}", flush=True)
    else:
        out["figures"] = "skipped: matplotlib is not installed on this machine"
        print("codebook figures skipped: matplotlib is not installed on this machine; the "
              "analysis printed 'codebook plots skipped' and training went on", flush=True)
    return out


def train_record(res: dict, wall: float, card: str) -> dict:
    """A codec-training run's record from train_vqgan.main's result: per
    phase the step seconds, samples/s over the steady steps (their median,
    the first excluded) and over the epoch; peak memory, the losses;
    printed."""
    peak = torch.cuda.max_memory_allocated() / 2**30
    rec = dict(batch=64, wall_s=wall, peak_mem_gib=peak, card=card,
               dtype=str(res["state"].codec.dtype), epochs=res["epochs"], val=res["val"])
    for ph, secs in res["step_seconds"].items():
        steady = secs[1:]
        (ep,) = [e for e in res["epoch_seconds"] if e["phase"] == ph]
        rec[ph] = dict(step_s=secs, steady_step_s=float(np.median(steady)),
                       samples_per_s=64 / float(np.median(steady)),
                       epoch_s=ep["seconds"],
                       epoch_samples_per_s=ep["samples"] / ep["seconds"],
                       outside_steps_s=ep["seconds"] - sum(secs))
    print(f"train {res['state'].codec.dtype} codec B=64 128²: " + ", ".join(
        f"{ph} {r['samples_per_s']:.2f} samples/s over steady steps, "
        f"{r['epoch_samples_per_s']:.2f} over the epoch ({r['epoch_s']:.4f} s, "
        f"{r['outside_steps_s']:.4f} s outside the steps; steps "
        f"{[round(x, 4) for x in r['step_s']]})"
        for ph, r in ((ph, rec[ph]) for ph in ("warmup", "gan")))
          + f", peak {peak:.2f} GiB, wall {wall:.1f} s | card: {card}", flush=True)
    for e in res["epochs"] + res["val"]:
        print("  " + " ".join(f"{k}={v:.4f}" if isinstance(v, float) else f"{k}={v}"
                              for k, v in e.items()), flush=True)
    return rec


def gan_breakdown(state, card: str, recipe: str = "flowers_vqgan.yaml", overrides=(),
                  lecam_weight: float = 0.0) -> dict:
    """Where a GAN step of ``recipe``'s codec (``state``, in its dtype, with
    ``overrides`` and LeCAM at ``lecam_weight``) goes, by CUDA events around
    its parts (the mean of 3 steps after one warm step), then one step under
    the profiler for the device's idle share."""
    from flocoder_torch.config import load_config
    from flocoder_torch.generate_samples import CONFIG_DIR
    from flocoder_torch.models.perceptual import make_perceptual_fn
    from flocoder_torch.training.vqgan import make_vqgan_gan_step

    cfg = load_config(recipe, CONFIG_DIR, list(overrides))
    step = make_vqgan_gan_step(cfg, make_perceptual_fn(device="cuda",
                                                       dtype=state.codec.dtype),
                               lecam_weight=lecam_weight)
    gen = torch.Generator("cuda").manual_seed(6)
    x = torch.rand(64, 128, 128, 3, device="cuda", generator=gen) * 2 - 1
    names = ["codec_forward", "d_step", "g_loss_backward", "optimizers"]
    totals = dict.fromkeys(names, 0.0)
    for it in range(4):
        events = [torch.cuda.Event(enable_timing=True)]
        events[0].record()

        def mark(name, events=events):
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            events.append(e)

        step(state, x, gen, mark)
        torch.cuda.synchronize()
        if it:
            for i, n in enumerate(names):
                totals[n] += events[i].elapsed_time(events[i + 1]) / 3
    out = {f"{n}_ms": v for n, v in totals.items()}
    out["step_ms"] = sum(totals.values())
    out.update(profile_batch(lambda: step(state, x, gen)))
    top = out.pop("top_kernels")
    print(f"GAN step breakdown ({recipe}, {state.codec.dtype}, B=64, 128²): " + " ".join(
        f"{k}={v:.4f}" for k, v in out.items()) + f" | card: {card}", flush=True)
    print("  device time by kernel (ms): " + "; ".join(
        f"{name[:60]}={ms:.2f}" for name, ms in top), flush=True)
    out["top_kernels"] = top
    return out


def small_training_setup() -> tuple:
    """The small codec of the card-vs-CPU training checks (hidden 64: head
    dims 8-32, which K1 and K2 take; fp32, seeded), NATTEN's gammas at 0.5
    so that K2's gradients reach the attention's projections, its RVQ
    initialised with no dead codes (a step draws nothing); a 16-wide patch
    discriminator, the VGG16 net, and two batches of 4 32² images. Returns
    (the codec's keyword arguments, codec, discriminator, VGG, batches)."""
    from flocoder_torch.models.codecs import NATTENBlock, VQVAE
    from flocoder_torch.models.discriminator import (VQGANPlusPatchDiscriminator,
                                                     init_discriminator)
    from flocoder_torch.models.layers import init_params
    from flocoder_torch.models.perceptual import VGG16Features

    kw = dict(hidden_channels=64, num_downsamples=3, internal_dim=64, vq_embedding_dim=4,
              vq_num_embeddings=16, codebook_levels=2, commitment_weight=0.5)
    codec = init_params(VQVAE(**kw), torch.Generator().manual_seed(0))
    for m in codec.modules():
        if isinstance(m, NATTENBlock):
            m.gamma.data.fill_(0.5)
    rng = np.random.default_rng(7)
    L, K, D = codec.vq.codebooks.shape
    codec.vq.assign_({
        "codebooks": torch.from_numpy(rng.normal(size=(L, K, D)).astype(np.float32)),
        "ema_counts": torch.from_numpy(rng.uniform(4, 30, (L, K)).astype(np.float32)),
        "ema_sums": torch.from_numpy(rng.normal(size=(L, K, D)).astype(np.float32)),
        "initted": torch.tensor(True)})
    disc = init_discriminator(VQGANPlusPatchDiscriminator(hidden_channels=16),
                              torch.Generator().manual_seed(1))
    vgg = init_params(VGG16Features(), torch.Generator().manual_seed(2))
    batches = [torch.from_numpy(rng.uniform(-1, 1, (4, 32, 32, 3)).astype(np.float32))
               for _ in range(2)]
    return kw, codec, disc, vgg, batches


def check_train_small(setup=None, lecam_weight: float = 0.0,
                      label: str = "hidden 64") -> None:
    """One warmup step and one GAN step of a small codec (``setup``'s, by
    default ``small_training_setup``'s: hidden 64, head dims 8-32, which K1
    and K2 take), deterministic, with LeCAM at ``lecam_weight``, on the
    card and on the CPU from the same weights and batches, TF32 off. Adam
    moves each weight by about ±lr whatever its gradient's size, so the
    gradients are held through Adam's first moments (0.9·0.1·g_warmup +
    0.1·g_GAN for the codec after the two steps, 0.1·g for the
    discriminator, each clipped), within 1e-3 of the largest first moment
    of that model. The card runs cuDNN's deterministic algorithms. With the
    default ones the VQGAN+ case failed in two of the full runs of this
    script that first held the dp phase (step 33), both times by the same
    amount (its discriminator's DiscrResBlock_2.Conv_2 moments 2.038e-05
    from the CPU's, tol 6.374e-06, against 3.302e-06 at worst in the runs
    that passed), and passed whenever this check ran alone; what changed
    the card's computation in those runs is not known (PERF.md §7)."""
    from flocoder_torch.config import load_config
    from flocoder_torch.generate_samples import CONFIG_DIR
    from flocoder_torch.models.perceptual import make_perceptual_fn
    from flocoder_torch.training.checkpoint import (DISC_PREFIXES, VQVAE_PREFIXES,
                                                    to_jax_flat)
    from flocoder_torch.training.vqgan import (create_vqgan_state,
                                               make_vqgan_gan_step,
                                               make_vqgan_warmup_step)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    cfg = load_config("smoke_vqgan.yaml", CONFIG_DIR, overrides=["codec.lambda_perc=0.001"])
    _, codec, disc, vgg, batches = (setup or small_training_setup)()
    out = {}
    for dev in ("cuda", "cpu"):
        state = create_vqgan_state(copy.deepcopy(codec).to(dev),
                                   copy.deepcopy(disc).to(dev), 1e-4)
        feat = make_perceptual_fn(model=copy.deepcopy(vgg), device=dev)
        warm = make_vqgan_warmup_step(cfg, feat, deterministic=True)
        gan = make_vqgan_gan_step(cfg, feat, lecam_weight=lecam_weight, deterministic=True)
        _, aux_w, _ = warm(state, batches[0].to(dev), torch.Generator(dev))
        _, aux_g, _ = gan(state, batches[1].to(dev), torch.Generator(dev))
        losses = {f"warmup/{k}": float(v) for k, v in aux_w.items()}
        losses.update({f"gan/{k}": float(v) for k, v in aux_g.items()})
        moments = {name: {n: opt.adam.state[p]["exp_avg"].cpu().numpy()
                          for n, p in model.named_parameters() if p in opt.adam.state}
                   for name, model, opt in (("codec", state.codec, state.opt_g),
                                            ("discriminator", state.disc, state.opt_d))}
        out[dev] = (losses, {**to_jax_flat(state.codec, VQVAE_PREFIXES),
                             **to_jax_flat(state.disc, DISC_PREFIXES)}, moments)
    torch.backends.cudnn.deterministic = deterministic
    (l_card, p_card, m_card), (l_cpu, p_cpu, m_cpu) = out["cuda"], out["cpu"]
    grad_report = []
    for model, ref_m in m_cpu.items():
        if set(ref_m) != set(m_card[model]) or not ref_m:
            fail(f"card and CPU optimise different {model} parameters")
        tol = 1e-3 * max(float(np.abs(r).max()) for r in ref_m.values())
        errs = {n: float(np.abs(m_card[model][n] - r).max()) for n, r in ref_m.items()}
        worst_n = max(errs, key=errs.get)
        if not (tol > 0 and all(np.isfinite(e) and e < tol for e in errs.values())):
            fail(f"card and CPU gradients disagree on {model} {worst_n}: "
                 f"{errs[worst_n]:.3e} (tol {tol:.3e})")
        grad_report.append(f"{model} {len(ref_m)} tensors, worst {worst_n} "
                           f"max_abs_err={errs[worst_n]:.3e} (tol {tol:.3e})")
    worst = ("", 0.0, 1.0)
    for name, ref in list(l_cpu.items()) + list(p_cpu.items()):
        a = l_card[name] if name in l_card else p_card[name]
        ref = np.asarray(ref, np.float64)
        err = float(np.abs(np.asarray(a, np.float64) - ref).max())
        tol = 1e-3 * max(1.0, float(np.abs(ref).max()))
        if not (np.isfinite(err) and err < tol):
            fail(f"card and CPU disagree after a training step on {name}: "
                 f"{err:.3e} (tol {tol:.3e})")
        if err / tol > worst[1] / worst[2]:
            worst = (name, err, tol)
    print(f"card vs CPU, one warmup + one GAN step ({label}): losses "
          + " ".join(f"{k}={l_card[k]:.5f}/{l_cpu[k]:.5f}" for k in sorted(l_cpu))
          + f"; {len(p_cpu)} parameter tensors, worst {worst[0]} max_abs_err="
          f"{worst[1]:.3e} (tol {worst[2]:.3e}); Adam first moments: "
          + "; ".join(grad_report), flush=True)


BF16_REL, BF16_WIDEN, BF16_NOUGHT, PICK_GAP = 3e-2, 2.5, 0.5, 5e-2


@contextlib.contextmanager
def forced_picks(picks: list, own: list):
    """Within the block the port's RVQ takes, at its i-th level search, the
    codes ``picks[i]`` (a numpy array of N codes, each level of each codec
    forward in turn) in place of its nearest ones, and appends its own
    nearest codes, residual and codebook (fp64, on the host) to ``own``."""
    from flocoder_torch.ops import rvq

    plain = rvq._sq_dists

    def dists(z, cb):
        d = plain(z, cb)
        i = len(own)
        own.append((d.argmin(1).cpu().numpy(), z.detach().double().cpu().numpy(),
                    cb.detach().double().cpu().numpy()))
        if picks is None:
            return d
        want = torch.as_tensor(picks[i], device=d.device)
        return d.scatter(1, want[:, None], float("-inf"))

    rvq._sq_dists = dists
    try:
        yield
    finally:
        rvq._sq_dists = plain


def worst_pick_gap(picks: list, own: list) -> float:
    """Over the searches and tokens where a step's own nearest code b
    differs from the pick a it was given: the largest least relative change
    of its residual r that swaps them, (d(r, a) − d(r, b)) / (2·|a − b|·|r|)
    with d the squared distance (0: no flips)."""
    worst = 0.0
    for want, (mine, r, cb) in zip(picks, own):
        i = np.nonzero(mine != want)[0]
        if len(i):
            a, b = cb[want[i]], cb[mine[i]]
            gap = ((((r[i] - a) ** 2).sum(1) - ((r[i] - b) ** 2).sum(1))
                   / (2 * np.linalg.norm(a - b, axis=1) * np.linalg.norm(r[i], axis=1)))
            worst = max(worst, float(gap.max()))
    return worst


def hold_bf16_moments(ours: dict, ref: dict, fp32: dict) -> dict:
    """Adam's first moments of one model from a bf16 step (``ours``) against
    a reference bf16 step's (``ref``), each tensor elementwise within
    BF16_REL·own + BF16_WIDEN·spread: own the tensor's largest |ref|,
    spread its largest |ref − fp32| (the fp32 step on the same picks: what
    bf16 rounding does to that tensor). A tensor nought to rounding (spread
    ≥ BF16_NOUGHT·own) is left out and counted, at most a tenth of the
    model's; one the reference's gradient does not reach must be 0. The
    NATTEN gammas, scalars whose gradients are sums that cancel, are held as
    one vector. Returns the readings: the worst err/tol and its tensor, the
    failures, the tensors left out, and among those held how many lie
    beyond BF16_REL alone, on how many the reference lies beyond it from
    fp32, and the largest (err − BF16_REL·own)/spread. The bf16 parity tests
    (tests/test_torch_vqgan_bf16.py) hold the port to JAX by the same
    function."""
    def gammas_as_one(flat):
        names = sorted(k for k in flat if k.endswith("/gamma"))
        out = {k: np.asarray(v, np.float64) for k, v in flat.items() if k not in names}
        if names:
            out["gammas"] = np.concatenate([np.asarray(flat[k], np.float64).ravel()
                                            for k in names])
        return out

    ours, ref, fp32 = (gammas_as_one(t) for t in (ours, ref, fp32))
    worst, failures, left_out = ("", 0.0), [], []
    over = wide = 0
    need = 0.0
    for name, r in ref.items():
        a, f = ours[name], fp32[name]
        own, spread = float(np.abs(r).max()), float(np.abs(r - f).max())
        err = float(np.abs(a - r).max()) if a.shape == r.shape else float("inf")
        if not np.isfinite(err):
            failures.append(f"{name}: not finite or shape {a.shape}")
        elif own == 0:
            if err > 0:
                failures.append(f"{name}: {err:.3e} where the reference's is 0")
        elif spread >= BF16_NOUGHT * own:
            left_out.append(name)
        else:
            tol = BF16_REL * own + BF16_WIDEN * spread
            if err > tol:
                failures.append(f"{name}: max_abs_err {err:.3e} > tol {tol:.3e}")
            if err / tol > worst[1]:
                worst = (name, err / tol)
            over += err > BF16_REL * own
            wide += spread > BF16_REL * own
            need = max(need, (err - BF16_REL * own) / spread if spread else 0.0)
    if len(left_out) > len(ref) // 10:
        failures.append(f"{len(left_out)} of {len(ref)} tensors nought to rounding")
    return dict(worst_tensor=worst[0], worst_err_over_tol=worst[1], failures=failures,
                left_out=left_out, tensors=len(ref), beyond_rel=over,
                ref_beyond_rel_from_fp32=wide, worst_need_of_spread=need)


def check_train_small_bf16() -> dict:
    """One bf16 warmup step and one bf16 GAN step (the codec, its patch
    discriminator and the VGG16 net computing in bf16 over fp32 parameters,
    tpu_vqgan's shared real features) of a small codec (hidden 64: head
    dims 8-32, which K1 and K2 take), deterministic, on the card and on the
    CPU from the same weights and batches, TF32 off, on the same RVQ picks:
    the CPU's own, which the card's step is given; the card's own nearest
    codes may differ from them only at near ties (a relative change of the
    residual below PICK_GAP swaps the codes). Held: the loss terms within
    3e-2·max(1, |ref|), their dtypes equal; Adam's first moments of the
    codec (after both steps) and of the discriminator by hold_bf16_moments,
    whose spread is the CPU's fp32 steps' on the same picks; each gamma's
    bf16 value within two bf16 spacings of the CPU's where its moment's
    sign is not rounding's; spectral norm's u and σ within 1e-4 (fp32).
    Then the card's steps again with na2d's plain twin (na2d_banded under
    autograd) in place of K1 and K2, whose readings are printed beside the
    kernels': where the gap between card and CPU comes from."""
    from flocoder_torch.config import load_config
    from flocoder_torch.generate_samples import CONFIG_DIR
    from flocoder_torch.models import codecs
    from flocoder_torch.models.codecs import VQVAE
    from flocoder_torch.models.discriminator import VQGANPlusPatchDiscriminator
    from flocoder_torch.models.perceptual import VGG16Features, make_perceptual_fn
    from flocoder_torch.ops.neighborhood_attention import na2d_banded
    from flocoder_torch.training.checkpoint import (DISC_PREFIXES, VQVAE_PREFIXES,
                                                    load_jax_flat, to_jax_flat)
    from flocoder_torch.training.vqgan import (create_vqgan_state, make_vqgan_gan_step,
                                               make_vqgan_warmup_step)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = load_config("tpu_vqgan.yaml", CONFIG_DIR)
    kw, codec, disc, vgg, batches = small_training_setup()
    flat = to_jax_flat(codec, VQVAE_PREFIXES)

    def run(dev, dtype, picks=None):
        """Both steps on ``dev`` in ``dtype``; with ``picks`` (one per
        search) on those codes. Returns losses, moments, parameters,
        spectral-norm stats and the searches' own codes."""
        c = load_jax_flat(VQVAE(**kw, dtype=dtype), flat, VQVAE_PREFIXES).to(dev)
        d = VQGANPlusPatchDiscriminator(hidden_channels=16, dtype=dtype)
        d.load_state_dict(disc.state_dict())
        state = create_vqgan_state(c, d.to(dev), 1e-4)
        feat = make_perceptual_fn(model=VGG16Features(dtype), device=dev)
        feat.load_state_dict(vgg.state_dict())
        own, aux = [], {}
        with forced_picks(picks, own):
            for name, make, x in (("warmup", make_vqgan_warmup_step, batches[0]),
                                  ("gan", make_vqgan_gan_step, batches[1])):
                _, a, _ = make(cfg, feat, deterministic=True)(state, x.to(dev),
                                                              torch.Generator(dev))
                aux.update({f"{name}/{k}": v.detach().cpu() for k, v in a.items()})
        moments = {}
        for what, model, opt, prefixes in (("codec", state.codec, state.opt_g, VQVAE_PREFIXES),
                                           ("disc", state.disc, state.opt_d, DISC_PREFIXES)):
            m = copy.deepcopy(model)
            with torch.no_grad():
                for pm, p in zip(m.parameters(), model.parameters()):
                    pm.copy_(opt.state_of(p)["exp_avg"])
            moments[what] = {k: v for k, v in to_jax_flat(m.float(), prefixes).items()
                             if "/params/" in k or k.startswith("params/")}
        params = to_jax_flat(state.codec, VQVAE_PREFIXES)
        stats = {k: v for k, v in to_jax_flat(state.disc, DISC_PREFIXES).items()
                 if k.startswith("batch_stats/")}
        return dict(aux=aux, moments=moments, params=params, stats=stats,
                    own=own, picks=[o[0] for o in own])

    cpu = run("cpu", torch.bfloat16)
    picks = cpu["picks"]
    cpu32 = run("cpu", torch.float32, picks)
    card = run("cuda", torch.bfloat16, picks)
    plain_na2d = codecs.na2d
    codecs.na2d = na2d_banded           # the twins in place of K1 and K2
    try:
        card_twins = run("cuda", torch.bfloat16, picks)
    finally:
        codecs.na2d = plain_na2d

    gap = worst_pick_gap(picks, card["own"])
    if gap >= PICK_GAP:
        fail(f"bf16 card vs CPU: the card's own RVQ picks differ from the CPU's beyond a "
             f"near tie (relative gap {gap:.3e})")
    for k, ref in cpu["aux"].items():
        a = card["aux"][k]
        if a.dtype != ref.dtype or not abs(float(a) - float(ref)) <= 3e-2 * max(
                1.0, abs(float(ref))):
            fail(f"bf16 card vs CPU loss {k}: {float(a)} ({a.dtype}) against "
                 f"{float(ref)} ({ref.dtype})")
    readings, twins = {}, {}
    for what in ("codec", "disc"):
        readings[what] = hold_bf16_moments(card["moments"][what], cpu["moments"][what],
                                           cpu32["moments"][what])
        twins[what] = hold_bf16_moments(card_twins["moments"][what], cpu["moments"][what],
                                        cpu32["moments"][what])
        if readings[what]["failures"]:
            fail(f"bf16 card vs CPU first moments of the {what}: "
                 + "; ".join(readings[what]["failures"][:5]))
    for name in (k for k in cpu["params"] if k.endswith("/gamma")):
        got, want = float(card["params"][name][0]), float(cpu["params"][name][0])
        mu, mu32 = float(cpu["moments"]["codec"][name][0]), float(
            cpu32["moments"]["codec"][name][0])
        spacing = float(np.spacing(np.float32(abs(want)))) * 2.0 ** 16
        if abs(mu - mu32) < BF16_NOUGHT * abs(mu) and abs(got - want) > 2 * spacing:
            fail(f"bf16 card vs CPU {name}: {got} against {want}")
    for k, ref in cpu["stats"].items():
        err = float(np.abs(card["stats"][k] - ref).max())
        if not err < 1e-4 * max(1.0, float(np.abs(ref).max())):
            fail(f"bf16 card vs CPU spectral norm {k}: max_abs_err {err:.3e}")
    out = dict(pick_gap=gap, losses={k: [float(card["aux"][k]), float(v)]
                                     for k, v in cpu["aux"].items()},
               kernels=readings, twins_on_card=twins)
    print("card vs CPU, one bf16 warmup + one bf16 GAN step (hidden 64, on the CPU's "
          f"RVQ picks; the card's own differ at near ties only, gap {gap:.3e}): losses "
          + " ".join(f"{k}={float(card['aux'][k]):.5f}/{float(v):.5f}"
                     for k, v in sorted(cpu["aux"].items()))
          + "; first moments, worst err/tol with K1/K2 and with the twins on the card: "
          + "; ".join(f"{w} {readings[w]['worst_err_over_tol']:.3f} "
                      f"({readings[w]['worst_tensor']}) / {twins[w]['worst_err_over_tol']:.3f}"
                      f" ({twins[w]['worst_tensor']}), {len(readings[w]['left_out'])} of "
                      f"{readings[w]['tensors']} tensors nought to rounding"
                      for w in ("codec", "disc")), flush=True)
    return out


@contextlib.contextmanager
def recording_na2d(capture_shape: tuple):
    """Within the block every call of K1's and K2's wrappers through
    NA2DFunction records its dtype, and the last K2 call whose q has
    ``capture_shape`` keeps its inputs (q, k, v, o, g) and window (the
    first step's carries no gradient: NATTEN's gamma starts at 0); the
    launches are the wrappers' own, counted as ever."""
    from flocoder_torch.ops import neighborhood_attention as nat

    fwd, bwd = nat.na2d_fwd, nat.na2d_bwd
    rec = {"na2d_fwd": {}, "na2d_bwd": {}, "captured": None}

    def seen(name, q):
        rec[name][str(q.dtype)] = rec[name].get(str(q.dtype), 0) + 1

    def fwd_rec(q, k, v, **window):
        seen("na2d_fwd", q)
        return fwd(q, k, v, **window)

    def bwd_rec(q, k, v, o, g, **window):
        seen("na2d_bwd", q)
        if tuple(q.shape) == capture_shape:
            rec["captured"] = ((q, k, v, o, g), window)
        return bwd(q, k, v, o, g, **window)

    nat.na2d_fwd, nat.na2d_bwd = fwd_rec, bwd_rec
    try:
        yield rec
    finally:
        nat.na2d_fwd, nat.na2d_bwd = fwd, bwd


def tpu_vqgan_train(tmp: str, card: str, kernels: dict) -> tuple:
    """configs/tpu_vqgan.yaml as composed (codec.bf16: the codec, its patch
    discriminator and the VGG16 perceptual net compute in bf16 over fp32
    parameters; shared real features) at flowers' full widths (128²,
    hidden 256, RVQ 4×96×4), B=64, through flocoder_torch.train_vqgan.main
    over the codec-training phase's 320 PNGs: one warmup and one GAN epoch
    of 4 steps, one validation batch. K1 and K2 are counted exactly (6 K1
    and 6 K2 a step, 6 K1 a validation batch), every launch in bf16; K2 in
    bf16 is held against its twin (na2d_bwd_banded in fp32 on the same
    bf16 values, within 3e-2 of the largest |ref|, which must not be 0) on
    the (q, k, v, o, g) of the last backward at the decoder's shape (B=64,
    32²×512) and is bitwise equal across two calls there. torch's bf16 mean on the card is checked to
    round once, as jnp.mean does. Prints samples/s over the steady steps,
    peak memory, and a GAN step's breakdown (the codec-training phase's is
    fp32's). Returns the checkpoint, the record, the launches and K2's
    error."""
    from flocoder_torch import train_vqgan as tv
    from flocoder_torch.ops.neighborhood_attention import na2d_bwd_banded

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = True      # PyTorch's default for convs
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _zero(kernels)
    t0 = time.time()
    with recording_na2d((64, 32, 32, 512)) as seen:
        res = tv.main(["--config-name", "tpu_vqgan.yaml",
                       f"data={os.path.join(tmp, 'flowers')}", "codec.epochs=2",
                       "codec.warmup_epochs=1", "+seed=0",
                       f"+ckpt_dir={os.path.join(tmp, 'tpu_vqgan_train_ckpt')}",
                       f"+output_dir={os.path.join(tmp, 'tpu_vqgan_train_out')}"])
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = _counts(kernels)
    state = res["state"]
    n_steps = {ph: len(t) for ph, t in res["step_seconds"].items()}
    steps, n_val = sum(n_steps.values()), len(res["val"])
    _expect(kernels, f"tpu_vqgan_train ({n_steps} steps, {n_val} validation batch, bf16)",
            launches, na2d_fwd=6 * steps + 6 * n_val, na2d_bwd=6 * steps)
    for name in ("na2d_fwd", "na2d_bwd"):
        if seen[name] != {"torch.bfloat16": launches[name]}:
            fail(f"tpu_vqgan_train: {name} ran {seen[name]}, not all bf16")
    if state.codec.dtype != torch.bfloat16 or state.disc.dtype != torch.bfloat16:
        fail(f"tpu_vqgan_train: codec {state.codec.dtype}, discriminator {state.disc.dtype}")
    rec = train_record(res, wall, card)

    (q, k, v, o, g), window = seen["captured"]
    first = kernels["na2d_bwd"](q, k, v, o, g, **window)
    second = kernels["na2d_bwd"](q, k, v, o, g, **window)
    refs = na2d_bwd_banded(*(t.float() for t in (q, k, v, o, g)), **window)
    k2_err, report = 0.0, []
    for name, a, b, ref in zip(("dq", "dk", "dv"), first, second, refs):
        err, top = (a.float() - ref).abs().max().item(), ref.abs().max().item()
        if (a.dtype != torch.bfloat16 or not torch.equal(a, b) or not top > 0
                or not err < 3e-2 * top):
            fail(f"K2 bf16 on the codec step's {name}: {a.dtype}, max_abs_err {err:.3e} "
                 f"(largest |ref| {top:.3e}), equal across calls {torch.equal(a, b)}")
        k2_err = max(k2_err, err)
        report.append(f"{name} max_abs_err={err:.3e} of largest {top:.3e}")
    print("K2 bf16 on the codec step's last backward at the decoder's shape (B=64, "
          "32²×512, 8 heads, ks 7) against na2d_bwd_banded in fp32: " + ", ".join(report)
          + f"; two calls bitwise equal | card: {card}", flush=True)
    del q, k, v, o, g, first, second, refs, seen

    g = torch.Generator("cuda").manual_seed(11)
    means = [torch.randn(n, device="cuda", generator=g).mul_(s).add_(s * 0.3).bfloat16()
             for n in (1000, 65536, 64 * 16 * 16) for s in (0.01, 1.0, 30.0)]
    twice = sum(int(x.mean() != x.float().mean().bfloat16()) for x in means)
    rec["bf16_mean_rounded_twice"] = twice
    print(f"bf16 mean on the card: {len(means) - twice} of {len(means)} equal to the "
          "fp32 mean rounded once (jnp.mean's rule)", flush=True)
    rec["gan_breakdown"] = gan_breakdown(state, card, "tpu_vqgan.yaml")
    del state, res["state"]
    torch.cuda.empty_cache()
    return res["checkpoint"], rec, launches, k2_err


def hold_picks(label, zq, idx, zq_ref, idx_ref, x64, cb, rel=1e-5) -> dict:
    """Prints and enforces flocoder_torch.ops.fused_vq.check_quantized: each
    token's picks equal the reference's or are ε-optimal under the fp64
    distances from ``x64`` (relative gap < 1e-5); z_q within
    ``rel``·max(1, max|ref|) where the picks agree."""
    from flocoder_torch.ops.fused_vq import check_quantized
    res = check_quantized(zq, idx, zq_ref, idx_ref, x64, cb, rel)
    print(f"{label}: {res['differ']} of {res['tokens']} tokens pick other codes than "
          f"the reference, max relative gap of those {res['max_gap']:.2e} (tol 1e-05); "
          f"z_q max_abs_err={res['max_abs_err']:.3e} where the picks agree (tol "
          f"{res['tol']:.3e}) {'ok' if res['ok'] else 'FAIL'}", flush=True)
    if not res["ok"]:
        fail(f"{label}: picks or z_q disagree")
    return res


def check_fused_vq() -> dict:
    """K4, K3 and K5 against their plain twins on the card, TF32 off, at
    every D the source instantiates (3, 4, 8): K4 at a pre-encode batch of
    tokens (8192×128 → 4, 4×96 codes), the probe's shape (1024×256, 3×512),
    a ragged N=77, N=300 at D=8 and D=3 and Din=30 (the scalar row loop); K3
    at a pre-encode batch (32×16²×128, both layouts of h, every cluster size),
    a ragged 5×7 map, a 20×20 map larger than the block, D=3 with one group
    and D=8 with two, a 1×1 map, B=1, and a 3-row map with a cluster of 8
    (five blocks with no rows); K5 at the probe's (4, 16, 16, 256) at every
    cluster size and a ragged one, against the twin and the fp64 oracle
    within 1e-5·max(1, max|ref|). Then codebooks with duplicated codes (the
    pick must be the first index exactly, K4 and K3 at every cluster size),
    a NaN token (no code at any level: z_q 0, index 0; in K3 a NaN image),
    two calls bitwise equal (each K3, K4 and K5 case), and a map too large for a cluster's shared memory (raises,
    nothing launched). Returns per kernel the worst numbers."""
    from flocoder_torch.ops import fused_vq as fvq
    from flocoder_torch.ops.kernels import fused_vq as fvk
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    g = torch.Generator("cuda").manual_seed(7)
    out = {}

    def worst(name, r):
        w = out.setdefault(name, {"max_abs_err": 0.0, "differ": 0, "tokens": 0,
                                  "max_gap": 0.0})
        w["max_abs_err"] = max(w["max_abs_err"], r["max_abs_err"])
        w["max_gap"] = max(w["max_gap"], r.get("max_gap", 0.0))
        w["differ"] += r.get("differ", 0)
        w["tokens"] += r.get("tokens", 0)

    def bitwise(label, first, second):
        if not all(torch.equal(a, b) for a, b in zip(first, second)):
            fail(f"{label}: two calls on the same inputs differ")

    for label, shape in (("pre-encode batch", (8192, 128, 4, 4, 96)),
                         ("probe", (1024, 256, 4, 3, 512)), ("ragged", (77, 128, 4, 4, 96)),
                         ("D=8", (300, 64, 8, 2, 64)), ("D=3", (300, 64, 3, 2, 64)),
                         ("Din=30", (100, 30, 4, 2, 16))):
        z, w, b, cb = fvq.random_vq_inputs(g, *shape)
        zq, idx = fvq.fused_compress_vq(z, w, b, cb)
        torch.cuda.synchronize()
        worst("fused_compress_vq", hold_picks(
            f"K4 check {label} N,Din,D,L,K={shape}", zq, idx,
            *fvq.fused_compress_vq_plain(z, w, b, cb),
            z.double() @ w.double() + b.double(), cb))
        bitwise(f"K4 {label}", (zq, idx), fvq.fused_compress_vq(z, w, b, cb))
    pre = (32, 16, 16, 128, 4, 4, 96, 2)
    for label, shape, nchw, cs in (
            ("pre-encode batch", pre, True, None),
            ("pre-encode batch, NHWC memory", pre, False, None),
            *((f"pre-encode batch, cluster {c}", pre, True, c) for c in fvk.CLUSTER_SIZES),
            ("ragged 5x7", (3, 5, 7, 128, 4, 4, 96, 2), True, None),
            ("20x20, more tokens than threads", (2, 20, 20, 128, 4, 4, 96, 2), True, 1),
            ("20x20, cluster of 8", (2, 20, 20, 128, 4, 4, 96, 2), True, None),
            ("D=3 groups=1", (4, 16, 16, 128, 3, 4, 96, 1), True, None),
            ("D=8 groups=2", (4, 16, 16, 128, 8, 4, 96, 2), True, None),
            ("1x1 map, B=1", (1, 1, 1, 128, 4, 4, 96, 2), True, None),
            ("1x1 map, B=1, cluster 8", (1, 1, 1, 128, 4, 4, 96, 2), True, 8),
            ("B=1", (1, 16, 16, 128, 4, 4, 96, 2), True, None),
            ("3 rows, cluster 8", (2, 3, 16, 128, 4, 4, 96, 2), True, 8),
            ("3 rows, cluster 8, NHWC memory", (2, 3, 5, 128, 4, 4, 96, 2), False, 8)):
        h, tail, cb = fvq.random_tail_inputs(g, *shape, nchw=nchw)
        groups = shape[-1]
        zq, idx = fvk.fused_compress_tail_vq(h, *tail, cb, groups, cluster=cs)
        torch.cuda.synchronize()
        worst("fused_compress_tail_vq", hold_picks(
            f"K3 check {label} B,H,W,Din,D,L,K,groups={shape}", zq, idx,
            *fvq.fused_compress_tail_vq_plain(h, *tail, cb, groups),
            fvq.compress_tail_oracle(h, *tail, groups)[2], cb))
        bitwise(f"K3 {label}", (zq, idx),
                fvk.fused_compress_tail_vq(h, *tail, cb, groups, cluster=cs))
    for label, shape, cs in (
            *((f"probe, cluster {c}", (4, 16, 16, 256, 4, 1, 1, 2), c)
              for c in fvk.CLUSTER_SIZES),
            ("ragged 5x7 D=3", (3, 5, 7, 64, 3, 1, 1, 1), None),
            ("1x1 map D=8, cluster 8", (1, 1, 1, 64, 8, 1, 1, 2), 8)):
        h, tail, _ = fvq.random_tail_inputs(g, *shape)
        groups = shape[-1]
        ours = fvk.compress_tail_debug(h, *tail, groups, cluster=cs)
        torch.cuda.synchronize()
        twin = fvq.compress_tail_debug_plain(h, *tail, groups)
        oracle = fvq.compress_tail_oracle(h, *tail, groups)
        for name, a, ref, ref64 in zip(("y1", "y2", "out"), ours, twin, oracle):
            for what, r in (("twin", ref), ("fp64 oracle", ref64)):
                err = (a.double() - r.double()).abs().max().item()
                tol = 1e-5 * max(1.0, r.abs().max().item())
                ok = bool(np.isfinite(err)) and err < tol
                print(f"K5 check {label} {shape[:5]} {name} vs {what}: max_abs_err="
                      f"{err:.3e} (tol {tol:.3e}) {'ok' if ok else 'FAIL'}", flush=True)
                if not ok:
                    fail(f"K5 disagrees with its {what} at {label} ({name})")
                worst("compress_tail_debug", {"max_abs_err": err})
        bitwise(f"K5 {label}", ours, fvk.compress_tail_debug(h, *tail, groups, cluster=cs))

    # codes 2i and 2i + 1 equal: the first of each pair, so every pick is even
    z, w, b, cb = fvq.random_vq_inputs(g, 8192, 128, 4, 4, 48)
    odd = [int((fvq.fused_compress_vq(z, w, b, cb.repeat_interleave(2, 1))[1] % 2).sum())]
    h, tail, cb = fvq.random_tail_inputs(g, *pre[:5], 4, 48, 2)
    odd += [int((fvk.fused_compress_tail_vq(h, *tail, cb.repeat_interleave(2, 1), 2,
                                            cluster=c)[1] % 2).sum())
            for c in fvk.CLUSTER_SIZES]
    print(f"duplicated codes (2i = 2i + 1): picks of the second copy, K4 and K3 at "
          f"clusters {fvk.CLUSTER_SIZES}: {odd} (must be 0)", flush=True)
    if any(odd):
        fail("a duplicated code was not picked at its first index")
    # a NaN token: no code wins at any level, as in the TPU kernels'
    # all-zero one-hot (z_q 0, index 0); K3: a NaN pixel makes its image NaN
    z[5] = float("nan")
    zq, idx = fvq.fused_compress_vq(z, w, b, cb)
    if idx[5].any() or zq[5].any() or not torch.equal(
            idx, fvq.fused_compress_vq_plain(z, w, b, cb)[1]):
        fail(f"K4 on a NaN token gave z_q {zq[5].tolist()}, indices {idx[5].tolist()}, "
             "not 0 and 0")
    h, tail, cb = fvq.random_tail_inputs(g, 2, 16, 16, 128, 4, 4, 96, 2)
    h[1, 3, 4] = float("nan")
    for c in fvk.CLUSTER_SIZES:
        zq, idx = fvk.fused_compress_tail_vq(h, *tail, cb, 2, cluster=c)
        if idx[1].any() or zq[1].any() or not torch.equal(
                idx, fvq.fused_compress_tail_vq_plain(h, *tail, cb, 2)[1]):
            fail(f"K3 (cluster {c}) on a NaN image did not give z_q 0 and index 0")
    print("NaN token: no code at any level (z_q 0, index 0), K4 and K3 at every cluster "
          "size, as the twins ok", flush=True)

    h, tail, _ = fvq.random_tail_inputs(g, 1, 512, 512, 8, 4, 1, 4, 2)
    before = fvk.compress_tail_debug.launches
    try:
        fvk.compress_tail_debug(h, *tail, 2)
        fail("K5 launched on a 1x512x512x4 map, more than a cluster's shared memory")
    except ValueError as e:
        print(f"oversized map refused before launch: {e}", flush=True)
    if fvk.compress_tail_debug.launches != before:
        fail("the oversized map counted a launch")
    return out


def fused_vq_bound_ms(n_bytes: float, n_ops: float) -> tuple:
    """(least ms, 'bytes' or 'operations') against HBM bytes and fp32 FLOPs."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_ops / FP32_FLOPS_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def host_us(fn, calls: int = 1000) -> float:
    """Host µs per call of ``fn`` over ``calls`` calls with no synchronise
    between them (the wrapper's checks, allocation and launch)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return t / calls * 1e6


def launch_floor_ms(images: int, cluster: int, card: str) -> float:
    """Device ms of an empty launch shaped like K3's (images·cluster blocks
    of its threads in clusters of ``cluster``, one cluster barrier): the
    least a K3 launch of this size can take, whatever its work."""
    import ctypes
    from flocoder_torch.ops.kernels.build import build_library
    fn = ctypes.CDLL(build_library("fused_vq.cu")).fused_vq_launch_floor
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    stream = torch.cuda.current_stream().cuda_stream
    if fn(images * cluster, cluster, stream) != 0:
        fail("the empty cluster launch failed")
    ms = device_ms(lambda: fn(images * cluster, cluster, stream), "empty_cluster_kernel", iters=50)
    print(f"empty cluster launch ({images * cluster} blocks, clusters of {cluster}): "
          f"device_ms={ms:.5f} | card: {card}", flush=True)
    return ms


def load_fused_kernels(root: str, alias: str):
    """``flocoder_torch/ops/kernels/fused_vq.py`` of the checkout at
    ``root`` (for instance an unpacked ``git archive`` of an earlier
    commit), imported as package ``alias``; it builds into that checkout's
    own ``flocoder_torch/build/``."""
    import importlib
    import importlib.util
    pkg = os.path.join(os.path.abspath(root), "flocoder_torch")
    spec = importlib.util.spec_from_file_location(
        alias, os.path.join(pkg, "__init__.py"), submodule_search_locations=[pkg])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[alias] = mod
    spec.loader.exec_module(mod)
    return importlib.import_module(f"{alias}.ops.kernels.fused_vq")


def time_fused_vq(card: str, parent: str | None = None) -> dict:
    """K4, K3 and K5 at their main shapes (K3 and K4: one pre-encode batch of
    flowers_vqgan, 32×16² tokens of 128 channels → D=4, 4×96 codes; K5: the
    probe's 4×16²×256), TF32 off: CUDA events over back-to-back calls, the
    profiler's device time of the kernel alone, the wrapper's host µs per
    call, the plain twin, and the unfused torch path (cuBLAS/cuDNN 1×1 conv
    → GroupNorm → SiLU → 3×3 conv → ``rvq_apply``, as the codec's
    ``quantize(encode(x))`` runs it; for K4 ``addmm`` → ``rvq_apply``): no
    single PyTorch call computes these functions, so that path is the
    library yardstick. K3 and K5 also at every cluster size. The bound
    counts each input read once and each output written once, against the
    fp32 operations: 2·Din·D per token for the 1×1, 18·D² for the 3×3, 10·D
    for GroupNorm + SiLU, and L·(K·(2·D + 3) + 2·D) for the search. With
    ``parent`` (another checkout), its kernels' device times on the same
    inputs in turns with this checkout's: parent, this, this, parent."""
    import torch.nn.functional as F
    from flocoder_torch.ops import fused_vq as fvq
    from flocoder_torch.ops.kernels import fused_vq as fvk
    from flocoder_torch.ops.rvq import RVQState, rvq_apply
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    g = torch.Generator("cuda").manual_seed(8)
    out = {}

    def state(cb):
        st = RVQState(*cb.shape).cuda()
        st.codebooks.copy_(cb)
        return st

    sm = torch.cuda.get_device_properties(0).multi_processor_count

    def measure(name, key, kernel, plain, library, n_bytes, n_ops, sweep=None,
                sweep_default=None):
        with torch.inference_mode():
            ms = cuda_ms(kernel, 200, warmup=5)
            dev_ms = device_ms(kernel, key, iters=20)
            host = host_us(kernel)
            plain_ms = cuda_ms(plain, 50, warmup=3)
            library_ms = cuda_ms(library, 50, warmup=3)
            by_cluster = {c: device_ms(lambda: sweep(c), key, iters=20)
                          for c in fvk.CLUSTER_SIZES} if sweep else None
        bound_ms, bound_by = fused_vq_bound_ms(n_bytes, n_ops)
        print(f"{name} time: kernel_ms={ms:.5f} device_ms={dev_ms:.5f} host_us_per_call="
              f"{host:.2f} plain_ms={plain_ms:.5f} library_ms={library_ms:.5f} (unfused "
              f"torch path) bound_ms={bound_ms:.5f} ({bound_by}; {n_bytes / 1e6:.3f} MB, "
              f"{n_ops / 1e6:.2f} MFLOP) | card: {card}", flush=True)
        out[name] = dict(ms=ms, device_ms=dev_ms, host_us_per_call=host, plain_ms=plain_ms,
                         library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by)
        if sweep:
            print(f"{name} device_ms by cluster size (the plan's default {sweep_default}): "
                  f"{by_cluster} | card: {card}", flush=True)
            out[name].update(device_ms_by_cluster=by_cluster, default_cluster=sweep_default)

    def search_ops(n, D, L, K):
        return n * L * (K * (2 * D + 3) + 2 * D)

    N, Din, D, L, K = 8192, 128, 4, 4, 96
    z, w, b, cb4 = fvq.random_vq_inputs(g, N, Din, D, L, K)
    st = state(cb4)
    measure("fused_compress_vq", "compress_vq_kernel",
            lambda: fvk.fused_compress_vq(z, w, b, cb4),
            lambda: fvq.fused_compress_vq_plain(z, w, b, cb4),
            lambda: rvq_apply(st, torch.addmm(b, z, w))[:2],
            4 * (N * Din + Din * D + D + L * K * D + N * D + N * L),
            2 * N * Din * D + search_ops(N, D, L, K))

    B, H, W, Din, groups = 32, 16, 16, 128, 2
    n = B * H * W
    h, tail, cb = fvq.random_tail_inputs(g, B, H, W, Din, D, L, K, groups)
    w1, b1, gs, gb, cw, cbias = tail
    st = state(cb)
    h_nchw = h.permute(0, 3, 1, 2)

    def unfused_tail(x):
        y = F.silu(F.group_norm(F.conv2d(x, w1, b1), groups, gs, gb, 1e-5))
        return F.conv2d(y, cw, cbias, padding=1)

    tail_bytes = 4 * (n * Din + D * Din + 4 * D + 9 * D * D)
    tail_ops = n * (2 * Din * D + 18 * D * D + 10 * D)
    with torch.inference_mode():
        lib_zq, lib_idx = rvq_apply(st, unfused_tail(h_nchw).permute(0, 2, 3, 1)
                                    .reshape(-1, D))[:2]
        zq, idx = fvq.fused_compress_tail_vq(h, *tail, cb, groups)
    hold_picks("K3 against the unfused torch path (its yardstick)", zq, idx, lib_zq,
               lib_idx, fvq.compress_tail_oracle(h, *tail, groups)[2], cb, rel=1e-4)
    measure("fused_compress_tail_vq", "tail_kernel<4, true",
            lambda: fvk.fused_compress_tail_vq(h, *tail, cb, groups),
            lambda: fvq.fused_compress_tail_vq_plain(h, *tail, cb, groups),
            lambda: rvq_apply(st, unfused_tail(h_nchw).permute(0, 2, 3, 1)
                              .reshape(-1, D))[:2],
            tail_bytes + 4 * (L * K * D + n * D + n * L),
            tail_ops + search_ops(n, D, L, K),
            sweep=lambda c: fvk.fused_compress_tail_vq(h, *tail, cb, groups, cluster=c),
            sweep_default=fvk.plan_bands(H, W, None, B, sm)[0])
    out["fused_compress_tail_vq"]["launch_floor_ms"] = launch_floor_ms(
        B, fvk.plan_bands(H, W, None, B, sm)[0], card)

    n5 = 4 * H * W
    h5, tail5, _ = fvq.random_tail_inputs(g, 4, H, W, 256, D, 1, 1, groups)
    measure("compress_tail_debug", "tail_kernel<4, false",
            lambda: fvk.compress_tail_debug(h5, *tail5, groups),
            lambda: fvq.compress_tail_debug_plain(h5, *tail5, groups),
            lambda: F.conv2d(F.silu(F.group_norm(F.conv2d(h5.permute(0, 3, 1, 2), tail5[0],
                                                          tail5[1]), groups, tail5[2],
                                                 tail5[3], 1e-5)), tail5[4], tail5[5],
                             padding=1),
            4 * (n5 * 256 + D * 256 + 4 * D + 9 * D * D + 3 * n5 * D),
            n5 * (2 * 256 * D + 18 * D * D + 10 * D),
            sweep=lambda c: fvk.compress_tail_debug(h5, *tail5, groups, cluster=c),
            sweep_default=fvk.plan_bands(H, W, None, 4, sm)[0])

    if parent:
        pk = load_fused_kernels(parent, "parent_flocoder_torch")
        t0 = time.time()
        pk.fused_compress_tail_vq.build()
        print(f"parent's fused_vq.cu ({parent}) build: {time.time() - t0:.1f} s", flush=True)
        runs = {"fused_compress_vq": ("compress_vq_kernel", lambda m: m.fused_compress_vq(
                    z, w, b, cb4)),
                "fused_compress_tail_vq": ("tail_kernel<4, true",
                                           lambda m: m.fused_compress_tail_vq(
                                               h, *tail, cb, groups)),
                "compress_tail_debug": ("tail_kernel<4, false",
                                        lambda m: m.compress_tail_debug(h5, *tail5, groups))}
        with torch.inference_mode():
            for name, (key, call) in runs.items():
                turns = [(who, device_ms(lambda: call(m), key, iters=20))
                         for who, m in (("parent", pk), ("this", fvk), ("this", fvk),
                                        ("parent", pk))]
                out[name]["parent_turns_device_ms"] = turns
                print(f"{name} device_ms in turns (parent, this, this, parent): "
                      + ", ".join(f"{who} {t:.5f}" for who, t in turns)
                      + f" | card: {card}", flush=True)
    torch.cuda.empty_cache()
    return out


def _tail_oracle_of(codec, h):
    """The fp64 compression tail of ``codec`` on its pre-compress
    activations ``h``."""
    from flocoder_torch.models.codecs import gn_groups
    from flocoder_torch.ops.fused_vq import compress_tail_oracle
    enc = codec.encoder
    return compress_tail_oracle(h, enc.Conv_1.weight, enc.Conv_1.bias,
                                enc.GroupNorm_0.weight, enc.GroupNorm_0.bias,
                                enc.Conv_2.weight, enc.Conv_2.bias,
                                gn_groups(2, codec.vq_embedding_dim),
                                enc.GroupNorm_0.eps)[2]


def rebuilt_batches(argv: list, split: str):
    """The pixel batches that flocoder_torch.preencode_data.main(argv)
    encoded for ``split``, rebuilt by its open_split from the same config
    (the same seed gives the same pixels)."""
    from flocoder_torch import preencode_data as pe
    from flocoder_torch.config import parse_cli
    from flocoder_torch.generate_samples import CONFIG_DIR
    _, _, batches = pe.open_split(parse_cli(argv, config_dir=CONFIG_DIR), split)
    return batches


def preencode_flowers(tmp: str, paths: dict, card: str, kernels: dict) -> tuple:
    """flowers_vqgan at full width (128², hidden 256, 3 downsamples, RVQ
    4×96×4) pre-encoded through flocoder_torch.preencode_data.main with
    ``preencoding.quantize=true preencoding.fused_vq=true``, batch 32 (the
    recipe's), ``augs_per=4`` (the recipe's 1024, cut for time) over 320
    seeded random 500² PNGs (decoding, rotating and cropping them costs the
    host what Oxford Flowers' ~500-px images cost): 4 val and 36 train
    batches. Checks the launch counts (5 K1 and 1 K3 per batch, no other
    kernel), reads the latents back through PreEncodedDataset, and holds the
    first batch's fused picks against the unfused path's, TF32 off. Times a
    batch's encode fused against unfused, and profiles one batch."""
    from flocoder_torch import preencode_data as pe
    from flocoder_torch.data.datasets import PreEncodedDataset

    data = write_pngs(os.path.join(tmp, "pe_images"), n=320, size=500, seed=4)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = True      # PyTorch's default for convs
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _zero(kernels)
    argv = ["--config-name", "flowers_vqgan.yaml", f"data={data}",
            f"codec.checkpoint={paths['codec']}", "preencoding.quantize=true",
            "preencoding.fused_vq=true", "preencoding.augs_per=4", "+seed=0"]
    t0 = time.time()
    res = pe.main(argv)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = _counts(kernels)
    peak = torch.cuda.max_memory_allocated() / 2**30
    splits = {s: res[s] for s in ("val", "train")}
    batches = sum(r["batches"] for r in splits.values())
    _expect(kernels, f"pre-encode ({batches} batches)", launches, na2d_fwd=5 * batches,
            fused_compress_tail_vq=batches)
    if [r["batches"] for r in splits.values()] != [4, 36]:
        fail(f"pre-encoding ran {[r['batches'] for r in splits.values()]} batches")
    for split, r in splits.items():
        ds = PreEncodedDataset(r["out_dir"])
        lat = [ds.get(i, np.random.default_rng(0))[0] for i in range(len(ds))]
        if len(lat) != r["latents"] or r["latents"] != 32 * r["batches"] or any(
                a.shape != (16, 16, 4) or not np.isfinite(a).all() for a in lat):
            fail(f"pre-encode {split}: {len(lat)} latents read back of "
                 f"{r['latents']}, shapes {sorted({a.shape for a in lat})}")

    codec = res["codec"]
    val_batches = rebuilt_batches(argv, "val")
    x = torch.from_numpy(next(val_batches)["pixels"]).cuda()
    val_batches.close()
    torch.backends.cudnn.allow_tf32 = False
    with torch.inference_mode():
        h = codec.encoder(x, stop_before_compress=True)
        layout = "NHWC" if h.is_contiguous() else "NCHW"
        print(f"pre-encode: the encoder hands K3 h {tuple(h.shape)} in {layout} "
              "memory", flush=True)
        zq_f, idx_f = codec.encode_quantize_fused(x)
        zq_u, idx_u, _, _ = codec.quantize(codec.encode(x))
        picks = hold_picks("pre-encode first batch, fused (K3) against unfused "
                           "(cuDNN + rvq_apply), TF32 off", zq_f, idx_f, zq_u, idx_u,
                           _tail_oracle_of(codec, h), codec.vq.codebooks)
    torch.backends.cudnn.allow_tf32 = True
    x_host = x.cpu().numpy()
    with torch.inference_mode():
        fused_ms = cuda_ms(lambda: codec.encode_quantize_fused(x), 10)
        unfused_ms = cuda_ms(lambda: codec.quantize(codec.encode(x))[0], 10)
        prof = profile_batch(lambda: codec.encode_quantize_fused(
            torch.from_numpy(x_host).cuda())[0].cpu())
    top = prof.pop("top_kernels")
    # K1's least time in one batch: the encoder's five NATTEN blocks at B=32
    # (two at 32²×512, two at 16²×1024, one at 16²×128; 8 heads, k=7)
    prof["na2d_bound_ms"] = sum(na2d_bound_ms(32, s, s, c, 7, torch.float32)[0]
                                for s, c in ((32, 512), (32, 512), (16, 1024),
                                             (16, 1024), (16, 128)))
    rec_out = dict(batch=32, batches=batches, wall_s=wall, peak_mem_gib=peak,
                   card=card, encode_fused_ms=fused_ms, encode_unfused_ms=unfused_ms,
                   first_batch_picks=picks, h_memory=layout, **prof,
                   **{f"{s}_latents_per_s": r["latents_per_s"] for s, r in splits.items()},
                   **{f"{s}_seconds": r["seconds"] for s, r in splits.items()})
    print(f"pre-encode flowers_vqgan B=32 128² (fused_vq): val "
          f"{splits['val']['latents_per_s']:.2f} latents/s ({splits['val']['seconds']:.3f} s),"
          f" train {splits['train']['latents_per_s']:.2f} latents/s "
          f"({splits['train']['seconds']:.3f} s), wall {wall:.1f} s, peak {peak:.2f} GiB; "
          f"encode per batch fused {fused_ms:.4f} ms, unfused {unfused_ms:.4f} ms "
          f"(CUDA events, cuDNN TF32 on); one batch under the profiler: "
          f"{prof['profiled_batch_s']:.4f} s wall, {prof['device_busy_s']:.4f} s busy, "
          f"idle share {prof['device_idle_share']:.4f}, K1 {prof['na2d_kernels_ms']:.4f} ms "
          f"of it (5 launches, bound {prof['na2d_bound_ms']:.4f} ms) | card: {card}",
          flush=True)
    print("  device time by kernel (ms): " + "; ".join(
        f"{name[:60]}={ms:.3f}" for name, ms in top), flush=True)
    del codec, res, x, h
    torch.cuda.empty_cache()
    return rec_out, launches


def check_preencode_small(tmp: str, config_dir: str) -> dict:
    """A small codec (flowers_vqgan at hidden 64, internal 64, 64² images)
    pre-encodes the same folder of 10 PNGs through
    flocoder_torch.preencode_data.main on the card and with +device=cpu,
    TF32 off (batch 8, augs_per 2: two batches of 1 in val, two of 8 in
    train). Each batch, rebuilt from the same config, is encoded by both
    runs' codecs: the card's picks must equal the CPU's or be ε-optimal
    under the fp64 tail of the card's own activations. The latent files
    must agree within 1e-4·max(1, |ref|) except at the tokens whose picks
    differ."""
    from flocoder_torch import preencode_data as pe
    from flocoder_torch.config import load_config
    from flocoder_torch.models.codecs import NATTENBlock, setup_codec
    from flocoder_torch.models.layers import init_params
    from flocoder_torch.training.checkpoint import (VQVAE_PREFIXES, save_checkpoint,
                                                    to_jax_flat)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    small = ["codec.hidden_channels=64", "codec.internal_dim=64", "codec.image_size=64"]
    cfg = load_config("flowers_vqgan.yaml", config_dir, small)
    codec = init_params(setup_codec(cfg, device="cuda"),
                        torch.Generator("cuda").manual_seed(10))
    for m in codec.modules():
        if isinstance(m, NATTENBlock):
            m.gamma.data.fill_(1.0)
    scale_codebooks(codec, 64)
    ckpt = save_checkpoint(to_jax_flat(codec, VQVAE_PREFIXES), 0,
                           ckpt_dir=os.path.join(tmp, "small_ckpt"), prefix="vqgan_")
    src = write_pngs(os.path.join(tmp, "pe_small"), n=10, size=64, seed=5)
    runs = {}
    for i, dev in enumerate(("cuda", "cpu")):
        data = f"{src}_{i}"
        shutil.copytree(src, data)
        argv = ["--config-name", "flowers_vqgan.yaml", f"data={data}", *small,
                f"codec.checkpoint={ckpt}", "preencoding.quantize=true",
                "preencoding.fused_vq=true", "preencoding.batch_size=8",
                "preencoding.augs_per=2", "preencoding.num_workers=2", "+seed=0"]
        runs[dev] = pe.main(argv + (["+device=cpu"] if dev == "cpu" else []))
    res_card, res_cpu = runs["cuda"], runs["cpu"]
    codec, codec_cpu = res_card["codec"], res_cpu["codec"]
    totals = {"tokens": 0, "differ": 0, "max_gap": 0.0, "max_abs_err": 0.0}
    n_batches = 0
    for split in ("val", "train"):
        for batch in rebuilt_batches(argv, split):
            x = torch.from_numpy(batch["pixels"])
            with torch.inference_mode():
                zq_c, idx_c = codec.encode_quantize_fused(x.cuda())
                zq_p, idx_p = codec_cpu.encode_quantize_fused(x)
                out64 = _tail_oracle_of(codec, codec.encoder(x.cuda(),
                                                             stop_before_compress=True))
            r = hold_picks(f"card vs CPU pre-encode {split} batch {tuple(x.shape)}",
                           zq_c.cpu(), idx_c.cpu(), zq_p, idx_p, out64.cpu(),
                           codec.vq.codebooks.cpu(), rel=1e-4)
            n_batches += 1
            for k in ("tokens", "differ"):
                totals[k] += r[k]
            for k in ("max_gap", "max_abs_err"):
                totals[k] = max(totals[k], r[k])
    if n_batches != 4:
        fail(f"small pre-encode: {n_batches} batches rebuilt, not 4")
    files = 0
    far = 0
    for split in ("val", "train"):
        a_dir, b_dir = res_card[split]["out_dir"], res_cpu[split]["out_dir"]
        names = sorted(os.path.relpath(os.path.join(r, f), a_dir)
                       for r, _, fs in os.walk(a_dir) for f in fs)
        names_cpu = sorted(os.path.relpath(os.path.join(r, f), b_dir)
                           for r, _, fs in os.walk(b_dir) for f in fs)
        if names != names_cpu or not names:
            fail(f"small pre-encode {split}: card and CPU wrote different files")
        for name in names:
            a, ref = np.load(os.path.join(a_dir, name)), np.load(os.path.join(b_dir, name))
            tol = 1e-4 * max(1.0, float(np.abs(ref).max()))
            far += int((np.abs(a - ref).max(-1) > tol).sum())
            files += 1
    print(f"card vs CPU pre-encode (hidden 64, 64², {files} files): {far} latent "
          f"vectors off by more than 1e-4·max(1, |ref|), {totals['differ']} of "
          f"{totals['tokens']} tokens with other picks", flush=True)
    if far > totals["differ"]:
        fail("card and CPU latent files disagree beyond the tokens whose picks differ")
    return dict(totals, files=files, far_vectors=far)


def _flow_batch(out_dir: str, n: int = 256) -> dict:
    """The first ``n`` latents of a pre-encoded split with their labels, on
    the card."""
    from flocoder_torch.data.datasets import PreEncodedDataset
    ds = PreEncodedDataset(out_dir, n_classes=102)
    items = [ds.get(i, np.random.default_rng(0)) for i in range(n)]
    return {"target": torch.from_numpy(np.stack([a for a, _ in items])).cuda(),
            "class_cond": torch.tensor([int(c) for _, c in items]).cuda()}


def _flow_step_on(dev: str, model, batch: dict, draws: dict, dtype,
                  paired: bool = False) -> tuple:
    """One flow step of a copy of ``model`` in ``dtype`` on ``dev``, with
    ``draws`` passed in and the CFG gate closed; ``paired``: a reflow step
    on the batch's sources."""
    from flocoder_torch.training.flow import create_flow_state, make_flow_train_step
    state = create_flow_state(copy.deepcopy(model).to(dev, dtype), 1e-4)
    on = {k: v.to(dev, dtype) if v.is_floating_point() else v.to(dev)
          for k, v in batch.items()}
    return make_flow_train_step(paired_source=paired)(state, on, None,
                                  draws=[{k: v.to(dev, dtype) for k, v in draws.items()}],
                                  drop=torch.tensor(False, device=dev))


def check_flow_step(model, batch: dict) -> dict:
    """One flow step (OT pairing, U-Net forward and backward, clipped Adam
    at lr 1e-4, EMA 0.999) of copies of ``model`` on the card and on the
    CPU, with the same draws passed in and the gate closed, held twice:
    - in fp32, TF32 off: the loss, the parameters, Adam's first moments and
      the EMA within 1e-3·max(1, |ref|) of each tensor;
    - in float64: what the step changed, (parameters after − before) and
      (EMA after − before), and Adam's first moments, on the card within
      1e-3 of the largest of each on the CPU. A step moves a weight by about
      1e-4 and the EMA by about 1e-7, so a card step that applied no update,
      another learning rate or no EMA update fails here. The changes are
      held in float64 because in fp32 a weight near 1 rounds at 1.2e-7, 1.2e-3
      of its change, and a gradient that rounds to zero flips its first Adam
      step from +lr to −lr.
    Also holds the parallel OT permutation at B=256 on the card to the
    CPU's."""
    from flocoder_torch.ops.ot import compute_ot_pairing_parallel
    from flocoder_torch.training.flow import draw_flow_inputs
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    draws = draw_flow_inputs(torch.Generator().manual_seed(11), batch["target"].shape)
    perms = [compute_ot_pairing_parallel(draws["noise"].to(dev), batch["target"].to(dev))
             for dev in ("cuda", "cpu")]
    if not torch.equal(perms[0].cpu(), perms[1]):
        fail(f"parallel OT at B=256: card and CPU permutations differ in "
             f"{int((perms[0].cpu() != perms[1]).sum())} places")

    worst = hold_flow_step_fp32(model, batch, draws)
    losses = worst.pop("loss_card"), worst.pop("loss_cpu")

    before = [p.detach().cpu().double() for p in model.parameters()]
    changes = {}
    for dev in ("cuda", "cpu"):
        state, _ = _flow_step_on(dev, model, batch, draws, torch.float64)
        changes[dev] = {
            "param_change": [p.detach().cpu() - b
                             for p, b in zip(state.model.parameters(), before)],
            "ema_change": [e.detach().cpu() - b
                           for e, b in zip(state.ema.parameters(), before)],
            "adam_mu_f64": [m.cpu() for m in _adam_mu(state)]}
    largest = {}
    for name, refs in changes["cpu"].items():
        largest[name] = max(r.abs().max().item() for r in refs)
        err = max((a - r).abs().max().item() for a, r in zip(changes["cuda"][name], refs))
        worst[name] = err / (1e-3 * largest[name]) if largest[name] > 0 else float("inf")
    print("card vs CPU flow step (B=256, same draws, TF32 off): fp32 max |Δ| / "
          "(1e-3·max(1, |ref|)) and float64 max |Δ| / (1e-3·largest CPU value) " +
          " ".join(f"{k}={v:.4f}" for k, v in worst.items()) +
          "; largest CPU float64 " + " ".join(f"{k}={v:.3e}" for k, v in largest.items()) +
          f"; loss {losses[0]:.6f} vs {losses[1]:.6f}; OT permutation "
          "equal", flush=True)
    if not all(np.isfinite(v) and v < 1.0 for v in worst.values()):
        fail(f"card and CPU disagree on a flow step: {worst}")
    return dict(worst, largest_cpu_f64=largest, ot_permutation_equal=True)


def write_inception_weights() -> str:
    """A seeded random init of the port's FID-Inception network written as
    weights/fid_inception.npz in the working directory (the JAX flat
    layout): with it, default_feature_fn scores FID on Inception features
    (reference-comparable only once converted weights replace it)."""
    from flocoder_torch.models.inception import InceptionV3Features, save_inception_weights
    from flocoder_torch.models.layers import init_params
    path = os.path.join("weights", "fid_inception.npz")
    save_inception_weights(init_params(InceptionV3Features(), torch.Generator().manual_seed(0)),
                           path)
    return path


def check_inception(card: str) -> dict:
    """The Inception features of 16 seeded 128² uint8 images on the card
    against the CPU's, TF32 off, within 1e-3 of the largest |CPU|; and the
    features of 64 images timed by CUDA events (the input pipeline's resize
    to 299² included)."""
    from flocoder_torch.models.inception import load_inception_weights, make_inception_feature_fn
    flags = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    fn = make_inception_feature_fn(state=load_inception_weights("weights/fid_inception.npz"))
    imgs = torch.from_numpy(np.random.default_rng(21).integers(0, 256, (64, 128, 128, 3),
                                                              dtype=np.uint8))
    ref = fn(imgs[:16]).double()
    got = fn(imgs[:16].cuda()).double().cpu()
    err, scale = float((got - ref).abs().max()), float(ref.abs().max())
    if not (got.shape == (16, 2048) and scale > 0 and err < 1e-3 * scale):
        fail(f"Inception features on the card {err:.3e} from the CPU's (largest {scale:.3e})")
    batch = imgs.cuda()
    ms = cuda_ms(lambda: fn(batch), 5)
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags
    print(f"Inception features (random init, TF32 off): card vs CPU max |d| {err:.3e} of "
          f"largest {scale:.3e} (tolerance 1e-3 of it); 64 images 128^2 -> 299^2 -> 2048 "
          f"{ms:.3f} ms (CUDA events) | card: {card}", flush=True)
    return dict(max_abs_err=err, largest=scale, ms_64=ms)


def run_profiling_tools(tmp: str, fn, card: str) -> dict:
    """utils/profiling's helpers once each around ``fn`` (a flow step):
    print_mem (bytes in use and the card's limit), step_timer (one
    synchronise at its end), trace (a torch.profiler trace file)."""
    from flocoder_torch.utils.profiling import print_mem, step_timer, trace
    mem = print_mem("flow phase")
    with step_timer("flow step B=256") as timed:
        fn()
    trace_dir = os.path.join(tmp, "flow_trace")
    with trace(trace_dir):
        fn()
    files = os.listdir(trace_dir)
    used, limit = mem.get("cuda:0", (0.0, 0.0))
    if not (used > 0 and limit > 70 and timed["seconds"] > 0 and files
            and os.path.getsize(os.path.join(trace_dir, files[0])) > 0):
        fail(f"profiling helpers: mem {mem}, step {timed}, trace {files}")
    print(f"profiling helpers: print_mem {used:.2f}/{limit:.2f} GB, step_timer "
          f"{timed['seconds'] * 1e3:.2f} ms, trace {files[0]} "
          f"({os.path.getsize(os.path.join(trace_dir, files[0]))} bytes) | card: {card}",
          flush=True)
    return dict(mem_gb=[used, limit], step_s=timed["seconds"], trace_file=files[0])


def train_flow_phase(tmp: str, pe_data: str, paths: dict, card: str, kernels: dict) -> tuple:
    """flowers_vqgan's flow at full width through flocoder_torch.train_flow.main
    on the latents the pre-encode phase wrote (1,152 train, 128 val): U-Net
    dim 16, dim_mults 1,2,4,8, 102 classes, batch 256, lr 1e-4 on cosine warm
    restarts (T0 50, Tmult 2, decay 0.6), EMA 0.999, parallel OT, RK4 + CFG
    3.0 evaluation. Cut for time: 1 epoch (the recipe's 10,000) and eval
    n_steps 20 (the recipe's 100). The launch counts are zeroed before and
    read after: K1 runs in every evaluation's two decodes (the samples and
    the targets, chunks of 128) and nothing else runs. Then serves the
    trained EMA checkpoint through generate_samples, times the OT pairing,
    profiles one step, and holds a step on the card to the CPU's."""
    from flocoder_torch import generate_samples as gs
    from flocoder_torch import train_flow as tf
    from flocoder_torch.evaluation import DECODE_CHUNK
    from flocoder_torch.ops.ot import pairwise_sqdist, parallel_assign
    from flocoder_torch.training.flow import make_flow_train_step

    print("flow phase cuts: 1 epoch (the recipe's 10,000), evaluation n_steps 20 "
          "(the recipe's 100)", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = True      # PyTorch's default for convs
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _zero(kernels)
    argv = ["--config-name", "flowers_vqgan.yaml", f"data={pe_data}",
            f"codec.checkpoint={paths['codec']}", "flow.unet.n_classes=102",
            "flow.epochs=1", "flow.n_steps=20", "flow.ckpt_every=1", "+seed=0",
            f"+ckpt_dir={os.path.join(tmp, 'flow_ckpt')}",
            f"+output_dir={os.path.join(tmp, 'flow_out')}"]
    # an event after each step is queued: the step times come from the
    # card's clock, and the loop keeps its one synchronise an epoch
    events, step_hook = _hooked()
    write_inception_weights()
    t0 = time.time()
    res = tf.main(argv, step_hook=step_hook)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = _counts(kernels)
    peak = torch.cuda.max_memory_allocated() / 2**30
    chunks = flow_decode_chunks(DECODE_CHUNK)
    eval_k1 = len(res["eval"]) * 2 * len(chunks)
    _expect(kernels, f"flow training ({len(res['eval'])} evaluations x 2 decodes x chunks "
            f"{chunks})", launches, na2d_fwd=eval_k1)
    if len(res["eval"]) != 1:
        fail(f"flow training ran {len(res['eval'])} evaluations")
    if (len(events) != 4 or [e["steps"] for e in res["epoch_seconds"]] != [4]
            or [e["samples"] for e in res["epoch_seconds"]] != [4 * FLOW_BATCH]):
        fail(f"flow training ran {len(events)} steps, {res['epoch_seconds']}")
    steps = _steady(events)
    losses = [v for e in res["epochs"] for k, v in e.items() if k != "epoch"]
    metrics = [v for e in res["eval"] for v in [e["val_loss"], *e["metrics"].values()]
               if not isinstance(v, str)]
    if not (np.isfinite(losses).all() and np.isfinite(metrics).all()):
        fail(f"flow losses or metrics not finite: {res['epochs']} {res['eval']}")
    if not (res["checkpoint"] and os.path.exists(res["ema_checkpoint"])):
        fail("flow training wrote no checkpoint")
    backend = res["eval"][0]["metrics"]["FID_feature_backend"]
    if backend != "fid_inception":
        fail(f"the flow evaluation's FID ran on {backend}, not the Inception weights file")
    import importlib.util
    plots = (["codebook/usage_hist", "codebook/combination_usage_map"]
             if importlib.util.find_spec("matplotlib") else [])
    log = check_metrics_log(res["metrics_log"], [
        "Loss/train", "Learning Rate", "batch_size", "samples_per_sec", "Loss/val",
        "metrics/FID_px", "metrics/FID_feature_backend", "metrics/sinkhorn",
        "codebook/val_usage_pct_level0", "codebook/gen_usage_pct_level0", "demo/decoded_pred*",
        *plots], "flow training")
    inception = check_inception(card)
    shutil.rmtree("weights")                # the later phases score FID as before

    # serve the trained EMA checkpoint on the card
    _zero(kernels)
    served = gs.main(["--config-name", "flowers_vqgan.yaml",
                      f"+flow_checkpoint={res['ema_checkpoint']}", "+n_samples=64",
                      "+n_steps=20", "+seed=0", f"+output_dir={os.path.join(tmp, 'flow_gen')}"])
    serve_k1 = _counts(kernels)
    _expect(kernels, "serving the trained flow", serve_k1, na2d_fwd=1)
    serve_k1 = serve_k1["na2d_fwd"]
    if served["images"].shape != (64, 128, 128, 3) or not np.isfinite(served["images"]).all():
        fail(f"serving the trained flow: {served['images'].shape}")
    launches["na2d_fwd"] += serve_k1

    train_dir = os.path.join(f"{pe_data}_encoded_vqgan", "train")
    batch = _flow_batch(train_dir)
    noise = torch.randn(batch["target"].shape, device="cuda",
                        generator=torch.Generator("cuda").manual_seed(12))
    ot = {}
    for k in (1, 2, 4, 8):
        ot[f"ms_rounds_per_check_{k}"] = cuda_ms(
            lambda k=k: parallel_assign(pairwise_sqdist(noise, batch["target"])[None],
                                        rounds_per_check=k), 10)
    ot["rounds_per_step"] = res["ot_rounds"]
    state = res["state"]
    step = make_flow_train_step()
    gen = torch.Generator("cuda").manual_seed(13)
    step(state, batch, gen)
    prof = profile_batch(lambda: step(state, batch, gen))
    top = prof.pop("top_kernels")
    tools = run_profiling_tools(tmp, lambda: step(state, batch, gen), card)
    step_check = check_flow_step(state.model, batch)

    steady = float(np.median(steps))
    rec = dict(batch=FLOW_BATCH, wall_s=wall, peak_mem_gib=peak, card=card, step_s=steps,
               steady_samples_per_s=FLOW_BATCH / steady,
               epoch_samples_per_s=[e["samples"] / e["seconds"] for e in res["epoch_seconds"]],
               epochs=res["epochs"], evals=res["eval"], ot=ot, step_profile=prof,
               k1_launches_eval=eval_k1, k1_launches_serve=serve_k1,
               serve_batch_s=served["batch_seconds"], card_vs_cpu=step_check,
               metrics_log=log, inception=inception, profiling_tools=tools)
    print(f"flow train flowers_vqgan B={FLOW_BATCH} 16x16x4: "
          f"{rec['steady_samples_per_s']:.2f} samples/s over steady steps (median of "
          f"{len(steps)} step-to-step intervals on CUDA events), per epoch "
          f"{[round(x, 2) for x in rec['epoch_samples_per_s']]} (evaluations excluded), "
          f"peak {peak:.2f} GiB, wall {wall:.1f} s; steps {[round(x, 4) for x in steps]} "
          f"| card: {card}", flush=True)
    print(f"  OT (parallel, B=256): rounds a step {ot['rounds_per_step']}; ms a pairing "
          "(CUDA events) with a host check every k rounds: " + ", ".join(
              f"k={k} {ot[f'ms_rounds_per_check_{k}']:.4f}" for k in (1, 2, 4, 8)) +
          f" (default k=2) | card: {card}", flush=True)
    for e in res["eval"]:
        print(f"  eval epoch {e['epoch']}: s " + " ".join(
            f"{k}={v:.4f}" for k, v in e["seconds"].items()) +
            f" total={sum(e['seconds'].values()):.4f}; val_loss {e['val_loss']:.4f}, "
            f"FID_px {e['metrics']['FID_px']:.3f}, sinkhorn {e['metrics']['sinkhorn']:.4f} "
            f"| card: {card}", flush=True)
    print(f"  one train step under the profiler: {prof['profiled_batch_s']:.4f} s wall, "
          f"{prof['device_busy_s']:.4f} s busy, idle share {prof['device_idle_share']:.4f} "
          f"| card: {card}", flush=True)
    print("  device time by kernel (ms): " + "; ".join(
        f"{name[:60]}={ms:.3f}" for name, ms in top), flush=True)
    print(f"  served the trained EMA checkpoint: 64 samples, nfe={served['nfe']}, "
          f"s/batch {[round(x, 4) for x in served['batch_seconds']]}, K1 launches "
          f"{serve_k1} | card: {card}", flush=True)
    del res, state, batch
    torch.cuda.empty_cache()
    return rec, launches


# ---------------------------------------------------------------------------
# The SD-VAE latent family: flowers_sd (pre-encode, serve) and flowers_hdit
# ---------------------------------------------------------------------------

HDIT_NA = ["flow.hdit_patch_size=2", "flow.hdit_attns=[na:7,global]"]
HDIT_N_STEPS = 20              # the evaluations' and serving's grid (the recipe's 100)
HDIT_NFE = 4 * (HDIT_N_STEPS - 1)   # RK4: four velocity calls a step between grid points
HDIT_NA_BLOCKS = 4             # down_0 and up_0, depth 2 each: K1 (K2) per forward (backward)
# (B, H, W, C, heads, ks) where HDiT's NA level runs K1/K2: the training
# batch and the evaluation sampler's CFG-doubled batch (2 x 128) at 256; the
# validation loss and serving's CFG-doubled batch (2 x 64) at 128; and the
# 4x4 map of na:7 at patch 4, where the window is clamped to 4x4.
HDIT_SHAPES = [(256, 8, 8, 256, 4, 7), (128, 8, 8, 256, 4, 7), (256, 4, 4, 256, 4, 7)]


def check_hdit_kernels(na2d_fwd, na2d_bwd, na2d_banded, na2d_bwd_banded,
                       shapes=HDIT_SHAPES, label: str = "HDiT") -> dict:
    """K1 and K2 at ``shapes`` (HDIT_SHAPES by default) against their plain
    twins, fp32 and bf16, TF32 off, with the gates of check_k1 and
    check_k2: K1 1e-4 and 2e-2 absolute, K2 1e-4·max(1, |ref|) and
    3e-2·max(1, |ref|)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator("cuda").manual_seed(14)
    errs = {}
    for B, H, W, C, heads, ks in shapes:
        for dtype, tol1, rel2 in ((torch.float32, 1e-4, 1e-4), (torch.bfloat16, 2e-2, 3e-2)):
            q, k, v, gr = (torch.randn(B, H, W, C, device="cuda", generator=g).to(dtype)
                           for _ in range(4))
            o = na2d_fwd(q, k, v, kernel_size=ks, heads=heads)
            grads = na2d_bwd(q, k, v, o, gr, kernel_size=ks, heads=heads)
            torch.cuda.synchronize()
            f32 = [t.float() for t in (q, k, v, o, gr)]
            e1 = (o.float() - na2d_banded(*f32[:3], kernel_size=ks, heads=heads)).abs().max().item()
            refs = na2d_bwd_banded(*f32, kernel_size=ks, heads=heads)
            e2 = [(a.float() - r).abs().max().item() for a, r in zip(grads, refs)]
            tol2 = [rel2 * max(1.0, r.abs().max().item()) for r in refs]
            ok = (np.isfinite(e1) and e1 < tol1
                  and all(np.isfinite(e) and e < t for e, t in zip(e2, tol2)))
            print(f"K1/K2 check {label} B={B} {H}x{W} C={C} heads={heads} k={ks} "
                  f"{str(dtype)[6:]}: K1 max_abs_err={e1:.3e} (tol {tol1:g}), K2 dq/dk/dv "
                  f"max_abs_err={[f'{e:.3e}' for e in e2]} (tol {[f'{t:.3e}' for t in tol2]}) "
                  f"{'ok' if ok else 'FAIL'}", flush=True)
            if not ok:
                fail(f"K1 or K2 disagrees with its plain twin at {label}'s {(B, H, W, C)} "
                     f"{dtype}")
            for name, e in (("na2d_fwd", e1), ("na2d_bwd", max(e2))):
                key = (name, dtype)
                errs[key] = max(errs.get(key, 0.0), e)
    return errs


def time_hdit_kernels(na2d_fwd, na2d_bwd, card: str, shapes=HDIT_SHAPES,
                      path: str = "hdit", label: str = "HDiT") -> list:
    """K1 and K2 at ``shapes`` (HDIT_SHAPES by default), fp32 and bf16: the
    kernels' device time by the profiler, CUDA events over 20 calls, the
    bound, and the SDPA yardstick with the window mask (forward for K1;
    forward + backward, against K1 + K2's 'fwd_bwd_ms', for K2). Rows carry
    ``path``."""
    import torch.nn.functional as F
    rows = []
    g = torch.Generator("cuda").manual_seed(15)
    for B, H, W, C, heads, ks in shapes:
        dh = C // heads
        mask = _window_mask(H, W, ks)
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v, gr = (torch.randn(B, H, W, C, device="cuda", generator=g).to(dtype)
                           for _ in range(4))
            o = na2d_fwd(q, k, v, kernel_size=ks, heads=heads)
            heads_first = lambda t: (t.reshape(B, H * W, heads, dh).transpose(1, 2)  # noqa: E731
                                     .contiguous())
            qs, ks_, vs = (heads_first(t).requires_grad_() for t in (q, k, v))
            gs_ = heads_first(gr)
            fwd = lambda: na2d_fwd(q, k, v, kernel_size=ks, heads=heads)  # noqa: E731
            bwd = lambda: na2d_bwd(q, k, v, o, gr, kernel_size=ks, heads=heads)  # noqa: E731
            sdpa = lambda: F.scaled_dot_product_attention(qs, ks_, vs, attn_mask=mask)  # noqa: E731
            sdpa_fb = lambda: torch.autograd.grad(sdpa(), (qs, ks_, vs), gs_)  # noqa: E731
            lib_err = (sdpa().detach().transpose(1, 2).reshape(B, H, W, C).float()
                       - o.float()).abs().max().item()
            if not lib_err < (1e-3 if dtype == torch.float32 else 5e-2):
                fail(f"the SDPA yardstick disagrees with K1 at {label}'s shape ({lib_err:.3e})")
            for name, fn, bound, lib in (("na2d_fwd", fwd, na2d_bound_ms, sdpa),
                                         ("na2d_bwd", bwd, na2d_bwd_bound_ms, sdpa_fb)):
                row = dict(kernel=name, shape=[B, H, W, C], heads=heads, kernel_size=ks,
                           dtype=str(dtype)[6:], path=path,
                           device_ms=device_ms(fn, name), ms=cuda_ms(fn, 20),
                           bound_ms=bound(B, H, W, C, ks, dtype)[0],
                           bound_by=bound(B, H, W, C, ks, dtype)[1],
                           library_ms=cuda_ms(lib, 20))
                if name == "na2d_bwd":
                    row["fwd_bwd_ms"] = cuda_ms(lambda: (fwd(), bwd()), 20)
                rows.append(row)
                print(f"{name} {label} B={B} {H}x{W} C={C} heads={heads} k={ks} {row['dtype']}: "
                      f"device_ms={row['device_ms']:.4f} ms={row['ms']:.4f} bound_ms="
                      f"{row['bound_ms']:.4f} ({row['bound_by']}) SDPA+mask library_ms="
                      f"{row['library_ms']:.4f}"
                      + (f" (K1+K2 {row['fwd_bwd_ms']:.4f})" if "fwd_bwd_ms" in row else "")
                      + f" | card: {card}", flush=True)
            del q, k, v, gr, o, qs, ks_, vs, gs_
    torch.cuda.empty_cache()
    return rows


def sd_preencode(tmp: str, pe_data: str, card: str, kernels: dict) -> tuple:
    """flowers_sd pre-encoded through flocoder_torch.preencode_data.main at
    full width (the SD VAE's channels 128-512, 128² images, 16×16×4
    latents, posterior mean), batch 32 (the recipe's), augs_per 4 (the
    recipe's 128, cut for time), over the 500² PNGs of the VQGAN pre-encode
    phase: 4 val and 36 train batches. The SD VAE runs no kernel of the
    port (its attention is global), so every launch count stays 0. Then the
    encode ms a batch (CUDA events), one batch under the profiler, and two
    images encoded on the card and on the CPU, TF32 off, within
    1e-4·max(1, |ref|)."""
    from flocoder_torch import preencode_data as pe
    from flocoder_torch.data.datasets import PreEncodedDataset

    print("sd_preencode cuts: augs_per 4 (the recipe's 128)", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = True      # PyTorch's default for convs
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _zero(kernels)
    argv = ["--config-name", "flowers_sd.yaml", f"data={pe_data}",
            "preencoding.augs_per=4", "+seed=0"]
    t0 = time.time()
    res = pe.main(argv)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = _counts(kernels)
    peak = torch.cuda.max_memory_allocated() / 2**30
    splits = {s: res[s] for s in ("val", "train")}
    _expect(kernels, "sd pre-encode", launches)
    if [r["batches"] for r in splits.values()] != [4, 36]:
        fail(f"sd pre-encode ran {[r['batches'] for r in splits.values()]} batches")
    for split, r in splits.items():
        ds = PreEncodedDataset(r["out_dir"])
        lat = [ds.get(i, np.random.default_rng(0))[0] for i in range(len(ds))]
        if len(lat) != 32 * r["batches"] or any(
                a.shape != (16, 16, 4) or not np.isfinite(a).all() for a in lat):
            fail(f"sd pre-encode {split}: {len(lat)} latents, shapes "
                 f"{sorted({a.shape for a in lat})}")
    codec = res["codec"]
    val_batches = rebuilt_batches(argv, "val")
    x = torch.from_numpy(next(val_batches)["pixels"]).cuda()
    val_batches.close()
    x_host = x.cpu().numpy()
    with torch.inference_mode():
        encode_ms = cuda_ms(lambda: codec.encode(x), 10)
        prof = profile_batch(lambda: codec.encode(torch.from_numpy(x_host).cuda()).cpu())
    top = prof.pop("top_kernels")
    torch.backends.cudnn.allow_tf32 = False
    cpu_codec = copy.deepcopy(codec).cpu()
    with torch.inference_mode():
        z = codec.encode(x[:2]).cpu()
        ref = cpu_codec.encode(x[:2].cpu())
    err = (z - ref).abs().max().item()
    tol = 1e-4 * max(1.0, ref.abs().max().item())
    print(f"card vs CPU SD-VAE encode (2 images, 128², full width, TF32 off): "
          f"max_abs_err={err:.3e} (tol {tol:.3e})", flush=True)
    if not (np.isfinite(err) and err < tol):
        fail("card and CPU disagree on the SD-VAE encode")
    torch.backends.cudnn.allow_tf32 = True
    rec = dict(batch=32, wall_s=wall, peak_mem_gib=peak, card=card, encode_ms=encode_ms,
               card_vs_cpu_err=err, card_vs_cpu_tol=tol, **prof,
               **{f"{s}_latents_per_s": r["latents_per_s"] for s, r in splits.items()},
               **{f"{s}_seconds": r["seconds"] for s, r in splits.items()})
    print(f"sd_preencode flowers_sd B=32 128² -> 16x16x4: val "
          f"{splits['val']['latents_per_s']:.2f} latents/s ({splits['val']['seconds']:.3f} s), "
          f"train {splits['train']['latents_per_s']:.2f} latents/s "
          f"({splits['train']['seconds']:.3f} s), wall {wall:.1f} s, peak {peak:.2f} GiB; "
          f"encode {encode_ms:.4f} ms a batch (CUDA events, cuDNN TF32 on); one batch "
          f"under the profiler: {prof['profiled_batch_s']:.4f} s wall, "
          f"{prof['device_busy_s']:.4f} s busy, idle share {prof['device_idle_share']:.4f} "
          f"| card: {card}", flush=True)
    print("  device time by kernel (ms): " + "; ".join(
        f"{name[:60]}={ms:.3f}" for name, ms in top), flush=True)
    del codec, cpu_codec, res, x
    torch.cuda.empty_cache()
    return rec, launches


def sd_serve(tmp: str, config_dir: str, card: str, kernels: dict) -> tuple:
    """flowers_sd served through flocoder_torch.generate_samples.main: 128
    samples in batches of 64 at 20 grid points (the recipe's 100), RK4,
    unconditional and CFG 3.0 with 102 classes, decoded through the SD VAE
    at full width. No kernel of the port runs (launch counts stay 0). Then
    the decode ms of a batch of 64 (CUDA events), and check_small_input on
    the class-conditional checkpoint (the SD VAE's encode and decode)."""
    from flocoder_torch import generate_samples as gs
    from flocoder_torch.config import Config

    print("sd_serve cuts: n_steps 20 (the recipe's 100)", flush=True)
    paths = write_checkpoints(tmp, config_dir, "flowers_sd")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = True
    _zero(kernels)
    results = []
    for label, ckpt in (("unconditional", paths["uncond"]), ("CFG n_classes=102", paths["cfg"])):
        torch.cuda.reset_peak_memory_stats()
        res = gs.main(["--config-name", "flowers_sd.yaml", f"+flow_checkpoint={ckpt}",
                       "+n_samples=128", f"+n_steps={HDIT_N_STEPS}", "flow.batch_size=64",
                       "+seed=0", f"+output_dir={os.path.join(tmp, 'sd_out')}"])
        imgs, secs = res["images"], res["batch_seconds"]
        if imgs.shape != (128, 128, 128, 3) or not np.isfinite(imgs).all():
            fail(f"sd serving {label}: images {imgs.shape}")
        peak = torch.cuda.max_memory_allocated() / 2**30
        results.append(dict(run=label, samples=128, batch=64, nfe=res["nfe"], s_per_batch=secs,
                            samples_per_s=128 / sum(secs), steady_samples_per_s=64 / secs[-1],
                            peak_mem_gib=peak, card=card))
        print(f"sd_serve {label}: 128 samples, nfe={res['nfe']}, s/batch="
              f"{[round(s, 4) for s in secs]}, {results[-1]['samples_per_s']:.2f} samples/s "
              f"(last batch {results[-1]['steady_samples_per_s']:.2f}), peak {peak:.2f} GiB "
              f"| card: {card}", flush=True)
    launches = _counts(kernels)
    _expect(kernels, "sd serving", launches)
    b = gs.load_models_once(Config({}), paths["cfg"], torch.device("cuda"))
    x64 = torch.randn(64, 16, 16, 4, device="cuda", generator=torch.Generator("cuda").manual_seed(22))
    with torch.inference_mode():
        decode_ms = cuda_ms(lambda: b["codec"].decode(x64), 5)
    worst = check_small_input(paths["cfg"], "sd serving ")
    torch.backends.cudnn.allow_tf32 = True
    print(f"sd_serve decode of 64 latents: {decode_ms:.4f} ms (CUDA events, cuDNN TF32 on) "
          f"| card: {card}", flush=True)
    return dict(runs=results, decode_b64_ms=decode_ms, card_vs_cpu=worst), launches


def _adam_mu(state) -> list:
    return [state.opt.adam.state[p]["exp_avg"] for p in state.model.parameters()]


def hold_flow_step_fp32(model, batch: dict, draws: dict, paired: bool = False) -> dict:
    """One flow step (OT pairing, or with ``paired`` the batch's own
    sources; forward, backward, clipped Adam at lr 1e-4, EMA 0.999) of fp32
    copies of ``model`` on the card and on the CPU with ``draws`` passed in
    and the gate closed, TF32 off. Returns for the loss, the parameters,
    Adam's first moments and the EMA the worst ratio max |Δ| /
    (1e-3·max(1, |ref|)) over their tensors, and both losses."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    (sc, ac), (sp, ap) = (_flow_step_on(dev, model, batch, draws, torch.float32, paired)
                          for dev in ("cuda", "cpu"))
    worst = {}
    for name, pairs in (("loss", [(ac["loss"], ap["loss"])]),
                        ("params", zip(sc.model.parameters(), sp.model.parameters())),
                        ("adam_mu", zip(_adam_mu(sc), _adam_mu(sp))),
                        ("ema", zip(sc.ema.parameters(), sp.ema.parameters()))):
        worst[name] = max((a.detach().float().cpu() - r.detach().float()).abs().max().item()
                          / (1e-3 * max(1.0, r.detach().abs().max().item())) for a, r in pairs)
    worst["loss_card"], worst["loss_cpu"] = float(ac["loss"]), float(ap["loss"])
    return worst


def hdit_flow_phase(tmp: str, pe_data: str, card: str, kernels: dict) -> tuple:
    """flowers_hdit with the recipe's NA variant (flow.hdit_patch_size=2,
    flow.hdit_attns=[na:7,global]) through flocoder_torch.train_flow.main
    at full width (widths 256/512, depths 2/4, d_head 64, mapping 2×256,
    102 classes, batch 256, bf16) on the latents sd_preencode wrote (1,152
    train, 128 val): 1 epoch (the recipe's 10,000), with the
    validation loss and an RK4 + CFG 3.0 evaluation at 20 grid points
    decoded through the SD VAE. Then serves the EMA checkpoint as trained
    (64 samples, in bf16: its flow.bf16, no flag; the SD VAE too). K1 and K2
    launch counts are held exactly: 4 K1 (K2) per
    HDiT forward (backward), 4·NFE K1 per sampler call. Then one step under
    the profiler and one fp32 step, its zero-init weights perturbed, on the
    card against the CPU."""
    from flocoder_torch import generate_samples as gs
    from flocoder_torch import train_flow as tf
    from flocoder_torch.config import parse_cli
    from flocoder_torch.models.flow_model import build_flow_model
    from flocoder_torch.training.flow import draw_flow_inputs, make_flow_train_step

    print(f"hdit_flow cuts: 1 epoch (the recipe's 10,000), evaluation and serving n_steps "
          f"{HDIT_N_STEPS} (the recipe's 100)", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = True
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _zero(kernels)
    argv = ["--config-name", "flowers_hdit.yaml", f"data={pe_data}", *HDIT_NA,
            "flow.epochs=1", f"flow.n_steps={HDIT_N_STEPS}", "flow.ckpt_every=1", "+seed=0",
            f"+ckpt_dir={os.path.join(tmp, 'hdit_ckpt')}",
            f"+output_dir={os.path.join(tmp, 'hdit_out')}"]
    events, step_hook = _hooked()
    t0 = time.time()
    res = tf.main(argv, step_hook=step_hook)
    torch.cuda.synchronize()
    wall = time.time() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    steps = len(events)
    evals = len(res["eval"])
    train_launches = _counts(kernels)
    _expect(kernels, f"hdit_flow training ({steps} steps x {HDIT_NA_BLOCKS}, {evals} "
            f"evaluations x {HDIT_NA_BLOCKS} x (1 validation forward + {HDIT_NFE} sampler "
            "forwards))", train_launches,
            na2d_fwd=HDIT_NA_BLOCKS * (steps + evals * (1 + HDIT_NFE)),
            na2d_bwd=HDIT_NA_BLOCKS * steps)
    if steps != 4 or evals != 1:
        fail(f"hdit_flow training ran {steps} steps and {evals} evaluations")
    losses = [v for e in res["epochs"] for k, v in e.items() if k != "epoch"]
    metrics = [v for e in res["eval"] for v in [e["val_loss"], *e["metrics"].values()]
               if not isinstance(v, str)]
    if not (np.isfinite(losses).all() and np.isfinite(metrics).all()):
        fail(f"hdit_flow losses or metrics not finite: {res['epochs']} {res['eval']}")

    _zero(kernels)
    served = gs.main(["--config-name", "flowers_hdit.yaml",
                      f"+flow_checkpoint={res['ema_checkpoint']}", "+n_samples=64",
                      f"+n_steps={HDIT_N_STEPS}", "+seed=0",
                      f"+output_dir={os.path.join(tmp, 'hdit_gen')}"])
    serve_launches = _counts(kernels)
    _expect(kernels, "serving the HDiT EMA checkpoint", serve_launches,
            na2d_fwd=HDIT_NA_BLOCKS * HDIT_NFE)
    if (served["images"].shape != (64, 128, 128, 3) or not np.isfinite(served["images"]).all()
            or served["nfe"] != HDIT_NFE or not served["bf16"]):
        fail(f"serving the HDiT EMA checkpoint as trained (bf16): {served['images'].shape}, "
             f"nfe {served['nfe']}, bf16 {served['bf16']}")

    batch = _flow_batch(os.path.join(f"{pe_data}_encoded_sd", "train"))
    state = res["state"]
    step = make_flow_train_step()
    gen = torch.Generator("cuda").manual_seed(25)
    step(state, batch, gen)
    prof = profile_batch(lambda: step(state, batch, gen))
    top = prof.pop("top_kernels")
    cfg = parse_cli(argv, config_dir=gs.CONFIG_DIR)
    model32 = build_flow_model(cfg, 4, 102).cuda()
    model32.load_state_dict(state.model.state_dict())
    with torch.no_grad():       # every zero-init projection carries signal
        g = torch.Generator("cuda").manual_seed(26)
        for p in model32.parameters():
            p.add_(0.02 * torch.randn(p.shape, device="cuda", generator=g))
    small = {k: v[:64] for k, v in batch.items()}
    step_check = hold_flow_step_fp32(model32, small, draw_flow_inputs(
        torch.Generator().manual_seed(24), small["target"].shape))
    print("card vs CPU HDiT fp32 flow step (B=64, NA k7 on 8x8, zero-init weights perturbed, "
          "same draws, TF32 off): "
          "max |Δ| / (1e-3·max(1, |ref|)) " + " ".join(
              f"{k}={v:.4f}" for k, v in step_check.items() if not k.startswith("loss_"))
          + f"; loss {step_check['loss_card']:.6f} vs {step_check['loss_cpu']:.6f}", flush=True)
    if not all(np.isfinite(step_check[k]) and step_check[k] < 1.0
               for k in ("loss", "params", "adam_mu", "ema")):
        fail(f"card and CPU disagree on an HDiT flow step: {step_check}")

    intervals = _steady(events)
    steady = float(np.median(intervals))
    rec = dict(batch=FLOW_BATCH, wall_s=wall, peak_mem_gib=peak, card=card,
               step_s=intervals, steady_samples_per_s=FLOW_BATCH / steady,
               epoch_samples_per_s=[e["samples"] / e["seconds"] for e in res["epoch_seconds"]],
               epochs=res["epochs"], evals=res["eval"], step_profile=prof,
               launches_train_eval=train_launches, launches_serve=serve_launches,
               serve_batch_s=served["batch_seconds"], card_vs_cpu=step_check,
               ema_checkpoint=res["ema_checkpoint"])
    print(f"hdit_flow flowers_hdit (patch 2, na:7) B={FLOW_BATCH} bf16: "
          f"{rec['steady_samples_per_s']:.2f} samples/s over steady steps (median of "
          f"{len(intervals)} intervals on CUDA events), per epoch "
          f"{[round(x, 2) for x in rec['epoch_samples_per_s']]} (evaluations excluded), "
          f"peak {peak:.2f} GiB, wall {wall:.1f} s; steps {[round(x, 4) for x in intervals]} "
          f"| card: {card}", flush=True)
    for e in res["eval"]:
        print(f"  eval epoch {e['epoch']}: s " + " ".join(
            f"{k}={v:.4f}" for k, v in e["seconds"].items()) +
            f" total={sum(e['seconds'].values()):.4f}; val_loss {e['val_loss']:.4f}, "
            f"FID_px {e['metrics']['FID_px']:.3f} | card: {card}", flush=True)
    print(f"  one train step under the profiler: {prof['profiled_batch_s']:.4f} s wall, "
          f"{prof['device_busy_s']:.4f} s busy, idle share {prof['device_idle_share']:.4f}, "
          f"K1+K2 {prof['na2d_kernels_ms']:.4f} ms | card: {card}", flush=True)
    print("  device time by kernel (ms): " + "; ".join(
        f"{name[:60]}={ms:.3f}" for name, ms in top), flush=True)
    print(f"  served the EMA checkpoint as trained (bf16): 64 samples, nfe={served['nfe']}, s/batch "
          f"{[round(x, 4) for x in served['batch_seconds']]}, launches {serve_launches} "
          f"| card: {card}", flush=True)
    launches = {name: train_launches[name] + serve_launches[name] for name in kernels}
    del res, state, batch, model32
    torch.cuda.empty_cache()
    return rec, launches


def hdit_short_phase(tag: str, tmp: str, pe_data: str, card: str, kernels: dict,
                     overrides: list) -> tuple:
    """One epoch of flowers_hdit with ``overrides`` through
    flocoder_torch.train_flow.main, no evaluation: steady samples/s, the
    launch counts (4 K1 and 4 K2 a step with the NA level, none without),
    and, with MoE levels, the auxiliary loss and the dropped fraction of a
    forward on a training batch."""
    from flocoder_torch import train_flow as tf

    print(f"{tag} cuts: 1 epoch (the recipe's 10,000), no evaluation", flush=True)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _zero(kernels)
    argv = ["--config-name", "flowers_hdit.yaml", f"data={pe_data}", *overrides,
            "flow.epochs=1", "flow.no_eval=true", "+seed=0",
            f"+ckpt_dir={os.path.join(tmp, tag + '_ckpt')}",
            f"+output_dir={os.path.join(tmp, tag + '_out')}"]
    events, step_hook = _hooked()
    res = tf.main(argv, step_hook=step_hook)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 2**30
    launches = _counts(kernels)
    na = HDIT_NA_BLOCKS * len(events) if any("na:" in o for o in overrides) else 0
    _expect(kernels, f"{tag} ({len(events)} steps)", launches, na2d_fwd=na, na2d_bwd=na)
    (ep,) = res["epochs"]
    if len(events) != 4 or not all(np.isfinite(v) for k, v in ep.items() if k != "epoch"):
        fail(f"{tag}: {len(events)} steps; epoch {ep}")
    intervals = _steady(events)
    rec = dict(batch=FLOW_BATCH, peak_mem_gib=peak, card=card, step_s=intervals,
               steady_samples_per_s=FLOW_BATCH / float(np.median(intervals)), epoch=ep,
               epoch_samples_per_s=res["epoch_seconds"][0]["samples"]
               / res["epoch_seconds"][0]["seconds"])
    extra = ""
    if "loss_model_aux" in ep:
        batch = _flow_batch(os.path.join(f"{pe_data}_encoded_sd", "train"))
        t = torch.full((FLOW_BATCH,), 500.0, device="cuda")
        with torch.no_grad():
            _, aux = res["state"].model(batch["target"], t, {"class_cond": batch["class_cond"]},
                                        return_aux=True)
        rec.update(loss_model_aux=ep["loss_model_aux"],
                   moe_aux=aux["moe_aux"].tolist(), moe_dropped=aux["moe_dropped"].tolist())
        if not np.isfinite(ep["loss_model_aux"]):
            fail(f"{tag}: the MoE auxiliary loss is not finite")
        extra = (f"; loss_model_aux {ep['loss_model_aux']:.5f}, dropped fraction by block "
                 f"{[round(x, 5) for x in rec['moe_dropped']]} (a forward at t=500 on a "
                 "training batch)")
    print(f"{tag} B={FLOW_BATCH} bf16: {rec['steady_samples_per_s']:.2f} samples/s over "
          f"steady steps (median of {len(intervals)}), {rec['epoch_samples_per_s']:.2f} over "
          f"the epoch, peak {peak:.2f} GiB, loss {ep['loss']:.4f}{extra} | card: {card}",
          flush=True)
    del res
    torch.cuda.empty_cache()
    return rec, launches


# ---------------------------------------------------------------------------
# Reflow distillation on flowers_hdit's NA variant
# ---------------------------------------------------------------------------

REFLOW_PAIRS = 1280            # 5 batches of 256: 1,216 train pairs (4 steps) and 64 val
REFLOW_BATCHES = REFLOW_PAIRS // FLOW_BATCH
REFLOW_SERVE_STEPS = 5         # Euler over 5 grid points: 4 NFE
REFLOW_CHECK_STEPS = 3         # the card-vs-CPU pairs: RK4 over 3 grid points (8 NFE)


def _pair_batch(split_dir: str, n: int = 64) -> dict:
    """The first ``n`` reflow pairs of a split (targets, sources, labels),
    on the card."""
    from flocoder_torch.data.datasets import PreEncodedDataset
    ds = PreEncodedDataset(split_dir, n_classes=102)
    items = [ds.get(i, np.random.default_rng(0)) for i in range(n)]
    return {"target": torch.from_numpy(np.stack([d["target_latents"] for d, _ in items])).cuda(),
            "source": torch.from_numpy(np.stack([d["source_latents"] for d, _ in items])).cuda(),
            "class_cond": torch.tensor([int(c) for _, c in items]).cuda()}


def check_reflow_pairs_small(teacher: str) -> dict:
    """An fp32 copy of the teacher (the checkpoint served with
    ``+bf16=false``), every weight perturbed by 0.02·N(0, 1) (after a few
    steps its EMA still sits at its zero-init output projections, so its
    field barely moves the noise), integrates 8 injected noises with their
    labels, RK4 + CFG 3.0 over REFLOW_CHECK_STEPS grid points, on the card
    and on the CPU, TF32 off: the pairs within 1e-3·max(1, |ref|), and the
    field moves the noise by more than 0.1."""
    from flocoder_torch import generate_samples as gs
    from flocoder_torch.config import Config
    from flocoder_torch.make_reflow_pairs import sample_pairs

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    b = gs.load_models_once(Config({"bf16": False}), teacher, torch.device("cuda"))
    model = copy.deepcopy(b["model"])
    with torch.no_grad():
        g = torch.Generator("cuda").manual_seed(30)
        for p in model.parameters():
            p.add_(0.02 * torch.randn(p.shape, device="cuda", generator=g))
    g = torch.Generator().manual_seed(31)
    noise = torch.randn(8, *b["latent_shape"], generator=g)
    labels = torch.randint(0, b["n_classes"], (8,), generator=g)
    kw = dict(n_classes=b["n_classes"], method="rk4", n_steps=REFLOW_CHECK_STEPS,
              cfg_strength=3.0)
    card, nfe = sample_pairs(model, noise.cuda(), labels, **kw)
    ref, _ = sample_pairs(model.cpu(), noise, labels, **kw)
    err = (card.cpu() - ref).abs().max().item()
    tol = 1e-3 * max(1.0, ref.abs().max().item())
    moved = (ref - noise).abs().max().item()
    print(f"card vs CPU reflow pairs (fp32 teacher, weights perturbed, 8 noises, RK4 {nfe} "
          f"NFE + CFG, TF32 off): max_abs_err={err:.3e} (tol {tol:.3e}); the field moved the "
          f"noise by up to {moved:.3f}", flush=True)
    if not (np.isfinite(err) and err < tol and moved > 0.1):
        fail("card and CPU disagree on the reflow pairs, or the field did not move")
    torch.backends.cudnn.allow_tf32 = True
    return dict(max_abs_err=err, tol=tol, nfe=nfe, moved=moved)


def reflow_phase(tmp: str, teacher: str, card: str, kernels: dict) -> tuple:
    """Reflow on flowers_hdit's NA variant (module docstring, step 28):
    the pairs tool on ``teacher`` (hdit_flow's EMA, bf16), one epoch of
    train_flow with +reflow=true and its evaluation on the pairs, serving
    the reflowed EMA with Euler at 4 NFE beside the teacher's RK4 at
    HDIT_NFE, then the card against the CPU on pairs and on a paired step.
    Returns (record, launches by tag)."""
    from flocoder_torch import generate_samples as gs
    from flocoder_torch import make_reflow_pairs as mrp
    from flocoder_torch import train_flow as tf
    from flocoder_torch.config import Config, parse_cli
    from flocoder_torch.evaluation import sampler
    from flocoder_torch.models.flow_model import build_flow_model
    from flocoder_torch.training.flow import draw_flow_inputs

    print(f"reflow cuts: {REFLOW_PAIRS} pairs (the tool's 10,000) at n_steps {HDIT_N_STEPS} "
          f"(its 50), 1 training epoch (the recipe's 10,000) with its evaluation at "
          f"n_steps {HDIT_N_STEPS} (its 100)", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = True
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    launches = {}
    pairs_dir = os.path.join(tmp, "reflow_pairs")
    _zero(kernels)
    pairs = mrp.main(["--config-name", "flowers_hdit.yaml", f"+flow_checkpoint={teacher}",
                      f"+out_dir={pairs_dir}", f"+n_pairs={REFLOW_PAIRS}",
                      f"+batch_size={FLOW_BATCH}", f"+n_steps={HDIT_N_STEPS}", "+method=rk4",
                      "+cfg_strength=3.0", "+seed=0"])
    torch.cuda.synchronize()
    launches["reflow_pairs"] = _counts(kernels)
    _expect(kernels, f"reflow pairs ({REFLOW_BATCHES} batches x {HDIT_NFE} NFE x "
            f"{HDIT_NA_BLOCKS})", launches["reflow_pairs"],
            na2d_fwd=HDIT_NA_BLOCKS * HDIT_NFE * REFLOW_BATCHES)
    if (pairs["train"], pairs["val"], pairs["batches"], pairs["nfe"]) != (
            REFLOW_PAIRS - REFLOW_PAIRS // 20, REFLOW_PAIRS // 20, REFLOW_BATCHES, HDIT_NFE):
        fail(f"reflow pairs: {pairs}")
    pairs_peak = torch.cuda.max_memory_allocated() / 2**30

    torch.cuda.reset_peak_memory_stats()
    _zero(kernels)
    argv = ["--config-name", "flowers_hdit.yaml", f"data={pairs_dir}", *HDIT_NA,
            "+reflow=true", "flow.epochs=1", f"flow.n_steps={HDIT_N_STEPS}",
            "flow.ckpt_every=1", "+seed=0", f"+ckpt_dir={os.path.join(tmp, 'reflow_ckpt')}",
            f"+output_dir={os.path.join(tmp, 'reflow_out')}"]
    events, step_hook = _hooked()
    t0 = time.time()
    res = tf.main(argv, step_hook=step_hook)
    torch.cuda.synchronize()
    wall = time.time() - t0
    train_peak = torch.cuda.max_memory_allocated() / 2**30
    steps, evals = len(events), len(res["eval"])
    launches["reflow_train"] = _counts(kernels)
    _expect(kernels, f"reflow training ({steps} steps x {HDIT_NA_BLOCKS}, {evals} evaluations x "
            f"{HDIT_NA_BLOCKS} x (1 validation forward + {HDIT_NFE} sampler forwards))",
            launches["reflow_train"], na2d_fwd=HDIT_NA_BLOCKS * (steps + evals * (1 + HDIT_NFE)),
            na2d_bwd=HDIT_NA_BLOCKS * steps)
    losses = [v for e in res["epochs"] for k, v in e.items() if k != "epoch"]
    metrics = [v for e in res["eval"] for v in [e["val_loss"], *e["metrics"].values()]
               if not isinstance(v, str)]
    if (steps != 4 or evals != 1 or res["ot_rounds"] or not np.isfinite(losses).all()
            or not np.isfinite(metrics).all()):
        fail(f"reflow training: {steps} steps, {evals} evaluations, OT rounds "
             f"{res['ot_rounds']}, epochs {res['epochs']}, eval {res['eval']}")

    _zero(kernels)
    served = gs.main(["--config-name", "flowers_hdit.yaml",
                      f"+flow_checkpoint={res['ema_checkpoint']}", "+n_samples=128",
                      "flow.batch_size=64", "+method=euler", f"+n_steps={REFLOW_SERVE_STEPS}",
                      "+seed=0", f"+output_dir={os.path.join(tmp, 'reflow_gen')}"])
    launches["reflow_serve"] = _counts(kernels)
    nfe = REFLOW_SERVE_STEPS - 1
    _expect(kernels, f"serving the reflowed EMA (2 batches x {nfe} NFE x {HDIT_NA_BLOCKS})",
            launches["reflow_serve"], na2d_fwd=HDIT_NA_BLOCKS * nfe * 2)
    if (served["images"].shape != (128, 128, 128, 3) or not np.isfinite(served["images"]).all()
            or served["nfe"] != nfe or not served["bf16"]):
        fail(f"serving the reflowed EMA: {served['images'].shape}, nfe {served['nfe']}, "
             f"bf16 {served['bf16']}")
    # a batch of 64 by CUDA events, the student at Euler 4 NFE beside the
    # teacher at RK4 HDIT_NFE, both as trained (bf16), then the SD VAE's decode
    gen = torch.Generator("cuda").manual_seed(32)
    serve_ms = {}
    for tag, ckpt, method, n_steps in (("reflowed", res["ema_checkpoint"], "euler",
                                        REFLOW_SERVE_STEPS),
                                       ("teacher", teacher, "rk4", HDIT_N_STEPS)):
        b = gs.load_models_once(Config({}), ckpt, torch.device("cuda"))
        with torch.inference_mode():
            serve_ms[tag] = cuda_ms(lambda: sampler(
                b["model"], b["codec"], gen, method=method, batch_size=64, n_steps=n_steps,
                n_classes=b["n_classes"], latent_shape=b["latent_shape"]), 3, warmup=1)

    pairs_check = check_reflow_pairs_small(teacher)
    cfg = parse_cli(argv, config_dir=gs.CONFIG_DIR)
    model32 = build_flow_model(cfg, 4, 102).cuda()
    model32.load_state_dict(res["state"].model.state_dict())
    with torch.no_grad():       # every zero-init projection carries signal
        g = torch.Generator("cuda").manual_seed(33)
        for p in model32.parameters():
            p.add_(0.02 * torch.randn(p.shape, device="cuda", generator=g))
    small = _pair_batch(os.path.join(pairs_dir, "train"))
    step_check = hold_flow_step_fp32(model32, small, draw_flow_inputs(
        torch.Generator().manual_seed(34), small["target"].shape), paired=True)
    print("card vs CPU HDiT fp32 reflow step (B=64, paired sources, no OT, zero-init weights "
          "perturbed, same draws, TF32 off): max |Δ| / (1e-3·max(1, |ref|)) " + " ".join(
              f"{k}={v:.4f}" for k, v in step_check.items() if not k.startswith("loss_"))
          + f"; loss {step_check['loss_card']:.6f} vs {step_check['loss_cpu']:.6f}", flush=True)
    if not all(np.isfinite(step_check[k]) and step_check[k] < 1.0
               for k in ("loss", "params", "adam_mu", "ema")):
        fail(f"card and CPU disagree on a reflow step: {step_check}")
    torch.backends.cudnn.allow_tf32 = True

    intervals = _steady(events)
    rec = dict(batch=FLOW_BATCH, card=card, pairs=REFLOW_PAIRS, pairs_s=pairs["seconds"],
               pairs_per_s=pairs["pairs_per_s"], pairs_batch_s=pairs["batch_seconds"],
               pairs_peak_mem_gib=pairs_peak, train_wall_s=wall, train_peak_mem_gib=train_peak,
               step_s=intervals, steady_samples_per_s=FLOW_BATCH / float(np.median(intervals)),
               epoch_samples_per_s=[e["samples"] / e["seconds"] for e in res["epoch_seconds"]],
               epochs=res["epochs"], evals=res["eval"], serve_batch_s=served["batch_seconds"],
               serve_b64_ms=serve_ms, pairs_card_vs_cpu=pairs_check, step_card_vs_cpu=step_check,
               launches=launches)
    print(f"reflow pairs: {REFLOW_PAIRS} in {pairs['seconds']:.2f} s, "
          f"{pairs['pairs_per_s']:.2f} pairs/s (RK4 {HDIT_NFE} NFE + CFG, B={FLOW_BATCH}, bf16; "
          f"s/batch {[round(x, 4) for x in pairs['batch_seconds']]}), peak {pairs_peak:.2f} GiB "
          f"| card: {card}", flush=True)
    print(f"reflow training B={FLOW_BATCH} bf16: {rec['steady_samples_per_s']:.2f} samples/s "
          f"over steady steps (median of {len(intervals)} intervals on CUDA events), per epoch "
          f"{[round(x, 2) for x in rec['epoch_samples_per_s']]}, peak {train_peak:.2f} GiB, "
          f"wall {wall:.1f} s; steps {[round(x, 4) for x in intervals]} | card: {card}",
          flush=True)
    for e in res["eval"]:
        print(f"  eval epoch {e['epoch']}: s " + " ".join(
            f"{k}={v:.4f}" for k, v in e["seconds"].items()) +
            f" total={sum(e['seconds'].values()):.4f}; val_loss {e['val_loss']:.4f}, "
            f"FID_px {e['metrics']['FID_px']:.3f} | card: {card}", flush=True)
    print(f"reflow serving (bf16, B=64 with CFG): the reflowed EMA at Euler {nfe} NFE "
          f"{serve_ms['reflowed']:.2f} ms a batch, the teacher at RK4 {HDIT_NFE} NFE "
          f"{serve_ms['teacher']:.2f} ms (CUDA events, sampler + SD-VAE decode; "
          f"{serve_ms['teacher'] / serve_ms['reflowed']:.2f}x); generate_samples s/batch "
          f"{[round(x, 4) for x in served['batch_seconds']]} | card: {card}", flush=True)
    del res, served, model32, small
    torch.cuda.empty_cache()
    return rec, launches


# ---------------------------------------------------------------------------
# The vqgan_plus codec family on flowers_vqgan
# ---------------------------------------------------------------------------

VQGAN_PLUS = ["codec.choice=vqgan_plus", "+discriminator=vqgan_plus", "+lecam_weight=0.001"]


def vqgan_plus_small_setup() -> tuple:
    """The small VQGAN+ codec of the card-vs-CPU check (hidden 32, three
    downsamples, fp32, seeded, its RVQ initialised with no dead codes), the
    full VQGANPlusDiscriminator at base 16, the VGG16 net and two batches
    of 4 32² images (``small_training_setup``'s layout)."""
    from flocoder_torch.models.discriminator import VQGANPlusDiscriminator, init_discriminator
    from flocoder_torch.models.layers import init_params
    from flocoder_torch.models.perceptual import VGG16Features
    from flocoder_torch.models.vqgan_plus import VQGANPlus

    kw = dict(hidden_channels=32, num_downsamples=3, internal_dim=32, vq_embedding_dim=4,
              vq_num_embeddings=16, codebook_levels=2, commitment_weight=0.5)
    codec = init_params(VQGANPlus(**kw), torch.Generator().manual_seed(0))
    rng = np.random.default_rng(7)
    L, K, D = codec.vq.codebooks.shape
    codec.vq.assign_({
        "codebooks": torch.from_numpy(rng.normal(size=(L, K, D)).astype(np.float32)),
        "ema_counts": torch.from_numpy(rng.uniform(4, 30, (L, K)).astype(np.float32)),
        "ema_sums": torch.from_numpy(rng.normal(size=(L, K, D)).astype(np.float32)),
        "initted": torch.tensor(True)})
    disc = init_discriminator(VQGANPlusDiscriminator(base_channels=16),
                              torch.Generator().manual_seed(1))
    vgg = init_params(VGG16Features(), torch.Generator().manual_seed(2))
    batches = [torch.from_numpy(rng.uniform(-1, 1, (4, 32, 32, 3)).astype(np.float32))
               for _ in range(2)]
    return kw, codec, disc, vgg, batches


def vqgan_plus_phase(tmp: str, card: str, kernels: dict) -> tuple:
    """flowers_vqgan with the VQGAN+ codec (module docstring, step 29):
    codec training with its GAN step's parts, pre-encoding with
    preencoding.fused_vq=true (the unfused RVQ), serving in fp32 and with
    +quant=int8 through a seeded flow checkpoint whose codec it is, the
    decode of 64 in both, then a small GAN step on the card against the
    CPU. Returns (record, launches by tag)."""
    from flocoder_torch import generate_samples as gs
    from flocoder_torch import preencode_data as pe
    from flocoder_torch import train_vqgan as tv
    from flocoder_torch.config import Config, load_config
    from flocoder_torch.data.datasets import PreEncodedDataset
    from flocoder_torch.models.layers import init_params
    from flocoder_torch.models.unet import Unet
    from flocoder_torch.models.vqgan_plus import VQGANPlus
    from flocoder_torch.training.checkpoint import UNET_PREFIXES, checkpoint_payload, to_jax_flat

    print("vqgan_plus cuts: codec 2 epochs of 4 steps (1 warmup, 1 GAN; the recipe's 2000 "
          "with 5 warmup), pre-encode augs_per 1 (its 1024), serving from seeded flow "
          f"weights (no flow epoch) at n_steps {HDIT_N_STEPS} (its 100)", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = True
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    launches = {}
    _zero(kernels)
    t0 = time.time()
    res = tv.main(["--config-name", "flowers_vqgan.yaml", f"data={os.path.join(tmp, 'flowers')}",
                   *VQGAN_PLUS, "codec.epochs=2", "codec.warmup_epochs=1", "+seed=0",
                   f"+ckpt_dir={os.path.join(tmp, 'vqgan_plus_ckpt')}",
                   f"+output_dir={os.path.join(tmp, 'vqgan_plus_out')}"])
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches["vqgan_plus_train"] = _counts(kernels)
    n_steps = {ph: len(t) for ph, t in res["step_seconds"].items()}
    _expect(kernels, f"vqgan_plus training ({n_steps} steps, {len(res['val'])} validation "
            "batch)", launches["vqgan_plus_train"])
    state = res["state"]
    ckpt = res["checkpoint"]
    if (not isinstance(state.codec, VQGANPlus) or type(state.disc).__name__
            != "VQGANPlusDiscriminator" or min(n_steps.values()) < 4
            or ckpt is None or not os.path.exists(ckpt)):
        fail(f"vqgan_plus training: {type(state.codec).__name__}, "
             f"{type(state.disc).__name__}, {n_steps} steps, checkpoint {ckpt}")
    losses = [v for e in res["epochs"] + res["val"] for k, v in e.items()
              if k not in ("epoch", "phase")]
    if not np.isfinite(losses).all() or "d_loss" not in res["epochs"][1]:
        fail(f"vqgan_plus losses: {res['epochs']} {res['val']}")
    rec = dict(train=train_record(res, wall, card),
               codec_params=sum(p.numel() for p in [*state.codec.encoder.parameters(),
                                                    *state.codec.decoder.parameters()]),
               disc_params=sum(p.numel() for p in state.disc.parameters()))
    print(f"vqgan_plus codec {rec['codec_params'] / 1e6:.2f} M parameters, discriminator "
          f"{rec['disc_params'] / 1e6:.2f} M", flush=True)
    rec["train"]["gan_breakdown"] = gan_breakdown(state, card, "flowers_vqgan.yaml",
                                                  VQGAN_PLUS, lecam_weight=0.001)
    del state, res
    torch.cuda.empty_cache()

    torch.cuda.reset_peak_memory_stats()
    _zero(kernels)
    over = [*VQGAN_PLUS, f"codec.checkpoint={ckpt}"]
    pre = pe.main(["--config-name", "flowers_vqgan.yaml",
                   f"data={os.path.join(tmp, 'pe_images')}", *over,
                   "preencoding.quantize=true", "preencoding.fused_vq=true",
                   "preencoding.augs_per=1", "+seed=0"])
    torch.cuda.synchronize()
    launches["vqgan_plus_preencode"] = _counts(kernels)
    _expect(kernels, "vqgan_plus pre-encode (the unfused RVQ)", launches["vqgan_plus_preencode"])
    splits = {s: pre[s] for s in ("val", "train")}
    for split, r in splits.items():
        lat = [a for a, _ in (PreEncodedDataset(r["out_dir"]).get(i, np.random.default_rng(0))
                              for i in range(r["latents"]))]
        if (r["quantize"] != "rvq" or r["batches"] != {"val": 1, "train": 9}[split]
                or any(a.shape != (16, 16, 4) or not np.isfinite(a).all() for a in lat)):
            fail(f"vqgan_plus pre-encode {split}: {r}")
    rec["preencode"] = dict(peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30, **{
        f"{s}_{k}": r[k] for s, r in splits.items() for k in ("latents_per_s", "seconds",
                                                              "batches", "quantize")})
    print(f"vqgan_plus pre-encode B=32 (quantize: {splits['train']['quantize']}): val "
          f"{splits['val']['latents_per_s']:.2f} latents/s, train "
          f"{splits['train']['latents_per_s']:.2f} latents/s, peak "
          f"{rec['preencode']['peak_mem_gib']:.2f} GiB | card: {card}", flush=True)

    cfg = load_config("flowers_vqgan", gs.CONFIG_DIR, [*over, "flow.unet.n_classes=102"])
    unet = init_params(Unet(dim=16, channels=4, dim_mults=(1, 2, 4, 8), n_classes=102).cuda(),
                       torch.Generator("cuda").manual_seed(1))
    flow = os.path.join(tmp, "flowema_vqgan_plus_0.npz")
    np.savez(flow, **checkpoint_payload(to_jax_flat(unet, UNET_PREFIXES), 0, cfg))
    _zero(kernels)
    rec["serve"], z = {}, torch.randn(64, 16, 16, 4, device="cuda",
                                      generator=torch.Generator("cuda").manual_seed(35))
    for quant in ("false", "int8"):
        torch.cuda.reset_peak_memory_stats()
        served = gs.main(["--config-name", "flowers_vqgan.yaml", f"+flow_checkpoint={flow}",
                          "+n_samples=64", f"+n_steps={HDIT_N_STEPS}", f"+quant={quant}",
                          "+seed=0", f"+output_dir={os.path.join(tmp, 'vqgan_plus_gen')}"])
        if (served["images"].shape != (64, 128, 128, 3)
                or not np.isfinite(served["images"]).all()
                or served["quant"] != (quant == "int8")):
            fail(f"vqgan_plus serving +quant={quant}: {served['images'].shape}, "
                 f"quant {served['quant']}")
        b = gs.load_models_once(Config({"quant": quant}), flow, torch.device("cuda"))
        with torch.inference_mode():
            decode_ms = cuda_ms(lambda: b["codec"].decode(z), 5)
        rec["serve"][quant] = dict(s_per_batch=served["batch_seconds"], decode_b64_ms=decode_ms,
                                   peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30)
        print(f"vqgan_plus serving {'int8' if quant == 'int8' else 'fp32'}: 64 samples, "
              f"nfe={served['nfe']}, s/batch {[round(x, 4) for x in served['batch_seconds']]}; "
              f"decode of 64 {decode_ms:.4f} ms (CUDA events) | card: {card}", flush=True)
    launches["vqgan_plus_serve"] = _counts(kernels)
    _expect(kernels, "vqgan_plus serving (fp32, int8)", launches["vqgan_plus_serve"])
    check_train_small(vqgan_plus_small_setup, lecam_weight=0.001,
                      label="vqgan_plus hidden 32, VQGANPlusDiscriminator base 16, LeCAM")
    torch.backends.cudnn.allow_tf32 = True
    del unet
    torch.cuda.empty_cache()
    return rec, launches


# ---------------------------------------------------------------------------
# MIDI piano rolls and inpainting: midi_vqgan with inpainting=true, and
# midi_inpainting's codec at its widths
# ---------------------------------------------------------------------------

MIDI_SONGS = 108               # 98 train songs: 294 rolls, 265 after the 10% val split
MIDI_CODEC_NATTEN = (5, 1)     # midi_vqgan's codec (flowers' widths): K1 a encode, a decode
MIDI_OTF = ["flow.otf_aug=true", "+flow.curriculum_epochs=1", "+flow.extend_epochs=2",
            "+flow.p_ones=0.3", "+flow.p_zeros=0.05"]
# (B, H, W, C, heads, ks) of midi_inpainting's widest NATTEN blocks: 8x8x2048
# with 8 heads of 256, at the codec training batch and the pre-encode batch
MIDI_INP_SHAPES = [(64, 8, 8, 2048, 8, 7), (32, 8, 8, 2048, 8, 7)]


def midi_train_codec(tmp: str, card: str, kernels: dict) -> tuple:
    """midi_vqgan's codec at full width (128² RGB piano rolls, hidden 256,
    RVQ 4×96×4, VGG16 perceptual loss, patch discriminator) through
    flocoder_torch.train_vqgan.main on a seeded corpus (the port's
    write_synthetic_corpus: MIDI_SONGS songs of MELODY and PIANO, each
    rolling to three 128² images), converted to PNGs by the loader:
    one warmup epoch of 4 steps at batch 64 (the GAN step at these widths is
    flowers_vqgan's and tpu_vqgan's), one validation batch with the note
    metrics and their grids. 6 K1 and 6 K2 a step, 6 K1 a validation
    batch."""
    from flocoder_torch import train_vqgan as tv
    from flocoder_torch.data.midi_io import write_synthetic_corpus

    write_synthetic_corpus(os.path.join(tmp, "midi"), MIDI_SONGS, seed=5)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = True      # PyTorch's default for convs
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _zero(kernels)
    t0 = time.time()
    res = tv.main(["--config-name", "midi_vqgan.yaml", f"data={os.path.join(tmp, 'midi')}",
                   "codec.epochs=1", "codec.warmup_epochs=1", "+seed=0",
                   f"+ckpt_dir={os.path.join(tmp, 'midi_ckpt')}",
                   f"+output_dir={os.path.join(tmp, 'midi_train_out')}"])
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = _counts(kernels)
    n_steps = {ph: len(t) for ph, t in res["step_seconds"].items()}
    steps = sum(n_steps.values())
    enc, dec = MIDI_CODEC_NATTEN
    _expect(kernels, "midi codec training", launches,
            na2d_fwd=(enc + dec) * (steps + len(res["val"])), na2d_bwd=(enc + dec) * steps)
    if n_steps != {"warmup": 4, "gan": 0}:
        fail(f"midi codec training ran {n_steps} steps, expected 4 warmup steps")
    (val,) = res["val"]
    values = [v for e in res["epochs"] + res["val"] for k, v in e.items()
              if k not in ("epoch", "phase")]
    if not np.isfinite(values).all() or "note_onset_f1" not in val:
        fail(f"midi codec training: losses or note metrics {res['epochs']} {res['val']}")
    grids = [f for f in os.listdir(os.path.join(tmp, "midi_train_out")) if f.startswith("metric_")]
    if len(grids) != 10:
        fail(f"midi codec training wrote {len(grids)} note-metric grids, expected 10")
    peak = torch.cuda.max_memory_allocated() / 2**30
    rec = dict(batch=64, wall_s=wall, peak_mem_gib=peak, card=card, epochs=res["epochs"],
               val=res["val"])
    secs, (ep,) = res["step_seconds"]["warmup"], res["epoch_seconds"]
    rec["warmup"] = dict(step_s=secs, samples_per_s=64 / float(np.median(secs[1:])),
                         epoch_samples_per_s=ep["samples"] / ep["seconds"])
    print("train midi_vqgan B=64 128² piano rolls: " + ", ".join(
        f"{ph} {rec[ph]['samples_per_s']:.2f} samples/s over steady steps, "
        f"{rec[ph]['epoch_samples_per_s']:.2f} over the epoch" for ph in ("warmup",))
        + f", peak {peak:.2f} GiB, wall {wall:.1f} s (with the corpus's conversion); note "
        "metrics " + " ".join(f"{k[5:]}={v:.4f}" for k, v in val.items() if k.startswith("note_"))
        + f" | card: {card}", flush=True)
    del res
    torch.cuda.empty_cache()
    return rec, launches


def midi_preencode(tmp: str, card: str, kernels: dict) -> tuple:
    """midi_vqgan pre-encoded with inpainting=true through
    flocoder_torch.preencode_data.main from the codec training's checkpoint,
    over the corpus's 324 roll PNGs: batch 32 (the recipe's), augs_per 2
    (the recipe's 1024): 2 val and 18 train batches, each two encodes (the
    image and the masked image, masks generate_mask_batch(seed·100003+b)),
    5 K1 an encode. Reads the triplets back."""
    from flocoder_torch import preencode_data as pe
    from flocoder_torch.data.datasets import PreEncodedDataset

    ckpt = os.path.join(tmp, "midi_ckpt", "vqgan_1.npz")
    data = os.path.join(tmp, "midi_images")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _zero(kernels)
    t0 = time.time()
    res = pe.main(["--config-name", "midi_vqgan.yaml", f"data={data}",
                   f"codec.checkpoint={ckpt}", "+inpainting=true", "preencoding.augs_per=2",
                   "+seed=0"])
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = _counts(kernels)
    splits = {s: res[s] for s in ("val", "train")}
    batches = sum(r["batches"] for r in splits.values())
    _expect(kernels, "midi inpainting pre-encode", launches,
            na2d_fwd=2 * MIDI_CODEC_NATTEN[0] * batches)
    if [r["batches"] for r in splits.values()] != [2, 18]:
        fail(f"midi pre-encode ran {[r['batches'] for r in splits.values()]} batches")
    for split, r in splits.items():
        ds = PreEncodedDataset(r["out_dir"])
        items = [ds.get(i, np.random.default_rng(0))[0] for i in range(len(ds))]
        ok = len(items) == r["latents"] == 32 * r["batches"] and all(
            set(t) == {"target_latents", "source_latents", "mask_pixels"}
            and t["target_latents"].shape == t["source_latents"].shape == (16, 16, 4)
            and t["mask_pixels"].shape == (128, 128, 1) and t["mask_pixels"].dtype == bool
            and np.isfinite(t["target_latents"]).all() and np.isfinite(t["source_latents"]).all()
            for t in items)
        if not ok:
            fail(f"midi pre-encode {split}: triplets read back do not hold")
    peak = torch.cuda.max_memory_allocated() / 2**30
    rec = dict(batch=32, batches=batches, wall_s=wall, peak_mem_gib=peak, card=card,
               **{f"{s}_triplets_per_s": r["latents_per_s"] for s, r in splits.items()},
               **{f"{s}_seconds": r["seconds"] for s, r in splits.items()})
    print(f"pre-encode midi_vqgan inpainting B=32 128²: val {rec['val_triplets_per_s']:.2f} "
          f"triplets/s ({rec['val_seconds']:.3f} s), train {rec['train_triplets_per_s']:.2f} "
          f"triplets/s ({rec['train_seconds']:.3f} s), two encodes a triplet; wall "
          f"{wall:.1f} s, peak {peak:.2f} GiB | card: {card}", flush=True)
    del res
    torch.cuda.empty_cache()
    return rec, launches


def _inpaint_batch(out_dir: str, n: int) -> dict:
    from flocoder_torch.data.datasets import PreEncodedDataset
    ds = PreEncodedDataset(out_dir)
    items = [ds.get(i, np.random.default_rng(0))[0] for i in range(n)]
    stack = lambda k: torch.from_numpy(np.stack([t[k] for t in items]).astype(np.float32))  # noqa: E731
    return {"target": stack("target_latents"), "source": stack("source_latents"),
            "mask_pixels": stack("mask_pixels"),
            "class_cond": torch.zeros(n, dtype=torch.long)}


def hold_inpaint_flow_step(state, batch: dict, blank) -> dict:
    """One inpainting flow step (mask encoder, mask blend, OTF curriculum past
    its ramp, OT pairing, masked U-Net forward and backward, both optimizer
    groups at lr 1e-4, EMA 0.999) of copies of the trained U-Net and mask
    encoder on the card and on the CPU, the same draws passed in and the
    gate closed, held as check_flow_step holds the plain step: in fp32 (TF32
    off) the loss, parameters, Adam's first moments and EMA of both nets
    within 1e-3·max(1, |ref|); in float64 the step's changes and the first
    moments within 1e-3 of the largest on the CPU."""
    from flocoder_torch.training.flow import (create_flow_state, draw_flow_inputs,
                                              make_flow_train_step, otf_counts)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    otf = {"curriculum_epochs": 1, "extend_epochs": 2, "p_ones": 0.3, "p_zeros": 0.05,
           "steps_per_epoch": 4}
    step_at = 12                               # epoch 4: past the ramp
    n = batch["target"].shape[0]
    if min(otf_counts(otf, step_at, n)) < 1:
        fail("the held inpainting step selects no OTF items")
    draws = draw_flow_inputs(torch.Generator().manual_seed(21), batch["target"].shape, otf=True)

    def run(dev, dtype):
        st = create_flow_state(copy.deepcopy(state.model).to(dev, dtype), 1e-4,
                               mask_encoder=copy.deepcopy(state.mask_encoder).to(dev, dtype))
        st.step = step_at
        on = {k: v.to(dev, dtype) if v.is_floating_point() else v.to(dev)
              for k, v in batch.items()}
        d = {k: v.to(dev, dtype) if v.is_floating_point() else v.to(dev)
             for k, v in draws.items()}
        step = make_flow_train_step(blank_latents=blank.to(dev, dtype), otf_aug=otf)
        return step(st, on, None, draws=[d], drop=torch.tensor(False, device=dev))

    def params(st):
        return [*st.model.parameters(), *st.mask_encoder.parameters()]

    def emas(st):
        return [*st.ema.parameters(), *st.ema_mask_encoder.parameters()]

    def mus(st):
        return ([st.opt.adam.state[p]["exp_avg"] for p in st.model.parameters()]
                + [st.mask_opt.adam.state[p]["exp_avg"] for p in st.mask_encoder.parameters()])

    (sc, ac), (sp, ap) = (run(dev, torch.float32) for dev in ("cuda", "cpu"))
    worst = {}
    for name, pairs in (("loss", [(ac["loss"], ap["loss"])]),
                        ("loss_mask", [(ac["loss_mask"], ap["loss_mask"])]),
                        ("params", zip(params(sc), params(sp))),
                        ("adam_mu", zip(mus(sc), mus(sp))), ("ema", zip(emas(sc), emas(sp)))):
        worst[name] = max((a.detach().float().cpu() - r.detach().float()).abs().max().item()
                          / (1e-3 * max(1.0, r.detach().abs().max().item())) for a, r in pairs)
    before = [p.detach().cpu().double() for p in (*state.model.parameters(),
                                                  *state.mask_encoder.parameters())]
    changes = {}
    for dev in ("cuda", "cpu"):
        st, _ = run(dev, torch.float64)
        changes[dev] = {"param_change": [p.detach().cpu() - b for p, b in zip(params(st), before)],
                        "ema_change": [e.detach().cpu() - b for e, b in zip(emas(st), before)],
                        "adam_mu_f64": [m.cpu() for m in mus(st)]}
    for name, refs in changes["cpu"].items():
        largest = max(r.abs().max().item() for r in refs)
        err = max((a - r).abs().max().item() for a, r in zip(changes["cuda"][name], refs))
        worst[name] = err / (1e-3 * largest) if largest > 0 else float("inf")
    torch.backends.cudnn.allow_tf32 = True
    print(f"card vs CPU inpainting flow step (B={n}, mask encoder, OTF, same draws, TF32 "
          "off): max |Δ| / tolerance " + " ".join(f"{k}={v:.4f}" for k, v in worst.items())
          + f"; loss {float(ac['loss']):.6f} vs {float(ap['loss']):.6f}", flush=True)
    if not all(np.isfinite(v) and v < 1.0 for v in worst.values()):
        fail(f"card and CPU disagree on an inpainting flow step: {worst}")
    return worst


def export_corpus_rolls(tmp: str, n: int = 64) -> dict:
    """The .mid export of ``n`` corpus piano rolls (the loader's PNGs, in the
    decoder's [-1, 1] range) through generate_samples.save_sample_batch,
    timed. Fails unless the notes read back hold some and equal, file by
    file, those of img2midi_multi on the rect layout of the same rolls."""
    from PIL import Image

    from flocoder_torch import generate_samples as gs
    from flocoder_torch.data.midi_io import read_midi
    from flocoder_torch.data.pianoroll import img2midi_multi, square_to_rect
    from flocoder_torch.utils.viz import _to_uint8_img

    files = sorted(os.path.join(r, f) for r, _, fs in os.walk(os.path.join(tmp, "midi_images"))
                   for f in fs if f.endswith(".png"))[:n]
    rolls = np.stack([np.asarray(Image.open(f).convert("RGB"), np.float32) / 127.5 - 1.0
                      for f in files])
    t0 = time.time()
    mids = gs.save_sample_batch(rolls, 0, os.path.join(tmp, "midi_export"), is_midi=True)
    seconds = time.time() - t0

    def notes(mf):
        return sorted((n.pitch, n.velocity, n.start, n.end)
                      for i in mf.instruments for n in i.notes)
    total = 0
    for roll, path in zip(rolls, mids):
        got = notes(read_midi(path))
        want = notes(img2midi_multi(square_to_rect(Image.fromarray(_to_uint8_img(roll)))))
        if len(got) != len(want) or any(
                g[:2] != w[:2] or abs(g[2] - w[2]) > 1e-6 or abs(g[3] - w[3]) > 1e-6
                for g, w in zip(got, want)):
            fail(f"the .mid export of {path}: {len(got)} notes read back, img2midi "
                 f"gives {len(want)}")
        total += len(got)
    if len(mids) != n or total == 0:
        fail(f"the .mid export of {n} corpus rolls wrote {len(mids)} files, {total} notes")
    return dict(rolls=n, seconds=seconds, notes=total)


def midi_flow(tmp: str, card: str, kernels: dict) -> tuple:
    """The inpainting flow of midi_vqgan through flocoder_torch.train_flow.main on
    the pre-encoded triplets (576 train, 64 val): the mask-conditioned U-Net
    (dim 16, dim_mults 1,2,4,8) and the MaskEncoder (128² masks → 8² →
    resized to the 16² latents), batch 256 (the recipe's), OTF curriculum
    (curriculum 1 epoch, ramp to epoch 2, then p_ones 0.3 and p_zeros 0.05)
    with blank_latents (one encode: 5 K1), and an RK4 inpainting evaluation
    each epoch at 20 grid points (the recipe's 100) conditioned on the val
    batch's masks, from its mask-blended sources: 3 decodes (samples,
    targets, sources) of 64, 1 K1 each. 1 epoch of 2 steps (the recipe's
    10,000). Then serves the EMA with .mid export (64 samples, 1 K1) and
    parses every .mid back (rolls that hold no notes yet), exports corpus
    rolls that do (export_corpus_rolls); profiles one step; holds a step on
    the card to the CPU's (hold_inpaint_flow_step)."""
    from flocoder_torch import generate_samples as gs
    from flocoder_torch import train_flow as tf
    from flocoder_torch.config import load_config
    from flocoder_torch.data.midi_io import read_midi
    from flocoder_torch.generate_samples import CONFIG_DIR
    from flocoder_torch.preencode_data import load_codec
    from flocoder_torch.training.flow import make_flow_train_step

    print("midi flow cuts: 1 epoch (the recipe's 10,000), evaluation n_steps 20 (the "
          "recipe's 100), the OTF curriculum's first epoch", flush=True)
    ckpt = os.path.join(tmp, "midi_ckpt", "vqgan_1.npz")
    data = os.path.join(tmp, "midi_images_encoded_vqgan_inpainting")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = True
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _zero(kernels)
    events, step_hook = _hooked()
    t0 = time.time()
    res = tf.main(["--config-name", "midi_vqgan.yaml", f"data={data}", f"codec.checkpoint={ckpt}",
                   "flow.epochs=1", "flow.n_steps=20", "flow.ckpt_every=1", *MIDI_OTF,
                   "+seed=0", f"+ckpt_dir={os.path.join(tmp, 'midi_flow_ckpt')}",
                   f"+output_dir={os.path.join(tmp, 'midi_flow_out')}"], step_hook=step_hook)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = _counts(kernels)
    peak = torch.cuda.max_memory_allocated() / 2**30
    _expect(kernels, "midi inpainting flow", launches,
            na2d_fwd=MIDI_CODEC_NATTEN[0] + 3 * len(res["eval"]) * MIDI_CODEC_NATTEN[1])
    if len(events) != 2 or len(res["eval"]) != 1:
        fail(f"midi flow ran {len(events)} steps and {len(res['eval'])} evaluations")
    losses = [v for e in res["epochs"] for k, v in e.items() if k != "epoch"]
    metrics = [v for e in res["eval"] for v in [e["val_loss"], *e["metrics"].values()]
               if not isinstance(v, str)]
    if not (np.isfinite(losses).all() and np.isfinite(metrics).all()
            and all("loss_mask" in e for e in res["epochs"])):
        fail(f"midi flow losses or metrics: {res['epochs']} {res['eval']}")
    grids = os.listdir(os.path.join(tmp, "midi_flow_out"))
    if not all(any(f.startswith(g) for f in grids)
               for g in ("mask_latents", "mask_pixels", "decoded_source")):
        fail("the inpainting evaluation wrote no mask or source grids")

    _zero(kernels)
    served = gs.main(["--config-name", "midi_vqgan.yaml",
                      f"+flow_checkpoint={res['ema_checkpoint']}", "+n_samples=64",
                      "+n_steps=20", "+seed=0",
                      f"+output_dir={os.path.join(tmp, 'midi_gen')}"])
    serve_launches = _counts(kernels)
    _expect(kernels, "midi serving", serve_launches, na2d_fwd=MIDI_CODEC_NATTEN[1])
    notes = [sum(len(i.notes) for i in read_midi(p).instruments) for p in served["midi_files"]]
    if served["images"].shape != (64, 128, 128, 3) or len(notes) != 64:
        fail(f"midi serving: images {served['images'].shape}, {len(notes)} .mid files")
    export = export_corpus_rolls(tmp)

    state = res["state"]
    batch = {k: v.cuda() for k, v in _inpaint_batch(os.path.join(data, "train"), 256).items()}
    codec = load_codec(load_config("midi_vqgan.yaml", CONFIG_DIR, [f"codec.checkpoint={ckpt}"]),
                       torch.device("cuda"))
    with torch.no_grad():              # train_flow's blank_latents
        blank = codec.encode(torch.zeros(1, 128, 128, 3, device="cuda")).cpu()
    step = make_flow_train_step(blank_latents=blank.cuda(), otf_aug={
        "curriculum_epochs": 1, "extend_epochs": 2, "p_ones": 0.3, "p_zeros": 0.05,
        "steps_per_epoch": 4})
    gen = torch.Generator("cuda").manual_seed(13)
    step(state, batch, gen)
    prof = profile_batch(lambda: step(state, batch, gen))
    top = prof.pop("top_kernels")
    small = {k: v[:64].cpu() for k, v in batch.items()}
    step_check = hold_inpaint_flow_step(state, small, blank)
    intervals = _steady(events)
    rec = dict(batch=FLOW_BATCH, wall_s=wall, peak_mem_gib=peak, card=card, step_s=intervals,
               steady_samples_per_s=FLOW_BATCH / float(np.median(intervals)),
               epoch_samples_per_s=[e["samples"] / e["seconds"] for e in res["epoch_seconds"]],
               epochs=res["epochs"], evals=res["eval"], step_profile=prof,
               serve_batch_s=served["batch_seconds"], serve_nfe=served["nfe"],
               midi_files=len(notes), notes_per_file=notes, corpus_export=export,
               card_vs_cpu=step_check)
    print(f"flow train midi_vqgan inpainting B={FLOW_BATCH} 16x16x4: "
          f"{rec['steady_samples_per_s']:.2f} samples/s over steady steps (median of "
          f"{len(intervals)}), per epoch {[round(x, 2) for x in rec['epoch_samples_per_s']]}, "
          f"peak {peak:.2f} GiB, wall {wall:.1f} s | card: {card}", flush=True)
    for e in res["eval"]:
        print(f"  inpainting eval epoch {e['epoch']}: s " + " ".join(
            f"{k}={v:.4f}" for k, v in e["seconds"].items()) +
            f" total={sum(e['seconds'].values()):.4f}; val_loss {e['val_loss']:.4f}, FID_px "
            f"{e['metrics']['FID_px']:.3f} | card: {card}", flush=True)
    print(f"  one train step under the profiler: {prof['profiled_batch_s']:.4f} s wall, "
          f"{prof['device_busy_s']:.4f} s busy, idle share {prof['device_idle_share']:.4f} "
          f"| card: {card}", flush=True)
    print("  device time by kernel (ms): " + "; ".join(
        f"{name[:60]}={ms:.3f}" for name, ms in top), flush=True)
    print(f"  served the EMA with .mid export: 64 samples, nfe={served['nfe']}, s/batch "
          f"{[round(x, 4) for x in served['batch_seconds']]}, 64 .mid files parsed back "
          f"({sum(notes)} notes: the rolls of a flow trained 8 steps) | card: {card}",
          flush=True)
    print(f"  .mid export of 64 corpus rolls through generate_samples.save_sample_batch: "
          f"{export['seconds']:.4f} s, {export['notes']} notes read back, equal to img2midi's "
          f"| card: {card}", flush=True)
    del res, state, batch, codec
    torch.cuda.empty_cache()
    return rec, {"midi_flow": launches, "midi_serve": serve_launches}


def midi_inpainting_codec(tmp: str, card: str, kernels: dict, k1k2: tuple) -> tuple:
    """midi_inpainting's codec at its widths (1 channel, hidden 256, 4
    downsamples, internal 128, 2×32 codes of 4; seeded random weights,
    609.9 M parameters), whose two widest encoder NATTEN blocks run at
    8×8×2048 with 8 heads of 256: create_inpainting_triplet on 32 grayscale
    piano rolls, its first two held to the CPU's (TF32 off, the latents
    unquantized, 1e-4·max(1, |ref|)); one reconstruction-only training step
    at B=64 through the port's codec step (the recipe's warmup_epochs 999999
    trains no GAN), timed with its peak memory (weights, gradients and Adam's
    two moments of 609.9 M fp32 parameters are ~9.8 GB); K1 and K2 at
    MIDI_INP_SHAPES held to their twins and timed beside the bound and
    SDPA + mask."""
    from PIL import Image

    from flocoder_torch.config import load_config
    from flocoder_torch.data.transforms import midi_transforms
    from flocoder_torch.generate_samples import CONFIG_DIR
    from flocoder_torch.inpainting import create_inpainting_triplet
    from flocoder_torch.models.codecs import NATTENBlock, setup_codec
    from flocoder_torch.training.vqgan import create_vqgan_state, make_vqgan_warmup_step

    na2d_fwd, na2d_bwd, na2d_banded, na2d_bwd_banded = k1k2
    errs = check_hdit_kernels(na2d_fwd, na2d_bwd, na2d_banded, na2d_bwd_banded,
                              shapes=MIDI_INP_SHAPES, label="midi_inpainting")
    rows = time_hdit_kernels(na2d_fwd, na2d_bwd, card, shapes=MIDI_INP_SHAPES,
                             path="midi_inpainting", label="midi_inpainting")

    cfg = load_config("midi_inpainting.yaml", CONFIG_DIR, ["+seed=0"])
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    codec = setup_codec(cfg, device="cuda")
    codec.init(torch.Generator("cuda").manual_seed(0))
    n_params = sum(p.numel() for p in [*codec.encoder.parameters(),
                                       *codec.decoder.parameters()])
    n_enc = sum(isinstance(m, NATTENBlock) for m in codec.encoder.modules())
    n_dec = sum(isinstance(m, NATTENBlock) for m in codec.decoder.modules())
    files = sorted(os.path.join(r, f) for r, _, fs in os.walk(os.path.join(tmp, "midi_images"))
                   for f in fs if f.endswith(".png"))[:64]
    tf_gray = midi_transforms(128, grayscale=True)
    rng = np.random.default_rng(9)
    x = torch.from_numpy(np.stack([tf_gray(Image.open(f).convert("RGB"), rng)
                                   for f in files])).cuda()
    if tuple(x.shape) != (64, 128, 128, 1):
        fail(f"grayscale piano rolls of shape {tuple(x.shape)}")

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    codec.eval()
    _zero(kernels)
    t0 = time.time()
    target, masks, source = create_inpainting_triplet(x[:32], codec, seed=7)
    torch.cuda.synchronize()
    triplet_s = time.time() - t0
    triplet_launches = _counts(kernels)
    _expect(kernels, "midi_inpainting triplet", triplet_launches, na2d_fwd=2 * n_enc)
    cpu_codec = copy.deepcopy(codec).cpu()
    t_cpu, m_cpu, s_cpu = create_inpainting_triplet(x[:2].cpu(), cpu_codec, seed=7)
    del cpu_codec
    if not np.array_equal(masks[:2], m_cpu):
        fail("the triplet's masks differ between the card's batch and the CPU's")
    worst = max((a[:2].float().cpu() - r).abs().max().item() / (1e-4 * max(1.0, r.abs().max().item()))
                for a, r in ((target, t_cpu), (source, s_cpu)))
    print(f"midi_inpainting triplet: 32 grayscale rolls → latents {tuple(target.shape)} in "
          f"{triplet_s:.3f} s (first call), card vs CPU (2 images, TF32 off) max |Δ| / "
          f"(1e-4·max(1, |ref|)) = {worst:.4f} | card: {card}", flush=True)
    if not (np.isfinite(worst) and worst < 1.0):
        fail(f"midi_inpainting triplet: card and CPU disagree ({worst})")
    del target, source

    torch.backends.cudnn.allow_tf32 = True      # PyTorch's default for convs
    codec.train()
    state = create_vqgan_state(codec, None, float(cfg.codec.get("learning_rate", 1e-4)))
    step = make_vqgan_warmup_step(cfg, None)
    gen = torch.Generator("cuda").manual_seed(1)
    _zero(kernels)
    secs = []
    for _ in range(2):
        t0 = time.time()
        state, aux, _ = step(state, x, gen)
        torch.cuda.synchronize()
        secs.append(time.time() - t0)
    train_launches = _counts(kernels)
    _expect(kernels, "midi_inpainting codec step", train_launches,
            na2d_fwd=2 * (n_enc + n_dec), na2d_bwd=2 * (n_enc + n_dec))
    peak = torch.cuda.max_memory_allocated() / 2**30
    losses = {k: float(v) for k, v in aux.items()}
    if not np.isfinite(list(losses.values())).all():
        fail(f"midi_inpainting codec step: losses {losses}")
    rec = dict(params=n_params, natten_blocks=[n_enc, n_dec], triplet_first_call_s=triplet_s,
               triplet_card_vs_cpu=worst, step_s=secs, samples_per_s=64 / secs[-1],
               peak_mem_gib=peak, losses=losses, card=card,
               k1k2_max_abs_err={f"{n}_{str(d)[6:]}": e for (n, d), e in errs.items()})
    print(f"midi_inpainting codec ({n_params / 1e6:.1f} M parameters, NATTEN blocks "
          f"{n_enc} + {n_dec}): reconstruction step B=64 128² gray, {secs[-1]:.4f} s "
          f"(first {secs[0]:.4f} s), {rec['samples_per_s']:.2f} samples/s, peak "
          f"{peak:.2f} GiB, losses " + " ".join(f"{k}={v:.4f}" for k, v in losses.items())
          + f" | card: {card}", flush=True)
    del state, codec, x, aux
    torch.cuda.empty_cache()
    return rec, rows, errs, {"midi_inp_triplet": triplet_launches,
                             "midi_inp_codec_step": train_launches}


# ---------------------------------------------------------------------------
# The host pipeline: device augmentation on the card, the native image
# decoder and packed latent shards (pe_host, flow_shard), and tpu_demo as
# composed
# ---------------------------------------------------------------------------

PE_HOST = ["preencoding.quantize=true", "preencoding.fused_vq=true",
           "preencoding.device_augs=true", "preencoding.format=shard",
           "preencoding.augs_per=4"]


def hold_device_augment(x_src: torch.Tensor, image_size: int) -> dict:
    """The device augment (flocoder_torch.data.device_augs) on the card
    against its CPU twin on the same host batch and the same draws (drawn
    on the card): max |Δ| < 1e-5. Times the augment of the batch by CUDA
    events."""
    from flocoder_torch.data.device_augs import draw_params, make_device_augment, warp

    params = draw_params(x_src.shape[0], torch.Generator("cuda").manual_seed(7919))
    out = warp(x_src, params, image_size)
    ref = warp(x_src.cpu(), type(params)(*(t.cpu() for t in params)), image_size)
    err = (out.cpu() - ref).abs().max().item()
    print(f"device augment {tuple(x_src.shape)} -> {tuple(out.shape)}, card vs CPU twin "
          f"on the same draws: max_abs_err={err:.3e} (tol 1e-5)", flush=True)
    if not (np.isfinite(err) and err < 1e-5):
        fail("the device augment disagrees with its CPU twin")
    augment = make_device_augment(image_size)
    gen = torch.Generator("cuda").manual_seed(1)
    ms = cuda_ms(lambda: augment(x_src, gen), 20)
    return {"max_abs_err": err, "augment_ms_per_batch": ms, "batch": x_src.shape[0]}


def hold_shard_gather(path: str, batch: int = 256) -> dict:
    """Every record of the shard at ``path`` by the native gather
    (csrc/fcloader.cpp) and by its numpy memmap twin, bitwise; then the host
    ms of one shuffled gather of ``batch`` records each way (best of 20)."""
    from flocoder_torch.data.shard import ShardReader

    native, plain = ShardReader(path), ShardReader(path, use_native=False)
    idx = np.arange(native.n)
    a, la = native.gather(idx)
    b, lb = plain.gather(idx)
    if not (native.is_native and la.tobytes() == lb.tobytes()
            and all(a[k].tobytes() == b[k].tobytes() for k in b)):
        fail(f"the native gather of {path} differs from the memmap twin")
    order = np.random.default_rng(0).permutation(native.n)[:batch]
    times = {}
    for name, reader in (("native", native), ("memmap", plain)):
        best = float("inf")
        for _ in range(20):
            t0 = time.perf_counter()
            reader.gather(order)
            best = min(best, time.perf_counter() - t0)
        times[f"{name}_gather_ms"] = best * 1e3
    native.close()
    return {"records": int(idx.size), "record_bytes": native.record_bytes,
            "gather_batch": len(order), **times}


def pe_host(tmp: str, paths: dict, card: str, kernels: dict) -> tuple:
    """flowers_vqgan at full width pre-encoded through
    flocoder_torch.preencode_data.main with the host pipeline: fused_vq,
    device_augs (the host decodes each 500² PNG once to 160², natively where
    the C++ decoder builds, and the card augments to 128²) and
    format=shard, batch 32, augs_per 4, over the 320 PNGs of the files-format
    phase (a link to the same folder, so that the outputs do not collide):
    4 val and 36 train batches. The launch counts are zeroed before and read
    after: 5 K1 and 1 K3 a batch, nothing else. Holds the augment on the card
    to its CPU twin for the same draws, the native gather to the memmap twin
    on both shards, and reads the latents back."""
    from flocoder_torch import preencode_data as pe
    from flocoder_torch.data.device_augs import make_device_augment
    from flocoder_torch.data.shard import ShardReader

    data = os.path.join(tmp, "pe_host_images")
    os.symlink(os.path.join(tmp, "pe_images"), data)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = True      # PyTorch's default for convs
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _zero(kernels)
    argv = ["--config-name", "flowers_vqgan.yaml", f"data={data}",
            f"codec.checkpoint={paths['codec']}", *PE_HOST, "+seed=0"]
    t0 = time.time()
    res = pe.main(argv)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = _counts(kernels)
    peak = torch.cuda.max_memory_allocated() / 2**30
    splits = {s: res[s] for s in ("val", "train")}
    batches = sum(r["batches"] for r in splits.values())
    _expect(kernels, f"pe_host ({batches} batches)", launches, na2d_fwd=5 * batches,
            fused_compress_tail_vq=batches)
    if [r["batches"] for r in splits.values()] != [4, 36]:
        fail(f"pe_host ran {[r['batches'] for r in splits.values()]} batches")
    gathers = {}
    for split, r in splits.items():
        path = os.path.join(r["out_dir"], "data.fcshard")
        if r["format"] != "shard" or os.listdir(r["out_dir"]) != ["data.fcshard"]:
            fail(f"pe_host {split} wrote {os.listdir(r['out_dir'])}")
        reader = ShardReader(path)
        fields, _ = reader.gather(np.arange(reader.n))
        lat = fields["target"]
        if reader.n != r["latents"] or r["latents"] != 32 * r["batches"] or \
                lat.shape[1:] != (16, 16, 4) or not np.isfinite(lat).all():
            fail(f"pe_host {split}: {reader.n} records of {r['latents']}, {lat.shape}")
        gathers[split] = hold_shard_gather(path)
    decoder = splits["train"]["decoder"]
    batches_host = rebuilt_batches(argv, "val")
    x_src = torch.from_numpy(next(batches_host)["pixels"]).cuda()
    batches_host.close()
    aug = hold_device_augment(x_src, 128)
    codec = res["codec"]
    with torch.inference_mode():
        aug_x = make_device_augment(128)(x_src, torch.Generator("cuda").manual_seed(0))
        encode_ms = cuda_ms(lambda: codec.encode_quantize_fused(aug_x), 10)
    rec = dict(batch=32, batches=batches, wall_s=wall, peak_mem_gib=peak, card=card,
               decoder=decoder, encode_fused_ms=encode_ms, augment=aug, gather=gathers,
               **{f"{s}_latents_per_s": r["latents_per_s"] for s, r in splits.items()},
               **{f"{s}_seconds": r["seconds"] for s, r in splits.items()})
    print(f"pe_host flowers_vqgan B=32 (fused_vq, device_augs, shard; decoder {decoder}): "
          f"val {splits['val']['latents_per_s']:.2f} latents/s "
          f"({splits['val']['seconds']:.3f} s), train {splits['train']['latents_per_s']:.2f}"
          f" latents/s ({splits['train']['seconds']:.3f} s), wall {wall:.1f} s, peak "
          f"{peak:.2f} GiB; encode per batch {encode_ms:.4f} ms, augment per batch "
          f"{aug['augment_ms_per_batch']:.4f} ms (CUDA events); gather of 256 records "
          f"native {gathers['train']['native_gather_ms']:.4f} ms, memmap "
          f"{gathers['train']['memmap_gather_ms']:.4f} ms (host clock) | card: {card}",
          flush=True)
    del codec, res, aug_x, x_src
    torch.cuda.empty_cache()
    return rec, launches


def flow_shard(tmp: str, paths: dict, card: str, kernels: dict) -> tuple:
    """flowers_vqgan's flow through flocoder_torch.train_flow.main on
    pe_host's shards (1,152 train, 128 val records, read by the native
    gather): U-Net dim 16, 102 classes, B=256, 2 epochs of 4 steps (the
    recipe's 10,000) with flow.no_eval=true; then its one RK4 + CFG
    evaluation, at n_steps 20 (the recipe's 100), by
    flocoder_torch.evaluate_model on the val shard with the EMA checkpoint.
    The launch counts are zeroed before and read after each: no kernel in
    training, K1 in the evaluation's two decodes (chunks of
    evaluation.DECODE_CHUNK)."""
    from flocoder_torch import evaluate_model as tev
    from flocoder_torch import train_flow as tf
    from flocoder_torch.evaluation import DECODE_CHUNK

    print("flow_shard cuts: 2 epochs (the recipe's 10,000), one evaluation (by "
          "evaluate_model) at n_steps 20 (the recipe's 100)", flush=True)
    data = os.path.join(tmp, "pe_host_images")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = True
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _zero(kernels)
    ckpt_dir = os.path.join(tmp, "flow_shard_ckpt")
    argv = ["--config-name", "flowers_vqgan.yaml", f"data={data}",
            f"codec.checkpoint={paths['codec']}", "flow.unet.n_classes=102",
            "flow.epochs=2", "flow.no_eval=true", "flow.ckpt_every=2", "+seed=0",
            f"+ckpt_dir={ckpt_dir}", f"+output_dir={os.path.join(tmp, 'flow_shard_out')}"]
    events, step_hook = _hooked()
    t0 = time.time()
    res = tf.main(argv, step_hook=step_hook)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = _counts(kernels)
    peak = torch.cuda.max_memory_allocated() / 2**30
    chunks = flow_decode_chunks(DECODE_CHUNK)
    _expect(kernels, "flow_shard training", launches)
    if res["eval"] or len(events) != 8 or \
            [e["samples"] for e in res["epoch_seconds"]] != [4 * FLOW_BATCH] * 2:
        fail(f"flow_shard ran {len(events)} steps, {len(res['eval'])} evaluations")
    losses = [v for e in res["epochs"] for k, v in e.items() if k != "epoch"]
    if not np.isfinite(losses).all():
        fail(f"flow_shard losses not finite: {res['epochs']}")

    _zero(kernels)
    metrics = tev.main(["--config-name", "flowers_vqgan.yaml", f"data={data}",
                        f"codec.checkpoint={paths['codec']}",
                        f"+flow_checkpoint={res['ema_checkpoint']}", "+n_steps=20",
                        "+seed=0", f"+output_dir={os.path.join(tmp, 'flow_shard_eval')}"])
    ev_launches = _counts(kernels)
    _expect(kernels, f"evaluate_model on the val shard (2 decodes x chunks {chunks})",
            ev_launches, na2d_fwd=2 * len(chunks))
    if not all(np.isfinite(v) for v in metrics.values() if isinstance(v, float)):
        fail(f"evaluate_model on the val shard: {metrics}")
    if os.path.exists("weights") or metrics["FID_feature_backend"] != "rp2048":
        fail(f"evaluate_model scored FID on {metrics['FID_feature_backend']}, not the "
             "default rp2048 (the flow phase's Inception weights file was left behind)")
    launches["na2d_fwd"] += ev_launches["na2d_fwd"]
    steps = _steady(events)
    rec = dict(batch=FLOW_BATCH, wall_s=wall, peak_mem_gib=peak, card=card, step_s=steps,
               steady_samples_per_s=FLOW_BATCH / float(np.median(steps)),
               epoch_samples_per_s=[e["samples"] / e["seconds"] for e in res["epoch_seconds"]],
               epochs=res["epochs"], evaluate_model=metrics,
               k1_launches_evaluate_model=ev_launches["na2d_fwd"])
    print(f"flow_shard flowers_vqgan B={FLOW_BATCH} on the shard: "
          f"{rec['steady_samples_per_s']:.2f} samples/s over steady steps (median of "
          f"{len(steps)}), per epoch {[round(x, 2) for x in rec['epoch_samples_per_s']]}, "
          f"peak {peak:.2f} GiB, wall {wall:.1f} s; evaluate_model FID_px "
          f"{metrics['FID_px']:.3f} | card: {card}", flush=True)
    del res
    torch.cuda.empty_cache()
    return rec, launches


def tpu_demo(tmp: str, card: str, kernels: dict) -> tuple:
    """configs/tpu_demo.yaml as composed: the resize codec, the synthetic
    set at 128² (256 images), device_augs and format=shard in pre-encoding
    (B=64, augs_per 6 of the recipe's 48: 6 val batches of 25, 21 train
    batches of 64), then
    the U-Net (dim 16, dim_mults 1,2,4,8, 4 classes) in bf16 at B=256 with
    lr 1e-3 and an RK4 + CFG 2.0 evaluation each epoch; its EMA served as
    trained, in bf16 (the checkpoint's flow.bf16, no flag). Cut: 1 epoch
    (the recipe's 40) and evaluation
    n_steps 20 (its 50); flow.ckpt_every=1 (its 20) so that the cut run
    writes the checkpoint it serves. No kernel of the port runs: the resize
    codec has no NATTEN."""
    from flocoder_torch import generate_samples as gs
    from flocoder_torch import preencode_data as pe
    from flocoder_torch import train_flow as tf

    print("tpu_demo cuts: pre-encode augs_per 6 (the recipe's 48), 1 epoch (its 40), "
          "evaluation n_steps 20 (its 50); flow.ckpt_every=1 (its 20) to write the served "
          "checkpoint", flush=True)
    data = os.path.join(tmp, "fc_tpu_demo")          # absent: the synthetic set
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = True
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _zero(kernels)
    t0 = time.time()
    enc = pe.main(["--config-name", "tpu_demo.yaml", f"data={data}", "preencoding.augs_per=6"])
    pe_wall = time.time() - t0
    pe_peak = torch.cuda.max_memory_allocated() / 2**30
    if [enc[s]["batches"] for s in ("val", "train")] != [6, 21] or any(
            enc[s]["format"] != "shard" for s in ("val", "train")):
        fail(f"tpu_demo pre-encode: {[(enc[s]['batches'], enc[s]['format']) for s in ('val', 'train')]}")

    torch.cuda.reset_peak_memory_stats()
    argv = ["--config-name", "tpu_demo.yaml", f"data={data}", "flow.epochs=1",
            "flow.n_steps=20", "flow.ckpt_every=1", f"+ckpt_dir={os.path.join(tmp, 'demo_ckpt')}",
            f"+output_dir={os.path.join(tmp, 'demo_out')}"]
    events, step_hook = _hooked()
    t0 = time.time()
    res = tf.main(argv, step_hook=step_hook)
    torch.cuda.synchronize()
    wall = time.time() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    model = res["state"].model
    n_train = enc["train"]["latents"]
    if model.dtype != torch.bfloat16 or any(p.dtype != torch.float32
                                            for p in model.parameters()):
        fail("tpu_demo's U-Net did not train in bf16 over fp32 parameters")
    if [e["steps"] for e in res["epoch_seconds"]] != [n_train // FLOW_BATCH] or \
            len(res["eval"]) != 1:
        fail(f"tpu_demo ran {res['epoch_seconds']}, {len(res['eval'])} evaluations")
    losses = [v for e in res["epochs"] for k, v in e.items() if k != "epoch"]
    metrics = [v for e in res["eval"] for v in [e["val_loss"], *e["metrics"].values()]
               if not isinstance(v, str)]
    if not (np.isfinite(losses).all() and np.isfinite(metrics).all()):
        fail(f"tpu_demo losses or metrics not finite: {res['epochs']}")
    served = gs.main(["--config-name", "tpu_demo.yaml",
                      f"+flow_checkpoint={res['ema_checkpoint']}", "+n_samples=64",
                      "+n_steps=20", "+seed=0",
                      f"+output_dir={os.path.join(tmp, 'demo_gen')}"])
    if served["images"].shape != (64, 128, 128, 3) or not np.isfinite(served["images"]).all():
        fail(f"tpu_demo serving: {served['images'].shape}")
    if not served["bf16"]:
        fail("tpu_demo's flow.bf16 checkpoint did not serve in bf16")
    launches = _counts(kernels)
    _expect(kernels, "tpu_demo (resize codec)", launches)
    steps = _steady(events)
    rec = dict(batch=FLOW_BATCH, card=card, pe_wall_s=pe_wall, pe_peak_mem_gib=pe_peak,
               decoder=enc["train"]["decoder"],
               **{f"pe_{s}_latents_per_s": enc[s]["latents_per_s"] for s in ("val", "train")},
               wall_s=wall, peak_mem_gib=peak, step_s=steps,
               steady_samples_per_s=FLOW_BATCH / float(np.median(steps)),
               epoch_samples_per_s=[e["samples"] / e["seconds"] for e in res["epoch_seconds"]],
               epochs=res["epochs"], evals=res["eval"], serve_batch_s=served["batch_seconds"])
    print(f"tpu_demo pre-encode (synthetic 128², device_augs, shard, decoder "
          f"{rec['decoder']}): val {rec['pe_val_latents_per_s']:.2f}, train "
          f"{rec['pe_train_latents_per_s']:.2f} latents/s, peak {pe_peak:.2f} GiB; U-Net bf16 "
          f"B={FLOW_BATCH}: {rec['steady_samples_per_s']:.2f} samples/s over steady steps "
          f"(median of {len(steps)}), per epoch "
          f"{[round(x, 2) for x in rec['epoch_samples_per_s']]}, peak {peak:.2f} GiB; served "
          f"64 as trained (bf16), s/batch {[round(x, 4) for x in served['batch_seconds']]} | card: "
          f"{card}", flush=True)
    del res, model
    torch.cuda.empty_cache()
    return rec, launches


# ---------------------------------------------------------------------------
# The bf16 and int8 slice: tpu_vqgan as composed, serving as trained, the
# int8 decode, K3 on bf16 activations
# ---------------------------------------------------------------------------

TPU_VQGAN_PE = ["preencoding.quantize=true", "preencoding.fused_vq=true",
                "preencoding.augs_per=1", "preencoding.batch_size=32"]
# B, C, H, W of the SD decoder's 3×3 convolutions at the serving batch; the
# last is also the VQGAN decoder's 32²×512
SD_DECODER_CONVS = [(64, 128, 128, 128), (64, 256, 64, 64), (64, 512, 32, 32)]


def check_bf16_slice_kernels(card: str) -> dict:
    """K3's bf16 case against its plain twin on the same bf16 h, TF32 off, at
    the pre-encode shape (B=32, 16²×128 → D=4, 4×96 codes) in both layouts
    of h and every cluster size, and at a ragged 5×7 map: the picks equal
    and z_q equal (bf16); and against K3's fp32 case on h widened, bit for
    bit. Then the W8A8 convolution on the card (im2col + torch._int_mm)
    against its float64 twin on the CPU at an SD-decoder shape (128²×128 →
    128, k 3, B=2) and a VQGAN decoder shape (32²×512 → 512, k 3, B=2): the
    int8 codes equal, the output within 1e-6 of the largest |ref|."""
    from flocoder_torch.ops import fused_vq as fvq
    from flocoder_torch.ops import quant
    from flocoder_torch.ops.kernels import fused_vq as fvk
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    g = torch.Generator("cuda").manual_seed(31)
    out = {}
    for B, H, W, Din, nchw, cs in ((32, 16, 16, 128, True, None), (32, 16, 16, 128, False, None),
                                   *((32, 16, 16, 128, True, c) for c in fvk.CLUSTER_SIZES),
                                   (3, 5, 7, 16, True, None), (3, 5, 7, 16, False, None)):
        h, tail, cb = fvq.random_tail_inputs(g, B, H, W, Din, 4, 4, 96, 2, nchw)
        hb = h.to(torch.bfloat16)
        zq, idx = fvk.fused_compress_tail_vq_bf16(hb, *tail, cb, 2, cluster=cs)
        torch.cuda.synchronize()
        zq_t, idx_t = fvq.fused_compress_tail_vq_plain(hb, *tail, cb, 2)
        zq32, idx32 = fvk.fused_compress_tail_vq(hb.float(), *tail, cb, 2, cluster=cs)
        differ = int((idx != idx_t).any(-1).sum())
        err = (zq.float() - zq_t.float()).abs().max().item()
        ok = (differ == 0 and err == 0.0 and zq.dtype == torch.bfloat16
              and torch.equal(idx, idx32) and torch.equal(zq, zq32.to(torch.bfloat16)))
        print(f"K3 bf16 check B={B} {H}x{W}x{Din} {'NCHW' if nchw else 'NHWC'} cluster {cs}: "
              f"{differ} of {B * H * W} tokens pick other codes than the twin, z_q "
              f"max_abs_err={err:.3e} (equal asked); equal to K3 fp32 on h widened "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            fail("K3's bf16 case disagrees with its twin or with K3 on h widened")
    out["fused_compress_tail_vq_bf16"] = {"max_abs_err": 0.0}
    worst = 0.0
    for B, C, S, Co in ((2, 128, 128, 128), (2, 512, 32, 512)):
        x = torch.randn(B, C, S, S, device="cuda", generator=g).to(torch.bfloat16)
        w = torch.randn(Co, C, 3, 3, device="cuda", generator=g) / (9 * C) ** 0.5
        b = torch.randn(Co, device="cuda", generator=g) * 0.1
        y = quant.int8_conv(x, w, b, 1, 1, torch.bfloat16)
        torch.cuda.synchronize()
        codes = (torch.equal(quant.quantize_activations(x)[0].cpu(),
                             quant.quantize_activations(x.cpu())[0])
                 and torch.equal(quant.quantize_weight(w)[0].cpu(),
                                 quant.quantize_weight(w.cpu())[0]))
        ref = quant.int8_conv(x.cpu(), w.cpu(), b.cpu(), 1, 1, torch.bfloat16).float()
        err = (y.cpu().float() - ref).abs().max().item()
        tol = 1e-6 * ref.abs().max().item()
        print(f"int8_conv check {B}x{C}x{S}x{S} -> {Co}, k 3: codes equal {codes}; "
              f"max_abs_err={err:.3e} (tol {tol:.3e}) {'ok' if codes and err <= tol else 'FAIL'}",
              flush=True)
        if not (codes and err <= tol):
            fail("the int8 convolution on the card disagrees with its float64 twin")
        worst = max(worst, err)
    out["int8_conv"] = {"max_abs_err": worst}
    torch.cuda.empty_cache()
    return out


def time_bf16_slice(card: str) -> dict:
    """K3's bf16 case at the pre-encode shape (device ms by the profiler,
    CUDA events) beside K3's fp32 case on the same h widened, in turns
    (fp32, bf16, bf16, fp32), the twin on the card, the unfused torch path
    on h widened (the yardstick: no single PyTorch call computes K3) and
    its bound (h read as bf16, z_q written as bf16). Then the W8A8
    convolution (im2col + torch._int_mm) beside cuDNN's bf16 and fp32
    convolutions at the SD decoder's 3×3 shapes at B=64 (32²×512 is the
    VQGAN decoder's too)."""
    import torch.nn.functional as F
    from flocoder_torch.ops import fused_vq as fvq
    from flocoder_torch.ops import quant
    from flocoder_torch.ops.kernels import fused_vq as fvk
    from flocoder_torch.ops.rvq import RVQState, rvq_apply
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    g = torch.Generator("cuda").manual_seed(32)
    B, H, W, Din, D, L, K, groups = 32, 16, 16, 128, 4, 4, 96, 2
    n = B * H * W
    h, tail, cb = fvq.random_tail_inputs(g, B, H, W, Din, D, L, K, groups)
    hb = h.to(torch.bfloat16)
    hw = hb.float()
    w1, b1, gs, gb, cw, cbias = tail
    st = RVQState(L, K, D).cuda()
    st.codebooks.copy_(cb)

    def unfused():
        y = F.silu(F.group_norm(F.conv2d(hw.permute(0, 3, 1, 2), w1, b1), groups, gs, gb, 1e-5))
        y = F.conv2d(y, cw, cbias, padding=1).permute(0, 2, 3, 1).reshape(-1, D)
        return rvq_apply(st, y)[:2]

    bf16 = lambda: fvk.fused_compress_tail_vq_bf16(hb, *tail, cb, groups)  # noqa: E731
    fp32 = lambda: fvk.fused_compress_tail_vq(hw, *tail, cb, groups)  # noqa: E731
    with torch.inference_mode():
        ms = cuda_ms(bf16, 200, warmup=5)
        turns = [(who, device_ms(fn, key, iters=20)) for who, fn, key in (
            ("fp32", fp32, "tail_kernel<4, true"), ("bf16", bf16, "tail_kernel<4, true"),
            ("bf16", bf16, "tail_kernel<4, true"), ("fp32", fp32, "tail_kernel<4, true"))]
        plain_ms = cuda_ms(lambda: fvq.fused_compress_tail_vq_plain(hb, *tail, cb, groups), 50)
        library_ms = cuda_ms(unfused, 50)
    dev = float(np.mean([t for who, t in turns if who == "bf16"]))
    n_bytes = 2 * n * Din + 4 * (D * Din + 4 * D + 9 * D * D + L * K * D) + 2 * n * D + 4 * n * L
    n_ops = n * (2 * Din * D + 18 * D * D + 10 * D) + n * L * (K * (2 * D + 3) + 2 * D)
    bound_ms, bound_by = fused_vq_bound_ms(n_bytes, n_ops)
    rec = {"fused_compress_tail_vq_bf16": dict(
        ms=ms, device_ms=dev, plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms,
        bound_by=bound_by, fp32_turns_device_ms=turns)}
    print(f"K3 bf16 h time: kernel_ms={ms:.5f} device_ms={dev:.5f} plain_ms={plain_ms:.5f} "
          f"library_ms={library_ms:.5f} (unfused torch path on h widened) bound_ms="
          f"{bound_ms:.5f} ({bound_by}; {n_bytes / 1e6:.3f} MB); device ms in turns "
          f"(K3 fp32 on h widened, bf16, bf16, fp32): "
          + ", ".join(f"{who} {t:.5f}" for who, t in turns) + f" | card: {card}", flush=True)

    convs = []
    for B, C, S, _ in SD_DECODER_CONVS:
        x = torch.randn(B, C, S, S, device="cuda", generator=g).to(torch.bfloat16)
        w = torch.randn(C, C, 3, 3, device="cuda", generator=g) / (9 * C) ** 0.5
        b = torch.zeros(C, device="cuda")
        wb, bb, x32 = w.to(torch.bfloat16), b.to(torch.bfloat16), x.float()
        with torch.inference_mode():
            t_int8 = cuda_ms(lambda: quant.int8_conv(x, w, b, 1, 1, torch.bfloat16), 10, 2)
            t_bf16 = cuda_ms(lambda: F.conv2d(x, wb, bb, padding=1), 10, 2)
            t_fp32 = cuda_ms(lambda: F.conv2d(x32, w, b, padding=1), 10, 2)
        row = dict(shape=[B, C, S, S], k=3, int8_ms=t_int8, cudnn_bf16_ms=t_bf16,
                   cudnn_fp32_ms=t_fp32, int8_bound_ms=max(
                       2 * B * S * S * C * C * 9 / 1.979e15, (2 * 2 * B * C * S * S) / HBM_BYTES_PER_S) * 1e3)
        convs.append(row)
        print(f"conv 3x3 {B}x{C}x{S}x{S} -> {C}: int8 (im2col + _int_mm, quantize and "
              f"dequantize included) {t_int8:.4f} ms, cuDNN bf16 {t_bf16:.4f} ms, cuDNN fp32 "
              f"(TF32 off) {t_fp32:.4f} ms | card: {card}", flush=True)
        del x, x32
        torch.cuda.empty_cache()
    rec["int8_conv"] = convs
    return rec


def hold_k1_in_decode(codec, z, kernels: dict) -> float:
    """K1 on the q, k, v that the decoder's NATTEN block computes while
    ``codec`` (bf16) decodes ``z``: K1 against na2d_banded in fp32 on the
    same bf16 values, max |Δ| < 2e-2 (the bf16 gate of check_k1). Returns
    the error."""
    import torch.nn.functional as F
    from flocoder_torch.models.codecs import NATTENBlock
    from flocoder_torch.ops.neighborhood_attention import na2d_banded
    blocks = [m for m in codec.decoder.modules() if isinstance(m, NATTENBlock)]
    seen = []
    handle = blocks[0].register_forward_pre_hook(lambda m, a: seen.append(a[0]))
    with torch.inference_mode():
        codec.decode(z)
        handle.remove()
        blk = blocks[0]
        x = seen[0]
        c = x.shape[1]
        xn = blk.GroupNorm_0(x).permute(0, 2, 3, 1)
        w = blk.Dense_0.weight.to(x.dtype)
        q, k, v = (F.linear(xn.to(x.dtype), w[i * c:(i + 1) * c]) for i in range(3))
        out = kernels["na2d_fwd"](q, k, v, kernel_size=blk.kernel_size, heads=blk.num_heads)
        torch.cuda.synchronize()
        ref = na2d_banded(q.float(), k.float(), v.float(), kernel_size=blk.kernel_size,
                          heads=blk.num_heads)
    err = (out.float() - ref).abs().max().item()
    print(f"K1 check inside the bf16 decode {tuple(q.shape)} dh {c // blk.num_heads} "
          f"{q.dtype}: max_abs_err={err:.3e} (tol 2e-2) {'ok' if err < 2e-2 else 'FAIL'}",
          flush=True)
    if not (np.isfinite(err) and err < 2e-2):
        fail("K1 inside the bf16 decode disagrees with its plain version")
    return err


def time_decodes(paths: dict, sd_paths: dict, card: str, kernels: dict) -> dict:
    """The decode of 64 latents (16×16×4) by flowers_vqgan's codec (its
    checkpoint) and flowers_sd's SD VAE (seeded), each in fp32, bf16 and
    bf16 with the int8 decoder (CUDA events over 3 decodes after 1, cuDNN's
    TF32 on as the scripts leave it; the bf16 codecs take the fp32 one's
    weights); and K1 held inside the VQGAN's bf16 decode."""
    from flocoder_torch.config import load_config
    from flocoder_torch.generate_samples import CONFIG_DIR
    from flocoder_torch.models.codecs import load_codec_weights, setup_codec
    torch.backends.cudnn.allow_tf32 = True
    z = torch.randn(64, 16, 16, 4, device="cuda", generator=torch.Generator("cuda").manual_seed(33))
    rec, k1_err = {}, 0.0
    for recipe, ckpt in (("flowers_vqgan", paths["codec"]), ("flowers_sd", None)):
        cfg = load_config(recipe, CONFIG_DIR, [f"codec.checkpoint={ckpt}"] if ckpt else [])
        row, weights = {}, None
        for mode, dtype, q in (("fp32", torch.float32, False), ("bf16", torch.bfloat16, False),
                               ("bf16_int8", torch.bfloat16, True)):
            codec = setup_codec(cfg, device="cuda", dtype=dtype, quant_decode=q)
            if weights is None:
                codec.init(torch.Generator("cuda").manual_seed(0))
                load_codec_weights(codec, ckpt)
                weights = codec.state_dict()
            else:
                codec.load_state_dict(weights)
            codec.eval()
            with torch.inference_mode():
                row[mode] = cuda_ms(lambda: codec.decode(z), 3, warmup=1)
            if recipe == "flowers_vqgan" and mode == "bf16":
                k1_err = hold_k1_in_decode(codec, z, kernels)
            del codec
            torch.cuda.empty_cache()
        del weights
        rec[recipe] = row
        print(f"decode of 64 (16x16x4 -> 128²) {recipe}: " + ", ".join(
            f"{m} {t:.3f} ms" for m, t in row.items()) + f" | card: {card}", flush=True)
    rec["k1_in_bf16_decode_err"] = k1_err
    return rec


def tpu_vqgan_phase(tmp: str, paths: dict, card: str, kernels: dict) -> tuple:
    """configs/tpu_vqgan.yaml as composed (codec.bf16: the codec computes in
    bf16 over fp32 parameters; rng_impl rbg accepted and ignored) at its full
    widths (hidden 256, internal 128, 4×96 codebooks, 128² images), the
    codec's weights ``paths['codec']``: the checkpoint tpu_vqgan_train wrote
    (trained in bf16; its codebooks k-means-initialised on the encoder's
    output), so that the recipe runs from codec training to serving.
    Pre-encodes the pre-encode phase's 320 500² PNGs with
    preencoding.fused_vq=true at B=32, augs_per 1 (the recipe's 1024): 1 val
    and 9 train batches, 5 K1 (bf16) and 1 K3 (its bf16 case) a batch,
    exactly; then with +quant=int8 (the encoder's convolutions W8A8, the same
    launches a batch beside the int8 products) over 96 such PNGs (1 val and 2
    train batches). Trains the flow (flow.bf16,
    B=256) for one epoch on the bf16 latents (1 step) with its RK4 + CFG
    evaluation at 20 grid points decoded in bf16 (2 K1), then serves the EMA
    checkpoint as trained (bf16; 1 K1) and with +quant=int8 (1 K1)."""
    from flocoder_torch import generate_samples as gs
    from flocoder_torch import preencode_data as pe
    from flocoder_torch import train_flow as tf
    from flocoder_torch.data.datasets import PreEncodedDataset
    from flocoder_torch.ops import quant

    print("tpu_vqgan cuts: pre-encode augs_per 1 (the recipe's 1024), flow 1 epoch (its "
          "10,000), evaluation and serving n_steps 20 (its 100)", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = True
    torch.cuda.empty_cache()
    rec, launches = {"card": card}, dict.fromkeys(kernels, 0)

    def add(got):
        for name in kernels:
            launches[name] += got[name]

    write_pngs(os.path.join(tmp, "tpu_vqgan_int8_images"), n=96, size=500, seed=5)
    for tag, extra, images, n_batches in (
            ("bf16", [], "pe_images", 10),
            ("bf16_int8", ["+quant=int8"], "tpu_vqgan_int8_images", 3)):
        data = os.path.join(tmp, f"tpu_vqgan_{tag}")
        os.symlink(os.path.join(tmp, images), data)
        _zero(kernels)
        quant.int_mm_calls.launches = 0
        torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        enc = pe.main(["--config-name", "tpu_vqgan.yaml", f"data={data}",
                       f"codec.checkpoint={paths['codec']}", *TPU_VQGAN_PE, *extra])
        wall = time.time() - t0
        got = _counts(kernels)
        batches = enc["val"]["batches"] + enc["train"]["batches"]
        if enc["codec"].dtype != torch.bfloat16 or batches != n_batches:
            fail(f"tpu_vqgan pre-encode {tag}: codec {enc['codec'].dtype}, {batches} batches")
        _expect(kernels, f"tpu_vqgan pre-encode {tag} ({batches} batches x (5 K1 bf16 + 1 K3 "
                "bf16))", got, na2d_fwd=5 * batches, fused_compress_tail_vq_bf16=batches)
        mm = quant.int_mm_calls.launches
        if (mm > 0) != bool(extra):
            fail(f"tpu_vqgan pre-encode {tag}: {mm} int8 products")
        add(got)
        ds = PreEncodedDataset(enc["train"]["out_dir"])
        lat = np.stack([ds.get(i, None)[0] for i in range(len(ds))])
        if lat.dtype != np.float32 or lat.shape[1:] != (16, 16, 4) or not np.isfinite(lat).all():
            fail(f"tpu_vqgan latents {tag}: {lat.dtype} {lat.shape}")
        rec[f"preencode_{tag}"] = dict(
            wall_s=wall, peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30,
            int8_products=mm, **{f"{s}_latents_per_s": enc[s]["latents_per_s"]
                                 for s in ("val", "train")})
        print(f"tpu_vqgan pre-encode {tag} B=32 (fused: K3 on bf16 h): val "
              f"{enc['val']['latents_per_s']:.2f}, train {enc['train']['latents_per_s']:.2f} "
              f"latents/s, wall {wall:.1f} s, {mm} int8 products, peak "
              f"{rec[f'preencode_{tag}']['peak_mem_gib']:.2f} GiB | card: {card}", flush=True)

    _zero(kernels)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    res = tf.main(["--config-name", "tpu_vqgan.yaml", f"data={os.path.join(tmp, 'tpu_vqgan_bf16')}",
                   f"codec.checkpoint={paths['codec']}", "flow.unet.n_classes=102",
                   "flow.bf16=true", "flow.epochs=1", "flow.n_steps=20", "flow.ckpt_every=1",
                   "+seed=0", f"+ckpt_dir={os.path.join(tmp, 'tpu_vqgan_ckpt')}",
                   f"+output_dir={os.path.join(tmp, 'tpu_vqgan_out')}"])
    wall = time.time() - t0
    got = _counts(kernels)
    _expect(kernels, "tpu_vqgan flow (1 evaluation x 2 decodes of 32 in bf16)", got, na2d_fwd=2)
    add(got)
    metrics = [v for e in res["eval"] for v in [e["val_loss"], *e["metrics"].values()]
               if not isinstance(v, str)]
    if len(res["eval"]) != 1 or not np.isfinite(metrics).all():
        fail(f"tpu_vqgan flow evaluation: {res['eval']}")
    rec["flow"] = dict(wall_s=wall, epochs=res["epochs"], evals=res["eval"])
    print(f"tpu_vqgan flow 1 epoch (bf16 U-Net, bf16 codec): wall {wall:.1f} s, evaluation s "
          + " ".join(f"{k}={v:.4f}" for k, v in res["eval"][0]["seconds"].items())
          + f", FID_px {res['eval'][0]['metrics']['FID_px']:.3f} | card: {card}", flush=True)

    for tag, extra in (("bf16", []), ("bf16_int8", ["+quant=int8"])):
        _zero(kernels)
        quant.int_mm_calls.launches = 0
        served = gs.main(["--config-name", "tpu_vqgan.yaml",
                          f"+flow_checkpoint={res['ema_checkpoint']}", "+n_samples=64",
                          "+n_steps=20", "+seed=0",
                          f"+output_dir={os.path.join(tmp, f'tpu_vqgan_gen_{tag}')}", *extra])
        got = _counts(kernels)
        _expect(kernels, f"tpu_vqgan serving {tag} (1 decode)", got, na2d_fwd=1)
        add(got)
        if (served["images"].shape != (64, 128, 128, 3) or not np.isfinite(served["images"]).all()
                or not served["bf16"] or served["quant"] != bool(extra)
                or (quant.int_mm_calls.launches > 0) != bool(extra)):
            fail(f"tpu_vqgan serving {tag}: {served['images'].shape}, bf16 {served['bf16']}, "
                 f"quant {served['quant']}, {quant.int_mm_calls.launches} int8 products")
        rec[f"serve_{tag}"] = dict(s_per_batch=served["batch_seconds"], nfe=served["nfe"],
                                   int8_products=quant.int_mm_calls.launches)
        print(f"tpu_vqgan served as trained ({tag}): 64 samples, nfe {served['nfe']}, s/batch "
              f"{[round(x, 4) for x in served['batch_seconds']]}, "
              f"{quant.int_mm_calls.launches} int8 products | card: {card}", flush=True)
    del res
    torch.cuda.empty_cache()
    return rec, launches


def int8_serving(tmp: str, paths: dict, sd_paths: dict, card: str, kernels: dict) -> tuple:
    """flowers_vqgan and flowers_sd served with +quant=int8 through
    generate_samples (the unconditional seeded checkpoints; 64 samples, 20
    grid points): the decoders' W8A8 convolutions run (torch._int_mm), K1
    once in the VQGAN's decode (fp32: the recipe is not bf16), none in the
    SD VAE's."""
    from flocoder_torch import generate_samples as gs
    from flocoder_torch.ops import quant
    rec, launches = {}, dict.fromkeys(kernels, 0)
    for recipe, ckpt, k1 in (("flowers_vqgan", paths["uncond"], 1),
                             ("flowers_sd", sd_paths["uncond"], 0)):
        _zero(kernels)
        quant.int_mm_calls.launches = 0
        served = gs.main(["--config-name", f"{recipe}.yaml", f"+flow_checkpoint={ckpt}",
                          "+n_samples=64", "+n_steps=20", "+seed=0", "+quant=int8",
                          f"+output_dir={os.path.join(tmp, f'int8_{recipe}')}"])
        got = _counts(kernels)
        _expect(kernels, f"{recipe} serving with +quant=int8", got, na2d_fwd=k1)
        for name in kernels:
            launches[name] += got[name]
        mm = quant.int_mm_calls.launches
        if (served["images"].shape != (64, 128, 128, 3) or not np.isfinite(served["images"]).all()
                or not served["quant"] or mm == 0):
            fail(f"{recipe} int8 serving: {served['images'].shape}, quant {served['quant']}, "
                 f"{mm} int8 products")
        rec[recipe] = dict(s_per_batch=served["batch_seconds"], int8_products=mm)
        print(f"{recipe} served with +quant=int8: 64 samples, s/batch "
              f"{[round(x, 4) for x in served['batch_seconds']]}, {mm} int8 products | card: "
              f"{card}", flush=True)
    return rec, launches



# ---------------------------------------------------------------------------
# The audio family: audio_dac from codec training to WAV serving
# ---------------------------------------------------------------------------

AUDIO_N = 64                   # synthetic_n: 4 codec steps an epoch at the recipe's B=16
AUDIO_AUGS = 4                 # pre-encode augs_per (the recipe's 8)
AUDIO_CROP = 32768             # audio_dac's crop_len: 16×16×8 latents
AUDIO_SERVE = 16               # clips served
# check_audio_small in bf16: the card's bf16 step must lie under this share
# of the CPU's bf16-to-fp32 spread, and the card's fp32 step (the control,
# about 1.0 of it) above; sound bf16 steps read 0.12-0.63 of it on an H100
BF16_STEP_GATE = 0.8


def _audio_argv(tmp: str, *extra, bf16: bool = False) -> list:
    """audio_dac.yaml as composed on the synthetic chords (its data path is
    absent), no metrics log, the checkpoints under one directory (the
    scripts' default codec is its newest dac_*.npz); with ``bf16`` the
    codec in bf16 (codec.bf16), with a data path and checkpoints of its
    own."""
    tag = "audio_bf16" if bf16 else "audio"
    return ["--config-name", "audio_dac.yaml", f"data={os.path.join(tmp, f'fc_{tag}_data')}",
            "no_wandb=true", f"+ckpt_dir={os.path.join(tmp, f'{tag}_ckpt')}",
            *(["+codec.bf16=true"] if bf16 else []), *extra]


def check_wavs(paths: list, frames: int, label: str) -> None:
    """Every WAV reads back through stdlib wave as 16-bit mono at 16 kHz
    with ``frames`` samples, not all zero."""
    import wave
    if not paths:
        fail(f"{label}: no WAV written")
    for path in paths:
        with wave.open(path, "rb") as w:
            meta = (w.getsampwidth(), w.getframerate(), w.getnchannels(), w.getnframes())
            pcm = np.frombuffer(w.readframes(w.getnframes()), "<i2")
        if meta != (2, 16000, 1, frames) or not pcm.any():
            fail(f"{label}: {path} reads back as {meta}, all zero: {not pcm.any()}")


def audio_train(tmp: str, card: str, kernels: dict, bf16: bool = False) -> tuple:
    """audio_dac's DAC codec at full width (strides 2,4,4,4, base 32, RVQ
    4×512×8, B=16 crops of 32,768 samples; 3.49 M + 3.51 M parameters and
    the 26.85 M-parameter waveform discriminators) through
    flocoder_torch.train_audio_codec.main on 64 synthetic chords: one
    reconstruction and one GAN epoch of 4 steps, a validation batch and two
    WAV pairs after each; no kernel of the port; with ``bf16`` the codec
    computes in bf16 (codec.bf16). Returns (state, record, launches)."""
    from flocoder_torch import train_audio_codec as tac

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = True
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _zero(kernels)
    events, step_hook = _hooked()
    t0 = time.time()
    dtype = torch.bfloat16 if bf16 else torch.float32
    label = f"audio_dac codec ({str(dtype)[6:]})"
    out = os.path.join(tmp, "audio_bf16_codec_out" if bf16 else "audio_codec_out")
    res = tac.main(_audio_argv(tmp, f"+synthetic_n={AUDIO_N}", "codec.epochs=2",
                               "codec.gan_warmup_epochs=1", "+eval_every=1",
                               f"+output_dir={out}", bf16=bf16), step_hook=step_hook)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = _counts(kernels)
    _expect(kernels, f"audio_train ({label})", launches)
    if res["state"].codec.dtype != dtype:
        fail(f"{label}: the codec computes in {res['state'].codec.dtype}")
    if [(e["phase"], e["clips"]) for e in res["epoch_seconds"]] != [("recon", 64), ("gan", 64)]:
        fail(f"audio codec training ran {res['epoch_seconds']}")
    losses = [v for e in res["epochs"] + res["val"] for v in e.values() if isinstance(v, float)]
    if not np.isfinite(losses).all():
        fail(f"audio codec losses are not finite: {res['epochs']} {res['val']}")
    if res["checkpoint"] is None or not os.path.exists(res["checkpoint"]):
        fail("audio codec training wrote no checkpoint")
    check_wavs(res["wavs"], AUDIO_CROP, "audio codec validation")
    peak = torch.cuda.max_memory_allocated() / 2**30
    rec = dict(batch=16, crop=AUDIO_CROP, wall_s=wall, peak_mem_gib=peak, card=card,
               epochs=res["epochs"], val=res["val"], dtype=str(dtype),
               checkpoint=res["checkpoint"])
    for epoch, ph in ((1, "recon"), (2, "gan")):
        (ep,) = [e for e in res["epoch_seconds"] if e["epoch"] == epoch]
        steady = _steady([e for e in events if e[0] == epoch])
        rec[ph] = dict(steady_step_s=steady, clips_per_s=16 / float(np.median(steady)),
                       host_step_s=res["step_seconds"][ph], epoch_s=ep["seconds"],
                       epoch_clips_per_s=ep["clips"] / ep["seconds"])
    print(f"{label} B=16 x 32768 samples: " + ", ".join(
        f"{ph} {rec[ph]['clips_per_s']:.2f} clips/s over steady steps (CUDA events, median "
        f"of {len(rec[ph]['steady_step_s'])}), {rec[ph]['epoch_clips_per_s']:.2f} over the "
        f"epoch" for ph in ("recon", "gan")) + f", peak {peak:.2f} GiB, wall {wall:.1f} s | "
        f"card: {card}", flush=True)
    for e in res["epochs"] + res["val"]:
        print("  " + " ".join(f"{k}={v:.4f}" if isinstance(v, float) else f"{k}={v}"
                              for k, v in e.items()), flush=True)
    return res["state"], rec, launches


def audio_gan_breakdown(state, card: str) -> dict:
    """Where an audio GAN step goes (the trained state, B=16 chords of
    32,768 samples): CUDA events around its parts, the mean of 3 steps
    after one warm step, then one step under the profiler for the device's
    idle share."""
    from flocoder_torch.config import load_config
    from flocoder_torch.data.audio_io import SyntheticAudioDataset
    from flocoder_torch.generate_samples import CONFIG_DIR
    from flocoder_torch.training.audio import make_audio_gan_step

    dtype = str(state.codec.dtype)[6:]
    step = make_audio_gan_step(load_config("audio_dac.yaml", CONFIG_DIR))
    ds = SyntheticAudioDataset(n=16, crop_len=AUDIO_CROP, seed=11)
    x = torch.from_numpy(np.stack([ds.get(i, None)[0] for i in range(16)])).cuda()
    gen = torch.Generator("cuda").manual_seed(6)
    names = ["codec_forward", "d_step", "g_loss_backward", "optimizers"]
    totals = dict.fromkeys(names, 0.0)
    for it in range(4):
        events = [torch.cuda.Event(enable_timing=True)]
        events[0].record()

        def mark(name, events=events):
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            events.append(e)

        step(state, x, gen, mark)
        torch.cuda.synchronize()
        if it:
            for i, n in enumerate(names):
                totals[n] += events[i].elapsed_time(events[i + 1]) / 3
    out = {f"{n}_ms": v for n, v in totals.items()}
    out["step_ms"] = sum(totals.values())
    out.update(profile_batch(lambda: step(state, x, gen)))
    top = out.pop("top_kernels")
    print(f"audio GAN step breakdown (audio_dac, codec {dtype}, B=16 x 32768): " + " ".join(
        f"{k}={v:.4f}" for k, v in out.items()) + f" | card: {card}", flush=True)
    print("  device time by kernel (ms): " + "; ".join(
        f"{name[:60]}={ms:.2f}" for name, ms in top), flush=True)
    out["top_kernels"] = top
    return out


def audio_preencode(tmp: str, card: str, kernels: dict, bf16: bool = False) -> tuple:
    """audio_dac's pre-encode through flocoder_torch.preencode_data.main with
    the trained codec (the newest dac_*.npz): the 256 synthetic chords (25
    val, 231 train), B=16, augs_per 4 (the recipe's 8): 6 val and 57 train
    batches, folded into 16×16×8 latent files; no kernel of the port."""
    from flocoder_torch import preencode_data as pe
    from flocoder_torch.data.datasets import PreEncodedDataset

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _zero(kernels)
    t0 = time.time()
    enc = pe.main(_audio_argv(tmp, f"preencoding.augs_per={AUDIO_AUGS}", bf16=bf16))
    wall = time.time() - t0
    launches = _counts(kernels)
    _expect(kernels, f"audio_preencode (codec bf16: {bf16})", launches)
    if [enc[s]["batches"] for s in ("val", "train")] != [6, 57]:
        fail(f"audio pre-encode ran {[enc[s]['batches'] for s in ('val', 'train')]} batches")
    for s in ("val", "train"):
        ds = PreEncodedDataset(enc[s]["out_dir"])
        lat = np.stack([ds.get(i, None)[0] for i in range(0, len(ds), 7)])
        if len(ds) != enc[s]["latents"] or lat.shape[1:] != (16, 16, 8) or \
                not np.isfinite(lat).all():
            fail(f"audio pre-encode {s}: {len(ds)} files, latents {lat.shape}")
    peak = torch.cuda.max_memory_allocated() / 2**30
    rec = dict(batch=16, wall_s=wall, peak_mem_gib=peak, card=card, bf16=bf16,
               **{f"{s}_latents": enc[s]["latents"] for s in ("val", "train")},
               **{f"{s}_latents_per_s": enc[s]["latents_per_s"] for s in ("val", "train")})
    print(f"audio_dac pre-encode B=16 (codec bf16: {bf16}; synthetic chords, augs_per "
          f"{AUDIO_AUGS}): val "
          f"{rec['val_latents']} latents at {rec['val_latents_per_s']:.2f}/s, train "
          f"{rec['train_latents']} at {rec['train_latents_per_s']:.2f}/s, 16x16x8, peak "
          f"{peak:.2f} GiB, wall {wall:.1f} s | card: {card}", flush=True)
    return rec, launches


def audio_flow(tmp: str, card: str, kernels: dict, bf16: bool = False) -> tuple:
    """The U-Net flow on the audio latents (dim_mults 1,2,4, 4 classes,
    B=64) through flocoder_torch.train_flow.main: 1 epoch (the recipe's
    100) with evaluate_model_audio (RK4 over 20 grid points, the recipe's
    50; CFG 3.0; the sampled and the target latents decoded to waveforms,
    WAVs written); then generate_samples serves 16 clips from the EMA
    checkpoint at 20 grid points and every WAV is read back. No kernel of the port. With
    ``bf16`` the codec and the U-Net (flow.bf16) compute in bf16, and the
    EMA checkpoint serves in bf16 as trained (no +bf16 flag)."""
    from flocoder_torch import generate_samples as gs
    from flocoder_torch import train_flow as tf

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _zero(kernels)
    tag = "audio_bf16" if bf16 else "audio"
    out_dir = os.path.join(tmp, f"{tag}_flow_out")
    events, step_hook = _hooked()
    t0 = time.time()
    res = tf.main(_audio_argv(tmp, "flow.epochs=1", "flow.ckpt_every=1", "flow.n_steps=20",
                              f"+output_dir={out_dir}", *(["flow.bf16=true"] if bf16 else []),
                              bf16=bf16), step_hook=step_hook)
    torch.cuda.synchronize()
    wall = time.time() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    flow_launches = _counts(kernels)
    _expect(kernels, f"audio_flow (U-Net, evaluate_model_audio; bf16: {bf16})",
            flow_launches)
    (ep,), (ev,) = res["epoch_seconds"], res["eval"]
    if ep["steps"] < 4 or not np.isfinite(list(ev["metrics"].values())).all():
        fail(f"audio flow: {res['epoch_seconds']} {ev}")
    check_wavs(sorted(os.path.join(out_dir, f) for f in os.listdir(out_dir)
                      if f.endswith(".wav")), AUDIO_CROP, "audio flow evaluation")

    _zero(kernels)
    t0 = time.time()
    served = gs.main(["--config-name", "audio_dac.yaml",
                      f"+flow_checkpoint={res['ema_checkpoint']}", f"+n_samples={AUDIO_SERVE}",
                      "+n_steps=20", "+seed=0", f"+output_dir={os.path.join(tmp, f'{tag}_gen')}"])
    serve_wall = time.time() - t0
    serve_launches = _counts(kernels)
    _expect(kernels, f"audio_serve (bf16: {bf16})", serve_launches)
    if served["bf16"] != bf16:
        fail(f"audio serving ran bf16={served['bf16']}, the checkpoint was trained "
             f"bf16={bf16}")
    if served["images"].shape != (AUDIO_SERVE, AUDIO_CROP, 1) or \
            not np.isfinite(served["images"]).all() or len(served["wav_files"]) != AUDIO_SERVE:
        fail(f"audio serving: {served['images'].shape}, {len(served['wav_files'])} WAVs")
    check_wavs(served["wav_files"], AUDIO_CROP, "audio serving")
    steps = _steady(events)
    rec = dict(batch=64, card=card, wall_s=wall, peak_mem_gib=peak, steps=ep["steps"],
               step_s=steps, steady_samples_per_s=64 / float(np.median(steps)),
               epoch_samples_per_s=ep["samples"] / ep["seconds"], eval=ev,
               serve_wall_s=serve_wall, serve_batch_s=served["batch_seconds"],
               serve_nfe=served["nfe"], bf16=bf16)
    print(f"audio_dac flow B=64 16x16x8 (bf16: {bf16}): {rec['steady_samples_per_s']:.2f} "
          "samples/s over "
          f"steady steps (median of {len(steps)}), {rec['epoch_samples_per_s']:.2f} over the "
          f"epoch of {ep['steps']} steps, peak {peak:.2f} GiB; evaluation sinkhorn_mel "
          f"{ev['metrics']['sinkhorn_mel']:.4f} sinkhorn {ev['metrics']['sinkhorn']:.4f} nfe "
          f"{ev['metrics']['nfe']:.0f} in {sum(ev['seconds'].values()):.2f} s "
          f"({', '.join(f'{k} {v:.2f}' for k, v in ev['seconds'].items())}); served "
          f"{AUDIO_SERVE} clips (nfe {served['nfe']}) in {serve_wall:.2f} s, s/batch "
          f"{[round(x, 4) for x in served['batch_seconds']]}, every WAV 16-bit 16 kHz "
          f"{AUDIO_CROP} frames | card: {card}", flush=True)
    return rec, flow_launches, serve_launches


def check_audio_small(dtype=torch.float32) -> dict:
    """A small DAC (strides 2,4, base 8, RVQ 2×16×8) and small waveform
    discriminators (periods 2, 3; 2 scales; base 4), every weight random
    (the zero-initialised convolutions and log_alpha included: kernels
    N(0, 0.49/fan_in), the decoder's output kernel ten times that spread,
    biases N(0, 0.01²), log_alpha N(0, 0.3²)), on the card
    and on the CPU from the same weights, batches (4 chords of 2,048
    samples) and RVQ draws (an initialised codebook whose first two codes a
    level are dead, reseeded by the injected picks), TF32 off: one
    reconstruction step and one GAN step, each from those initial weights
    (and fresh optimizers), losses and parameters within
    1e-3·max(1, |ref|), Adam's first moments within 1e-3 of the largest
    |ref| of each model and step; the multi-scale STFT and mel losses of two
    full-length batches (4 × 32,768) within 1e-4·max(1, |ref|).

    The losses' log(|X| + 1e-5) is ill-conditioned where a clip's spectrum
    lies at the FFT's rounding floor (about 1e-7 of its largest bin): there
    |rfft|'s gradient points where the rounding does, weighted by up to
    1e5, and the card's FFT rounds otherwise than the CPU's. Kernels at
    0.5/√fan_in with biases of 0.3 made such a decoder (a DC offset of 0.22
    over an AC part of 0.08: bins down to 1.3e-7 of the largest) and the
    gradients parted by more than their own size, the loss values by 0.2%.
    At these weights the decoder's output has a spread of about 0.5 around
    a small mean, saturates in under 1% of its samples, and the spectrum of
    the reconstruction step's output stays above 1e-5 of its largest bin at
    every FFT size of the losses (a hundred times the rounding floor); the
    check prints that floor.

    With ``dtype`` bf16 the codec computes in bf16 (the discriminators, the
    losses and Adam stay fp32) on both devices, and the gates are bf16's:
    losses within 3e-2·max(1, |ref|); parameters within 1e-3·max(1, |ref|)
    as in fp32 (one Adam step moves a weight by about lr = 1e-4 either way);
    Adam's first moments by the median over each model's tensors of
    (largest |card − CPU| / largest |CPU|), which must be under
    BF16_STEP_GATE of the same median between the CPU's bf16 step and its
    fp32 step on the same weights (the spread, 0.17–0.23 on the chip), and
    the card's fp32 step, the control, must read at or above that gate: the
    gate tells a bf16 step from an fp32 one in every run.
    Elementwise they are not held: a bf16 step's log-magnitude gradients
    move by their own size between two sound roundings
    (tests/test_torch_audio_bf16_step.py measures that spread between two
    JAX compilations), and cuDNN sums otherwise than the CPU."""
    from flocoder_torch.config import load_config
    from flocoder_torch.data.audio_io import SyntheticAudioDataset
    from flocoder_torch.generate_samples import CONFIG_DIR
    from flocoder_torch.models.audio_codec import DACCodec
    from flocoder_torch.models.audio_disc import DACDiscriminator
    from flocoder_torch.ops.audio import multiscale_mel_loss, multiscale_stft_loss, stft
    from flocoder_torch.training.audio import (create_audio_state, make_audio_gan_step,
                                               make_audio_train_step)
    from flocoder_torch.training.checkpoint import (DAC_PREFIXES, DISC_PREFIXES, load_jax_flat,
                                                   to_jax_flat)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.default_rng(12)

    def randomize(module):
        with torch.no_grad():
            for name, p in module.named_parameters():
                std = (0.7 / np.sqrt(p[0].numel()) if p.ndim > 1
                       else 0.3 if name.endswith("log_alpha") else 0.01)
                p.copy_(torch.from_numpy(rng.normal(size=tuple(p.shape)).astype(np.float32)
                                         * std))
        return module

    cfg = load_config("audio_dac.yaml", CONFIG_DIR, [
        "codec.strides=[2,4]", "codec.base_channels=8", "codec.crop_len=2048",
        "codec.codebook_levels=2", "codec.vq_num_embeddings=16", "codec.learning_rate=1e-4"])
    bf16 = dtype == torch.bfloat16
    codec = randomize(DACCodec(strides=(2, 4), base_channels=8, codebook_levels=2,
                               vq_num_embeddings=16, dtype=dtype)
                      .init(torch.Generator().manual_seed(0)))
    with torch.no_grad():
        codec.decoder.ops[-1].weight.mul_(10.0)
    disc = randomize(DACDiscriminator(periods=(2, 3), scales=2, base_channels=4))
    chords = SyntheticAudioDataset(n=8, crop_len=2048, seed=3)
    batches = [torch.from_numpy(np.stack([chords.get(4 * b + i, None)[0] for i in range(4)]))
               for b in range(2)]
    with torch.no_grad():
        spread = float(codec.encode(batches[0]).std())
    L, K, D = codec.vq.codebooks.shape
    counts = rng.uniform(4, 30, (L, K)).astype(np.float32)
    counts[:, :2] = 0.5
    codec.vq.assign_({
        "codebooks": torch.from_numpy(rng.normal(size=(L, K, D)).astype(np.float32) * spread),
        "ema_counts": torch.from_numpy(counts),
        "ema_sums": torch.from_numpy(rng.normal(size=(L, K, D)).astype(np.float32)),
        "initted": torch.tensor(True)})
    with torch.no_grad():
        recon = codec(batches[0])[0][..., 0]        # what the reconstruction step sees
    floor = min(float(sp.min() / sp.max()) for sp in (stft(recon, n) for n in (512, 1024, 2048)))
    n_tokens = 4 * 2048 // codec.hop
    draws = [dict(kmeans_seeds=rng.integers(0, n_tokens, (L, K)),
                  reseed_picks=rng.integers(0, n_tokens, (L, K))) for _ in range(2)]
    steps = (("recon", make_audio_train_step, False), ("gan", make_audio_gan_step, True))
    runs = [("card", "cuda", codec), ("cpu", "cpu", codec)]
    if bf16:        # the fp32 step on the same weights, on the CPU and the card
        fp32 = load_jax_flat(DACCodec(strides=(2, 4), base_channels=8, codebook_levels=2,
                                      vq_num_embeddings=16),
                             to_jax_flat(codec, DAC_PREFIXES), DAC_PREFIXES)
        runs += [("cpu_fp32", "cpu", fp32), ("card_fp32", "cuda", fp32)]
    out = {}
    for run, dev, model0 in runs:
        losses, params, moments, picks = {}, {}, {}, []
        for (kind, make, adversarial), batch, draw in zip(steps, batches, draws):
            # each step from the same initial weights: a weight whose first
            # gradient is rounding's moves by ±lr on either side, and a second
            # step would carry that into the discriminators' cancelling sums
            state = create_audio_state(copy.deepcopy(model0).to(dev),
                                       copy.deepcopy(disc).to(dev), 1e-4)
            _, aux, idx = make(cfg)(state, batch.to(dev), None, **draw)
            losses.update({f"{kind}/{k}": float(v) for k, v in aux.items()})
            trained = [("codec", state.codec, state.opt_g, DAC_PREFIXES)]
            if adversarial:
                trained.append(("discriminators", state.disc, state.opt_d, DISC_PREFIXES))
            for name, model, opt, prefixes in trained:
                moments[f"{kind}/{name}"] = {
                    n: opt.adam.state[p]["exp_avg"].cpu().numpy()
                    for n, p in model.named_parameters() if p in opt.adam.state}
                params.update({f"{kind}/{k}": v for k, v in to_jax_flat(model, prefixes).items()})
            picks.append(idx.cpu().numpy())
        out[run] = (losses, params, moments, picks)
    (l_card, p_card, m_card, i_card), (l_cpu, p_cpu, m_cpu, i_cpu) = out["card"], out["cpu"]
    same_picks = float(np.mean([np.mean(a == b) for a, b in zip(i_card, i_cpu)]))
    report = {"same_picks": same_picks, "spectrum_floor": floor}
    for model, ref_m in m_cpu.items():
        if set(ref_m) != set(m_card[model]) or not ref_m:
            fail(f"card and CPU optimise different {model} parameters")
        errs = {n: float(np.abs(m_card[model][n] - r).max()) for n, r in ref_m.items()}
        if bf16:
            held = [n for n, r in ref_m.items() if np.abs(r).max() > 0]

            def median_err(m):
                return float(np.median([np.abs(m[n] - ref_m[n]).max() / np.abs(ref_m[n]).max()
                                        for n in held]))
            rel, spread = median_err(m_card[model]), median_err(out["cpu_fp32"][2][model])
            control = median_err(out["card_fp32"][2][model])
            if not (held and np.isfinite(rel) and rel < BF16_STEP_GATE * spread
                    <= control):
                fail(f"audio bf16 card and CPU gradients of {model}: median error {rel:.3e} "
                     f"of each tensor's largest, the card's fp32 step {control:.3e}, the "
                     f"CPU's fp32 step {spread:.3e} (gate: {BF16_STEP_GATE} of the last, "
                     "the bf16 step under it and the fp32 step not)")
            report[f"{model}_moment_err_over_tol"] = rel / (BF16_STEP_GATE * spread)
            report[f"{model}_median_moment_err"] = dict(card_bf16=rel, card_fp32=control,
                                                        cpu_fp32=spread)
            continue
        tol = 1e-3 * max(float(np.abs(r).max()) for r in ref_m.values())
        worst_n = max(errs, key=errs.get)
        if not (tol > 0 and all(np.isfinite(e) and e < tol for e in errs.values())):
            fail(f"audio card and CPU gradients disagree on {model} {worst_n}: "
                 f"{errs[worst_n]:.3e} (tol {tol:.3e})")
        report[f"{model}_moment_err_over_tol"] = errs[worst_n] / tol
    worst = ("", 0.0)
    for name, ref in list(l_cpu.items()) + list(p_cpu.items()):
        a = l_card[name] if name in l_card else p_card[name]
        ref = np.asarray(ref, np.float64)
        err = float(np.abs(np.asarray(a, np.float64) - ref).max())
        tol = (3e-2 if bf16 and name in l_cpu else 1e-3) * max(1.0, float(np.abs(ref).max()))
        if not (np.isfinite(err) and err < tol):
            fail(f"audio card and CPU disagree after the steps on {name}: {err:.3e} "
                 f"(tol {tol:.3e})")
        if err / tol > worst[1]:
            worst = (name, err / tol)
    report["worst_loss_or_param"] = worst

    long = SyntheticAudioDataset(n=8, crop_len=AUDIO_CROP, seed=5)
    x, y = (torch.from_numpy(np.stack([long.get(4 * b + i, None)[0][:, 0] for i in range(4)]))
            for b in range(2))
    for name, fn in (("stft", lambda a, b: multiscale_stft_loss(a, b, (512, 1024))),
                     ("mel", lambda a, b: multiscale_mel_loss(a, b, 16000))):
        ref = float(fn(x, y))
        got = float(fn(x.cuda(), y.cuda()))
        if not abs(got - ref) < 1e-4 * max(1.0, abs(ref)):
            fail(f"multi-scale {name} loss on the card {got} against the CPU's {ref}")
        report[f"{name}_loss"] = (got, ref)
    print(f"audio card vs CPU, one reconstruction and one GAN step (DAC base 8, "
          f"{str(dtype)[6:]}): losses "
          + " ".join(f"{k}={l_card[k]:.5f}/{l_cpu[k]:.5f}" for k in sorted(l_cpu))
          + f"; decoder spectrum down to {floor:.2e} of its largest bin; picks equal "
          f"{same_picks:.4f}; worst loss/parameter {worst[0]} at "
          f"{worst[1]:.3f} of its tolerance; Adam first moments at "
          + ", ".join(f"{k[:-len('_moment_err_over_tol')]} {v:.3f}"
                      for k, v in report.items() if k.endswith("over_tol"))
          + " of theirs; multi-scale losses card/CPU "
          + ", ".join(f"{n} {report[f'{n}_loss'][0]:.6f}/{report[f'{n}_loss'][1]:.6f}"
                      for n in ("stft", "mel")), flush=True)
    return report


def audio_phase(tmp: str, card: str, kernels: dict) -> tuple:
    """The audio family on audio_dac at full width, cut in depth only (the
    module docstring's step 27): codec training, its GAN step's breakdown,
    pre-encoding, flow training with its evaluation, serving, then the card
    against the CPU. Returns (record, launches by tag)."""
    print(f"audio_dac cuts: synthetic_n {AUDIO_N} (4 codec steps an epoch), codec epochs 2 "
          f"(1 recon + 1 GAN; the recipe's 200 with 50 recon), pre-encode augs_per "
          f"{AUDIO_AUGS} (its 8), flow 1 epoch (its 100) with evaluation and serving at n_steps "
          f"20 (its 50), flow.ckpt_every=1 (its 25) to write "
          "the served checkpoint", flush=True)
    state, train, train_launches = audio_train(tmp, card, kernels)
    train["gan_breakdown"] = audio_gan_breakdown(state, card)
    del state
    torch.cuda.empty_cache()
    pre, pre_launches = audio_preencode(tmp, card, kernels)
    flow, flow_launches, serve_launches = audio_flow(tmp, card, kernels)
    card_vs_cpu = check_audio_small()
    return (dict(train=train, preencode=pre, flow=flow, card_vs_cpu=card_vs_cpu),
            {"audio_train": train_launches, "audio_preencode": pre_launches,
             "audio_flow": flow_launches, "audio_serve": serve_launches})


def bf16_excess(got: torch.Tensor, ref: torch.Tensor) -> float:
    """The largest |got − ref| over the larger of two bf16 spacings of each
    reference element and 1e-2 of the largest |ref|: at most 1 when every
    element lies within a few bf16 spacings or 1e-2 of the largest."""
    ref = ref.detach().double().cpu()
    mag = np.maximum(ref.abs().numpy(), 2.0 ** -126).astype(np.float32)
    spacing = torch.from_numpy(np.spacing(mag).astype(np.float64) * 2.0 ** 16)
    tol = torch.maximum(2 * spacing, torch.tensor(1e-2 * float(ref.abs().max())))
    return float(((got.detach().double().cpu() - ref).abs() / tol).max())


def bf16_ops(card_codec, cpu_codec, x, zq) -> list:
    """Every convolution, transposed convolution and Snake of the bf16 codec
    on the card fed the CPU bf16 codec's own input to it (forward hooks on
    the CPU's encode of ``x`` and decode of ``zq``). Returns (name, share of
    elements that differ, bf16_excess of the card over the CPU) for each
    op, and the CPU's latents and waveform."""
    from flocoder_torch.models.audio_codec import Snake, Conv1d
    card_mods = dict(card_codec.named_modules())
    device = next(card_codec.parameters()).device
    seen = []
    hooks = [m.register_forward_hook(lambda m, i, o, n=n: seen.append((n, i[0], o)))
             for n, m in cpu_codec.named_modules() if isinstance(m, (Conv1d, Snake))]
    with torch.no_grad():
        z, w = cpu_codec.encode(x), cpu_codec.decode(zq)
    for h in hooks:
        h.remove()
    out = []
    with torch.no_grad():
        for name, inp, ref in seen:
            got = card_mods[name](inp.to(device)).cpu()
            if got.dtype != torch.bfloat16 or ref.dtype != torch.bfloat16 \
                    or got.shape != ref.shape:
                fail(f"bf16 DAC op {name}: card {got.dtype} {tuple(got.shape)}, CPU "
                     f"{ref.dtype} {tuple(ref.shape)}")
            out.append((name, float((got != ref).double().mean()), bf16_excess(got, ref)))
    return out, z, w


def hold_bf16_codec_forward(checkpoint: str, card: str) -> dict:
    """The bf16-trained dac_ checkpoint (fp32 parameters) in a bf16 codec
    on the card against the same bf16 codec on the CPU (the branch that
    tests/test_torch_audio_bf16.py holds to JAX bit for bit), TF32 off, on
    one chord of 32,768 samples.

    Op by op (bf16_ops, 118 ops), the sharp hold: under 5% of each op's
    elements differ (random weights on an H100 read up to 0.7%, in the
    decoder's last convolution; a convolution that leaves its input
    unrounded, or computes in fp32 and rounds once, moves over 10% of them:
    tests/test_torch_audio_bf16.py), and each element
    lies within 2 bf16 spacings of the CPU's or 1e-2 of the op's largest
    |CPU| (bf16_excess at most 1; cuDNN sums in another order, and between
    runs in more than one, which moves a result by more than its own
    spacing where the sum, or the sum and the bias, cancel). End to end,
    the encoder's latents and the decoder's waveform from the same
    quantized latents, only against gross faults: the card's RMS distance
    from the CPU's bf16 under twice the card's fp32 forward's (bf16's own
    distance). One-spacing differences grow through 118 ops, so the two
    bf16 forwards part about as far as bf16 and fp32 do (random weights
    read 0.67 and 1.08 of it).

    Then the bf16 codec against the fp32 codec, both on the card, on 4
    chords: latents and waveform within 5e-2 of the largest |fp32| (the
    tiny codec of tests/test_torch_audio_bf16.py lies 0.9% from fp32,
    where the port and JAX agree bit for bit) and not equal to fp32's."""
    from flocoder_torch.config import load_config
    from flocoder_torch.data.audio_io import SyntheticAudioDataset
    from flocoder_torch.generate_samples import CONFIG_DIR
    from flocoder_torch.models.codecs import load_codec_weights, setup_codec

    flags = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    cfg = load_config("audio_dac.yaml", CONFIG_DIR)
    codecs = {}
    for dev, dtype in (("cuda", torch.float32), ("cuda", torch.bfloat16),
                       ("cpu", torch.bfloat16)):
        codecs[dev, dtype] = setup_codec(cfg, device=dev, dtype=dtype).eval()
        load_codec_weights(codecs[dev, dtype], checkpoint)
    f32, b16, cpu = (codecs["cuda", torch.float32], codecs["cuda", torch.bfloat16],
                     codecs["cpu", torch.bfloat16])
    ds = SyntheticAudioDataset(n=4, crop_len=AUDIO_CROP, seed=17)
    x = torch.from_numpy(np.stack([ds.get(i, None)[0] for i in range(4)])).cuda()
    with torch.no_grad():
        z32 = f32.encode(x)
        z16 = b16.encode(x)
        zq = f32.quantize(z32)[0]
        w32 = f32.decode(zq)
        w16 = b16.decode(zq)
    ops, z_cpu, w_cpu = bf16_ops(b16, cpu, x[:1].cpu(), zq[:1].cpu())
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags

    def rms(a):
        return float(a.double().pow(2).mean().sqrt())
    out = dict(ops=len(ops), ops_most_differing=max(ops, key=lambda o: o[1]),
               ops_most_excess=max(ops, key=lambda o: o[2]))
    for name, got, ctl, ref in (("latents", z16[:1], z32[:1], z_cpu),
                                ("waveform", w16[:1], w32[:1], w_cpu)):
        got, ctl = got.cpu(), ctl.cpu()
        out[f"card_vs_cpu_{name}"] = dict(
            rms_over_fp32s=rms(got - ref) / rms(ctl - ref), rms=rms(got - ref),
            fp32_rms=rms(ctl - ref), max_abs_err=float((got - ref).abs().max()),
            largest=float(ref.abs().max()))
    for name, got, ref in (("latents", z16, z32), ("waveform", w16, w32)):
        err, scale = float((got.double() - ref.double()).abs().max()), float(ref.abs().max())
        out[name] = dict(max_abs_err=err, largest=scale, rel=err / scale, dtype=str(got.dtype))
    (n_share, share, _), (n_ex, _, excess) = out["ops_most_differing"], out["ops_most_excess"]
    print("bf16 DAC forward on the card (TF32 off) against the CPU's bf16 forward on the "
          f"same weights: {len(ops)} ops, at most {share:.2e} of an op's elements differ "
          f"({n_share}; gate 5e-2), the largest element at {excess:.3f} of the larger of 2 bf16 "
          f"spacings and 1e-2 of its op's largest ({n_ex}; gate 1); "
          "end to end RMS " + ", ".join(
              f"{k} {out[f'card_vs_cpu_{k}']['rms']:.3e} against fp32's "
              f"{out[f'card_vs_cpu_{k}']['fp32_rms']:.3e} "
              f"({out[f'card_vs_cpu_{k}']['rms_over_fp32s']:.3f}; gate 2)"
              for k in ("latents", "waveform")) +
          "; against fp32 on the card, 4 chords: " +
          ", ".join(f"{k} {out[k]['rel']:.4f} of the largest |fp32| "
                    f"({out[k]['max_abs_err']:.3e}; gate 5e-2)" for k in ("latents", "waveform"))
          + f" | card: {card}", flush=True)
    if len(ops) != 118 or share >= 5e-2 or not excess <= 1:
        fail(f"the bf16 DAC's ops on the card against the CPU's: {len(ops)} ops, "
             f"{out['ops_most_differing']}, {out['ops_most_excess']}")
    for k in ("latents", "waveform"):
        r = out[f"card_vs_cpu_{k}"]["rms_over_fp32s"]
        if not r < 2:
            fail(f"the bf16 DAC's {k} on the card: RMS distance from the CPU's bf16 {r:.3f} "
                 "of the fp32 forward's (gate 2)")
        if out[k]["dtype"] != "torch.float32" or not 0 < out[k]["rel"] < 5e-2:
            fail(f"the bf16 DAC's {k} on the card against fp32's: {out[k]}")
    return out


def audio_bf16_phase(tmp: str, card: str, kernels: dict, fp32: dict) -> tuple:
    """The audio family with the DAC codec in bf16 (codec.bf16; the module
    docstring's step 30): the audio phase's codec training, GAN step
    breakdown, pre-encoding, flow training (flow.bf16) with its evaluation
    and serving as trained, on a data path and checkpoints of its own; then
    the bf16 codec's forward against fp32's on the trained weights, and a
    small bf16 step on the card against the CPU. ``fp32`` is the audio
    phase's record, printed beside. Returns (record, launches by tag)."""
    state, train, train_launches = audio_train(tmp, card, kernels, bf16=True)
    train["gan_breakdown"] = audio_gan_breakdown(state, card)
    del state
    torch.cuda.empty_cache()
    pre, pre_launches = audio_preencode(tmp, card, kernels, bf16=True)
    flow, flow_launches, serve_launches = audio_flow(tmp, card, kernels, bf16=True)
    forward = hold_bf16_codec_forward(train["checkpoint"], card)
    card_vs_cpu = check_audio_small(torch.bfloat16)
    f32 = fp32["train"]
    print("audio_dac codec bf16 against fp32 in this run (B=16 x 32768): reconstruction "
          f"{train['recon']['clips_per_s']:.2f} against {f32['recon']['clips_per_s']:.2f} "
          f"clips/s, GAN {train['gan']['clips_per_s']:.2f} against "
          f"{f32['gan']['clips_per_s']:.2f} clips/s over steady steps; a GAN step by CUDA "
          f"events {train['gan_breakdown']['step_ms']:.2f} against "
          f"{f32['gan_breakdown']['step_ms']:.2f} ms; peak {train['peak_mem_gib']:.2f} against "
          f"{f32['peak_mem_gib']:.2f} GiB; pre-encode train {pre['train_latents_per_s']:.2f} "
          f"against {fp32['preencode']['train_latents_per_s']:.2f} latents/s; flow "
          f"{flow['steady_samples_per_s']:.2f} against "
          f"{fp32['flow']['steady_samples_per_s']:.2f} samples/s | card: {card}", flush=True)
    return (dict(train=train, preencode=pre, flow=flow, forward=forward,
                 card_vs_cpu=card_vs_cpu),
            {"audio_bf16_train": train_launches, "audio_bf16_preencode": pre_launches,
             "audio_bf16_flow": flow_launches, "audio_bf16_serve": serve_launches})


# ---------------------------------------------------------------------------
# The sampler's web UI and the quality-runs tool
# ---------------------------------------------------------------------------

WEBAPP_SAMPLES = 16            # one request: 16 samples, RK4 over 20 grid points, CFG 3.0
WEBAPP_STEPS = 20


def _get(url: str):
    import urllib.request
    with urllib.request.urlopen(url, timeout=120) as r:
        return r.status, r.headers.get("Content-Type"), r.read()


def webapp_phase(tmp: str, paths: dict, card: str, kernels: dict) -> tuple:
    """The sampler's web UI (the module docstring's step 31) in a thread on
    127.0.0.1, serving flowers_vqgan's CFG checkpoint from
    write_checkpoints: the form's fields, one POST of 16 samples at RK4 over
    20 grid points with CFG 3.0 (its status must not start with ERROR), the
    written PNGs served back byte for byte as image/png and a missing file
    as a 404, the images within 1e-4·max(1, |ref|) of a direct
    generate_samples call with the same config, and K1 launched once for
    each decoder call of the request. Returns (record, launches by tag)."""
    import threading
    import urllib.error
    import urllib.parse
    import urllib.request
    from flocoder_torch import generate_samples as gs
    from flocoder_torch.config import config_from_dict, parse_cli, to_dict
    from flocoder_torch.evaluation import DECODE_CHUNK
    from flocoder_torch.ui.webapp import METHODS, create_app

    config = parse_cli(["--config-name", "flowers_vqgan.yaml", "+seed=0"],
                       default_config=None, config_dir=gs.CONFIG_DIR)
    out = os.path.join(tmp, "webapp")
    server = create_app(config, out_dir=out)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    results = []
    generate = gs.generate_samples

    def recording(cfg):                       # keeps the request's own result
        results.append(generate(cfg))
        return results[-1]

    gs.generate_samples = recording
    form = dict(ckpt=paths["cfg"], n_samples=WEBAPP_SAMPLES, cfg=3.0, method="rk4",
                steps=WEBAPP_STEPS, seed=0, init_image="", init_strength=0.5)
    try:
        code, ctype, page = _get(base + "/")
        page = page.decode()
        missing = [f for f in ("ckpt", "n_samples", "cfg", "method", "steps", "seed",
                               "init_image", "init_strength") if f'name="{f}"' not in page]
        missing += [m for m in METHODS if f'value="{m}"' not in page]
        if code != 200 or missing:
            fail(f"webapp: the form page ({code}) lacks {missing}")
        torch.cuda.synchronize()
        _zero(kernels)
        t0 = time.time()
        with urllib.request.urlopen(base + "/generate", timeout=600,
                                    data=urllib.parse.urlencode(form).encode()) as r:
            body = r.read().decode()
        request_s = time.time() - t0
        launches = _counts(kernels)
        status = json.loads(_get(base + "/status")[2])
        if status.startswith("ERROR") or "ERROR" in body or len(results) != 1:
            fail(f"webapp: the request's status is {status[-1500:]!r}")
        names = sorted(n for n in os.listdir(out) if n.startswith("sample_"))
        if len(names) != WEBAPP_SAMPLES:
            fail(f"webapp: {len(names)} sample PNGs written, expected {WEBAPP_SAMPLES}")
        for name in names:
            code, ctype, data = _get(f"{base}/files/{name}")
            with open(os.path.join(out, name), "rb") as f:
                if (code, ctype, data) != (200, "image/png", f.read()):
                    fail(f"webapp: /files/{name} served {code} {ctype}, not the file")
            if f'src="/files/{name}"' not in body:
                fail(f"webapp: the gallery lacks {name}")
        try:
            urllib.request.urlopen(base + "/files/nope.png", timeout=60)
            fail("webapp: a missing file was served")
        except urllib.error.HTTPError as e:
            if e.code != 404:
                fail(f"webapp: a missing file gave {e.code}, not 404")
    finally:
        gs.generate_samples = generate
        server.shutdown()
        server.server_close()
    res = results[0]
    batches = [min(WEBAPP_SAMPLES, 64)]        # the UI's batch: min(samples, 64)
    _expect(kernels, "webapp", launches,
            na2d_fwd=sum(-(-b // DECODE_CHUNK) for b in batches))
    cfg = to_dict(config)
    cfg.update(flow_checkpoint=paths["cfg"], n_samples=WEBAPP_SAMPLES, cfg_strength=3.0,
               n_steps=WEBAPP_STEPS, seed=0, method="rk4", batch_size=batches[0],
               output_dir=os.path.join(tmp, "webapp_direct"), init_image=None,
               init_strength=0.5)
    direct = gs.generate_samples(config_from_dict(cfg))
    imgs, ref = res["images"], direct["images"]
    err = float(np.abs(imgs - ref).max() / max(1.0, float(np.abs(ref).max())))
    if imgs.shape != (WEBAPP_SAMPLES, 128, 128, 3) or not np.isfinite(imgs).all() \
            or not err <= 1e-4:
        fail(f"webapp: images {imgs.shape} against the direct call's: max |Δ| / "
             f"max(1, |ref|) = {err:.3e} (tol 1e-4)")
    rec = dict(samples=WEBAPP_SAMPLES, n_steps=WEBAPP_STEPS, method="rk4", cfg_strength=3.0,
               nfe=res["nfe"], request_s=request_s, batch_seconds=res["batch_seconds"],
               direct_batch_seconds=direct["batch_seconds"], status=status,
               max_rel_err_vs_direct=err, card=card)
    print(f"webapp flowers_vqgan: one request of {WEBAPP_SAMPLES} samples (RK4, "
          f"{WEBAPP_STEPS} grid points, nfe={res['nfe']}, CFG 3.0) {request_s:.4f} s; the "
          f"generation's batch_seconds {[round(x, 4) for x in res['batch_seconds']]} (a "
          f"direct call {[round(x, 4) for x in direct['batch_seconds']]}); images against the "
          f"direct call {err:.3e} of max(1, |ref|) | card: {card}", flush=True)
    return rec, launches


QUALITY_SMOKE = {     # tiny budgets: the payloads and the device path, not quality
    "unet_vs_hdit": dict(steps=8, hdit_budget_x=1, eval_steps=4),
    "meanflow": dict(steps=8, eval_steps=4),
    "reflow": dict(steps=8, pair_batches=1, eval_steps=4),
    "audio": dict(steps=4, gan_steps=4),
    "image": dict(steps=8, hdit_budget_x=1, reflow_steps=4, pair_batches=1, eval_steps=4),
}


def _same_keys(ours, ref, where: str) -> list:
    """Where a dict of ``ref`` (at any depth) has keys that ``ours`` lacks."""
    if not isinstance(ref, dict):
        return []
    if not isinstance(ours, dict):
        return [where]
    bad = [f"{where}.{k}" for k in ref if k not in ours]
    for k in ref:
        if k in ours:
            bad += _same_keys(ours[k], ref[k], f"{where}.{k}")
    return bad


def _numbers(node):
    if isinstance(node, dict):
        for v in node.values():
            yield from _numbers(v)
    elif isinstance(node, list):
        for v in node:
            yield from _numbers(v)
    elif isinstance(node, (int, float)) and not isinstance(node, bool):
        yield node


def quality_phase(tmp: str, root: str, card: str, kernels: dict) -> tuple:
    """The quality-runs tool's five families on the card at tiny budgets
    (QUALITY_SMOKE; the module docstring's step 32) into the temporary
    directory: each payload holds the JAX artifact's keys
    (eval_out/quality/<family>.json) at every depth, every number finite,
    the image family's FID on rp2048; K1–K5 launch 0 times. Returns
    (record, launches by tag)."""
    from flocoder_torch import quality_runs as qr

    out = os.path.join(tmp, "quality")
    rec = {}
    torch.cuda.synchronize()
    _zero(kernels)
    for family, sizes in QUALITY_SMOKE.items():
        t0 = time.time()
        qr.FAMILIES[family](**sizes, device="cuda", out=out)
        wall = time.time() - t0
        with open(os.path.join(out, f"{family}.json")) as f:
            ours = json.load(f)
        with open(os.path.join(root, "eval_out", "quality", f"{family}.json")) as f:
            ref = json.load(f)
        bad = _same_keys(ours, ref, family)
        if bad or not all(np.isfinite(v) for v in _numbers(ours)):
            fail(f"quality {family}: keys missing {bad[:8]}, or a number is not finite")
        if ours["device"]["type"] != "cuda" or (family == "image"
                                                and ours["fid_backend"] != "rp2048"):
            fail(f"quality {family}: device {ours['device']}, "
                 f"FID backend {ours.get('fid_backend')}")
        rec[family] = dict(sizes=sizes, wall_s=wall, summary=ours["summary"])
        print(f"quality {family} {sizes}: {wall:.1f} s, payload keys as "
              f"eval_out/quality/{family}.json | card: {card}", flush=True)
    launches = _counts(kernels)
    _expect(kernels, "quality", launches)
    torch.cuda.empty_cache()
    return rec, launches


# ---------------------------------------------------------------------------
# The parallel layer's data axis: two ranks on the card, and NCCL as a world
# of one
# ---------------------------------------------------------------------------

DP_RANKS = 2
DP_GAN_BATCH = 64              # the codec GAN step's global batch (32 a rank)
DP_SERVE = 64                  # sharded serving's samples, one batch
DP_PE_BATCH = 32               # the fused pre-encode's batch (16 a rank)
DP_MU_REL = 1e-3               # a first moment's tolerance: of its own tensor's largest |μ|
DP_MU_FLOOR = 1e-5             # plus this share of its model's largest |μ|
DP_NORM_REL = 1e-4             # a pre-clip gradient norm's, of one process's


def _max_rel(ours: dict, ref: dict) -> tuple:
    """The worst tensor of ``ours`` against ``ref`` (same keys) by
    max|Δ| / max(1, max|ref|): (key, err, tol at 1e-3)."""
    worst = ("", 0.0, 1e-3)
    for k, r in ref.items():
        r = np.asarray(r, np.float64)
        err = float(np.abs(np.asarray(ours[k], np.float64) - r).max())
        tol = 1e-3 * max(1.0, float(np.abs(r).max()))
        if not np.isfinite(err) or err / tol > worst[1] / worst[2]:
            worst = (k, err, tol)
    return worst


def _worst_moment(ours: dict, ref: dict) -> tuple:
    """Adam's first moments of one model (``ours``, same keys as ``ref``;
    numpy arrays or tensors) against one process's: each tensor within
    DP_MU_REL of its own largest |μ_ref| plus DP_MU_FLOOR of the model's
    largest. Returns the worst by err/tol: (key, err, tol, its own largest
    |μ_ref|, the model's)."""
    ours = {k: torch.as_tensor(v).double() for k, v in ours.items()}
    ref = {k: torch.as_tensor(v).double() for k, v in ref.items()}
    own = {k: float(r.abs().max()) if r.numel() else 0.0 for k, r in ref.items()}
    peak = max(own.values())
    worst = ("", 0.0, 1.0, 0.0, peak)
    for k, r in ref.items():
        err = float((ours[k].to(r.device) - r).abs().max()) if r.numel() else 0.0
        tol = DP_MU_REL * own[k] + DP_MU_FLOOR * peak
        if not np.isfinite(err) or err / tol > worst[1] / worst[2]:
            worst = (k, err, tol, own[k], peak)
    return worst


def _record_norms(state, into: list) -> None:
    """Wraps the optimizers' ``step`` of a codec state to append (name, the
    gradients' global norm before clipping) to ``into`` at each call."""
    for name in ("opt_d", "opt_g"):
        opt = getattr(state, name)

        def step(count=0, _step=opt.step, _name=name):
            norm = _step(count)
            into.append((_name, norm.detach().clone()))
            return norm

        opt.step = step


def _flow_mu(state) -> dict:
    """Adam's first moments of a flow state's model in ``to_jax_flat``'s
    keys (zeros where there is none); an FSDP state's gathered whole."""
    from flocoder_torch.training.checkpoint import UNET_PREFIXES, adam_to_jax_flat
    flat = adam_to_jax_flat(state.model, state.opt.adam, state.step, UNET_PREFIXES)
    return {k[len("1/0/mu/"):]: v for k, v in flat.items() if k.startswith("1/0/mu/")}


def _step_ms(fn) -> float:
    """One call of ``fn`` by CUDA events."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


def dp_job(tmp: str, paths: dict, pe_data: str) -> dict:
    """The dp phase's inputs, written to ``<tmp>/dp/job.pt`` for the ranks:
    the codec checkpoint and an RVQ state for it, initialised with three
    codes a level that start dead (so that the GAN step reseeds them from
    the injected picks, rows of batch rank 0's images) and its injected
    draws; the discriminator's seeded weights; 64 images; the 256 latents,
    global draws and U-Net of the flow steps; 32 images to pre-encode; the
    serving checkpoint."""
    from flocoder_torch.models.discriminator import (VQGANPlusPatchDiscriminator,
                                                     init_discriminator)
    from flocoder_torch.training.checkpoint import (UNET_PREFIXES, load_checkpoint,
                                                    load_jax_flat, subtree)
    from flocoder_torch.models.unet import Unet

    d = os.path.join(tmp, "dp")
    os.makedirs(d, exist_ok=True)
    rng = np.random.default_rng(17)
    cb = load_checkpoint(paths["codec"])["model_state_dict"]["vq/codebooks"].astype(np.float32)
    L, K, D = cb.shape
    counts = rng.uniform(4, 30, (L, K)).astype(np.float32)
    counts[:, :3] = 0.5
    rvq = {"codebooks": cb, "ema_counts": counts,
           "ema_sums": (cb * counts[..., None]).astype(np.float32),
           "initted": np.asarray(True)}
    tokens_rank0 = (DP_GAN_BATCH // DP_RANKS) * 16 * 16
    draws = {"kmeans_seeds": rng.integers(0, tokens_rank0, (L, K)),
             "reseed_picks": rng.integers(0, tokens_rank0, (L, K))}
    disc = init_discriminator(VQGANPlusPatchDiscriminator(in_channels=3),
                              torch.Generator().manual_seed(2))
    batch = _flow_batch(os.path.join(f"{pe_data}_encoded_vqgan", "train"))
    flat = load_checkpoint(paths["cfg"])["model_state_dict"]
    unet = Unet(dim=16, channels=4, dim_mults=(1, 2, 4, 8), n_classes=102)
    load_jax_flat(unet, subtree(flat, "model/"), UNET_PREFIXES)
    g = torch.Generator().manual_seed(18)
    shape, n = tuple(batch["target"].shape), batch["target"].shape[0]
    job = {"codec": paths["codec"], "rvq": rvq, "draws": draws, "out": d,
           "images": rng.uniform(-1, 1, (DP_GAN_BATCH, 128, 128, 3)).astype(np.float32),
           "disc": disc.state_dict(), "unet": unet.state_dict(),
           "flow_batch": {k: v.cpu() for k, v in batch.items()},
           "flow_draws": {"noise": torch.randn(shape, generator=g),
                          "t_uniform": torch.rand(n, generator=g),
                          "cfg_noise": torch.randn(shape, generator=g)},
           "pe_images": rng.uniform(0, 1, (DP_PE_BATCH, 128, 128, 3)).astype(np.float32),
           "serve_ckpt": paths["cfg"]}
    torch.save(job, os.path.join(d, "job.pt"))
    return job


def _checksums(tensors: dict) -> dict:
    """A checksum of each tensor's bits, on the card: the 32-bit words
    weighted by their position modulo a prime (any flipped bit moves it)."""
    out = {}
    for k, t in tensors.items():
        t = torch.as_tensor(t, device="cuda")
        bits = t.contiguous().view(-1).view(torch.uint8)
        bits = bits[:bits.numel() // 4 * 4].view(torch.int32).to(torch.int64)
        w = torch.arange(bits.numel(), device=bits.device) % 1009 + 1
        out[k] = int((bits * w).sum())
    return out


def _worst_on_card(ours: dict, ref: dict) -> tuple:
    """``_max_rel`` of tensors on the card: (key, err, tol at 1e-3)."""
    worst = ("", 0.0, 1e-3)
    for k, r in ref.items():
        r = r.double()
        err = float((ours[k].double() - r).abs().max())
        tol = 1e-3 * max(1.0, float(r.abs().max()))
        if not np.isfinite(err) or err / tol > worst[1] / worst[2]:
            worst = (k, err, tol)
    return worst


def dp_rank(rank: int, world: int, root: str, job_path: str, port: int) -> None:
    """One rank of the dp phase on cuda:0, in the world that torchrun's
    variables describe (rendezvous on localhost:``port``; two ranks on one
    card, so ``maybe_init_distributed`` takes gloo). Drives, with its launch
    counts zeroed before and read after each part: the codec GAN step on its 32 images; the
    data-parallel and the FSDP flow steps (then the FSDP state's sharded
    checkpoint); generate_samples.main of 64 samples, sharded; the fused
    encode of its 16 rows of a batch of 32. Rank 0 also computes the
    one-process references in turn (the other rank idle, both ranks'
    memory freed): the GAN step on all 64 images with the ranks' RVQ picks,
    the flow steps' documented functions; it holds its state against them
    and every rank's replicated state against its own, hash for hash.
    Writes its record beside the job."""
    import faulthandler
    import torch.distributed as dist
    t_rank = time.time()
    faulthandler.enable()               # a native crash still prints where it was
    sys.path.insert(0, root)
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK="0",
                      LOCAL_WORLD_SIZE=str(world), MASTER_ADDR="127.0.0.1",
                      MASTER_PORT=str(port))
    from flocoder_torch.parallel import mesh as pm
    if pm.maybe_init_distributed() != torch.device("cuda:0") or dist.get_backend() != "gloo":
        raise RuntimeError(f"dp rank {rank}: {dist.get_backend()} world, not gloo on cuda:0")
    job = torch.load(job_path, weights_only=False)
    d = job["out"]
    # TF32 off in the training parts: the ranks' halves and one process's
    # whole batch then agree to fp32 rounding
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from flocoder_torch import generate_samples as gs
    from flocoder_torch import train_flow as tf
    from flocoder_torch.config import load_config
    from flocoder_torch.generate_samples import CONFIG_DIR
    from flocoder_torch.models.codecs import setup_codec
    from flocoder_torch.models.discriminator import VQGANPlusPatchDiscriminator
    from flocoder_torch.models.perceptual import make_perceptual_fn
    from flocoder_torch.models.unet import Unet
    from flocoder_torch.ops.kernels import fused_vq as fvk
    from flocoder_torch.ops.kernels.na2d import na2d_bwd, na2d_fwd
    from flocoder_torch.training.checkpoint import (UNET_PREFIXES, VQVAE_PREFIXES,
                                                    load_checkpoint, load_jax_flat,
                                                    save_checkpoint_sharded, to_jax_flat)
    from flocoder_torch.training.flow import (create_flow_state, make_flow_train_step,
                                              shard_flow_state)
    from flocoder_torch.training.vqgan import create_vqgan_state, make_vqgan_gan_step

    kernels = {"na2d_fwd": na2d_fwd, "na2d_bwd": na2d_bwd,
               "fused_compress_vq": fvk.fused_compress_vq,
               "fused_compress_tail_vq": fvk.fused_compress_tail_vq,
               "fused_compress_tail_vq_bf16": fvk.fused_compress_tail_vq_bf16,
               "compress_tail_debug": fvk.compress_tail_debug}
    for k in kernels.values():
        k.build()                       # the libraries the parent built: loaded
    mesh = pm.make_mesh(device="cuda")
    rec, parts = {"rank": rank}, {}
    cfg = load_config("flowers_vqgan.yaml", CONFIG_DIR, [f"codec.checkpoint={job['codec']}"])
    codec_flat = load_checkpoint(job["codec"])["model_state_dict"]

    def gan_state():
        codec = setup_codec(cfg, device="cuda")
        load_jax_flat(codec, codec_flat, VQVAE_PREFIXES)
        codec.vq.assign_({k: torch.from_numpy(v).cuda() for k, v in job["rvq"].items()})
        disc = VQGANPlusPatchDiscriminator(in_channels=3).cuda()
        disc.load_state_dict({k: v.cuda() for k, v in job["disc"].items()})
        return create_vqgan_state(codec, disc, 1e-4)

    def gan_tensors(state) -> dict:
        """Copies on the card: each group's tensors by name (the codec's
        and discriminator's parameters and buffers, Adam's first moments)."""
        def moments(module, opt):
            return {n: (opt.state_of(p)["exp_avg"] if opt.state_of(p) else torch.zeros_like(p))
                    .detach().clone() for n, p in module.named_parameters()}
        return {"codec": {k: v.detach().clone() for k, v in state.codec.state_dict().items()},
                "disc": {k: v.detach().clone() for k, v in state.disc.state_dict().items()},
                "codec_mu": moments(state.codec, state.opt_g),
                "disc_mu": moments(state.disc, state.opt_d)}

    def replicated(name: str, groups: dict) -> None:
        """Every rank's replicated state the same, checksum for checksum."""
        sums = [None] * world
        dist.all_gather_object(sums, {g: _checksums(t) for g, t in groups.items()})
        rec.setdefault("replicated", {})[name] = all(x == sums[0] for x in sums)

    # the codec GAN step on this rank's rows, its RVQ picks recorded
    print(f"dp rank {rank}: codec GAN step at {time.time() - t_rank:.1f} s", flush=True)
    stamps = {}

    def stamp(name):
        torch.cuda.synchronize()
        stamps[name] = round(time.time() - t_rank, 2)

    perc = make_perceptual_fn(seed=0, device="cuda")
    step = make_vqgan_gan_step(cfg, perc, mesh=mesh, deterministic=True)
    stamp("perceptual")
    state = gan_state()
    stamp("gan_state")
    x = torch.from_numpy(pm.shard_batch(mesh, job["images"])).cuda()
    own, norms = [], []
    _record_norms(state, norms)
    _zero(kernels)
    with forced_picks(None, own):
        _, aux, idx = step(state, x, torch.Generator("cuda"), **job["draws"])
    torch.cuda.synchronize()
    parts["gan"] = _counts(kernels)
    stamp("gan_step")
    picks = [pm.gather_rows(torch.from_numpy(o[0]).cuda(), mesh).cpu().numpy() for o in own]
    mine = gan_tensors(state)
    replicated("gan", mine)
    stamp("checksums")
    rec["gan"] = {"aux": {k: float(v) for k, v in aux.items()},
                  "norms": {n: float(v) for n, v in norms},
                  "rvq": {k: getattr(state.codec.vq, k).cpu().numpy()
                          for k in ("codebooks", "ema_counts", "ema_sums")},
                  "idx": pm.gather_rows(idx, mesh).cpu().numpy()}
    rec["gan"]["step_ms"] = _step_ms(lambda: step(state, x, torch.Generator("cuda"),
                                                  **job["draws"]))
    if rank == 0:       # the parent starts the NCCL run, whose start-up is imports
        open(os.path.join(d, "gan_steps_timed"), "w").close()
    del state, x
    torch.cuda.empty_cache()
    dist.barrier()
    if rank == 0:
        # one process: all 64 images, the ranks' picks forced (the halves'
        # encodes differ from the whole's in the last bits, which can flip a
        # pick at a near tie); its own nearest codes are counted and held to
        # be near ties
        one = make_vqgan_gan_step(cfg, perc, deterministic=True)
        state = gan_state()
        xb = torch.from_numpy(job["images"]).cuda()
        ref_own, ref_norms = [], []
        _record_norms(state, ref_norms)
        stamp("reference_state")
        with forced_picks(picks, ref_own):
            _, ref_aux, ref_idx = one(state, xb, torch.Generator("cuda"), **job["draws"])
        stamp("reference_step")
        ref = gan_tensors(state)
        rec["gan"].update(
            ref_aux={k: float(v) for k, v in ref_aux.items()},
            ref_norms={n: float(v) for n, v in ref_norms[:2]},
            worst={k: (_worst_moment if k.endswith("_mu") else _worst_on_card)(mine[k], ref[k])
                   for k in ref},
            idx_equal=bool(np.array_equal(rec["gan"]["idx"], ref_idx.cpu().numpy())),
            ref_flips=int(sum((o[0] != p).sum() for p, o in zip(picks, ref_own))),
            pick_gap=worst_pick_gap(picks, ref_own),
            ref_rvq={k: ref["codec"][f"vq.{k}"].cpu().numpy()
                     for k in ("ema_counts", "ema_sums")},
            one_process_ms=_step_ms(lambda: one(state, xb, torch.Generator("cuda"),
                                                **job["draws"])))
        stamp("reference_held_and_timed")
        del state, xb, ref
    del mine
    torch.cuda.empty_cache()
    dist.barrier()
    rec["stamps"] = stamps

    # the flow steps: data-parallel (its rows, its draws), then FSDP
    print(f"dp rank {rank}: flow steps at {time.time() - t_rank:.1f} s", flush=True)
    batch = {k: v.cuda() for k, v in job["flow_batch"].items()}
    draws = {k: v.cuda() for k, v in job["flow_draws"].items()}
    unet = Unet(dim=16, channels=4, dim_mults=(1, 2, 4, 8), n_classes=102).cuda()
    unet.load_state_dict({k: v.cuda() for k, v in job["unet"].items()})
    drop = torch.tensor(False, device="cuda")
    refs = {}
    if rank == 0:       # the documented functions: per-rank microbatches; the global batch
        per = batch["target"].shape[0] // world
        rank_draws = [{k: v[r * per:(r + 1) * per] for k, v in draws.items()}
                      for r in range(world)]
        for name, kw, draws_of in (("dp", dict(grad_accum=world), rank_draws),
                                   ("fsdp", {}, [draws])):
            st = create_flow_state(copy.deepcopy(unet), 1e-4)
            fstep = make_flow_train_step(**kw)
            _, faux = fstep(st, batch, None, draws=draws_of, drop=drop)
            refs[name] = {"aux": {k: float(v) for k, v in faux.items()},
                          "params": to_jax_flat(st.model, UNET_PREFIXES),
                          "ema": to_jax_flat(st.ema, UNET_PREFIXES), "mu": _flow_mu(st),
                          "step_ms": _step_ms(lambda: fstep(st, batch, None, draws=draws_of,
                                                            drop=drop))}
            del st
    rec["flow"] = {}
    _zero(kernels)
    for name, fsdp in (("dp", False), ("fsdp", True)):
        st = create_flow_state(copy.deepcopy(unet), 1e-4)
        dims = shard_flow_state(st, mesh) if fsdp else {}
        fstep = make_flow_train_step(mesh=mesh, fsdp=fsdp)
        mine = pm.shard_batch(mesh, batch)
        dr = [draws if fsdp else pm.shard_batch(mesh, draws)]
        _, faux = fstep(st, mine, None, draws=dr, drop=drop)
        ours = {"params": to_jax_flat(st.model, UNET_PREFIXES),
                "ema": to_jax_flat(st.ema, UNET_PREFIXES), "mu": _flow_mu(st)}
        replicated(f"flow_{name}", {g: {k: torch.from_numpy(np.ascontiguousarray(v))
                                        for k, v in t.items()} for g, t in ours.items()})
        r = {"aux": {k: float(v) for k, v in faux.items()},
             "sharded": sum(v is not None for v in dims.values()), "params": len(dims)}
        if rank == 0:
            r.update(ref=refs[name]["aux"], one_process_ms=refs[name]["step_ms"],
                     worst={k: (_worst_moment if k == "mu" else _max_rel)(ours[k], refs[name][k])
                            for k in ours})
        r["step_ms"] = _step_ms(lambda: fstep(st, mine, None, draws=dr, drop=drop))
        if fsdp:       # after the timed step: the state the checkpoint holds
            save_checkpoint_sharded(tf._sharded_tree(st), 2, ckpt_dir=os.path.join(d, "ck"))
            whole = {f"params/{k}": v for k, v in to_jax_flat(st.model, UNET_PREFIXES).items()}
            whole.update({f"ema/{k}": v for k, v in to_jax_flat(st.ema, UNET_PREFIXES).items()})
            whole.update({f"opt_state/{k}": v for k, v in tf._opt_flat(st).items()})
            if rank == 0:
                np.savez(os.path.join(d, "whole.npz"), **whole)
        rec["flow"][name] = r
        del st
    parts["flow"] = _counts(kernels)
    del unet, batch, draws
    torch.cuda.empty_cache()

    # sharded serving through the entry point
    print(f"dp rank {rank}: sharded serving at {time.time() - t_rank:.1f} s", flush=True)
    torch.backends.cudnn.allow_tf32 = True      # PyTorch's default, as the parent's
    _zero(kernels)
    served = gs.main(["--config-name", "flowers_vqgan.yaml", "+device=cuda:0",
                      f"+flow_checkpoint={job['serve_ckpt']}", f"+n_samples={DP_SERVE}",
                      "+n_steps=20", f"flow.batch_size={DP_SERVE}", "+seed=0",
                      f"+output_dir={os.path.join(d, 'samples')}"])
    parts["serve"] = _counts(kernels)
    rec["serve"] = {"seed": pm.rank_seed(0, mesh), "batch_s": served["batch_seconds"],
                    "nfe": served["nfe"]}
    if rank == 0:
        np.save(os.path.join(d, "served.npy"), served["images"])

    # the fused pre-encode of one batch: K3 on this rank's rows
    print(f"dp rank {rank}: fused pre-encode at {time.time() - t_rank:.1f} s", flush=True)
    pcodec = gs.load_models_once(cfg, job["serve_ckpt"], torch.device("cuda:0"))["codec"]
    xs = torch.from_numpy(pm.shard_batch(mesh, job["pe_images"])).cuda()
    _zero(kernels)
    with torch.inference_mode():
        zq, pidx = pcodec.encode_quantize_fused(xs)
        zq, pidx = pm.gather_rows(zq, mesh), pm.gather_rows(pidx, mesh)
    torch.cuda.synchronize()
    parts["preencode"] = _counts(kernels)
    if rank == 0:
        np.savez(os.path.join(d, "encoded.npz"), zq=zq.float().cpu().numpy(),
                 idx=pidx.cpu().numpy())
    rec["launches"] = parts
    dist.destroy_process_group()
    torch.save(rec, os.path.join(d, f"rank{rank}.pt"))


def nccl_world_of_one(root: str, pe_data: str) -> dict:
    """Starts train_flow in the background under ``torchrun --standalone
    --nproc_per_node=1``: the NCCL backend, flowers_vqgan's flow at full
    width with flow.fsdp=true and flow.sharded_checkpoints=true, one epoch
    of 4 steps (B=256) on the pre-encode phase's latents, no evaluation
    (the codec stays seeded). Its start-up takes ~35 s (torch imported by
    the launcher and the worker, FSDP2's first use). Its output goes to
    files (a pipe could fill and stall it). Returns the handle
    ``nccl_result`` reads."""
    d = tempfile.mkdtemp(prefix="chip_smoke_nccl_")
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc_per_node=1", "-m", "flocoder_torch.train_flow",
           "--config-name", "flowers_vqgan.yaml", f"data={pe_data}",
           "flow.unet.n_classes=102", "flow.epochs=1", "flow.ckpt_every=1",
           "flow.no_eval=true", "flow.fsdp=true", "flow.sharded_checkpoints=true",
           "+seed=0", f"+ckpt_dir={os.path.join(d, 'ck')}",
           f"+output_dir={os.path.join(d, 'out')}"]
    out, err = open(os.path.join(d, "stdout"), "w"), open(os.path.join(d, "stderr"), "w")
    proc = subprocess.Popen(cmd, cwd=d, stdout=out, stderr=err,
                            env={**os.environ, "PYTHONPATH": root})
    return {"proc": proc, "dir": d, "files": (out, err), "t0": time.time()}


def nccl_stop(h: dict) -> None:
    """Stops the NCCL run if it still runs, and removes its folder."""
    if h["proc"].poll() is None:
        h["proc"].kill()
        h["proc"].wait()
    for f in h["files"]:
        f.close()
    shutil.rmtree(h["dir"], ignore_errors=True)


def nccl_result(h: dict, card: str) -> dict:
    """Waits for the NCCL run (started by nccl_world_of_one) and reads its
    sharded checkpoint back whole."""
    from flocoder_torch.training.checkpoint import load_checkpoint_sharded
    try:
        h["proc"].wait(timeout=300)
        wall = time.time() - h["t0"]
        for f in h["files"]:
            f.flush()
        with open(os.path.join(h["dir"], "stdout")) as f:
            out = f.read()
        if h["proc"].returncode:
            with open(os.path.join(h["dir"], "stderr")) as f:
                print(out[-4000:], f.read()[-4000:], sep="\n", flush=True)
            fail(f"train_flow under torchrun (NCCL, a world of one) exited "
                 f"{h['proc'].returncode}")
        lines = [ln for ln in out.splitlines()
                 if ln.startswith(("train_flow: mesh", "FSDP:", "epoch 1/1", "done in"))]
        if len(lines) != 4 or "FSDP step" not in lines[0]:
            fail(f"train_flow under torchrun did not run the FSDP step: {lines}")
        state = load_checkpoint_sharded(os.path.join(h["dir"], "ck"), "flow_", 1)["state"]
        if not (any(k.startswith("params/") for k in state) and all(
                np.isfinite(v).all() for v in state.values()
                if np.issubdtype(np.asarray(v).dtype, np.floating))):
            fail("the NCCL run's sharded checkpoint is empty or not finite")
    finally:
        nccl_stop(h)
    print(f"dp nccl: torchrun --nproc_per_node=1 train_flow flow.fsdp=true "
          f"flow.sharded_checkpoints=true: {' | '.join(lines)}; checkpoint "
          f"{len(state)} leaves read back; {wall:.1f} s from its start, beside the ranks "
          f"once their GAN steps were timed, then beside step 8's checks | card: {card}",
          flush=True)
    return {"wall_s": wall, "lines": lines, "checkpoint_leaves": len(state), "card": card}


def dp_phase(tmp: str, paths: dict, pe_data: str, root: str, card: str,
             kernels: dict) -> tuple:
    """The parallel layer's data axis on the card (step 33): two ranks on
    the one H100 in a gloo world (NCCL takes one rank a device), started by
    torch.multiprocessing (dp_rank), and, once their data-parallel GAN
    steps are timed, the NCCL world of one (nccl_world_of_one). A rank that
    fails makes the join raise and the script exit non-zero. Returns
    (record, launches summed over the ranks, the NCCL run's handle, which
    nccl_result reads once the caller has run step 8's checks beside it)."""
    import torch.multiprocessing as mp
    from flocoder_torch import generate_samples as gs
    from flocoder_torch.config import ldcfg, load_config
    from flocoder_torch.evaluation import sampler
    from flocoder_torch.generate_samples import CONFIG_DIR
    from flocoder_torch.training.checkpoint import load_checkpoint_sharded

    t0 = time.time()
    job = dp_job(tmp, paths, pe_data)
    d = job["out"]
    torch.cuda.empty_cache()
    t1 = time.time()
    with socket.socket() as sock:       # a free port on localhost for the rendezvous
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    ctx = mp.start_processes(dp_rank, args=(DP_RANKS, root, os.path.join(d, "job.pt"), port),
                             nprocs=DP_RANKS, join=False, start_method="spawn")
    nccl = None
    try:
        # its start-up (imports) runs beside the ranks once their
        # data-parallel GAN steps are timed
        while not ctx.join(timeout=0.5):
            if nccl is None and os.path.exists(os.path.join(d, "gan_steps_timed")):
                nccl = nccl_world_of_one(root, pe_data)
        if nccl is None:
            nccl = nccl_world_of_one(root, pe_data)
    except BaseException:
        if nccl is not None:
            nccl_stop(nccl)
        raise
    t_ranks = time.time() - t1
    try:
        recs = [torch.load(os.path.join(d, f"rank{r}.pt"), weights_only=False)
                for r in range(DP_RANKS)]

        # launches: each rank's as one process's step (6 K1 + 6 K2), one decode
        # (1 K1), one fused encode (5 K1 + 1 K3); the flow steps run none
        for r in recs:
            for part, want in (("gan", dict(na2d_fwd=6, na2d_bwd=6)), ("flow", {}),
                               ("serve", dict(na2d_fwd=1)),
                               ("preencode", dict(na2d_fwd=5, fused_compress_tail_vq=1))):
                _expect(kernels, f"dp rank {r['rank']} {part}", r["launches"][part], **want)
            if not all(r["replicated"].values()):
                fail(f"dp rank {r['rank']}: replicated state differs between the ranks: "
                     f"{r['replicated']}")
        # the codec GAN step (rank 0 holds its state to one process's)
        g = recs[0]["gan"]
        for k, v in g["ref_aux"].items():
            for r in recs:
                if not abs(r["gan"]["aux"][k] - v) < 1e-3 * max(1.0, abs(v)):
                    fail(f"dp rank {r['rank']} GAN step loss {k}: {r['gan']['aux'][k]} vs {v}")
        for name, (k, err, tol, *_) in g["worst"].items():
            if not err < tol:
                fail(f"dp GAN step {name} {k}: {err:.3e} (tol {tol:.3e})")
        norm_worst = 0.0
        for r in recs:          # the gradients' norms before clipping, G's and D's
            for n, want in g["ref_norms"].items():
                rel = abs(r["gan"]["norms"][n] - want) / want
                norm_worst = max(norm_worst, rel)
                if not rel < DP_NORM_REL:
                    fail(f"dp rank {r['rank']} GAN step {n} gradient norm "
                         f"{r['gan']['norms'][n]} vs {want} ({rel:.3e} relative, tol "
                         f"{DP_NORM_REL})")
        if not (g["idx_equal"] and g["pick_gap"] < 1e-4):
            fail(f"dp GAN step: the ranks' VQ indices differ from one process's, or a pick "
                 f"of its own is no near tie (relative gap {g['pick_gap']:.3e})")
        rvq_worst = 0.0
        for k in ("codebooks", "ema_counts", "ema_sums"):
            if not np.array_equal(recs[0]["gan"]["rvq"][k], recs[1]["gan"]["rvq"][k]):
                fail(f"dp: the RVQ {k} differ between the ranks")
        for k, ref in g["ref_rvq"].items():
            ref = np.asarray(ref, np.float64)
            err = float(np.abs(g["rvq"][k] - ref).max() / max(np.abs(ref).max(), 1e-30))
            rvq_worst = max(rvq_worst, err)
            if not err < 1e-5:
                fail(f"dp: RVQ {k} {err:.3e} relative from one process's (tol 1e-5)")
        # the flow steps
        for name, f in recs[0]["flow"].items():
            for k in ("loss", "grad_norm"):
                for r in recs:
                    got, want = r["flow"][name]["aux"][k], f["ref"][k]
                    if not abs(got - want) < 1e-3 * max(1.0, abs(want)):
                        fail(f"dp rank {r['rank']} {name} flow step {k}: {got} vs {want}")
            for what, (k, err, tol, *_) in f["worst"].items():
                if not err < tol:
                    fail(f"dp {name} flow step {what} {k}: {err:.3e} (tol {tol:.3e})")
        fs = recs[0]["flow"]["fsdp"]
        if not 0 < fs["sharded"] < fs["params"]:
            fail(f"dp: FSDP sharded {fs['sharded']} of {fs['params']} parameters")
        # the sharded checkpoint, read back by this one process
        got = load_checkpoint_sharded(os.path.join(d, "ck"), "flow_", 2)["state"]
        with np.load(os.path.join(d, "whole.npz")) as f:
            whole = {k: f[k] for k in f.files}
        if set(got) != set(whole) or not all(np.array_equal(got[k], v) for k, v in whole.items()):
            fail("dp: the 2-rank sharded checkpoint read back is not the whole state")
        # sharded serving against one process given each rank's noise, with
        # the ranks' precision flags whatever an earlier phase left set
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = True
        cfg = load_config("flowers_vqgan.yaml", CONFIG_DIR,
                          [f"+flow_checkpoint={job['serve_ckpt']}", "+n_steps=20"])
        b = gs.load_models_once(cfg, job["serve_ckpt"], torch.device("cuda"))
        per = DP_SERVE // DP_RANKS
        imgs, grid = [], None
        for r in recs:
            gen = torch.Generator("cuda").manual_seed(r["serve"]["seed"])
            cols = torch.randint(0, b["n_classes"], (10,), generator=gen, device="cuda")
            grid = cols.repeat(-(-DP_SERVE // 10))[:DP_SERVE] if r["rank"] == 0 else grid
            rows = grid[r["rank"] * per:(r["rank"] + 1) * per]
            imgs.append(sampler(b["model"], b["codec"], gen, batch_size=per, n_steps=20,
                                cond={"class_cond": rows}, n_classes=b["n_classes"],
                                cfg_strength=float(ldcfg(cfg, "cfg_strength", 3.0)),
                                latent_shape=b["latent_shape"], t_scale=b["t_scale"])[1]
                        .float().cpu().numpy())
        ref_imgs = np.concatenate(imgs)
        served = np.load(os.path.join(d, "served.npy"))
        serve_err = float(np.abs(served - ref_imgs).max())
        serve_tol = 1e-4 * max(1.0, float(np.abs(ref_imgs).max()))
        if served.shape != (DP_SERVE, 128, 128, 3) or not serve_err < serve_tol:
            fail(f"dp serving: {served.shape}, max_abs_err {serve_err:.3e} (tol {serve_tol:.3e})")
        # the fused pre-encode against one process on each rank's rows
        zqs, idxs = [], []
        half = DP_PE_BATCH // DP_RANKS
        with torch.inference_mode():
            for r in range(DP_RANKS):
                zq, idx = b["codec"].encode_quantize_fused(
                    torch.from_numpy(job["pe_images"][r * half:(r + 1) * half]).cuda())
                zqs.append(zq.float().cpu().numpy())
                idxs.append(idx.cpu().numpy())
        with np.load(os.path.join(d, "encoded.npz")) as f:
            if not (np.array_equal(f["idx"], np.concatenate(idxs))
                    and np.array_equal(f["zq"], np.concatenate(zqs))):
                fail("dp pre-encode: the ranks' latents or indices differ from one process's")
        del b
        torch.cuda.empty_cache()
        t_holds = time.time() - t1 - t_ranks
    except BaseException:
        nccl_stop(nccl)         # a failed hold leaves no process behind
        raise

    launches = {name: sum(sum(p[name] for p in r["launches"].values()) for r in recs)
                for name in kernels}
    per_rank = [{name: sum(p[name] for p in r["launches"].values()) for name in kernels}
                for r in recs]
    rec = {"ranks": DP_RANKS, "backend": "gloo (CUDA tensors)", "card": card,
           "launches_by_rank": per_rank,
           "gan": {"step_ms_ranks": [r["gan"]["step_ms"] for r in recs],
                   "step_ms_one_process": g["one_process_ms"], "worst": g["worst"],
                   "one_process_pick_flips": g["ref_flips"],
                   "worst_pick_gap": g["pick_gap"], "rvq_rel_err": rvq_worst,
                   "grad_norms_one_process": g["ref_norms"], "grad_norm_rel_err": norm_worst},
           "flow": {name: {"step_ms_ranks": [r["flow"][name]["step_ms"] for r in recs],
                           "step_ms_one_process": recs[0]["flow"][name]["one_process_ms"],
                           "worst": recs[0]["flow"][name]["worst"]}
                    for name in ("dp", "fsdp")},
           "fsdp_sharded": [fs["sharded"], fs["params"]],
           "serve": {"batch_s_ranks": [r["serve"]["batch_s"] for r in recs],
                     "max_abs_err": serve_err},
           "seconds": {"ranks": t_ranks, "holds": t_holds, "phase": time.time() - t0}}
    print(f"dp: 2 ranks (gloo, CUDA tensors) on one card: launches by rank {per_rank}; "
          f"codec GAN step (B=32 a rank) ms {rec['gan']['step_ms_ranks']} against one "
          f"process B={DP_GAN_BATCH} {g['one_process_ms']:.2f}; flow step (B=128 a rank) "
          f"ms data-parallel {rec['flow']['dp']['step_ms_ranks']} (one process, as 2 "
          f"microbatches, {rec['flow']['dp']['step_ms_one_process']:.2f}), FSDP "
          f"{rec['flow']['fsdp']['step_ms_ranks']} (one process "
          f"{rec['flow']['fsdp']['step_ms_one_process']:.2f}); FSDP sharded "
          f"{fs['sharded']} of {fs['params']} parameters; serving max_abs_err "
          f"{serve_err:.3e}; replicated state equal on the ranks, hash for hash; RVQ "
          f"statistics {rvq_worst:.3e} relative from one process (its own picks: "
          f"{g['ref_flips']} near ties flipped, worst relative gap {g['pick_gap']:.3e}) "
          f"| card: {card}", flush=True)
    moments = [(f"GAN {n}", w) for n, w in g["worst"].items() if n.endswith("_mu")] + [
        (f"flow {n} mu", recs[0]["flow"][n]["worst"]["mu"]) for n in ("dp", "fsdp")]
    print("dp holds: Adam first moments, each tensor within "
          f"{DP_MU_REL}·its own max|μ| + {DP_MU_FLOOR}·its model's, the worst by err/tol: "
          + "; ".join(f"{n} {k} err {e:.3e} (tol {t:.3e}; own max {o:.3e}, model's "
                      f"{p:.3e})" for n, (k, e, t, o, p) in moments)
          + f"; GAN gradient norms before clipping {g['ref_norms']}, worst rank "
          f"{norm_worst:.3e} relative (tol {DP_NORM_REL}) | card: {card}", flush=True)
    print("dp seconds: " + ", ".join(f"{k} {v:.1f}" for k, v in rec["seconds"].items())
          + f"; rank 0's GAN part by its clock {recs[0]['stamps']} | card: {card}", flush=True)
    return rec, launches, nccl


# ---------------------------------------------------------------------------
# The model axis: ring attention (step 34)
# ---------------------------------------------------------------------------

RING_RANKS = 2
# the ring op's shapes: HDiT's global level (flowers_hdit's NA variant: 4×4
# tokens, 8 heads of 64, B=256) and the VQGAN decoder's non-local attention
# (16×16 latents, one head, q and k of width 2, v of width 4, a decode's B=64)
RING_OP_SHAPES = {"hdit_global": (256, 16, 8, 64, 64), "decoder_nonlocal": (64, 256, 1, 2, 4)}


def ring_job(tmp: str, paths: dict, pe_data: str) -> dict:
    """The ring phase's inputs, written to ``<tmp>/ring/job.pt`` for the
    ranks: flowers_hdit's NA variant at full width with seeded weights,
    every parameter perturbed so that the zero-init projections carry
    signal, 256 of sd_preencode's latents and their draws; flowers_vqgan's
    class-conditional U-Net (the serving checkpoint) and 256 of the
    pre-encode phase's latents with theirs."""
    from flocoder_torch.config import load_config
    from flocoder_torch.generate_samples import CONFIG_DIR
    from flocoder_torch.models.flow_model import build_flow_model
    from flocoder_torch.models.layers import init_params
    from flocoder_torch.models.unet import Unet
    from flocoder_torch.training.checkpoint import (UNET_PREFIXES, load_checkpoint,
                                                    load_jax_flat, subtree)

    d = os.path.join(tmp, "ring")
    os.makedirs(d, exist_ok=True)
    cfg = load_config("flowers_hdit.yaml", CONFIG_DIR, HDIT_NA)
    hdit = init_params(build_flow_model(cfg, 4, 102), torch.Generator().manual_seed(30))
    g = torch.Generator().manual_seed(31)
    with torch.no_grad():
        for p in hdit.parameters():
            p.add_(0.02 * torch.randn(p.shape, generator=g))
    unet = Unet(dim=16, channels=4, dim_mults=(1, 2, 4, 8), n_classes=102)
    load_jax_flat(unet, subtree(load_checkpoint(paths["cfg"])["model_state_dict"], "model/"),
                  UNET_PREFIXES)
    job = {"out": d, "hdit": hdit.state_dict(), "unet": unet.state_dict()}
    for name, split in (("hdit", "sd"), ("unet", "vqgan")):
        batch = {k: v.cpu() for k, v in _flow_batch(
            os.path.join(f"{pe_data}_encoded_{split}", "train")).items()}
        shape, n = tuple(batch["target"].shape), batch["target"].shape[0]
        job[f"{name}_batch"] = batch
        job[f"{name}_draws"] = {"noise": torch.randn(shape, generator=g),
                                "t_uniform": torch.rand(n, generator=g),
                                "cfg_noise": torch.randn(shape, generator=g)}
    torch.save(job, os.path.join(d, "job.pt"))
    return job


def _ring_hold(ours: dict, ref: dict, after: dict, lr: float = 1e-4) -> dict:
    """A ring step's parameter changes and Adam's first moments (tensors on
    the card by name; ``after``: the reference's parameters after its step)
    against one process's: every moment within 1e-4 of its tensor's largest
    |μ_ref|, every change within 1e-4 of its tensor's largest |Δ_ref| plus
    two allowances that the held moments fix. (1) fp32's spacing at the
    parameter: a change is measured as the difference of two fp32
    parameters, which rounds each update to the parameter's ulp. (2) What
    Adam's first update, lr·g/(|g| + ε) with g = μ/(1 − β1), makes of the
    two gradients: near ε = 1e-8 it turns their last bits into a share of
    lr, and at a gradient of fp32's noise floor it may flip the sign.
    Returns the worst tensor of each by err/tol and the count of changes
    that needed an allowance."""
    from flocoder_torch.training.vqgan import ClippedAdam
    eps, b1 = ClippedAdam.eps, 0.9      # the flow optimizer's ε and β1

    def adam(mu):
        g = mu.double() / (1 - b1)
        return g / (g.abs() + eps)

    out, allowed = {}, 0
    for what in ("delta", "mu"):
        worst = ("", 0.0, 1.0)
        for k, r in ref[what].items():
            diff = (ours[what][k].double() - r.double()).abs()
            tol = 1e-4 * float(r.abs().max()) or 1e-30
            if what == "delta":
                a = after[k].detach().abs()
                spacing = (torch.nextafter(a, torch.full_like(a, float("inf"))) - a).double()
                extra = spacing + 1.01 * lr * (adam(ours["mu"][k]) - adam(ref["mu"][k])).abs()
                allowed += int((diff > tol).sum())
                diff = (diff - extra).clamp_min(0.0)
            err = float(diff.max()) if diff.numel() else 0.0
            if not np.isfinite(err) or err / tol > worst[1] / worst[2]:
                worst = (k, err, tol)
        out[what] = worst
    out["allowed"] = allowed
    return out


def ring_rank(rank: int, world: int, root: str, job_path: str, port: int) -> None:
    """One rank of the ring phase on cuda:0, in the world torchrun's
    variables describe (rendezvous on localhost:``port``; gloo, as two ranks
    share the card), a 1×2 mesh of the model axis. In order: the ring op at
    RING_OP_SHAPES, fp32 and bf16, against plain attention on the same
    inputs (each rank holds its own) and timed; flowers_hdit's bf16 step
    (the recipe) with the ring twin, timed, and flowers_vqgan's fp32 U-Net
    step (its recipe) with the ring at the bottleneck, timed; then, TF32
    off, one fp32 ring step of each, its state checksummed on both ranks.
    Rank 0 computes one process's references in turn (the other rank idle):
    plain attention timed, the plain steps timed, and the fp32 plain steps
    it holds the ring steps to. Launch counts a part, zeroed before and read
    after. Writes its record beside the job."""
    import faulthandler
    import torch.distributed as dist
    t_rank = time.time()
    faulthandler.enable()
    sys.path.insert(0, root)
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK="0",
                      LOCAL_WORLD_SIZE=str(world), MASTER_ADDR="127.0.0.1",
                      MASTER_PORT=str(port))
    from flocoder_torch.parallel import mesh as pm
    if pm.maybe_init_distributed() != torch.device("cuda:0") or dist.get_backend() != "gloo":
        raise RuntimeError(f"ring rank {rank}: {dist.get_backend()} world, not gloo on cuda:0")
    from flocoder_torch.config import load_config
    from flocoder_torch.generate_samples import CONFIG_DIR
    from flocoder_torch.models.flow_model import build_flow_model, ring_twin
    from flocoder_torch.models.unet import Unet
    from flocoder_torch.ops.kernels.na2d import na2d_bwd, na2d_fwd
    from flocoder_torch.parallel import ring_attention as ra
    from flocoder_torch.training.flow import create_flow_state, make_flow_train_step

    kernels = {"na2d_fwd": na2d_fwd, "na2d_bwd": na2d_bwd}
    for k in kernels.values():
        k.build()                       # the libraries the parent built: loaded
    job = torch.load(job_path, weights_only=False)
    mesh = pm.make_mesh(n_model=world, device="cuda")
    rec = {"rank": rank, "layout": [list(mesh.get_coordinate()), pm.batch_rank(mesh),
                                    pm.model_rank(pm.model_group(mesh))],
           "transport": dist.get_backend(pm.model_group(mesh)), "op": {}, "steps": {}}
    cfg = load_config("flowers_hdit.yaml", CONFIG_DIR, HDIT_NA)
    drop = torch.tensor(False, device="cuda")

    def replicated(tensors: dict) -> list:
        """The names of the tensors that differ between the ranks."""
        sums = [None] * world
        dist.all_gather_object(sums, _checksums(tensors))
        return sorted(k for k in sums[0] if any(s[k] != sums[0][k] for s in sums))

    # the op: each rank holds the ring against plain attention on the same inputs
    torch.backends.cuda.matmul.allow_tf32 = False
    for name, (b, n, h, d, dv) in RING_OP_SHAPES.items():
        for dt in (torch.float32, torch.bfloat16):
            g = torch.Generator("cuda").manual_seed(40)
            q, k = (torch.randn(b, n, h, d, generator=g, device="cuda") for _ in range(2))
            v, w = (torch.randn(b, n, h, dv, generator=g, device="cuda") for _ in range(2))
            res = {}
            for how in ("ring", "plain"):
                leaves = [t.detach().to(dt, copy=True).requires_grad_(True) for t in (q, k, v)]
                ra.reset_hops()
                out = (ra.ring_attention_replicated(*leaves, world) if how == "ring"
                       else ra._plain_attention(*leaves))
                (out.float() * w).sum().backward()
                res[how] = (out.detach().float(), [t.grad.float() for t in leaves],
                            [ra.HOPS["forward"], ra.HOPS["backward"]])
            (o, gr, hops), (o_ref, g_ref, _) = res["ring"], res["plain"]
            rel = lambda a, r: float((a - r).abs().max()) / max(1.0, float(r.abs().max()))  # noqa: E731
            errs = {"out": rel(o, o_ref), "dq": rel(gr[0], g_ref[0]), "dk": rel(gr[1], g_ref[1]),
                    "dv": rel(gr[2], g_ref[2])}
            tols = ({"out": 1e-5, "dq": 1e-4, "dk": 1e-4, "dv": 1e-4} if dt == torch.float32
                    else dict.fromkeys(errs, 2e-2))
            leaves = [t.detach().to(dt, copy=True).requires_grad_(True) for t in (q, k, v)]

            def call(fn=ra.ring_attention_replicated):
                (fn(*leaves, world).float() * w).sum().backward()

            call()
            rec["op"][f"{name}_{str(dt)[6:]}"] = {"errs": errs, "tols": tols, "hops": hops,
                                                 "ms": _step_ms(call)}
            del res, leaves
    torch.cuda.empty_cache()
    dist.barrier()
    if rank == 0:       # one process's plain attention, the other rank idle
        for name, (b, n, h, d, dv) in RING_OP_SHAPES.items():
            for dt in (torch.float32, torch.bfloat16):
                g = torch.Generator("cuda").manual_seed(40)
                q, k = (torch.randn(b, n, h, d, generator=g, device="cuda") for _ in range(2))
                v, w = (torch.randn(b, n, h, dv, generator=g, device="cuda") for _ in range(2))
                leaves = [t.detach().to(dt, copy=True).requires_grad_(True) for t in (q, k, v)]

                def plain():
                    (ra._plain_attention(*leaves).float() * w).sum().backward()

                plain()
                rec["op"][f"{name}_{str(dt)[6:]}"]["plain_ms"] = _step_ms(plain)
    dist.barrier()

    def models(kind, dtype):
        if kind == "hdit":
            m = build_flow_model(cfg, 4, 102, dtype=dtype).cuda()
        else:
            m = Unet(dim=16, channels=4, dim_mults=(1, 2, 4, 8), n_classes=102).cuda()
        m.load_state_dict({k: v.cuda() for k, v in job[kind].items()})
        return m

    def batch_of(kind, dtype=torch.float32):
        return ({k: (v.cuda().to(dtype) if v.is_floating_point() else v.cuda())
                 for k, v in job[f"{kind}_batch"].items()},
                [{k: v.cuda().to(dtype) for k, v in job[f"{kind}_draws"].items()}])

    def ring_step(kind, dtype):
        model = models(kind, dtype)
        twin = ring_twin(model, world)
        state = create_flow_state(model, 1e-4)
        return state, make_flow_train_step(mesh=mesh,
                                           model_apply=lambda m, x, t, c: twin(x, t, c))

    # the recipes' steps timed: flowers_hdit's in bf16, flowers_vqgan's U-Net in fp32
    print(f"ring rank {rank}: timed steps at {time.time() - t_rank:.1f} s", flush=True)
    torch.backends.cudnn.allow_tf32 = True          # PyTorch's default, as the parent's
    for kind, dtype in (("hdit", torch.bfloat16), ("unet", torch.float32)):
        state, step = ring_step(kind, dtype)
        batch, draws = batch_of(kind)
        _zero(kernels)
        step(state, batch, None, draws=draws, drop=drop)
        ms = _step_ms(lambda: step(state, batch, None, draws=draws, drop=drop))
        rec["steps"][kind] = {"ms": ms, "launches_timed": _counts(kernels)}
        del state, step
        torch.cuda.empty_cache()
    dist.barrier()
    if rank == 0:
        for kind, dtype in (("hdit", torch.bfloat16), ("unet", torch.float32)):
            st = create_flow_state(models(kind, dtype), 1e-4)
            one = make_flow_train_step()
            batch, draws = batch_of(kind)
            _zero(kernels)
            one(st, batch, None, draws=draws, drop=drop)
            rec["steps"][kind].update(
                one_process_ms=_step_ms(lambda: one(st, batch, None, draws=draws, drop=drop)),
                one_process_launches=_counts(kernels))
            del st
            torch.cuda.empty_cache()
    dist.barrier()
    if rank == 0:       # the parent starts train_flow under torchrun beside the holds
        open(os.path.join(job["out"], "steps_timed"), "w").close()

    # one fp32 step of each, TF32 off, held against one process's
    print(f"ring rank {rank}: fp32 holds at {time.time() - t_rank:.1f} s", flush=True)
    torch.backends.cudnn.allow_tf32 = False
    for kind in ("hdit", "unet"):
        state, step = ring_step(kind, torch.float32)
        batch, draws = batch_of(kind)
        before = {n: p.detach().clone() for n, p in state.model.named_parameters()}
        _zero(kernels)
        _, aux = step(state, batch, None, draws=draws, drop=drop)
        torch.cuda.synchronize()
        r = rec["steps"][kind]
        r["launches_fp32"] = _counts(kernels)
        r["loss"] = float(aux["loss"])
        mine = {"delta": {n: p.detach() - before[n] for n, p in state.model.named_parameters()},
                "mu": {n: state.opt.adam.state[p]["exp_avg"].clone()
                       for n, p in state.model.named_parameters()}}
        r["replicas_differ"] = replicated(
            {**{f"p.{n}": p.detach() for n, p in state.model.named_parameters()},
             **{f"mu.{n}": t for n, t in mine["mu"].items()},
             **{f"ema.{n}": p.detach() for n, p in state.ema.named_parameters()}})
        del state, step
        torch.cuda.empty_cache()
        dist.barrier()
        if rank == 0:
            st = create_flow_state(models(kind, torch.float32), 1e-4)
            _zero(kernels)
            _, ref_aux = make_flow_train_step()(st, batch, None, draws=draws, drop=drop)
            torch.cuda.synchronize()
            r["one_process_launches_fp32"] = _counts(kernels)
            r["ref_loss"] = float(ref_aux["loss"])
            ref = {"delta": {n: p.detach() - before[n] for n, p in st.model.named_parameters()},
                   "mu": {n: st.opt.adam.state[p]["exp_avg"] for n, p in
                          st.model.named_parameters()}}
            r["hold"] = _ring_hold(mine, ref, dict(st.model.named_parameters()))
            del st, ref
        del mine, before
        torch.cuda.empty_cache()
        dist.barrier()
    rec["seconds"] = time.time() - t_rank
    dist.destroy_process_group()
    torch.save(rec, os.path.join(os.path.dirname(job_path), f"rank{rank}.pt"))


def ring_torchrun(root: str, pe_data: str) -> dict:
    """Starts train_flow in the background under ``torchrun --standalone
    --nproc_per_node=2``: flowers_hdit's NA variant at full width (bf16, the
    recipe) with flow.n_model=2 flow.ring_attention=true, both ranks on
    cuda:0 (gloo), one epoch of 4 steps on sd_preencode's latents, no
    evaluation. Its output goes to files. Returns the handle
    ``ring_torchrun_result`` reads."""
    d = tempfile.mkdtemp(prefix="chip_smoke_ring_")
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc_per_node=2", "-m", "flocoder_torch.train_flow",
           "--config-name", "flowers_hdit.yaml", f"data={pe_data}", *HDIT_NA,
           "+device=cuda:0", "flow.n_model=2", "flow.ring_attention=true", "flow.epochs=1",
           "flow.ckpt_every=1", "flow.no_eval=true", "+seed=0",
           f"+ckpt_dir={os.path.join(d, 'ck')}", f"+output_dir={os.path.join(d, 'out')}"]
    out, err = open(os.path.join(d, "stdout"), "w"), open(os.path.join(d, "stderr"), "w")
    proc = subprocess.Popen(cmd, cwd=d, stdout=out, stderr=err,
                            env={**os.environ, "PYTHONPATH": root})
    return {"proc": proc, "dir": d, "files": (out, err), "t0": time.time()}


def ring_phase(tmp: str, paths: dict, pe_data: str, root: str, card: str,
               kernels: dict) -> tuple:
    """The model axis's ring attention on the card (step 34): two ranks on
    the one H100 in a gloo world (ring_rank), then train_flow under torchrun
    with the ring (ring_torchrun, started once the ranks' steps are timed),
    and its EMA checkpoint served by generate_samples in this process.
    Returns (record, launches: the ranks' ring steps and the serving)."""
    import torch.multiprocessing as mp
    from flocoder_torch import generate_samples as gs

    t0 = time.time()
    job = ring_job(tmp, paths, pe_data)
    d = job["out"]
    torch.cuda.empty_cache()
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    ctx = mp.start_processes(ring_rank, args=(RING_RANKS, root, os.path.join(d, "job.pt"), port),
                             nprocs=RING_RANKS, join=False, start_method="spawn")
    run = None
    try:
        while not ctx.join(timeout=0.5):
            if run is None and os.path.exists(os.path.join(d, "steps_timed")):
                run = ring_torchrun(root, pe_data)
        if run is None:
            run = ring_torchrun(root, pe_data)
        t_ranks = time.time() - t0
        recs = [torch.load(os.path.join(d, f"rank{r}.pt"), weights_only=False)
                for r in range(RING_RANKS)]
        for r in recs:
            if r["layout"] != [[0, r["rank"]], 0, r["rank"]] or r["transport"] != "gloo":
                fail(f"ring rank {r['rank']}: layout {r['layout']}, transport {r['transport']}")
            for name, o in r["op"].items():
                if o["hops"] != [RING_RANKS, RING_RANKS] or not all(
                        np.isfinite(e) and e < o["tols"][k] for k, e in o["errs"].items()):
                    fail(f"ring op {name} on rank {r['rank']}: errors {o['errs']} (tol "
                         f"{o['tols']}), hops {o['hops']}")
            for kind, s in r["steps"].items():
                # K1 and K2 4 a step at the NA level: two timed steps, one fp32
                na = HDIT_NA_BLOCKS if kind == "hdit" else 0
                for part, want in (("launches_timed", 2 * na), ("launches_fp32", na)):
                    if s[part] != {"na2d_fwd": want, "na2d_bwd": want}:
                        fail(f"ring rank {r['rank']} {kind} {part}: {s[part]}, expected "
                             f"{want} each")
                if s["replicas_differ"]:
                    fail(f"ring {kind} step: the model replicas differ after the step in "
                         f"{len(s['replicas_differ'])} tensors: {s['replicas_differ'][:6]}")
        for kind, s in recs[0]["steps"].items():
            if (s["one_process_launches_fp32"] != s["launches_fp32"]
                    or s["one_process_launches"] != s["launches_timed"]):
                fail(f"ring {kind}: a rank's launches {s['launches_fp32']} "
                     f"{s['launches_timed']} differ from one process's "
                     f"{s['one_process_launches_fp32']} {s['one_process_launches']}")
            h = s["hold"]
            for what in ("delta", "mu"):
                k, err, tol = h[what]
                if not err < tol:
                    fail(f"ring {kind} fp32 step {what} {k}: {err:.3e} (tol {tol:.3e})")
            if not abs(s["loss"] - s["ref_loss"]) < 1e-4 * max(1.0, abs(s["ref_loss"])):
                fail(f"ring {kind} fp32 step loss {s['loss']} vs one process's {s['ref_loss']}")

        # train_flow under torchrun with the ring, then its EMA served here
        run["proc"].wait(timeout=300)
        wall = time.time() - run["t0"]
        for f in run["files"]:
            f.flush()
        with open(os.path.join(run["dir"], "stdout")) as f:
            out = f.read()
        if run["proc"].returncode:
            with open(os.path.join(run["dir"], "stderr")) as f:
                print(out[-4000:], f.read()[-4000:], sep="\n", flush=True)
            fail(f"train_flow under torchrun with the ring exited {run['proc'].returncode}")
        lines = [ln for ln in out.splitlines()
                 if ln.startswith(("train_flow: mesh", "epoch 1/1", "done in"))]
        if len(lines) != 3 or "ring attention over 'model' (size 2)" not in lines[0]:
            fail(f"train_flow under torchrun did not train the ring: {lines}")
        ema = os.path.join(run["dir"], "ck", "flowema_1.npz")
        _zero(kernels)
        served = gs.main(["--config-name", "flowers_hdit.yaml", f"+flow_checkpoint={ema}",
                          "+n_samples=64", f"+n_steps={HDIT_N_STEPS}", "+seed=0",
                          f"+output_dir={os.path.join(d, 'gen')}"])
        serve_launches = _counts(kernels)
    finally:
        if run is not None:
            if run["proc"].poll() is None:
                run["proc"].kill()
                run["proc"].wait()
            for f in run["files"]:
                f.close()
            shutil.rmtree(run["dir"], ignore_errors=True)
    _expect(kernels, "serving the ring run's EMA checkpoint", serve_launches,
            na2d_fwd=HDIT_NA_BLOCKS * HDIT_NFE)
    if (served["images"].shape != (64, 128, 128, 3) or not np.isfinite(served["images"]).all()
            or served["nfe"] != HDIT_NFE):
        fail(f"serving the ring run's EMA: {served['images'].shape}, nfe {served['nfe']}")
    launches = dict.fromkeys(kernels, 0)
    for r in recs:
        for s in r["steps"].values():
            for part in ("launches_timed", "launches_fp32"):
                for name, n in s[part].items():
                    launches[name] += n
    for name, n in serve_launches.items():
        launches[name] += n
    steps = recs[0]["steps"]
    rec = {"ranks": RING_RANKS, "transport": "gloo, K/V and dK/dV staged through host memory",
           "card": card, "op": {r["rank"]: r["op"] for r in recs},
           "steps": {kind: {"ms_ranks": [r["steps"][kind]["ms"] for r in recs],
                            "ms_one_process": s["one_process_ms"], "hold": s["hold"],
                            "launches_a_rank": {p: s[f"launches_{p}"] for p in ("timed", "fp32")},
                            "launches_one_process": {"timed": s["one_process_launches"],
                                                     "fp32": s["one_process_launches_fp32"]}}
                     for kind, s in steps.items()},
           "torchrun": {"wall_s": wall, "lines": lines},
           "serve": {"batch_s": served["batch_seconds"], "launches": serve_launches},
           "seconds": {"ranks": t_ranks, "rank0_own": recs[0]["seconds"],
                       "phase": time.time() - t0}}
    print(f"ring transport: {rec['transport']} (ring_permute_ on a gloo group: two ranks "
          f"share the one card) | card: {card}", flush=True)
    for name, o in recs[0]["op"].items():
        print(f"ring op {name} (S={RING_RANKS}): hops a call {o['hops']} (forward, backward); "
              f"max|Δ|/max(1,|ref|) " + " ".join(f"{k}={v:.2e}" for k, v in o["errs"].items())
              + f" (tol {o['tols']['out']:.0e}/{o['tols']['dq']:.0e}); forward+backward ms a "
              f"rank {[round(r['op'][name]['ms'], 3) for r in recs]} against plain attention "
              f"in one process {o['plain_ms']:.3f} | card: {card}", flush=True)
    for kind, s in rec["steps"].items():
        h = s["hold"]
        what = "flowers_hdit NA variant, bf16" if kind == "hdit" else "flowers_vqgan U-Net, fp32"
        print(f"ring {kind} step ({what}, B={FLOW_BATCH}): ms a rank {s['ms_ranks']} "
              f"against one process's plain step {s['ms_one_process']:.2f}; fp32 hold (TF32 "
              f"off): Δ {h['delta'][0]} {h['delta'][1]:.3e} (tol {h['delta'][2]:.3e}), μ "
              f"{h['mu'][0]} {h['mu'][1]:.3e} (tol {h['mu'][2]:.3e}), {h['allowed']} changes "
              f"past 1e-4 within fp32's spacing or Adam's map of the held moments; K1/K2 launches a rank (2 timed steps, 1 fp32) "
              f"{s['launches_a_rank']} = one process's {s['launches_one_process']}; replicas "
              f"equal bit for bit | card: {card}", flush=True)
    print(f"ring torchrun --nproc_per_node=2 train_flow flow.n_model=2 "
          f"flow.ring_attention=true: {' | '.join(lines)}; {wall:.1f} s from its start; "
          f"its EMA served (64 samples, nfe {served['nfe']}, launches {serve_launches}) | "
          f"card: {card}", flush=True)
    print("ring seconds: " + ", ".join(f"{k} {v:.1f}" for k, v in rec["seconds"].items())
          + f" | card: {card}", flush=True)
    return rec, launches


def print_ptxas(source: str) -> None:
    """Each kernel's registers and spills from ptxas's report of the build of
    ``source`` in this run, demangled."""
    from flocoder_torch.ops.kernels.build import build_log
    log = build_log(source)
    if shutil.which("c++filt"):
        log = subprocess.run(["c++filt"], input=log, capture_output=True, text=True,
                             check=True).stdout
    name = None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1].replace("(anonymous namespace)::", "")
            name = name.removeprefix("void ").split("(")[0]
        elif name and ("spill" in line or "Used" in line):
            print(f"ptxas {source} {name}: {line.strip()}", flush=True)


def host_profile() -> None:
    """Wraps this script's functions, the port's entry points, codec set-up
    and checkpoint I/O, and numpy's npz reads and writes, to sum the host
    seconds and calls of each (nested calls count in each caller too);
    prints the totals at exit, on stderr: where a run's time goes, since
    the phases' own laps mix the program's work with its I/O."""
    import atexit
    import functools
    import importlib
    import types
    from collections import defaultdict

    total, calls = defaultdict(float), defaultdict(int)

    def timed(name, fn):
        @functools.wraps(fn)
        def wrap(*a, **k):
            t0 = time.time()
            try:
                return fn(*a, **k)
            finally:
                total[name] += time.time() - t0
                calls[name] += 1
        return wrap

    for n in ("savez_compressed", "savez", "load"):
        setattr(np, n, timed(f"np.{n}", getattr(np, n)))
    ck = importlib.import_module("flocoder_torch.training.checkpoint")
    for n in ("save_checkpoint", "load_checkpoint", "load_jax_flat", "to_jax_flat"):
        setattr(ck, n, timed(f"checkpoint.{n}", getattr(ck, n)))
    codecs = importlib.import_module("flocoder_torch.models.codecs")
    for n in ("setup_codec", "load_codec_weights"):
        setattr(codecs, n, timed(n, getattr(codecs, n)))
    for mod in ("generate_samples", "preencode_data", "train_flow", "train_vqgan",
                "evaluate_model", "train_audio_codec", "make_reflow_pairs"):
        m = importlib.import_module(f"flocoder_torch.{mod}")
        setattr(m, "main", timed(f"{mod}.main", m.main))
    g = globals()
    for n, f in list(g.items()):
        if isinstance(f, types.FunctionType) and n not in ("main", "fail", "host_profile"):
            g[n] = timed(n, f)

    def report():
        print("host seconds by function (calls):", file=sys.stderr)
        for n, t in sorted(total.items(), key=lambda x: -x[1]):
            print(f"  {n:40s} {t:8.1f} {calls[n]}", file=sys.stderr)

    atexit.register(report)


def main() -> None:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", default=None,
                    help="another checkout (an unpacked git archive) whose fused VQ "
                         "kernels are timed in turns with this one's")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: chip_smoke needs a CUDA card")
    host_profile()
    t_start = time.time()
    card = card_line()
    print(f"card: {card}", flush=True)
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, root)
    from flocoder_torch.generate_samples import CONFIG_DIR
    from flocoder_torch.ops.kernels import fused_vq as fvk
    from flocoder_torch.ops.kernels.na2d import na2d_bwd, na2d_fwd
    from flocoder_torch.ops.neighborhood_attention import (na2d, na2d_banded,
                                                          na2d_bwd_banded)
    kernels = {"na2d_fwd": na2d_fwd, "na2d_bwd": na2d_bwd,
               "fused_compress_vq": fvk.fused_compress_vq,
               "fused_compress_tail_vq": fvk.fused_compress_tail_vq,
               "fused_compress_tail_vq_bf16": fvk.fused_compress_tail_vq_bf16,
               "compress_tail_debug": fvk.compress_tail_debug}
    fused = ("fused_compress_vq", "fused_compress_tail_vq", "fused_compress_tail_vq_bf16",
             "compress_tail_debug")

    t0 = time.time()
    # one nvcc per source, started together; K1 and K2's checks run while
    # fused_vq.cu (the longest build) still compiles
    pool = ThreadPoolExecutor(3)
    builds = [pool.submit(k.build) for k in (na2d_fwd, na2d_bwd, fvk.fused_compress_tail_vq)]
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    atexit.register(shutil.rmtree, tmp, True)
    home = os.getcwd()
    try:
        # while nvcc builds, in the temporary directory: the quality tool's
        # five families (step 32), which launch none of the kernels and
        # report no speed, and the fixtures
        os.chdir(tmp)
        t_q = time.time()
        quality, quality_launches = quality_phase(tmp, root, card, kernels)
        quality_s = time.time() - t_q
        paths = write_checkpoints(tmp, CONFIG_DIR)
        torch.cuda.empty_cache()
    finally:
        os.chdir(home)
    for f in builds[:2]:
        f.result()
    print(f"K1 + K2 build: {time.time() - t0:.1f} s", flush=True)
    from flocoder_torch.evaluation import DECODE_CHUNK
    errs = check_k1(na2d_fwd, na2d_banded, flow_decode_chunks(DECODE_CHUNK))
    errs2 = check_k2(na2d_fwd, na2d_bwd, na2d_bwd_banded)
    check_function(na2d, na2d_banded)
    timing, decode_err = time_k1(na2d_fwd, na2d_banded, card)
    errs[torch.float32] = max(errs[torch.float32], decode_err)
    timing2, train_err = time_k2(na2d_fwd, na2d_bwd, na2d_bwd_banded, na2d, card)
    errs2[torch.float32] = max(errs2[torch.float32], train_err)
    shapes = time_na2d_shapes(na2d_fwd, na2d_bwd, card)
    hdit_errs = check_hdit_kernels(na2d_fwd, na2d_bwd, na2d_banded, na2d_bwd_banded)
    for name, errs_of in (("na2d_fwd", errs), ("na2d_bwd", errs2)):
        for dtype in (torch.float32, torch.bfloat16):
            errs_of[dtype] = max(errs_of[dtype], hdit_errs[(name, dtype)])
    shapes += time_hdit_kernels(na2d_fwd, na2d_bwd, card)
    builds[2].result()
    pool.shutdown()
    for name in fused:                       # the library fused_vq.cu built
        kernels[name].build()
    print(f"K3/K4/K5 build (started with K1 + K2): done {time.time() - t0:.1f} s after "
          "the start", flush=True)
    print_ptxas("fused_vq.cu")
    fused_errs = check_fused_vq()
    fused_timing = time_fused_vq(card, args.parent)
    slice_errs = check_bf16_slice_kernels(card)
    slice_timing = time_bf16_slice(card)
    fused_errs["fused_compress_tail_vq_bf16"] = slice_errs["fused_compress_tail_vq_bf16"]
    fused_timing["fused_compress_tail_vq_bf16"] = slice_timing["fused_compress_tail_vq_bf16"]

    phase_s = {"quality (beside the builds)": quality_s}
    t_phase = [t_start]

    def lap(name):
        phase_s[name] = time.time() - t_phase[0]
        t_phase[0] = time.time()

    lap("kernel_checks")
    try:
        os.chdir(tmp)           # the trainers write their metrics logs (runs/) here
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = True      # PyTorch's default for convs
        serving, serve_launches = serve(tmp, paths, card, kernels)
        lap("serve")
        parts = breakdown(paths, card)
        lap("serve_breakdown")
        webapp, webapp_launches = webapp_phase(tmp, paths, card, kernels)
        lap("webapp")
        state, training, train_launches = train_flowers(tmp, card, kernels)
        gan_parts = gan_breakdown(state, card)
        del state
        torch.cuda.empty_cache()
        lap("codec_training")
        preencode, pre_launches = preencode_flowers(tmp, paths, card, kernels)
        lap("preencode")
        pe_host_rec, pe_host_launches = pe_host(tmp, paths, card, kernels)
        print(f"pre-encode flowers_vqgan B=32, train latents/s in this run: host pipeline "
              f"(device_augs, decoder {pe_host_rec['decoder']}, shard) "
              f"{pe_host_rec['train_latents_per_s']:.2f} against files with the PIL "
              f"transforms {preencode['train_latents_per_s']:.2f}; val "
              f"{pe_host_rec['val_latents_per_s']:.2f} against "
              f"{preencode['val_latents_per_s']:.2f} | card: {card}", flush=True)
        lap("pe_host")
        preencode_small = check_preencode_small(tmp, CONFIG_DIR)
        flow, flow_launches = train_flow_phase(tmp, os.path.join(tmp, "pe_images"),
                                               paths, card, kernels)
        lap("flow")
        shard_flow, shard_flow_launches = flow_shard(tmp, paths, card, kernels)
        lap("flow_shard")
        dp, dp_launches, nccl = dp_phase(tmp, paths, os.path.join(tmp, "pe_images"), root,
                                         card, kernels)
        lap("dp")
        try:    # card-vs-CPU checks (no speed metric) beside the rest of the NCCL run
            check_small_input(paths["cfg"])
            check_train_small()
            tpu_card_vs_cpu = check_train_small_bf16()
        except BaseException:
            nccl_stop(nccl)
            raise
        lap("card_vs_cpu_small")
        dp["nccl"] = nccl_result(nccl, card)
        dp["seconds"]["nccl_from_start"] = dp["nccl"]["wall_s"]
        lap("dp_nccl")
        tpu_ckpt, tpu_train, tpu_train_launches, k2_codec_err = tpu_vqgan_train(
            tmp, card, kernels)
        errs2[torch.bfloat16] = max(errs2[torch.bfloat16], k2_codec_err)
        tpu_train["card_vs_cpu"] = tpu_card_vs_cpu
        lap("tpu_vqgan_train")
        tpu_vqgan, tpu_vqgan_launches = tpu_vqgan_phase(
            tmp, dict(paths, codec=tpu_ckpt), card, kernels)
        lap("tpu_vqgan")
        sd_paths = write_checkpoints(tmp, CONFIG_DIR, "flowers_sd")
        int8_srv, int8_launches = int8_serving(tmp, paths, sd_paths, card, kernels)
        lap("int8_serving")
        decodes = time_decodes(paths, sd_paths, card, kernels)
        errs[torch.bfloat16] = max(errs[torch.bfloat16], decodes["k1_in_bf16_decode_err"])
        lap("decodes")
        pe_data = os.path.join(tmp, "pe_images")
        sd_pre, sd_pre_launches = sd_preencode(tmp, pe_data, card, kernels)
        lap("sd_preencode")
        sd_srv, sd_srv_launches = sd_serve(tmp, CONFIG_DIR, card, kernels)
        lap("sd_serve")
        hdit, hdit_launches = hdit_flow_phase(tmp, pe_data, card, kernels)
        lap("hdit_flow")
        hdit_recipe, recipe_launches = hdit_short_phase("hdit_recipe", tmp, pe_data, card,
                                                        kernels, [])
        hdit_moe, moe_launches = hdit_short_phase(
            "hdit_moe", tmp, pe_data, card, kernels, [*HDIT_NA, "+flow.hdit_moe_experts=[8,0]"])
        lap("hdit_short")
        reflow, reflow_launches = reflow_phase(tmp, hdit["ema_checkpoint"], card, kernels)
        lap("reflow")
        vqgan_plus, vqgan_plus_launches = vqgan_plus_phase(tmp, card, kernels)
        lap("vqgan_plus")
        midi_codec, midi_codec_launches = midi_train_codec(tmp, card, kernels)
        lap("midi_train")
        midi_pre, midi_pre_launches = midi_preencode(tmp, card, kernels)
        lap("midi_preencode")
        midi_fl, midi_flow_launches = midi_flow(tmp, card, kernels)
        lap("midi_flow")
        midi_inp, midi_rows, midi_errs, midi_inp_launches = midi_inpainting_codec(
            tmp, card, kernels, (na2d_fwd, na2d_bwd, na2d_banded, na2d_bwd_banded))
        lap("midi_inpainting")
        demo, demo_launches = tpu_demo(tmp, card, kernels)
        lap("tpu_demo")
        audio, audio_launches = audio_phase(tmp, card, kernels)
        lap("audio")
        audio_bf16, audio_bf16_launches = audio_bf16_phase(tmp, card, kernels, audio)
        lap("audio_bf16")
        ring, ring_launches = ring_phase(tmp, paths, pe_data, root, card, kernels)
        lap("ring")
    finally:
        os.chdir(home)
        shutil.rmtree(tmp, ignore_errors=True)
    print("phase seconds (host clock): " + ", ".join(f"{k} {v:.1f}" for k, v in phase_s.items())
          + f"; total {time.time() - t_start:.1f}", flush=True)

    for name, errs_of in (("na2d_fwd", errs), ("na2d_bwd", errs2)):
        for dtype in (torch.float32, torch.bfloat16):
            errs_of[dtype] = max(errs_of[dtype], midi_errs[(name, dtype)])
    shapes += midi_rows
    print(json.dumps({"serving": serving, "breakdown": parts, "training": training,
                      "gan_breakdown": gan_parts, "preencode": preencode,
                      "preencode_card_vs_cpu": preencode_small, "flow": flow,
                      "sd_preencode": sd_pre, "sd_serve": sd_srv, "hdit_flow": hdit,
                      "hdit_recipe": hdit_recipe, "hdit_moe": hdit_moe, "reflow": reflow,
                      "vqgan_plus": vqgan_plus,
                      "midi_train": midi_codec, "midi_preencode": midi_pre,
                      "midi_flow": midi_fl, "midi_inpainting_codec": midi_inp,
                      "pe_host": pe_host_rec, "flow_shard": shard_flow, "tpu_demo": demo,
                      "tpu_vqgan_train": tpu_train, "tpu_vqgan": tpu_vqgan,
                      "int8_serving": int8_srv, "decode_ms_64": decodes, "audio": audio,
                      "audio_bf16": audio_bf16, "webapp": webapp, "quality": quality,
                      "dp": dp, "ring": ring,
                      "int8_conv": {**slice_errs["int8_conv"],
                                    "timing": slice_timing["int8_conv"]},
                      "phase_s": phase_s}))
    by_tag = {"serve": serve_launches, "train": train_launches, "preencode": pre_launches,
              "flow": flow_launches, "sd_preencode": sd_pre_launches,
              "sd_serve": sd_srv_launches, "hdit_flow": hdit_launches,
              "hdit_recipe": recipe_launches, "hdit_moe": moe_launches,
              "midi_train": midi_codec_launches, "midi_preencode": midi_pre_launches,
              **midi_flow_launches, **midi_inp_launches, "pe_host": pe_host_launches,
              "flow_shard": shard_flow_launches, "tpu_demo": demo_launches,
              "tpu_vqgan_train": tpu_train_launches, "tpu_vqgan": tpu_vqgan_launches,
              "int8_serving": int8_launches, **audio_launches, **audio_bf16_launches,
              **reflow_launches,
              **vqgan_plus_launches, "webapp": webapp_launches, "quality": quality_launches,
              "dp": dp_launches, "ring": ring_launches}

    def by_path(name):
        paths = {tag: counts[name] for tag, counts in by_tag.items()}
        return {"launches": sum(paths.values()), "launches_by_path": paths}

    def fused_entry(name, replaces):
        return {"name": name, "route": "cuda", "source": "flocoder_torch/csrc/fused_vq.cu",
                "replaces": replaces, **by_path(name), **fused_errs[name],
                **fused_timing[name]}

    print(json.dumps({"kernels": [
        {"name": "na2d_fwd", "route": "cuda",
         "source": "flocoder_torch/csrc/na2d_fwd.cu",
         "replaces": "flocoder_tpu/ops/pallas/na2d.py:40",
         **by_path("na2d_fwd"),
         "max_abs_err": errs[torch.float32],
         "max_abs_err_bf16": errs[torch.bfloat16], **timing,
         "per_shape": [r for r in shapes if r["kernel"] == "na2d_fwd"]},
        {"name": "na2d_bwd", "route": "cuda",
         "source": "flocoder_torch/csrc/na2d_bwd.cu",
         "replaces": "flocoder_tpu/ops/pallas/na2d.py:148",
         **by_path("na2d_bwd"),
         "max_abs_err": errs2[torch.float32],
         "max_abs_err_bf16": errs2[torch.bfloat16], **timing2,
         "per_shape": [r for r in shapes if r["kernel"] == "na2d_bwd"]},
        fused_entry("fused_compress_tail_vq", "flocoder_tpu/ops/pallas/fused_vq.py:134"),
        fused_entry("fused_compress_tail_vq_bf16", "flocoder_tpu/ops/pallas/fused_vq.py:134"),
        fused_entry("fused_compress_vq", "flocoder_tpu/ops/pallas/fused_vq.py:80"),
        fused_entry("compress_tail_debug", "benchmarks/fused_probe.py:129")]}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
