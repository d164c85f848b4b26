#!/usr/bin/env python3
"""Drive the PyTorch port's fft_glo, stn_newmodel3, nemar and tfc_diff serve paths
and train steps, the rest of the TFC-GAN-FFT family (the debiased chain,
mask, regional FFT, favtgan temperature forms), the two baseline families
(ThermalGAN in both registry entries, CycleGAN), and the data and evaluation
chain, on one CUDA card.

    python3 chip_smoke.py [--params g_params.npz] [--init-seed 0]

Phases, one line or more each; any failure raises and exits non-zero (20
to 27 run after 19, and 18 last):

1. environment: torch/CUDA versions, the card, its power limit; TF32 off.
2. build: g++ builds ``tfcgan_tpu_torch/csrc/fastpair.cpp`` (the pair
   decoder) and nvcc ``csrc/blurpool.cu`` (blur-pool forward
   and backward), ``csrc/resample.cu`` (1-D affine resampling: forward,
   adjoint, position gradient) and ``csrc/gridsample.cu`` (dense bilinear
   grid_sample, forward and backward) and ``csrc/flashattn.cu`` (flash
   attention: forward, dq, dk/dv; on the float32 units for float32 and on the
   tensor cores for bfloat16), all started together; the build seconds.
3. blur-pool vs plain: the forward kernel against ``blur_pool_padded`` and the
   backward kernel against ``torch.autograd.grad`` of it, at the 11 blur shapes
   of the 256² generator at batch 8 (both strides; the first four stride-2
   shapes are also the discriminator's), odd shapes and 1-3 pixel maps,
   float32 (atol 1e-5) and bfloat16 (against the plain version in float32
   from the same bf16 input or output gradient, rounded: atol = rtol = 8e-3,
   one bf16 ulp), with kernel and plain times at the path's shapes; two
   identical forward and two identical backward runs at every path shape
   compared bit for bit; kernel times and the byte bound of one fft_glo
   step's bf16 calls at batch 128 (``fft_glo_step_calls``: 27 forward, 23
   backward).
4. resampling vs plain: the three kernels against ``resample_axis_plain`` and
   autograd of it (outputs and the gradient to x within 2e-5, the gradients to
   p and q within 2e-4, each x max(1, max|plain|): the reductions run in
   another order), float32 and bfloat16 input: the two passes of the path's
   warp at (8|32, 256, 256, 3) cubic with near-identity thetas, then linear,
   ``border=False``, channel strides 1, 3 and 5, other output lengths, odd
   shapes and lengths 1-3, with lines at p = 0.5, 4, 0.25, 0 and -1 and lines
   pushed wholly off either end; the adjoint's edge masses (``_edge_lines``:
   lines over both ends, p = 0 inside, near and beyond either end, p < 0) at
   1, 2, 3 and 40 elements and 1, 3, 5 and 10 channels a line; on every case
   the adjoint and the position gradient run twice and repeat bit for bit;
   ``warp_affine_separable`` forward and gradients through the kernels against
   the plain path; kernel, plain and library (``F.grid_sample``) times at (32,
   256, 256, 3), and each kernel's time on the device alone (CUDA graphs) and
   share of its byte bound over its passes of one warp (forward and position
   gradient both passes, with a float32 and a bfloat16 image; adjoint the
   y-pass), each run twice there and compared bit for bit.
5. dense grid_sample vs plain: both kernels against ``grid_sample_dense_plain``
   (``ops/warp.grid_sample`` in float32) and autograd of it, float32 and
   bfloat16 image: the path's shape (8|32, 256, 256, 6), zeros,
   ``align_corners=False``, with the identity grid (every sample on an integer
   coordinate), offsets of 0.3 pixel and of 5 pixels; then all three padding
   modes x both ``align_corners`` on (2, 24, 40, C) sampled to (16, 33) for
   C = 1, 2, 3, 6, 8 and 300 (two channels a backward thread), 1-3 pixel
   images, grids 5x off the image, a constant grid (4096 outputs on one spot),
   the identity grid, and coordinates 1e10, 3e38, +-inf and NaN (finite
   results, 0 under zeros, no gradient to such a coordinate, no access
   outside the image). Forward within 1e-5 x max(1,
   max|plain|) in float32 (the kernel repeats the plain version's rounded
   operations, so it is mostly exact) and one bf16 ulp in bfloat16; both
   gradients within 1e-4 x max(1, max|plain|): the image gradient is summed
   with float32 atomics in an order that changes from run to run (up to 4096
   terms on one pixel here), the grid gradient over the channels in another
   order than autograd. Kernel, plain and ``F.grid_sample`` times, forward and
   backward, at (32, 256, 256, 6), and the forward's time and bound in
   bfloat16 there; the largest difference between two identical backward
   runs; two identical forward runs, float32 and bfloat16, bit for bit.
6. fft_glo serve: the full-width ``GeneratorUNet`` (random weights from
   --init-seed, or --params) through ``Inferencer`` and
   ``run_test_set(save_spectra=True)`` on 4 synthetic batches of 8 at 256² in
   bfloat16, ``pair_metrics`` on the card, and the CLI (``test`` over 8 A|B PNG
   pairs, ``prep-crop``, ``eval``): 11 blur-pool forward launches per G
   forward, no other kernel.
6b. cli train (its own data seed): 64 train and 8 test synthetic A|B PNG
   pairs at 256². ``cli train --experiment fft_glo`` at batch 32, bf16, 2
   epochs, ``--checkpoint-interval 1 --sample-interval 2`` on the default
   staging (the device pool for this set): 1 + 2 x 2 steps, checkpoints
   ``step_00000003`` and ``step_00000005``, finite JSONL records, the sample
   grids and the gallery, 27 forward and 23 backward blur-pool launches a step
   and 11 forward a sample; the pool's first batch equal to
   ``batch_iterator``'s bit for bit. ``--resume step_00000003 --n-epochs 1``
   into a fresh out-dir reaches ``step_00000005`` (the data order restarts, so
   it is not compared with the straight run). ``test --checkpoint`` writes 8
   stacks. Timed runs of 16 epochs (32 epoch steps) with no sample hook, on
   the pool and on ``--staging stream --num-workers 4``: 27 + 23 blur-pool
   launches a step, and the stream's first device batch equals the pool's bit
   for bit. The library resume: the fft_glo bf16
   ``Trainer`` at 256², batch 32, on 5 fixed device batches, 5 steps straight
   (twice, with ``cudnn.deterministic``: the card's step-repeat difference)
   against 3 steps, ``save_checkpoint``, ``restore_checkpoint`` into a freshly
   built recipe and 2 steps, metrics and G/D weights held bit for bit where
   the straight run repeats bit for bit, else within twice its repeat
   difference; the checkpoint's save times, synchronous and asynchronous.
   tfc_diff ``cli train`` at 128², batch 8, 1 epoch (3 steps, 7 + 7 + 7 flash
   attention launches a step on the tensor cores) with the sample hook after
   step 3, and ``gen --checkpoint`` on 4 images (each the whole 500-step
   chain, 7 forward launches a U-Net forward). Printed: the fft_glo wall img/s
   over the timed runs' 32 epoch steps with data loading included, pool and
   stream, the time to the first step, the save times and the peak memory,
   each beside the card's name and power limit.
7. fft_glo compare: the same G weights in float32 through the kernel and
   through the plain path on the card (atol 1e-4), and G-forward images/s at
   batch 8, 32 and 128.
8. fft_glo train: the full-width recipe (G, spectral-norm D, random-weight
   LPIPS-VGG16, every loss term, two Adams) in bfloat16, ``Trainer.fit`` for 3
   steps at batch 8, 256²: finite losses that move, exactly 27 forward and 23
   backward blur-pool launches per step; one float32 step at batch 2 through
   the kernels and through the plain path (loss terms rtol 1e-4; every
   gradient within 1e-3 x max|g_plain| + 1e-7); train-step images/s and peak
   memory at batch 32 and 128 (2 warm-up and 5 timed steps, CUDA events).
9. stn_newmodel3 serve at full width (two U-Nets, ViT-Base localizer, bf16):
   ``Inferencer`` on 2 batches of 8 at 256², ``run_test_set`` writing 6-image
   stacks, ``cli test --config stn_newmodel3`` and ``prep-crop``: 33 blur-pool
   forward and 2 resampling forward launches a batch, no backward launch;
   float32 kernel path against plain resampling alone and against the plain
   path (atol 1e-4; 1e-3 for the two outputs behind the warp, where one
   float32 ulp of theta moves a sample); serve images/s at batch 8 and 32.
   The dtheta head gets small random weights here and in phase 10's float32
   step: at its zero init theta is the identity and the warp's gradients to
   the localizer vanish.
10. stn_newmodel3 train: 3 bf16 steps at batch 8 through ``Trainer.fit`` (every
   term finite, loss_G moving, theta_t printed; per step 65 forward and 57
   backward blur-pool launches, 2 resampling forward, 1 adjoint and 2 position
   gradient launches); one float32 step at batch 2 on the kernel path against
   itself, against plain resampling alone and against the whole plain path
   (loss terms rtol 1e-4; every gradient within 6e-2 x max|g| + 1e-7 and 1e-2 of
   its L2 norm: a few times what two identical runs of this step differ by, see
   ``main``); train-step images/s and peak memory at batch 32 on the kernel
   path, with plain resampling alone, and on the plain path.
11. nemar serve at full width (ResNet-9-block translator, deformable ResUnet
   STN, bf16): ``Inferencer`` on 2 batches of 8 at 256², ``run_test_set``
   writing 6-image stacks, ``cli test --config nemar`` and ``prep-crop``:
   exactly 1 grid_sample forward launch a batch and no other kernel; outputs
   finite and in [-1, 1]; float32 kernel path against the plain path (atol
   1e-4 for fake_B, 1e-3 for the three outputs behind the sampling); serve
   images/s at batch 8 and 32. The STN's zero-initialised offset head gets
   random weights, an offset of a few tenths of a pixel and live biases here
   and in phase 12's float32 step: at its zero init the warp is the identity.
12. nemar train: one float32 step at batch 2 on the kernel path against itself
   and against the plain path (loss terms rtol 1e-4; every gradient within
   ``NEMAR_TOL`` x max|g| + 1e-7 and ``NEMAR_TOL_L2`` of its L2 norm, see
   ``main``); train-step images/s and peak memory at 256², batch 32 and at
   128², batch 128, kernel path and plain path; 3 bf16 steps at batch 8
   through ``Trainer.fit`` (D first, then T and R through the updated D: every
   term finite, loss_G moving; per step exactly 1 grid_sample forward and 1
   backward launch and none of the other kernels, read after each step); the
   lr a step far into ``linear_decay`` used against the closed form.
13. flash attention vs plain: the three kernels through ``flash_attention`` and
   autograd against ``flash_attention_plain`` and autograd of it, float32 and
   bfloat16: the path's shapes (8 | 32 images x 8 heads, D = 8, S = 4096 and
   1024) through the strided (N, S, C) views the model passes, S = 16384 (a
   256² input), ragged S (1, 7, 255, 1000) in both layouts, D = 16, 32, 64,
   scores of several hundred (an unshifted exp would overflow), every subset of
   ``needs_input_grad`` (bit-identical to the full backward, only the kernels
   needed launched), two identical bfloat16 backward runs compared bit for bit,
   two identical bfloat16 forward runs at the path's shapes compared bit for
   bit (output and lse), and what the wrappers refuse. Every bfloat16 case
   must run its forward and backward on the tensor-core kernels (their three
   counts move by one each) and no float32 case may.
   Float32 forward within 2e-5 x max(1, max|plain|) (exp2f's 2 ulp and sums
   over up to 16384 keys in another order), gradients within 1e-4 x max(1,
   max|plain|) (sums of up to 16384 products of p and dp - di, which cancel);
   bfloat16 within 2e-2 x max(5e-3, max|plain|) (the forward rounds the
   unnormalised probability, the plain version the normalised one; the
   backward rounds P and dS to bfloat16 for its tensor-core products, the
   plain version's autograd rounds P, dP and dS; the backward is fed the
   forward kernel's lse). Kernel, plain and
   ``F.scaled_dot_product_attention`` times, forward and backward, at (256, 8,
   4096) and (256, 8, 1024) bfloat16.
14. tfc_diff serve at full width (the UNet2DModel denoiser, bf16, 128², the
   config's size): ``Inferencer`` on a synthetic batch of 8 over the whole
   500-step chain and ``cli gen --config tfc_diff`` over 4 A|B PNG pairs (one
   chain at batch 4): outputs finite and in [-1, 1], exactly 7 flash attention forward
   launches a U-Net forward (3500 a chain), all 7 on the tensor cores, no
   backward launch and none of the other kernels; U-Net forwards/s at batch 8
   and 32 and the sampled images/s they give. In float32: one U-Net forward
   on the kernel path against the plain path (atol 1e-4) and a 20-step chain
   with the same noise on both (atol 1e-3: what the two forwards differ by
   passes through 19 more of them).
15. tfc_diff train: one float32 ``tfc_diff`` step at batch 2 on the kernel path
   against itself and against the plain path (loss terms rtol 1e-4, every
   gradient within 1e-3 x max|g| + 1e-7); train-step images/s and peak memory
   at 128², batch 16 and 32, kernel path and plain path; 3 bf16 steps at batch 8
   through ``Trainer.fit`` for each of ``tfc_diff_label``, ``tfc_diff_hybrid``
   and ``tfc_diff`` (every term finite, ``g_noise_mse`` moving, ``loss_D`` 0:
   the family has no discriminator; per step exactly 7 launches of each flash
   attention kernel, all 21 on the tensor cores (none in the float32 step),
   and for ``hybrid`` also the 11 + 11 blur-pool launches of one G forward and
   backward, read after each step).
16. the rest of the TFC-GAN-FFT family (the debiased chain V1-V7, the
   saliency mask, the regional FFT loss, favtgan's L1 and temperature-map
   forms): each of the 12 entries at full width, 3 bf16 steps at batch 8,
   256², on labelled synthetic batches (every term finite and moving, g_ce,
   d_ce, g_region_fft and g_mask included; 27 forward and 23 backward
   blur-pool launches a step, read after each step: the path
   ``debiased_train``); one float32 step at batch 4 of ``fft_patch_debiased``
   and of ``fft_patch_mask`` on the kernel path against itself and against
   the plain path (loss terms rtol 1e-4; every gradient within
   ``DEBIASED_TOL`` / ``MASK_TOL``, about three times what two identical runs
   differ by, see ``main``); V7 and V4 train-step
   images/s over 10 steps at batch 32 (CUDA events around every step:
   median, min, max) and peak memory; the conditional G served by
   ``Inferencer`` with LAB3 at batch 8 and 32 (11 forward launches a batch,
   images/s, float32 kernel path against plain path, atol 1e-4); ``cli train
   --annots`` of V7 at batch 32 on 64 labelled PNG pairs, 2 epochs,
   ``--resume``, the conditional ``test`` refused; the library resume of V4
   at batch 8 (3 steps against 1 + save + load + 2) bit for bit where the
   straight run repeats with ``cudnn.deterministic``.
17. the baselines at full width (ResNet-9-block CycleGAN generators, the
   full G1, Encoder and G2), 256², no kernel on their paths: ``thermalgan``
   (detached D_vae), ``thermalgan_bn`` and ``cyclegan`` 3 bf16 steps each at
   batch 8 (every term finite and taking 3 values, but thermalgan's frozen
   pyramid score, a bf16 value as in JAX; 0 launches of every
   kernel, read after each step: the paths ``thermalgan_train``,
   ``thermalgan_bn_train``, ``cyclegan_train``); one float32 step at batch 2
   of ``thermalgan`` and of ``cyclegan`` (its replay buffers full) on the
   card against the same step on the CPU from the same weights, batch and
   draws (loss terms rtol 1e-4; every gradient within ``BASELINE_TOL``: the
   card's convs round otherwise than the CPU's, and the G chains' ReLU kinks
   turn that into gradient differences, see ``main``); train-step images/s
   over 10 steps after 3 warm-up steps (CUDA events around every step:
   median, min, max) and peak memory, ``thermalgan`` at batch 32 and 128,
   ``thermalgan_bn`` at 32, ``cyclegan`` at 16; ``Inferencer`` images/s at
   batch 8 and 32 for both families and ``cli test`` writing their stacks
   (3 and 4 images high); ``cli train`` of ``cyclegan`` at batch 8 on 16
   identical A|B pairs (so that every epoch's batches are the same whatever
   the order), 2 epochs, and ``--resume`` from the first epoch's checkpoint:
   weights, replay buffers and Adam states of the two final checkpoints equal
   bit for bit, under ``cudnn.deterministic``.
18. the result, printed after 26: the seconds each phase took, the card's
   ``nvidia-smi`` line, one JSON line for the kernels, and last ``{"ok":
   true, "device": {...}}``.
19. the data and evaluation chain at 256², bf16, on 64 synthetic A|B PNG
   pairs, 32 of 320x640 (resized) and 32 of 256x512: (a) the native decoder:
   ``process_pair_batch`` with 8 threads = ``process_pair`` bit for bit, the
   default ``PairedImageDataset``'s batches = the ``DevicePool``'s and the
   uint8 stream's bit for bit (phase 6b's check on the native path), decode
   images/s native (a dataset item, and the resize stage alone at 1 and 8
   threads) against PIL on the card machine's host; (b) ``cli train fft_glo
   --hist-every 4`` at batch 32, 4 epochs of 2 steps after step 0: records
   at each epoch's first step (2, 4, 6, 8; the JAX CLI's rule), weights and
   grads of every parameter of G (29,238,275) and D (2,767,808), each
   tensor's counts summing to its size, every stat finite, ``hists.html``
   written, 27 + 23 blur-pool launches asserted after every step, the median
   ms of a histogram step against a plain one (path ``hist_train``); (c)
   ``make_registered_dataset`` through the full-width stn_newmodel3
   ``Inferencer`` (the dtheta head random, as in phase 9), batch 32: 64 PNGs,
   33 blur-pool and 2 resampling forward launches a batch (path
   ``registered_set``), images/s with the PNG writes; (d) ``eval-reg --device
   cuda`` over (c)'s real_A / real_B / reg_B: 6 finite columns, and
   ``registration_metrics`` on the card = on the CPU within ``REG_TOL``
   (float32 reductions in another order; the bins are equal: the luma is
   divided by a tensor); (e) ``eval --iqa niqe`` over 32 pairs: columns and
   seconds an image; (f) ``prep-combine``, ``prep-crop``, ``prep-morphs``
   (the card's PNGs = the CPU's bit for bit), ``gallery``, and ``mesh``,
   which must refuse with the mediapipe message; (g) ``test_time_augment``
   with erasing at (32, 256, 256, 3): the card = the CPU bit for bit for the
   same draws.
20. ``parallel/``, the data axis over ``torch.distributed``: (a) phase 6b's
   first ``cli train`` (fft_glo, bf16, B=32, 2 epochs, checkpoints, samples)
   again under ``python -m torch.distributed.run --standalone
   --nproc_per_node 1``, a world of one over NCCL: its JSONL log equals 6b's
   plain run bit for bit (without the clock fields), 2 gradient all-reduces
   a step and 27 + 23 blur-pool launches a step (11 a sample hook), read
   from the run's summary line (path ``dp_cli_train``); (b) in this process
   an NCCL world of one: the fft_glo ``Trainer`` at B=128 bf16 with and
   without the mesh in turns (step ms, the flat buffers' MiB), and the GPipe
   trunk (``resnet_trunk_pipeline``, 9 residual blocks of 256 channels) at
   one stage: the serial trunk bit for bit at 1 microbatch; (c) two gloo
   ranks on the card (NCCL refuses two ranks on one device), fft_glo and
   thermalgan_bn float32 at global B=32: the first step's metrics and G
   gradients against one process within the CPU tests' bounds (rel 1e-5;
   1e-4 x max|g|) or 3 x the floor of one process, its step on A moved by
   one float32 step up and down (``DP_NUDGES``: the ranks' half batches run
   other cuDNN algorithms than the whole batch, and the rounding that
   moves shows as the nudges' does), the replicas' checksums equal after 3
   steps, 27 + 23 blur-pool launches a fft_glo step on each rank (path
   ``dp_two_ranks``).
21. the tensor axis (``parallel/tensor.py``), as gloo ranks of the card:
   (a) fft_glo float32 at global B=8, 256², on four ranks as (2 data x 2
   tensor): the first step's metrics and gathered G gradients against one
   process within 3 x the floor of cuDNN's algorithms (one process,
   benchmarked against deterministic); the
   step-1 metrics equal on the four ranks; 27 + 23 blur-pool launches a step
   on each rank over 3 steps (path ``tensor_fft_glo``); each rank's bytes of
   G, D and LPIPS parameters and Adam moments against one process's (a
   share in [0.5, 0.6)); the steps' ms a rank; (b) tfc_diff bf16 at global
   B=8, 128², on two ranks as (1 x 2 tensor): 7 + 7 + 7 flash attention
   launches a step on each rank, all on the tensor cores (path
   ``tensor_tfc_diff``), finite metrics, step 1 within ``TENSOR_DIFF_TOL``
   of one process's. Both legs' ranks run at once, six processes on the
   card.
22. the spatial axis (``parallel/spatial.py``): (a) K1's row-edge form
   (``tfcgan_blurpool_fwd`` / ``_bwd`` on a row window) on every shard of the 11
   path shapes (batch 8) split over 2 and 3 ranks, float32 and bfloat16,
   both strides: the forward bit for bit the whole-map launch's rows and
   within ``_check`` of ``blur_pool_padded``'s row form, the backward of
   autograd of it; rank 0 of 2's row-edge calls over one fft_glo step at
   batch 128 (27 forward, 23 backward, bf16) and the copies that build its
   windows, beside phase 3's whole-map step calls; (b) fft_glo float32 at
   global B=4, 256², on two gloo ranks of the card as (1 data x 2 spatial)
   against one process (a process of its own): the first step's metrics and
   reduced G and D gradients within 3 x the floor of cuDNN's algorithms, as
   phase 21, or of A moved by one float32 step where that is larger (the
   benchmark can pick the deterministic algorithms); metrics equal on both
   ranks; no layer run on the whole map;
   27 + 23 blur-pool launches a step on each rank over 2 steps (path
   ``spatial_fft_glo``); step 2's peak memory above what each process held
   before it, a rank against one process, as allocated and without the
   transient blocks (the convolution workspaces, which cuDNN's heuristics
   size by the free memory: ``_step_memory``); (c) one bf16 step on the pair,
   finite and within ``TENSOR_DIFF_TOL`` of one process's.
23. the spatial axis for the STN family and TFC-Diff: (a) K4 with local
   queries (``sq`` < ``sk``), float32 and bfloat16, forward, dq and dk/dv
   through ``flash_attention`` and autograd against the plain version, on
   every query share of 2 and 3 ranks of the (32 x 8 heads, D 8, 4096)
   attention (sq 2048, and 1408 / 1344 / 1344): within phase 13's
   tolerances, each share's output, lse and dq bit for bit the
   whole-sequence launch's rows; the three kernels' times for rank 0 of 2
   (sq 2048) against the whole sequence (sq 4096) at sk 4096 in bfloat16;
   (b) K2's output windows (``o_base``): the stn warp's y-pass at (32, 256,
   256, 3) float32 cubic cut into the rows of 2 and 3 ranks, each window's
   forward bit for bit the whole launch's rows and all three kernels within
   phase 4's bounds of the plain window, the windows' adjoints and position
   gradients summed within them of the whole launch's; (c) stn_newmodel3
   float32 at 256², global B=4 (the ViT-Base localizer on the gathered
   pair, the warp's intermediate gathered), and tfc_diff float32 at 128²,
   global B=8 (the attention's normed map gathered), each on two gloo ranks
   of the card as (1 data x 2 spatial) against one process, as phase 22
   (3 x the float32 floor, which here also takes A moved one step down;
   gradients zero in exact arithmetic compared at a floor scale, see
   ``SPATIAL_GRAD_FLOOR``); (d) one bf16 step each on the pair, finite;
   (e) each rank's K1 + K2 and K4 launches a step (paths ``spatial_stn``
   and ``spatial_tfc_diff``); (f) each rank's step peak memory against one
   process's.
24. the spatial axis for NeMAR, CycleGAN and ThermalGAN: (a) K3 on row
   windows: the whole (32, 256, 256, 6) image and a dense grid (offsets up
   to 5 pixels) cut into the rows of 2 and 3 ranks in float32, of 2 in
   bfloat16:
   each window's forward and grid gradient bit for bit the whole launch's
   rows and within phase 5's tolerances of the plain version, the windows'
   image gradients summed over the ranks within ``GRAD_TOL`` of the whole
   launch's (float32 atomics in another order); rank 0 of 2's window and
   the whole launch timed, the window's bound from the image rows its taps
   reach; (b) nemar (the deformable STN: its stacked
   targets gathered, K3 at the rank's grid rows), cyclegan (the replay
   buffers whole on both ranks) and thermalgan_bn (the batch norms' moments
   over the group) float32 at 256², global B=4, each on two gloo ranks of
   the card as (1 data x 2 spatial) against one process, as phase 22 (3 x
   the float32 floor; the ResNet and PatchGAN conv biases in front of an
   instance norm, zero in exact arithmetic, compared at 1e-3 of the largest
   gradient: ``SPATIAL_FLOORED``); (c) one bf16 step each on the pair,
   finite; (d) each rank's launches a step: K3's forward and backward once
   for nemar (path ``spatial_nemar``), none for cyclegan and thermalgan_bn
   (paths ``spatial_cyclegan``, ``spatial_thermalgan_bn``), and
   thermalgan_bn's one layer on the whole map a step; (e) each rank's step
   peak memory against one process's, as phase 22.
25. the spatial axis for the debiased chain and the saliency mask:
   fft_patch_debiased (V7: the conditional U-Net's label plane computed
   whole and cut to the rank's rows, the aux classifier's ethnicity head a
   row-sharded product summed over the pair, the frozen regional
   ResNet-18s on the bands of the gathered fake) and fft_patch_mask (G's
   mask channel from A gathered, the mask term on the gathered images)
   float32 at 256², global B=4, labelled batches for V7, each on two gloo
   ranks of the card as (1 data x 2 spatial) against one process, as phase
   22 (3 x the float32 floor, A moved one step up and down); one bf16 step
   each on the pair, finite; 27 + 23 blur-pool launches a step on each rank,
   one process's (paths ``spatial_debiased``, ``spatial_mask``); no layer
   on the whole map; each rank's step peak memory against one process's.
26. two learning journeys (``tools/family_journey_torch.py``'s
   ``run_journey``, bf16, 128², B=16, weights from seed 0): nemar for 200
   steps on misaligned face pairs and tfc_diff for 250 steps on labelled
   pairs, each evaluated on its held-out batch at step 1 and every 50
   steps. The last evaluation must pass ``JOURNEY_THRESHOLDS`` (nemar:
   reg_ncc_gt - reg_ncc_init >= 0.02 and fakeTRB_psnr >= 25 dB; tfc_diff:
   held_noise_mse <= 0.1) and step 1 must fail them; loss_G must end below
   step 1's. The launches are read and reset after every step (1 K3 forward
   and 1 backward a nemar step; 7 + 7 + 7 K4 launches a tfc_diff step, all
   on the tensor cores) and every evaluation (1 K3 forward; 7 K4 forward):
   paths ``nemar_journey`` and ``tfc_diff_journey``. One JSON line a family
   (``{"journey": ...}``: step-1 and final metrics, ms a step, launches).
27. nemar through the CLI, tools/run_e2e_nemar_journey_torch.sh cut to 2
   epochs: 32 face pairs whose B is misaligned (rotation +-4 degrees,
   translation +-6 px) at 128² through ``tools/make_e2e_dataset_torch.py``,
   ``cli train --experiment nemar`` (batch 16, bf16, a checkpoint every
   epoch: 5 steps), ``cli test`` from the last checkpoint (8 pairs, the
   6-image stacks), the 6-role ``prep-crop``, ``eval-reg`` over (real_B,
   real_A, reg_A) and ``eval --iqa niqe`` of fake_TR_B against real_B. The
   launches are read and reset after every train step (1 K3 forward and 1
   backward) and every served batch (1 K3 forward): path ``nemar_cli``. The
   metric CSVs must have their columns and every value finite. One JSON line
   (``{"nemar_cli": ...}``: steps, served batches, the metric means,
   launches, seconds).

In the kernels' JSON, ``launches`` is the count of the kernel's main path, the
last train path driven that runs it (``main_path``: phase 10's three steps for
blur-pool and resampling, phase 12's for grid_sample, phase 15's ``tfc_diff``
steps for flash attention), and the script fails if that is 0;
``launches_by_path`` gives each of the driven paths' counts, and for
flash attention ``tensor_core_launches`` how many of the main path's launches
were the bfloat16 tensor-core kernel. For
blur-pool, ``ms``/``plain_ms``/``bound_ms`` are sums over the 11 bfloat16 blur
calls of one batch-8 G forward (for the backward: of one G backward); for
resampling, over the calls of one warp at (32, 256, 256, 3) float32 (forward:
both passes; adjoint: the y-pass; position gradient: both); for grid_sample,
one call at (32, 256, 256, 6) float32 (the forward's ``bf16_ms`` and
``bf16_bound_ms``: in bfloat16); for flash attention, sums over the 7
bfloat16 calls of one batch-32 U-Net pass at 128² (3 at S = 4096, 4 at S =
1024, 256 heads each). ``bound_ms`` is the larger of bytes / 3.35 TB/s (inputs
read once, outputs written once) and operations over the card's rate for their
type: 67 TFLOP/s (float32 outside the tensor cores) for K1-K3; for flash
attention the larger of its exponentials at 16 a clock an SM (132 SMs at the
1.98 GHz that 67 TFLOP/s implies: 4.19e12 /s) and its matrix products on the
tensor cores with D padded to their depth of 16 (989 TFLOP/s bfloat16),
``bound_term`` naming which; phase 13's text lines also give what the same
products take on the float32 units, which the float32 kernels use.
Blur-pool's ``graph_ms`` is ``ms`` timed by replaying CUDA graphs (the device
alone: eager calls of the small shapes time the wrapper's host work), and
``step_ms`` and ``step_bound_ms`` are the sums over one fft_glo step's
``step_calls`` bf16 calls at batch 128; ``row_edge_step_ms`` the same calls
in the row-edge form on rank 0 of a spatial pair's windows,
``row_edge_halo_copy_ms`` (forward) the copies that build those windows, and
``row_edge_max_abs_err`` phase 22's largest error against the plain row form.
Each flash attention kernel's ``local_query_*`` keys are phase 23's: the
largest error of the local-query cases, the time for rank 0 of 2's 2048
queries against 4096 keys, the whole sequence's time at the same keys and
the former's bound; each resampling kernel's ``window_max_abs_err`` phase
23's largest error of an output window against the plain one. Each K3
kernel's ``row_window_*`` keys are phase 24's: the largest error of a row
window against the plain version, the float32 time of rank 0 of 2's window
(the grid's rows 0-127 over the whole (32, 256, 256, 6) image), the whole
launch's time and the window's bound (the image rows its taps reach, not
the whole image). Each
resampling kernel's ``graph_ms`` is its warp's ``ms`` on the device alone, and for the forward
and the position gradient ``bf16_ms``, ``bf16_graph_ms`` and
``bf16_bound_ms`` the same with a bfloat16 image.
``max_abs_err`` is the largest error of phase 3, 4, 5 or 13. ``library_ms`` is ``F.grid_sample`` on the same inputs (for the backward
kernels: its backward) and, for flash attention,
``F.scaled_dot_product_attention`` (for both backward kernels: its whole
backward, which gives all three gradients), timed here and called nowhere in
the port.
"""

from __future__ import annotations

import argparse
import contextlib
import csv
import dataclasses
import importlib.util
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
from unittest import mock

import numpy as np
import torch
import torch.nn.functional as F

from tfcgan_tpu_torch import cli
from tfcgan_tpu_torch.bridge import load_generator_npz
from tfcgan_tpu_torch.config import get_experiment
from tfcgan_tpu_torch.data.synth import synthetic_batch
from tfcgan_tpu_torch.data import native
from tfcgan_tpu_torch.data.augment import draw_test_time_augment, test_time_augment
from tfcgan_tpu_torch.data.pairs import _to_u8
from tfcgan_tpu_torch.data.pool import DevicePool
from tfcgan_tpu_torch.data.prefetch import PrefetchLoader, device_prefetch
from tfcgan_tpu_torch.data.prep import make_registered_dataset
from tfcgan_tpu_torch.evaluation.suite import (_load_dir, _read_rgb, pair_metrics,
                                               registration_metrics, save_image_grid, to_uint8,
                                               write_png)
from tfcgan_tpu_torch.train import histograms
from tfcgan_tpu_torch.infer import Inferencer
from tfcgan_tpu_torch.models import diffusion as diffusion_models
from tfcgan_tpu_torch.models import discriminator, layers
from tfcgan_tpu_torch.models import stn as stn_models
from tfcgan_tpu_torch.models.layers import spectral_power_iteration
from tfcgan_tpu_torch.models.unet import GeneratorUNet
from tfcgan_tpu_torch.ops import flashattn, gridsample, resample
from tfcgan_tpu_torch.ops.blurpool import blur_pool_padded
from tfcgan_tpu_torch.ops.kernels import _build
from tfcgan_tpu_torch.ops.kernels import blurpool as kernel
from tfcgan_tpu_torch.ops.kernels import flashattn as fkernel
from tfcgan_tpu_torch.ops.kernels import gridsample as gkernel
from tfcgan_tpu_torch.ops.kernels import resample as rkernel
from tfcgan_tpu_torch.ops.warp import affine_grid
from tfcgan_tpu_torch.recipes import build_recipe
from tfcgan_tpu_torch.recipes import cyclegan as cyclegan_recipe
from tfcgan_tpu_torch.recipes import diffusion as diffusion_recipe
from tfcgan_tpu_torch.recipes import thermalgan as thermalgan_recipe
from tfcgan_tpu_torch.recipes import nemar as nemar_recipe
from tfcgan_tpu_torch.recipes.stn import build_generators
from tfcgan_tpu_torch.recipes.tfcgan import build_generator
from tfcgan_tpu_torch.data.pairs import PairedImageDataset, batch_iterator
from tfcgan_tpu_torch.train.checkpoint import (STATE_FILE, AsyncCheckpointManager,
                                               latest_checkpoint, restore_checkpoint,
                                               save_checkpoint)
from tfcgan_tpu_torch.train.profiling import count_params
from tfcgan_tpu_torch.train.trainer import Trainer
from tfcgan_tpu_torch.parallel import place_state, spatial


def _load_tool(name: str):
    """A tool of tools/ beside this script, loaded by its path."""
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tools", f"{name}.py")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


journeys = _load_tool("family_journey_torch")  # the learning journeys' functions

STRIDE2_SHAPES = [(8, 255, 255, 64), (8, 127, 127, 128), (8, 63, 63, 256), (8, 31, 31, 512),
                  (8, 15, 15, 512), (8, 7, 7, 512)]
STRIDE1_SHAPES = [(8, 8, 8, 512), (8, 16, 16, 512), (8, 32, 32, 256), (8, 64, 64, 128),
                  (8, 128, 128, 64)]
EXTRA_SHAPES = [(1, 15, 17, 5), (1, 255, 9, 2), (2, 31, 31, 8),
                (2, 1, 1, 8), (2, 2, 2, 8), (2, 3, 3, 8)]
STEP_BATCH = 128  # the fft_glo step whose blur-pool calls phase 3 times
THROUGHPUT_BATCHES = (8, 32, 128)
TRAIN_RATE_BATCHES = (32, 128)
TRAIN_TERMS = ("g_adv", "g_triplet", "g_temp", "g_lpips", "g_fft", "loss_G", "loss_D")
STN_TERMS = ("g_adv", "g_recon", "g_lpips", "g_morph", "loss_G", "theta_t", "loss_D", "d1",
             "d2")
NEMAR_TERMS = ("loss_G", "g_l1_tr", "g_l1_rt", "g_gan_tr", "g_gan_rt", "g_smooth", "loss_D")
DIFF_TERMS = {"tfc_diff": ("g_noise_mse", "loss_G", "loss_D"),
              "tfc_diff_label": ("g_noise_mse", "loss_G", "loss_D"),
              "tfc_diff_hybrid": ("g_recon", "g_noise_mse", "loss_G", "loss_D")}
KERNELS = ("blurpool_fwd", "blurpool_bwd", "resample_fwd", "resample_adjoint",
           "resample_gradpos", "gridsample_fwd", "gridsample_bwd", "flashattn_fwd",
           "flashattn_bwd_dq", "flashattn_bwd_dkv")
# what the counts track: every kernel, and which of the flash attention
# launches took the tensor cores (the bfloat16 ones)
FLASH_TC = ("flashattn_fwd_tc", "flashattn_bwd_dq_tc", "flashattn_bwd_dkv_tc")
COUNTED = KERNELS + FLASH_TC
# Launches a unit of each path; a kernel that is not named is launched 0 times.
# One default fft_glo step: blur-pool forward G 11 + 4 D forwards x 4; backward
# G 11 + D(fake) 4 in the G phase and 4 + 4 in the D phase (D(real) of the G
# phase is detached); no resampling
FFT_GLO_STEP = {"blurpool_fwd": 27, "blurpool_bwd": 23}
# of one stn_newmodel3 step: blur-pool forward 3 G passes x 11 + 8 D forwards x
# 4; backward 33 + D(fake) of both heads in the G phase 8 + 16 in the D phase.
# The warp runs the forward kernel twice (x-pass, y-pass); its backward runs
# the position gradient of both passes and the adjoint of the y-pass only: the
# x-pass reads the batch's B, which needs no gradient
STN_STEP = {"blurpool_fwd": 65, "blurpool_bwd": 57, "resample_fwd": 2,
            "resample_adjoint": 1, "resample_gradpos": 2}
# of one stn_newmodel3 serve batch: 3 G forwards, one warp
STN_SERVE_BATCH = {"blurpool_fwd": 33, "resample_fwd": 2}
# of one nemar serve batch: the deformable STN samples A and fake_B, stacked on
# the channels, in one call. Of one nemar step: that call and its backward (the
# T/R forward runs once; its graph is kept across D's update)
NEMAR_SERVE_BATCH = {"gridsample_fwd": 1}
NEMAR_STEP = {"gridsample_fwd": 1, "gridsample_bwd": 1}
# of one U-Net forward of the tfc_diff family: attention after 3 resnets at
# HW/4 tokens and 4 at HW/16. Of one train step: those and, in the backward,
# one dq and one dk/dv launch each. The hybrid variant's G adds one U-Net
# generator forward and backward (LPIPS has no blur-pool). A float32 step
# launches no tensor-core kernel; a bfloat16 forward or step launches all its
# flash attention kernels on the tensor cores
DIFF_STEP = {"flashattn_fwd": 7, "flashattn_bwd_dq": 7, "flashattn_bwd_dkv": 7}
DIFF_FORWARD = {"flashattn_fwd": 7, "flashattn_fwd_tc": 7}
DIFF_STEP_BF16 = {**DIFF_STEP, **{f"{k}_tc": n for k, n in DIFF_STEP.items()}}
DIFF_HYBRID_STEP = {**DIFF_STEP_BF16, "blurpool_fwd": 11, "blurpool_bwd": 11}
DIFF_SIZE = 128  # the tfc_diff configs' image side
# the nemar float32 step against a reference: elementwise x max|g|, and L2 (see main)
NEMAR_TOL, NEMAR_TOL_L2 = 1e-2, 2e-3
SIZE = 256  # image side of every path (the reference trains and serves at 256²)
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate
FP32_FLOP_PER_S = 67e12    # H100 SXM float32 rate outside the tensor cores
BF16_FLOP_PER_S = 989e12   # H100 SXM dense bfloat16 rate of the tensor cores
# exponentials: 16 a clock an SM where the float32 rate is 2 x 128 flops a clock an SM
EXP_PER_S = FP32_FLOP_PER_S / (2 * 128) * 16
# operations per tap of the resampling kernels: the weight polynomial and one
# multiply-add; 4 more per element for the position
OPS_PER_TAP = {"cubic": 12, "linear": 5}
TAPS = {"cubic": 4, "linear": 2}


def reset_counts() -> None:
    kernel.LAUNCHES = kernel.BWD_LAUNCHES = 0
    rkernel.FWD_LAUNCHES = rkernel.ADJOINT_LAUNCHES = rkernel.GRADPOS_LAUNCHES = 0
    gkernel.FWD_LAUNCHES = gkernel.BWD_LAUNCHES = 0
    fkernel.FWD_LAUNCHES = fkernel.DQ_LAUNCHES = fkernel.DKV_LAUNCHES = 0
    fkernel.FWD_TC_LAUNCHES = fkernel.DQ_TC_LAUNCHES = fkernel.DKV_TC_LAUNCHES = 0


def counts() -> dict[str, int]:
    return dict(zip(COUNTED, (kernel.LAUNCHES, kernel.BWD_LAUNCHES, rkernel.FWD_LAUNCHES,
                              rkernel.ADJOINT_LAUNCHES, rkernel.GRADPOS_LAUNCHES,
                              gkernel.FWD_LAUNCHES, gkernel.BWD_LAUNCHES,
                              fkernel.FWD_LAUNCHES, fkernel.DQ_LAUNCHES,
                              fkernel.DKV_LAUNCHES, fkernel.FWD_TC_LAUNCHES,
                              fkernel.DQ_TC_LAUNCHES, fkernel.DKV_TC_LAUNCHES)))


def scaled(per_unit: dict[str, int], units: int) -> dict[str, int]:
    """``per_unit`` x ``units`` for every count, 0 for the ones not named."""
    return {k: per_unit.get(k, 0) * units for k in COUNTED}


def expect_counts(what: str, per_unit: dict[str, int], units: int) -> dict[str, int]:
    """The counts now, which must be ``per_unit`` x ``units`` for every kernel
    (and so at least one launch of every kernel the path runs)."""
    torch.cuda.synchronize()
    got = counts()
    want = scaled(per_unit, units)
    if got != want:
        raise AssertionError(f"{what}: kernel launches {got}, want {want}")
    return got


@contextlib.contextmanager
def plain_path():
    """The port with every kernel replaced by its plain PyTorch version."""
    with mock.patch.object(layers, "blur_pool", blur_pool_padded), \
            mock.patch.object(discriminator, "blur_pool", blur_pool_padded), \
            mock.patch.object(resample, "resample_axis", resample.resample_axis_plain), \
            mock.patch.object(stn_models, "grid_sample_dense",
                              gridsample.grid_sample_dense_plain), \
            mock.patch.object(diffusion_models, "flash_attention",
                              flashattn.flash_attention_plain):
        yield


@contextlib.contextmanager
def plain_resample():
    """Only the resampling kernels replaced by their plain version."""
    with mock.patch.object(resample, "resample_axis", resample.resample_axis_plain):
        yield


def bound_ms(n_bytes: float, n_ops: float, n_exp: float = 0.0,
             ops_per_s: float = FP32_FLOP_PER_S) -> tuple[float, str]:
    """The least time the card could take: (ms, "bytes" or "operations"), the
    largest of the bytes over the memory rate, the arithmetic operations over
    ``ops_per_s`` and the exponentials over the special-function rate."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = max(n_ops / ops_per_s, n_exp / EXP_PER_S) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def cuda_ms(fn, iters: int = 20) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls, after a warm-up."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, calls: int = 10, reps: int = 10) -> float:
    """Device time of one ``fn()``: ``calls`` calls captured in one CUDA graph,
    replayed ``reps`` times. Back-to-back eager calls of a small kernel time
    the wrapper's host work instead (20-45 us a call here): the card waits."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (reps * calls)


def _check(got: torch.Tensor, want: torch.Tensor, what: str) -> float:
    """got (kernel, its dtype) against want (plain, float32, rounded to got's
    dtype); returns the max abs error."""
    dtype = got.dtype
    got, want = got.float(), want.to(dtype).float()
    torch.cuda.synchronize()
    err = (got - want).abs()
    tol = 1e-5 if dtype == torch.float32 else 8e-3 + 8e-3 * want.abs()
    if not bool((err <= tol).all()):
        raise AssertionError(f"{what}: max abs err {float(err.max())}")
    return float(err.max())


def check_blurpool(x: torch.Tensor, stride: int) -> float:
    return _check(kernel.blur_pool_fwd(x, stride), blur_pool_padded(x.float(), stride),
                  f"blurpool fwd {x.dtype} s{stride} {tuple(x.shape)}")


def _plain_grad(dy: torch.Tensor, h: int, w: int, stride: int) -> torch.Tensor:
    x = torch.zeros((dy.shape[0], h, w, dy.shape[3]), device=dy.device, requires_grad=True)
    return torch.autograd.grad(blur_pool_padded(x, stride), x, dy.float())[0]


def check_blurpool_bwd(shape, stride: int, dtype, gen) -> float:
    n, h, w, c = shape
    dy = torch.randn((n, kernel.out_len(h, stride), kernel.out_len(w, stride), c),
                     device=gen.device, generator=gen).to(dtype)
    return _check(kernel.blur_pool_bwd(dy, h, w, stride), _plain_grad(dy, h, w, stride),
                  f"blurpool bwd {dtype} s{stride} {tuple(shape)}")


def fft_glo_step_calls(batch: int) -> tuple[list, list]:
    """One fft_glo step's blur-pool calls at ``batch``: ((shape, stride,
    calls) of the forward, of the backward). G runs its 11 shapes once each
    way; D's 4 blocks have G's first four stride-2 shapes and run in its 4
    forwards and 3 backwards (``FFT_GLO_STEP``)."""
    shapes = [((batch, *s[1:]), 2) for s in STRIDE2_SHAPES]
    shapes += [((batch, *s[1:]), 1) for s in STRIDE1_SHAPES]
    fwd = [(s, st, 1 + 4 * (i < 4)) for i, (s, st) in enumerate(shapes)]
    bwd = [(s, st, 1 + 3 * (i < 4)) for i, (s, st) in enumerate(shapes)]
    assert sum(c for *_, c in fwd) == FFT_GLO_STEP["blurpool_fwd"]
    assert sum(c for *_, c in bwd) == FFT_GLO_STEP["blurpool_bwd"]
    return fwd, bwd


def blur_work(shape, stride: int, element_size: int) -> tuple[int, int]:
    """(bytes, operations) of one blur-pool call either way at the forward's
    input ``shape``: the input and the output once, 16 multiply-adds an output
    (the backward reads dy and writes dx: the same bytes and products)."""
    n, h, w, c = shape
    out = n * kernel.out_len(h, stride) * kernel.out_len(w, stride) * c
    return (n * h * w * c + out) * element_size, 2 * 16 * out


def time_step_calls(device, batch: int, gen) -> dict[str, dict]:
    """Kernel ms and bound of one fft_glo step's bf16 blur-pool calls at
    ``batch``, forward and backward: {"blurpool_fwd": {...}, ...}."""
    out = {}
    for name, calls in zip(("blurpool_fwd", "blurpool_bwd"), fft_glo_step_calls(batch)):
        ms = n_bytes = n_ops = 0
        for shape, stride, count in calls:
            n, h, w, c = shape
            if name == "blurpool_fwd":
                x = torch.randn(shape, device=device, generator=gen).to(torch.bfloat16)
                ms += count * cuda_ms(lambda: kernel.blur_pool_fwd(x, stride), 10)
            else:
                x = torch.randn((n, kernel.out_len(h, stride), kernel.out_len(w, stride), c),
                                device=device, generator=gen).to(torch.bfloat16)
                ms += count * cuda_ms(lambda: kernel.blur_pool_bwd(x, h, w, stride), 10)
            b, o = blur_work(shape, stride, 2)
            n_bytes, n_ops = n_bytes + count * b, n_ops + count * o
            del x
            torch.cuda.empty_cache()
        bound, by = bound_ms(n_bytes, n_ops)
        out[name] = {"calls": sum(c for *_, c in calls), "ms": ms, "bound_ms": bound,
                     "bound_by": by, "bytes": n_bytes}
    return out


def in_turns(plain, kern, iters: int = 20) -> tuple[float, float]:
    """(kernel ms, plain ms): plain, kernel, kernel, plain, averaged."""
    p1, k1, k2, p2 = (cuda_ms(f, iters) for f in (plain, kern, kern, plain))
    return (k1 + k2) / 2, (p1 + p2) / 2


def phase_kernels(device) -> tuple[dict, dict]:
    """Blur-pool forward and backward kernel vs plain; one result dict each
    (max_abs_err, ms, plain_ms, bound_ms, bound_by)."""
    gen = torch.Generator(device=device).manual_seed(0)
    fwd, bwd = [0.0, 0.0, 0.0, 0.0], [0.0, 0.0, 0.0, 0.0]
    n_bytes = n_ops = 0
    path = [(s, 2) for s in STRIDE2_SHAPES] + [(s, 1) for s in STRIDE1_SHAPES]
    for dtype in (torch.float32, torch.bfloat16):
        name = "fp32" if dtype == torch.float32 else "bf16"
        for shape, stride in path:
            x = torch.randn(shape, device=device, generator=gen).to(dtype)
            errs = [check_blurpool(x, s) for s in (1, 2)]
            errs_b = [check_blurpool_bwd(shape, s, dtype, gen) for s in (1, 2)]
            fwd[0], bwd[0] = max(fwd[0], *errs), max(bwd[0], *errs_b)
            k, p = in_turns(lambda: blur_pool_padded(x, stride),
                            lambda: kernel.blur_pool_fwd(x, stride))
            if not torch.equal(*(kernel.blur_pool_fwd(x, stride) for _ in range(2))):
                raise AssertionError(f"blurpool fwd {name} s{stride} {shape} does not repeat")
            n, h, w, c = shape
            dy = torch.randn((n, kernel.out_len(h, stride), kernel.out_len(w, stride), c),
                             device=device, generator=gen).to(dtype)
            if not torch.equal(*(kernel.blur_pool_bwd(dy, h, w, stride) for _ in range(2))):
                raise AssertionError(f"blurpool bwd {name} s{stride} {shape} does not repeat")
            xg = x.detach().requires_grad_()
            y = blur_pool_padded(xg, stride)
            kb, pb = in_turns(lambda: torch.autograd.grad(y, xg, dy, retain_graph=True),
                              lambda: kernel.blur_pool_bwd(dy, h, w, stride))
            if dtype == torch.bfloat16:
                fwd[1], fwd[2], bwd[1], bwd[2] = fwd[1] + k, fwd[2] + p, bwd[1] + kb, bwd[2] + pb
                fwd[3] += graph_ms(lambda: kernel.blur_pool_fwd(x, stride))
                bwd[3] += graph_ms(lambda: kernel.blur_pool_bwd(dy, h, w, stride))
                b, o = blur_work(shape, stride, x.element_size())
                n_bytes, n_ops = n_bytes + b, n_ops + o
            print(f"kernel blurpool {name} s{stride} {shape}: max_abs_err fwd s1 {errs[0]:.3g} "
                  f"s2 {errs[1]:.3g}, bwd s1 {errs_b[0]:.3g} s2 {errs_b[1]:.3g}; "
                  f"fwd kernel {k:.4f} ms, plain {p:.4f} ms ({p / k:.2f}x); "
                  f"bwd kernel {kb:.4f} ms, plain {pb:.4f} ms ({pb / kb:.2f}x)")
        for shape in EXTRA_SHAPES:
            x = torch.randn(shape, device=device, generator=gen).to(dtype)
            errs = [check_blurpool(x, s) for s in (1, 2)]
            errs_b = [check_blurpool_bwd(shape, s, dtype, gen) for s in (1, 2)]
            fwd[0], bwd[0] = max(fwd[0], *errs), max(bwd[0], *errs_b)
            print(f"kernel blurpool {name} {shape}: max_abs_err fwd s1 {errs[0]:.3g} "
                  f"s2 {errs[1]:.3g}, bwd s1 {errs_b[0]:.3g} s2 {errs_b[1]:.3g}")
    bound, by = bound_ms(n_bytes, n_ops)
    print(f"kernel blurpool: all cases within tolerance, max_abs_err fwd {fwd[0]:.3g}, "
          f"bwd {bwd[0]:.3g}; both repeat bit for bit at every path shape; one bf16 "
          f"B=8 G forward's 11 calls: kernel {fwd[1]:.4f} ms (device alone, CUDA graph: "
          f"{fwd[3]:.4f}), plain {fwd[2]:.4f} ms; their backward: kernel {bwd[1]:.4f} ms "
          f"(device alone {bwd[3]:.4f}), plain {bwd[2]:.4f} ms; bound {bound:.4f} ms each way "
          f"({by}: {n_bytes / 1e6:.1f} MB, {n_ops / 1e9:.2f} GFLOP)")
    step = time_step_calls(device, STEP_BATCH, gen)
    for k, r in step.items():
        print(f"kernel {k}: the {r['calls']} bf16 calls of one fft_glo step at B={STEP_BATCH}: "
              f"kernel {r['ms']:.4f} ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']}: "
              f"{r['bytes'] / 1e9:.3f} GB), {100 * r['bound_ms'] / r['ms']:.1f} % of the bound")
    keys = ("max_abs_err", "ms", "plain_ms", "graph_ms")
    extra = {"bound_ms": bound, "bound_by": by, "library_ms": None}
    return tuple({**dict(zip(keys, v)), **extra, "step_ms": step[k]["ms"],
                  "step_bound_ms": step[k]["bound_ms"], "step_calls": step[k]["calls"]}
                 for k, v in (("blurpool_fwd", fwd), ("blurpool_bwd", bwd)))


# ------------------------------------------------------------ resampling (K2)
def _within(got: torch.Tensor, want: torch.Tensor, tol: float, what: str,
            floor: float = 1.0) -> float:
    """max|got - want|, which must be within ``tol`` x max(``floor``, max|want|)."""
    torch.cuda.synchronize()
    err, scale = float((got.float() - want.float()).abs().max()), float(want.abs().max())
    if not err <= tol * max(floor, scale):
        raise AssertionError(f"{what}: max abs err {err:.3g} at max|plain| {scale:.3g}, "
                             f"tolerance {tol} x max({floor}, max|plain|)")
    return err


def check_resample(x, p, q, g, mode: str, border: bool, channels: int, what: str,
                   o_base: int = 0) -> tuple[float, float, float]:
    """The three kernels on one case against the plain version and its
    autograd gradients; x (outer, l_in, inner), g (outer, l_out, inner), the
    outputs o_base .. o_base + l_out - 1 of each line. The adjoint and the
    position gradient run twice and must repeat bit for bit."""
    l_in, l_out = x.shape[1], g.shape[1]
    args = (mode, border, channels, o_base)
    out = rkernel.resample_fwd(x, p, q, l_out, *args)
    gx = rkernel.resample_adjoint(g, p, q, l_in, *args)
    gp, gq = rkernel.resample_gradpos(x, g, p, q, *args)
    again = (rkernel.resample_adjoint(g, p, q, l_in, *args),
             *rkernel.resample_gradpos(x, g, p, q, *args))
    if not all(torch.equal(a, b) for a, b in zip((gx, gp, gq), again)):
        raise AssertionError(f"{what}: the adjoint or the position gradient does not repeat "
                             f"bit for bit")
    xp = x.float().requires_grad_()
    pp, qp = p.clone().requires_grad_(), q.clone().requires_grad_()
    want = resample.resample_axis_plain(xp, pp, qp, l_out, *args)
    wx, wp, wq = torch.autograd.grad(want, (xp, pp, qp), g)
    return (_within(out, want.detach(), 2e-5, f"{what} forward"),
            _within(gx, wx, 2e-5, f"{what} adjoint"),
            max(_within(gp, wp, 2e-4, f"{what} gp"), _within(gq, wq, 2e-4, f"{what} gq")))


def _hard_lines(outer: int, lines: int, l_in: int, gen) -> tuple[torch.Tensor, torch.Tensor]:
    """p in [0.5, 4] and q in [-3, 3], the first lines replaced by the corner
    cases: p = 0.5 and 4 (the ends of the TPU adjoint's domain), the identity,
    lines wholly below and above the axis, p = 0.25 and 0 (outside that
    domain) and a flip."""
    dev = gen.device
    p = torch.empty(outer * lines, device=dev).uniform_(0.5, 4.0, generator=gen)
    q = torch.empty(outer * lines, device=dev).uniform_(-3.0, 3.0, generator=gen)
    corner = [(0.5, 0.3), (4.0, -1.7), (1.0, 0.0), (1.0, -3.0 * l_in - 5.0),
              (1.0, 3.0 * l_in + 5.0), (0.25, 0.4), (0.0, 0.5 * (l_in - 1)), (-1.0, l_in - 1.0)]
    for i, (pv, qv) in enumerate(corner[:outer * lines]):
        p[i], q[i] = pv, qv
    return p.view(outer, lines), q.view(outer, lines)


def _edge_lines(outer: int, lines: int, l_in: int, l_out: int, gen
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """p in [-4, 4] and q in [-l_in, 2 l_in], the first lines the cases of the
    adjoint's edge masses: lines over both ends (p = 2 from q = -3, its flip,
    and a slope that spans the line and 3 elements beyond each end), p = 0
    inside the line, near either end (the window leaves it) and beyond either
    end, p < 0 across the low end and across both, the identity shifted by half
    an element, a line that starts below 0."""
    dev = gen.device
    p = torch.empty(outer * lines, device=dev).uniform_(-4.0, 4.0, generator=gen)
    q = torch.empty(outer * lines, device=dev).uniform_(-l_in, 2.0 * l_in, generator=gen)
    corner = [(2.0, -3.0), (-2.0, l_in + 2.0), ((l_in + 6.0) / l_out, -3.0),
              (0.0, 0.5 * (l_in - 1)), (0.0, -0.7), (0.0, l_in - 1.3), (0.0, -5.0),
              (0.0, l_in + 4.0), (-1.5, l_in + 2.0), (-0.3, 1.0), (-4.0, 3.0 * l_in),
              (1.0, 0.5), (0.7, -2.5)]
    for i, (pv, qv) in enumerate(corner[:outer * lines]):
        p[i], q[i] = pv, qv
    return p.view(outer, lines), q.view(outer, lines)


# (l_in, l_out) of the edge cases: windows that hold the whole line (1 and 2
# elements; v == 0 is also the last element at 1), 3 elements, and a line
# longer than any window
EDGE_LENGTHS = ((1, 4), (2, 5), (3, 3), (40, 57))
EDGE_CHANNELS = (1, 3, 5, 10)  # 3 takes the unrolled channel loop, the rest the run-time one


def record_passes(src: torch.Tensor, theta: torch.Tensor, mode: str = "bicubic") -> list:
    """The arguments ``warp_affine_separable`` hands to ``resample_axis`` in its
    two passes: (x, p, q, l_out, mode, border, channels) each (the whole warp:
    its outputs start at o_base 0)."""
    calls = []

    def rec(x, p, q, l_out, mode, border, channels, o_base=0):
        assert o_base == 0
        calls.append((x.detach(), p.detach().float().contiguous(),
                      q.detach().float().contiguous(), l_out, mode, border, channels))
        return resample.resample_axis_plain(x, p, q, l_out, mode, border, channels)

    with mock.patch.object(resample, "resample_axis", rec), torch.no_grad():
        resample.warp_affine_separable(src, theta, mode)
    return calls


def _near_identity_theta(n: int, gen) -> torch.Tensor:
    """Rotations up to 0.1 rad, scales 0.9-1.1, shifts up to 0.1: what the STN
    predicts in training."""
    u = torch.rand((n, 5), device=gen.device, generator=gen) * 2 - 1
    ang, sx, sy = 0.1 * u[:, 0], 1 + 0.1 * u[:, 1], 1 + 0.1 * u[:, 2]
    return torch.stack([torch.stack([torch.cos(ang) * sx, -torch.sin(ang), 0.1 * u[:, 3]], 1),
                        torch.stack([torch.sin(ang), torch.cos(ang) * sy, 0.1 * u[:, 4]], 1)], 1)


def _time_pass(x, p, q, g, mode, border, channels) -> dict[str, tuple[float, float]]:
    """(kernel ms, plain ms) of each of the three kernels on one pass."""
    l_in, l_out = x.shape[1], g.shape[1]
    args = (mode, border, channels)
    xp = x.float().requires_grad_()
    pp, qp = p.clone().requires_grad_(), q.clone().requires_grad_()
    want = resample.resample_axis_plain(xp, pp, qp, l_out, *args)

    def plain_fwd():
        with torch.no_grad():
            return resample.resample_axis_plain(x, p, q, l_out, *args)

    return {
        "resample_fwd": in_turns(plain_fwd, lambda: rkernel.resample_fwd(x, p, q, l_out, *args)),
        "resample_adjoint": in_turns(
            lambda: torch.autograd.grad(want, xp, g, retain_graph=True),
            lambda: rkernel.resample_adjoint(g, p, q, l_in, *args)),
        "resample_gradpos": in_turns(
            lambda: torch.autograd.grad(want, (pp, qp), g, retain_graph=True),
            lambda: rkernel.resample_gradpos(x, g, p, q, *args)),
    }


def _pass_bounds(x, p, g, mode) -> dict[str, tuple[float, float]]:
    """(bytes, operations) of each kernel on one pass: inputs read once,
    outputs written once; one window of taps per output element, which is also
    every product the adjoint needs for these lines."""
    lines = 2 * p.numel() * 4
    x_bytes, g_bytes = x.numel() * x.element_size(), g.numel() * 4
    ops = g.numel() * (TAPS[mode] * OPS_PER_TAP[mode] + 4)
    return {"resample_fwd": (x_bytes + g_bytes + lines, ops),
            "resample_adjoint": (g_bytes + x.numel() * 4 + lines, ops),
            "resample_gradpos": (x_bytes + g_bytes + 2 * lines, ops + 3 * g.numel())}


# the passes of one stn warp each kernel runs: the position gradient both, the
# adjoint only the y-pass (the x-pass reads the batch, which needs no gradient)
WARP_PASSES = {"resample_fwd": (0, 1), "resample_adjoint": (1,), "resample_gradpos": (0, 1)}


def _warp_call(name: str, x, p, q, g, l_out, *args):
    if name == "resample_fwd":
        return rkernel.resample_fwd(x, p, q, l_out, *args)
    if name == "resample_adjoint":
        return rkernel.resample_adjoint(g, p, q, x.shape[1], *args)
    return rkernel.resample_gradpos(x, g, p, q, *args)


def time_warp(src: torch.Tensor, theta: torch.Tensor, card: str, gen) -> dict[str, dict]:
    """Each kernel over its passes of one cubic warp of ``src`` with a float32
    image, the forward and the position gradient also with a bfloat16 one (the
    adjoint reads no image): eager and device-alone (CUDA graph) ms and the
    byte bound; two identical runs compared bit for bit. Returns the keys the
    kernels' JSON adds: ``graph_ms``, and ``bf16_ms``, ``bf16_graph_ms`` and
    ``bf16_bound_ms`` where there is a bfloat16 run."""
    out = {k: {} for k in WARP_PASSES}
    for dtype, tag in ((torch.float32, ""), (torch.bfloat16, "bf16_")):
        passes = record_passes(src.to(dtype), theta)
        grads = [torch.randn((x.shape[0], l_out, x.shape[2]), device=x.device, generator=gen)
                 for x, _, _, l_out, *_ in passes]
        for name, used in WARP_PASSES.items():
            if dtype == torch.bfloat16 and name == "resample_adjoint":
                continue

            def warp():
                return [_warp_call(name, x, p, q, grads[i], *rest)
                        for i, (x, p, q, *rest) in enumerate(passes) if i in used]

            flat = [[t for r in run for t in (r if isinstance(r, tuple) else (r,))]
                    for run in (warp(), warp())]
            if not all(torch.equal(a, b) for a, b in zip(*flat)):
                raise AssertionError(f"{name} {dtype} does not repeat bit for bit")
            n_bytes = n_ops = 0
            for i in used:
                x, p, _, _, mode, *_ = passes[i]
                b, o = _pass_bounds(x, p, grads[i], mode)[name]
                n_bytes, n_ops = n_bytes + b, n_ops + o
            ms, alone, (bound, by) = cuda_ms(warp), graph_ms(warp), bound_ms(n_bytes, n_ops)
            out[name].update({f"{tag}ms": ms, f"{tag}graph_ms": alone, f"{tag}bound_ms": bound})
            print(f"kernel {name}: one cubic warp ({'- and '.join('xy'[i] for i in used)}-pass) "
                  f"of a {tuple(src.shape)} {str(dtype).split('.')[1]} image: kernel {ms:.4f} "
                  f"ms, device alone (CUDA graph) {alone:.4f} ms, bound {bound:.4f} ms ({by}, "
                  f"{n_bytes / 1e6:.1f} MB): {100 * bound / alone:.1f} % of the bound on the "
                  f"device alone; repeats bit for bit [{card}]")
    return {name: {k: v for k, v in d.items() if k not in ("ms", "bound_ms")}
            for name, d in out.items()}


def phase_resample(device, card: str) -> dict[str, dict]:
    """The resampling kernels vs plain; one result dict per kernel."""
    gen = torch.Generator(device=device).manual_seed(2)
    names = KERNELS[2:5]
    worst = dict.fromkeys(names, 0.0)

    def run(x, p, q, l_out, mode, border, channels, what, show=True):
        g = torch.randn((x.shape[0], l_out, x.shape[2]), device=device, generator=gen)
        errs = check_resample(x, p, q, g, mode, border, channels, what)
        for k, e in zip(names, errs):
            worst[k] = max(worst[k], e)
        if show:
            print(f"kernel resample {what}: max abs err fwd {errs[0]:.3g}, adjoint "
                  f"{errs[1]:.3g}, gradpos {errs[2]:.3g} (max abs)")
        return errs

    # the path's two passes, near-identity thetas, cubic and border
    for n in (8, 32):
        src = torch.rand((n, SIZE, SIZE, 3), device=device, generator=gen) * 2 - 1
        theta = _near_identity_theta(n, gen)
        for dtype in (torch.float32, torch.bfloat16):
            for i, (x, p, q, l_out, *rest) in enumerate(record_passes(src.to(dtype), theta)):
                run(x, p, q, l_out, *rest, f"path B={n} {'xy'[i]}-pass "
                    f"{tuple(x.shape)} {str(x.dtype).split('.')[1]} cubic border")
    # the same views with hard lines, then every other mode, stride and shape
    cases = [((2 * 256, 256, 3), 256, 3), ((2, 256, 768), 256, 3),  # the path's views
             ((64, 100, 1), 100, 1), ((16, 40, 6), 57, 3), ((7, 33, 10), 20, 5),
             ((15, 17, 5), 17, 5), ((1, 15, 85), 15, 5),            # (1, 15, 17, 5)
             ((4, 1, 6), 1, 3), ((4, 2, 6), 5, 3), ((4, 3, 6), 3, 3), ((3, 1, 1), 4, 1)]
    for shape, l_out, channels in cases:
        for mode in ("cubic", "linear"):
            for border in (True, False):
                for dtype in (torch.float32, torch.bfloat16):
                    x = torch.randn(shape, device=device, generator=gen).to(dtype)
                    p, q = _hard_lines(shape[0], shape[2] // channels, shape[1], gen)
                    run(x, p, q, l_out, mode, border, channels,
                        f"{shape}->{l_out} c{channels} {str(dtype).split('.')[1]} {mode} "
                        f"{'border' if border else 'zeros'}")

    # the adjoint's edge masses and the run-time channel loop: every edge line
    # of _edge_lines at 1-3 elements and at 40, 1, 3, 5 and 10 channels a line
    for channels in EDGE_CHANNELS:
        errs = [0.0, 0.0, 0.0]
        for l_in, l_out in EDGE_LENGTHS:
            shape = (8, l_in, 2 * channels)
            for mode in ("cubic", "linear"):
                for border in (True, False):
                    for dtype in (torch.float32, torch.bfloat16):
                        x = torch.randn(shape, device=device, generator=gen).to(dtype)
                        p, q = _edge_lines(8, 2, l_in, l_out, gen)
                        got = run(x, p, q, l_out, mode, border, channels,
                                  f"edge lines {shape}->{l_out} c{channels} "
                                  f"{str(dtype).split('.')[1]} {mode} "
                                  f"{'border' if border else 'zeros'}", show=False)
                        errs = [max(a, b) for a, b in zip(errs, got)]
        print(f"kernel resample edge lines, {channels} channels a line, (l_in, l_out) in "
              f"{EDGE_LENGTHS}, both modes, border and zeros, float32 and bfloat16: max abs "
              f"err fwd {errs[0]:.3g}, adjoint {errs[1]:.3g}, gradpos {errs[2]:.3g}; adjoint "
              f"and gradpos repeat bit for bit")

    # the separable warp through the kernels against the plain path
    for shape, mode, padding in (((2, 64, 48, 3), "bicubic", "border"),
                                 ((1, 15, 17, 5), "bilinear", "zeros")):
        src = torch.randn(shape, device=device, generator=gen)
        theta = _near_identity_theta(shape[0], gen)
        ct = torch.randn(shape, device=device, generator=gen)
        results = []
        for ctx in (contextlib.nullcontext(), plain_path()):
            s, t = src.clone().requires_grad_(), theta.clone().requires_grad_()
            with ctx:
                out = resample.warp_affine_separable(s, t, mode, padding)
                results.append((out.detach(), *torch.autograd.grad(out, (s, t), ct)))
        errs = [_within(a, b, tol, f"warp_affine_separable {shape} {mode} {padding} {what}")
                for a, b, tol, what in zip(*results, (2e-5, 2e-5, 2e-4),
                                           ("output", "d/dsrc", "d/dtheta"))]
        print(f"warp_affine_separable {shape} {mode} {padding}, kernels vs plain path: max abs err "
              f"output {errs[0]:.3g}, d/dsrc {errs[1]:.3g}, d/dtheta {errs[2]:.3g}")

    # times and bounds at the path's shape: one warp at (32, 256, 256, 3) float32
    src = torch.rand((32, SIZE, SIZE, 3), device=device, generator=gen) * 2 - 1
    theta = _near_identity_theta(32, gen)
    used = WARP_PASSES
    total = {k: [0.0, 0.0, 0.0, 0.0] for k in names}  # kernel ms, plain ms, bytes, operations
    for i, (x, p, q, l_out, mode, border, channels) in enumerate(record_passes(src, theta)):
        g = torch.randn((x.shape[0], l_out, x.shape[2]), device=device, generator=gen)
        times, bounds = _time_pass(x, p, q, g, mode, border, channels), _pass_bounds(x, p, g, mode)
        for k in names:
            b, by = bound_ms(*bounds[k])
            print(f"kernel {k} {'xy'[i]}-pass {tuple(x.shape)} fp32 cubic: kernel "
                  f"{times[k][0]:.4f} ms, plain {times[k][1]:.4f} ms "
                  f"({times[k][1] / times[k][0]:.1f}x), bound {b:.4f} ms ({by}) [{card}]")
            if i in used[k]:
                for j, v in enumerate((*times[k], *bounds[k])):
                    total[k][j] += v
    # the library yardstick: the direct 2-D warp, equal to the separable one
    # only without rotation or shear; timed here, called nowhere in the port
    src_n = src.permute(0, 3, 1, 2).contiguous().requires_grad_()
    th = theta.clone().requires_grad_()
    ct = torch.randn_like(src_n)

    def library():
        grid = F.affine_grid(th, src_n.shape, align_corners=True)
        return F.grid_sample(src_n, grid, mode="bicubic", padding_mode="border",
                             align_corners=True)

    alone = time_warp(src, theta, card, gen)
    out = library()
    lib = {"resample_fwd": cuda_ms(lambda: library().detach()),
           "resample_adjoint": cuda_ms(
               lambda: torch.autograd.grad(out, src_n, ct, retain_graph=True)),
           "resample_gradpos": cuda_ms(lambda: torch.autograd.grad(out, th, ct, retain_graph=True))}
    results = {}
    for k in names:
        b, by = bound_ms(total[k][2], total[k][3])
        results[k] = {"max_abs_err": worst[k], "ms": total[k][0], "plain_ms": total[k][1],
                      "bound_ms": b, "bound_by": by, "library_ms": lib[k], **alone[k]}
        print(f"kernel {k}: all cases within tolerance, worst {worst[k]:.3g}; one warp at "
              f"(32,256,256,3) fp32 (passes {[('x', 'y')[i] for i in used[k]]}): kernel "
              f"{total[k][0]:.4f} ms, plain {total[k][1]:.4f} ms, bound {b:.4f} ms ({by}, "
              f"{total[k][2] / 1e6:.1f} MB), F.grid_sample {lib[k]:.4f} ms [{card}]")
    return results


# ------------------------------------------------- dense grid_sample (K3)
GRAD_TOL = 1e-4  # of max(1, max|plain|), both K3 gradients (see the docstring)


def _identity_grid(n: int, h: int, w: int, device, align: bool = False) -> torch.Tensor:
    theta = torch.tensor([[1.0, 0.0, 0.0], [0.0, 1.0, 0.0]], device=device).expand(n, 2, 3)
    return affine_grid(theta, (n, h, w), align_corners=align).contiguous()


def check_gridsample(inp, grid, g, padding: str, align: bool, what: str
                     ) -> tuple[float, float, float]:
    """Both kernels on one case against the plain version and autograd of it:
    max abs errors of the output, the image gradient and the grid gradient.
    Samples with a coordinate that is inf, NaN or overflows when it is turned
    into pixels (where the plain version has no defined result) are held to
    the kernel's own rule (finite results; under zeros the output 0; no
    gradient to that coordinate), and the rest of the case is compared with
    those samples parked on a finite coordinate and given no output gradient."""
    out = gkernel.gridsample_fwd(inp, grid, padding, align)
    d_inp, d_grid = gkernel.gridsample_bwd(g, inp, grid, padding, align)
    bad = ~(grid.abs() <= 1e30)  # true for NaN too
    keep = ~bad.any(dim=-1, keepdim=True)
    grid_p = grid
    if bool(bad.any()):
        torch.cuda.synchronize()
        for name, t in (("output", out), ("image gradient", d_inp), ("grid gradient", d_grid)):
            if not bool(torch.isfinite(t).all()):
                raise AssertionError(f"{what}: {name} not finite at non-finite coordinates")
        if padding == "zeros" and bool(out[~keep.expand_as(out)].any()):
            raise AssertionError(f"{what}: a non-finite sample is not 0 under zeros padding")
        if bool(d_grid[bad].any()):
            raise AssertionError(f"{what}: gradient to a non-finite coordinate")
        grid_p = torch.where(bad, torch.zeros_like(grid), grid)
        g = g * keep.to(g.dtype)
        d_inp, d_grid = gkernel.gridsample_bwd(g, inp, grid, padding, align)
    ip, gp = inp.float().requires_grad_(), grid_p.clone().requires_grad_()
    want = gridsample.grid_sample_dense_plain(ip, gp, "bilinear", padding, align)
    # (reflection folds a 1-pixel axis to a constant: the grid may be unused)
    wi, wg = torch.autograd.grad(want, (ip, gp), g.float(), allow_unused=True)
    wg = torch.zeros_like(grid) if wg is None else wg
    want = want.detach()
    if inp.dtype == torch.float32:
        e_out = _within(out * keep, want * keep, 1e-5, f"{what} forward")
    else:
        e_out = _check(out * keep.to(out.dtype), want * keep, f"{what} forward")
    return (e_out, _within(d_inp, wi, GRAD_TOL, f"{what} image gradient"),
            _within(d_grid * keep, wg * keep, GRAD_TOL, f"{what} grid gradient"))


def phase_gridsample(device, card: str) -> dict[str, dict]:
    """The K3 kernels vs plain; one result dict per kernel."""
    gen = torch.Generator(device=device).manual_seed(4)
    worst = [0.0, 0.0, 0.0]
    paddings = gkernel.PADDING_MODES

    def run(inp, grid, padding, align, what):
        g = torch.randn((*grid.shape[:3], inp.shape[3]), device=device,
                        generator=gen).to(inp.dtype)
        errs = check_gridsample(inp, grid.contiguous(), g, padding, align, what)
        for i, e in enumerate(errs):
            worst[i] = max(worst[i], e)
        return errs

    def rand(shape, dtype=torch.float32):
        return torch.randn(shape, device=device, generator=gen).to(dtype)

    def uniform(shape, scale):
        return (torch.rand(shape, device=device, generator=gen) * 2 - 1) * scale

    # the path's shape: A and fake_B stacked, zeros, align_corners=False; the
    # identity grid (every sample on an integer coordinate), offsets of a
    # fraction of a pixel and of several pixels (2 / SIZE is one pixel)
    for n in (8, 32):
        base = _identity_grid(n, SIZE, SIZE, device)
        for dtype in (torch.float32, torch.bfloat16):
            inp = rand((n, SIZE, SIZE, 6), dtype)
            for label, pixels in (("identity grid", 0.0), ("offsets 0.3 px", 0.3),
                                  ("offsets 5 px", 5.0)):
                grid = base + uniform(base.shape, pixels * 2 / SIZE) if pixels else base
                errs = run(inp, grid, "zeros", False, f"path B={n} {label}")
                print(f"kernel gridsample path ({n},{SIZE},{SIZE},6) {str(dtype).split('.')[1]} "
                      f"{label}: max abs err fwd {errs[0]:.3g}, image gradient {errs[1]:.3g}, "
                      f"grid gradient {errs[2]:.3g}")
    # every padding mode and align_corners on small and odd cases
    cases = 0
    for padding in paddings:
        for align in (False, True):
            for dtype in (torch.float32, torch.bfloat16):
                tag = f"{padding} align={align} {str(dtype).split('.')[1]}"
                for c in (1, 2, 3, 6, 8, 300):  # Hg, Wg != H, W; 300: two channels a thread
                    run(rand((2, 24, 40, c), dtype), uniform((2, 16, 33, 2), 1.2), padding,
                        align, f"(2,24,40,{c})->(16,33) {tag}")
                for shape in ((2, 1, 1, 3), (2, 2, 3, 2), (1, 3, 1, 1)):  # 1-3 pixel images
                    run(rand(shape, dtype), uniform((shape[0], 5, 7, 2), 1.5), padding, align,
                        f"{shape}->(5,7) {tag}")
                inp = rand((2, 24, 40, 3), dtype)
                run(inp, uniform((2, 16, 33, 2), 6.0), padding, align, f"5x off the image {tag}")
                # 4096 outputs a sample on one spot: the image gradient's longest sums
                for at in ((0.0, 0.0), (0.313, -0.477)):
                    grid = torch.tensor(at, device=device).expand(2, 64, 64, 2)
                    run(inp, grid, padding, align, f"constant grid {at} {tag}")
                # on integer coordinates
                run(rand((2, 16, 16, 3), dtype), _identity_grid(2, 16, 16, device, align), padding,
                    align, f"identity (2,16,16,3) {tag}")
                # coordinates that no int holds
                grid = uniform((2, 16, 33, 2), 1.2)
                flat = grid.view(-1)
                for i, v in enumerate((1e10, -1e10, float("inf"), float("-inf"), float("nan"),
                                       3e38, float("nan"), float("inf"))):
                    flat[7 * i + 3] = v
                flat[200], flat[201] = float("nan"), float("inf")  # both of one sample
                run(inp, grid, padding, align, f"non-finite coordinates {tag}")
                cases += 15
    print(f"kernel gridsample: {cases} small cases (3 paddings x 2 align_corners x fp32/bf16: "
          f"C = 1, 2, 3, 6, 8, 300 at (2,24,40,C)->(16,33), 1-3 pixel images, 5x off the "
          f"image, constant grids, the identity grid, coordinates 1e10, 3e38, inf, NaN) "
          "within tolerance")

    # times, bounds and the run-to-run difference at the path's shape, B=32
    inp = rand((32, SIZE, SIZE, 6))
    grid = (_identity_grid(32, SIZE, SIZE, device)
            + uniform((32, SIZE, SIZE, 2), 0.6 / SIZE)).contiguous()
    g = rand((32, SIZE, SIZE, 6))
    ip, gp = inp.clone().requires_grad_(), grid.clone().requires_grad_()
    want = gridsample.grid_sample_dense_plain(ip, gp)

    def plain_fwd():
        with torch.no_grad():
            return gridsample.grid_sample_dense_plain(inp, grid)

    k_f, p_f = in_turns(plain_fwd, lambda: gkernel.gridsample_fwd(inp, grid))
    k_b, p_b = in_turns(lambda: torch.autograd.grad(want, (ip, gp), g, retain_graph=True),
                        lambda: gkernel.gridsample_bwd(g, inp, grid))
    k_bg = cuda_ms(lambda: gkernel.gridsample_bwd(g, inp, grid, need_inp=False))
    k_bi = cuda_ms(lambda: gkernel.gridsample_bwd(g, inp, grid, need_grid=False))
    del want, ip, gp
    # the library yardstick, in its own layout; timed here, called nowhere in the port
    inp_n = inp.permute(0, 3, 1, 2).contiguous().requires_grad_()
    grid_l, g_n = grid.clone().requires_grad_(), g.permute(0, 3, 1, 2).contiguous()
    lib_out = F.grid_sample(inp_n, grid_l, mode="bilinear", padding_mode="zeros",
                            align_corners=False)
    lib_err = float((lib_out.detach().permute(0, 2, 3, 1)
                     - gkernel.gridsample_fwd(inp, grid)).abs().max())
    if lib_err > 1e-5:
        raise AssertionError(f"gridsample forward vs F.grid_sample: max abs err {lib_err}")
    with torch.no_grad():
        lib_f = cuda_ms(lambda: F.grid_sample(inp_n, grid_l, mode="bilinear",
                                              padding_mode="zeros", align_corners=False))
    lib_b = cuda_ms(lambda: torch.autograd.grad(lib_out, (inp_n, grid_l), g_n, retain_graph=True))
    # the forward in bfloat16 at the same shape (F.grid_sample takes no
    # bfloat16 image with a float32 grid: no library time)
    inp16 = inp.to(torch.bfloat16)
    k_f16 = cuda_ms(lambda: gkernel.gridsample_fwd(inp16, grid))
    if not torch.equal(*(gkernel.gridsample_fwd(inp16, grid) for _ in range(2))):
        raise AssertionError("gridsample: the bf16 forward does not repeat")
    del lib_out, inp_n, grid_l, g_n, inp16
    first, second = (gkernel.gridsample_bwd(g, inp, grid) for _ in range(2))
    again = gkernel.gridsample_fwd(inp, grid)
    torch.cuda.synchronize()
    if not torch.equal(first[1], second[1]) or not torch.equal(
            again, gkernel.gridsample_fwd(inp, grid)):
        raise AssertionError("gridsample: the forward or the grid gradient does not repeat")
    repeat = float((first[0] - second[0]).abs().max())
    scale = float(first[0].abs().max())
    if repeat > GRAD_TOL * max(1.0, scale):
        raise AssertionError(f"gridsample image gradient: two runs differ by {repeat}")
    del first, second, again

    nb = {"in": inp.numel() * 4, "grid": grid.numel() * 4, "out": g.numel() * 4}
    pixels, c = grid.numel() // 2, inp.shape[3]
    # per pixel about 40 operations for the two coordinates and weights, then 8
    # a channel forward (4 multiply-adds) and about 24 backward
    bounds = {"gridsample_fwd": bound_ms(nb["in"] + nb["grid"] + nb["out"], pixels * (40 + 8 * c)),
              "gridsample_bwd": bound_ms(nb["out"] + nb["in"] + nb["grid"] + nb["in"] + nb["grid"],
                                         pixels * (40 + 24 * c))}
    mb = {"gridsample_fwd": (nb["in"] + nb["grid"] + nb["out"]) / 1e6,
          "gridsample_bwd": (nb["out"] + 2 * nb["in"] + 2 * nb["grid"]) / 1e6}
    times = {"gridsample_fwd": (k_f, p_f, lib_f), "gridsample_bwd": (k_b, p_b, lib_b)}
    results = {}
    for i, k in enumerate(("gridsample_fwd", "gridsample_bwd")):
        (b, by), (ms, plain, lib) = bounds[k], times[k]
        err = worst[0] if i == 0 else max(worst[1:])
        results[k] = {"max_abs_err": err, "ms": ms, "plain_ms": plain, "bound_ms": b,
                      "bound_by": by, "library_ms": lib}
        print(f"kernel {k}: all cases within tolerance, worst {err:.3g}; at (32,{SIZE},{SIZE},6) "
              f"fp32, offsets 0.3 px: kernel {ms:.4f} ms, plain {plain:.4f} ms, bound {b:.4f} ms "
              f"({by}, {mb[k]:.1f} MB), F.grid_sample {lib:.4f} ms [{card}]")
    # bf16 image and output, float32 grid
    b16, by16 = bound_ms(nb["in"] // 2 + nb["grid"] + nb["out"] // 2, pixels * (40 + 8 * c))
    results["gridsample_fwd"].update(bf16_ms=k_f16, bf16_bound_ms=b16)
    print(f"kernel gridsample_fwd: bf16 at (32,{SIZE},{SIZE},6): kernel {k_f16:.4f} ms, bound "
          f"{b16:.4f} ms ({by16}, {(nb['in'] // 2 + nb['grid'] + nb['out'] // 2) / 1e6:.1f} MB); "
          f"two identical runs bit-identical [{card}]")
    print(f"kernel gridsample_bwd: grid gradient alone {k_bg:.4f} ms, image gradient alone "
          f"{k_bi:.4f} ms; two identical runs: image gradient max abs diff {repeat:.3g} at "
          f"max|g| {scale:.3g} (atomics), grid gradient and forward bit-identical; forward vs "
          f"F.grid_sample max abs err {lib_err:.3g} [{card}]")
    return results


# ------------------------------------------------------------------- fft_glo
def phase_serve(device, args) -> tuple[GeneratorUNet, list, int]:
    """Inferencer + run_test_set + pair_metrics; returns G, its batches and G forwards."""
    cfg = get_experiment("fft_glo")
    cfg = cfg.replace(train=dataclasses.replace(cfg.train, compute_dtype="bfloat16"))
    g = build_generator(cfg, device, torch.Generator().manual_seed(args.init_seed))
    if args.params:
        g.load_state_dict(load_generator_npz(args.params))
    inf = Inferencer(cfg, g)
    batches = [synthetic_batch(batch_size=8, image_size=SIZE, seed=i) for i in range(4)]

    t0 = time.perf_counter()
    metrics, forwards = [], 0
    for b in batches:
        fake = inf(b)
        forwards += 1
        if fake.shape != (8, SIZE, SIZE, 3) or fake.dtype != torch.bfloat16:
            raise AssertionError(f"G output {tuple(fake.shape)} {fake.dtype}")
        if not bool(torch.isfinite(fake).all()) or float(fake.abs().max()) > 1.0:
            raise AssertionError("G output not finite or outside [-1, 1]")
        metrics.append(pair_metrics(torch.as_tensor(b["B"], device=device), fake))
    with tempfile.TemporaryDirectory() as out:
        written = inf.run_test_set(batches, out, save_spectra=True)
        forwards += len(batches)
        stacks = [f for f in os.listdir(out) if f.endswith(".png")]
        spectra = [f for f in os.listdir(os.path.join(out, "spectra")) if f.endswith(".png")]
    seconds = time.perf_counter() - t0
    if written != 32 or len(stacks) != 32 or len(spectra) != 32:
        raise AssertionError(f"wrote {written} ({len(stacks)} stacks, {len(spectra)} spectra)")
    means = {}
    for k in metrics[0]:
        v = torch.cat([m[k] for m in metrics])
        if not bool(torch.isfinite(v).all()):
            raise AssertionError(f"metric {k} not finite")
        means[k] = float(v.mean())
    print(f"serve: 4 batches x 8 at {SIZE}² bf16 in {seconds:.2f} s: {forwards} G forwards, "
          f"{len(stacks)} stacks, {len(spectra)} spectra; metric means "
          + ", ".join(f"{k} {v:.4f}" for k, v in means.items()))
    return g, batches, forwards


def _write_pairs(root: str, seed: int, count: int = 8, split: str = "test",
                 size: int = SIZE) -> None:
    """``count`` synthetic A|B PNG pairs at ``size``² under ``root``/``split``."""
    pairs = synthetic_batch(batch_size=count, image_size=size, seed=seed)
    for i in range(count):
        save_image_grid([pairs["A"][i], pairs["B"][i]],
                        os.path.join(root, split, f"{i:03d}.png"), axis=1)


def phase_cli(args) -> int:
    """The user's commands on the card: ``cli test`` over 8 A|B PNG pairs at 256²
    (batch 4, bf16, spectra), then ``prep-crop`` and ``eval``; returns G forwards."""
    weights = ["--params", args.params] if args.params else ["--init-seed", str(args.init_seed)]
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        data, out, crops = (os.path.join(tmp, d) for d in ("data", "out", "crops"))
        _write_pairs(data, seed=10)
        cli.main(["test", "--experiment", "fft_glo", "--data-root", data, "--image-size", str(SIZE),
                  "--batch-size", "4", "--dtype", "bfloat16", "--out-dir", out, "--spectra",
                  "--device", "cuda", *weights])
        cli.main(["prep-crop", "--stack-dir", out, "--out-root", crops])
        csv_path = os.path.join(tmp, "metrics.csv")
        cli.main(["eval", "--fake-dir", os.path.join(crops, "fake_B"),
                  "--real-dir", os.path.join(crops, "real_B"), "--out-csv", csv_path,
                  "--device", "cuda"])
        stacks = [f for f in os.listdir(out) if f.endswith(".png")]
        spectra = os.listdir(os.path.join(out, "spectra"))
        with open(csv_path, newline="") as f:
            rows = list(csv.reader(f))
    values = np.array([r[1:] for r in rows[1:]], dtype=np.float64)
    if len(stacks) != 8 or len(spectra) != 8 or values.shape != (8, len(rows[0]) - 1):
        raise AssertionError(f"cli: {len(stacks)} stacks, {len(spectra)} spectra, "
                             f"metrics {values.shape}")
    if not np.isfinite(values).all():
        raise AssertionError("cli eval: metric not finite")
    print(f"cli: test (8 PNG pairs, batch 4, bf16, spectra) + prep-crop + eval on cuda in "
          f"{time.perf_counter() - t0:.2f} s: {len(stacks)} stacks, {len(spectra)} spectra, "
          f"{values.shape[0]} x {values.shape[1]} finite metrics")
    return 2


# ----------------------------------------------------------------- cli train
CLI_BATCH = 32        # fft_glo cli train at full width: batch 32, 256², bf16
CLI_PAIRS = 64        # train pairs: 2 steps an epoch
CLI_TEST_PAIRS = 8
CLI_SEED = 50         # the phase's own data seed
CLI_RATE_EPOCHS = 16  # the timed runs, pool and stream: 32 epoch steps each
DIFF_CLI_BATCH, DIFF_CLI_PAIRS = 8, 16
LIB_STEPS, LIB_RESUME_AT = 5, 3  # the library resume: 5 steps vs 3, save, load, 2


class _CliClock:
    """While a CLI command of ``steps`` train steps runs: the number of steps,
    the end of the first and of the last (the card synchronised there and at
    no other step), the spans spent in sample hooks and checkpoint saves (the
    card synchronised at both ends), and the first batch a step was given."""

    def __init__(self, steps: int):
        self.steps, self.n, self.ends, self.pauses, self.first = steps, 0, [], [], None

    def _pause(self, fn, *a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*a, **kw)
        torch.cuda.synchronize()
        self.pauses.append((t0, time.perf_counter()))
        return out

    @contextlib.contextmanager
    def running(self):
        step, fit, save = Trainer.step, Trainer.fit, AsyncCheckpointManager.save

        def timed_step(trainer, state, batch):
            if self.first is None:
                self.first = {k: torch.as_tensor(v).clone() for k, v in batch.items()}
            out = step(trainer, state, batch)
            self.n += 1
            if self.n in (1, self.steps):
                torch.cuda.synchronize()
                self.ends.append(time.perf_counter())
            return out

        def timed_fit(trainer, state, batches, *a, sample_hook=None, **kw):
            hook = sample_hook and (lambda s, n: self._pause(sample_hook, s, n))
            return fit(trainer, state, batches, *a, sample_hook=hook, **kw)

        with mock.patch.object(Trainer, "step", timed_step), \
                mock.patch.object(Trainer, "fit", timed_fit), \
                mock.patch.object(AsyncCheckpointManager, "save",
                                  lambda mgr, *a, **kw: self._pause(save, mgr, *a, **kw)):
            self.t0 = time.perf_counter()
            yield self

    def rate(self, batch: int) -> tuple[float, float]:
        """(img/s over the steps after the first, with data loading and
        without the pauses; seconds from the command's start to the end of
        the first step)."""
        if self.n != self.steps:
            raise AssertionError(f"cli train ran {self.n} steps, not {self.steps}")
        lo, hi = self.ends[0], self.ends[-1]
        paused = sum(min(b, hi) - max(a, lo) for a, b in self.pauses if b > lo and a < hi)
        return (self.steps - 1) * batch / (hi - lo - paused), self.first_step_s()

    def first_step_s(self) -> float:
        """Seconds from the command's start to the end of its first step."""
        return self.ends[0] - self.t0


def _log_rows(path: str) -> list[dict]:
    with open(path) as f:
        rows = [json.loads(line) for line in f]
    if not rows or not all(np.isfinite(v) for r in rows for v in r.values()):
        raise AssertionError(f"{path}: {len(rows)} records, or a value not finite")
    return rows


def _bits_equal(a: dict, b: dict) -> bool:
    return a.keys() == b.keys() and all(
        x.dtype == y.dtype and torch.equal(x.view(torch.int32), y.view(torch.int32))
        if x.dtype == torch.float32 else torch.equal(x, y) for x, y in
        ((torch.as_tensor(a[k]).cpu(), torch.as_tensor(b[k]).cpu()) for k in a))


def _weights(state) -> dict[str, torch.Tensor]:
    modules = (("G", state.G), ("D", state.D), ("cnns", state.cnns))
    return {f"{m}.{k}": v.detach().clone() for m, module in modules if module is not None
            for k, v in module.state_dict().items()}


def _max_diff(m1, w1, m2, w2) -> tuple[float, float]:
    """(largest metric difference over the steps, largest weight difference)."""
    metrics = max(float((a[k] - b[k]).abs().float()) for a, b in zip(m1, m2) for k in a)
    weights = max(float((w1[k].float() - w2[k].float()).abs().max()) for k in w1)
    return metrics, weights


def _library_resume(device, args, card, tmp: str, name: str = "fft_glo",
                    batch: int = CLI_BATCH, steps: int = LIB_STEPS,
                    resume_at: int = LIB_RESUME_AT) -> None:
    """The bf16 ``Trainer`` of ``name`` at full width on fixed device batches:
    ``steps`` steps straight (twice: the card's step-repeat difference)
    against ``resume_at`` steps, ``save_checkpoint``, ``restore_checkpoint``
    into a freshly built recipe drawn from another seed and the rest; the save
    times, synchronous and asynchronous."""
    cfg = _cfg(name, "bfloat16")
    labels = cfg.loss.conditional
    batches = [_device_batch(batch, CLI_SEED + 10 + i, device, SIZE, labels)
               for i in range(steps)]

    def start(seed):
        trainer = Trainer(cfg, build_recipe(cfg, device))
        return trainer, trainer.init_state(seed)

    def straight():
        trainer, state = start(args.init_seed)
        metrics = [trainer.step(state, b) for b in batches]
        return metrics, _weights(state)

    deterministic = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        m1, w1 = straight()
        m2, w2 = straight()
        trainer, state = start(args.init_seed)
        resumed = [trainer.step(state, b) for b in batches[:resume_at]]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        path = save_checkpoint(os.path.join(tmp, "sync"), state)
        sync_s = time.perf_counter() - t0
        manager = AsyncCheckpointManager(os.path.join(tmp, "async"))
        t0 = time.perf_counter()
        manager.save(state)
        blocking_s = time.perf_counter() - t0
        manager.wait()
        async_s = time.perf_counter() - t0
        megabytes = os.path.getsize(os.path.join(path, STATE_FILE)) / 2**20
        del trainer, state
        trainer, state = start(args.init_seed + 1)
        state = restore_checkpoint(path, state)
        resumed += [trainer.step(state, b) for b in batches[resume_at:]]
        w3 = _weights(state)
        del trainer, state
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = deterministic
    repeat = _max_diff(m1, w1, m2, w2)
    resume = _max_diff(m1, w1, resumed, w3)
    if repeat == (0.0, 0.0):
        held = "bit for bit (the straight run repeats bit for bit with cudnn.deterministic)"
        if resume != (0.0, 0.0):
            raise AssertionError(f"library resume: metrics differ by {resume[0]}, weights by "
                                 f"{resume[1]}; the straight run repeats bit for bit")
    else:
        held = f"within 2 x the repeat difference {repeat}"
        if resume[0] > 2 * repeat[0] or resume[1] > 2 * repeat[1]:
            raise AssertionError(f"library resume: differences {resume}, straight run "
                                 f"repeated {repeat}")
    print(f"{name} library resume bf16 B={batch} {SIZE}²: {steps} steps straight "
          f"vs {resume_at} + save + load into a fresh recipe + "
          f"{steps - resume_at}: metrics and G/D weights (with u/v) "
          f"{'and the regional CNNs ' if cfg.loss.conditional else ''}{held}; "
          f"largest differences resume {resume}, repeat {repeat} [{card}]")
    print(f"{name} checkpoint ({megabytes:.1f} MiB: G, D, LPIPS, both Adams, generator): "
          f"save_checkpoint {sync_s:.3f} s; AsyncCheckpointManager.save returns in "
          f"{blocking_s:.3f} s (the host snapshot), the write done {async_s:.3f} s after the "
          f"call [{card}]")


def phase_cli_train(device, args, card: str) -> dict[str, dict[str, int]]:
    """``cli train`` on the card: fft_glo at full width (pool staging, 2
    epochs, checkpoints, log, samples), ``--resume``, ``test --checkpoint``,
    the stream path, the library resume, and tfc_diff ``train`` + ``gen
    --checkpoint``; returns the fft_glo and the tfc_diff runs' launch counts."""
    spe = CLI_PAIRS // CLI_BATCH
    steps = 1 + 2 * spe  # step 0 on the first batch, then 2 epochs
    hooks = steps // 2  # --sample-interval 2: after every even step
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        data = os.path.join(tmp, "data")
        _write_pairs(data, seed=CLI_SEED, count=CLI_PAIRS, split="train")
        _write_pairs(data, seed=CLI_SEED + 1, count=CLI_TEST_PAIRS)
        common = ["--experiment", "fft_glo", "--data-root", data, "--image-size", str(SIZE),
                  "--batch-size", str(CLI_BATCH), "--dtype", "bfloat16", "--device", "cuda"]
        runs, resumed = os.path.join(tmp, "runs"), os.path.join(tmp, "resumed")

        # fft_glo on the default staging: the pool, for this set
        reset_counts()
        torch.cuda.reset_peak_memory_stats()
        with _CliClock(steps).running() as pool_clock:
            cli.main(["train", *common, "--n-epochs", "2", "--checkpoint-interval", "1",
                      "--sample-interval", "2", "--out-dir", runs])
        peak = torch.cuda.max_memory_allocated() / 2**30
        fft_run = expect_counts("fft_glo cli train", {
            "blurpool_fwd": FFT_GLO_STEP["blurpool_fwd"] * steps + 11 * hooks,
            "blurpool_bwd": FFT_GLO_STEP["blurpool_bwd"] * steps}, 1)
        ckpts = sorted(d for d in os.listdir(runs) if d.startswith("step_"))
        _PLAIN_CLI_LOG[:] = _log_rows(os.path.join(runs, "logs", "fft_glo.jsonl"))
        logged = [r["step"] for r in _PLAIN_CLI_LOG]
        samples = sorted(os.listdir(os.path.join(runs, "samples")))
        want_samples = [f"{s:07d}.png" for s in range(2, steps + 1, 2)] + ["index.html"]
        if (ckpts != [f"step_{1 + spe:08d}", f"step_{steps:08d}"] or pool_clock.n != steps
                or logged != [1, 2, 2 + spe] or samples != want_samples):
            raise AssertionError(f"fft_glo cli train: checkpoints {ckpts}, "
                                 f"{pool_clock.n} steps, log steps {logged}, samples "
                                 f"{samples}")
        host = next(batch_iterator(PairedImageDataset(data, "train", SIZE), CLI_BATCH, seed=42))
        if not _bits_equal(pool_clock.first, host):
            raise AssertionError("the pool's first batch differs from batch_iterator's")

        # --resume into a fresh out-dir: the data order restarts
        reset_counts()
        cli.main(["train", *common, "--n-epochs", "1", "--checkpoint-interval", "1",
                  "--sample-interval", "2", "--out-dir", resumed,
                  "--resume", os.path.join(runs, f"step_{1 + spe:08d}")])
        expect_counts("fft_glo cli train --resume", {
            "blurpool_fwd": FFT_GLO_STEP["blurpool_fwd"] * spe + 11 * (spe // 2),
            "blurpool_bwd": FFT_GLO_STEP["blurpool_bwd"] * spe}, 1)
        r_logged = [r["step"] for r in _log_rows(os.path.join(resumed, "logs", "fft_glo.jsonl"))]
        if latest_checkpoint(resumed) != os.path.join(resumed, f"step_{steps:08d}") or \
                r_logged != [2 + spe]:
            raise AssertionError(f"cli train --resume: {latest_checkpoint(resumed)}, log steps "
                                 f"{r_logged}")

        # serve the checkpoint
        served = os.path.join(tmp, "served")
        reset_counts()
        cli.main(["test", *common, "--checkpoint", latest_checkpoint(runs), "--out-dir", served])
        expect_counts("test --checkpoint", {"blurpool_fwd": 11},
                      -(-CLI_TEST_PAIRS // CLI_BATCH))
        stacks = [f for f in os.listdir(served) if f.endswith(".png")]
        if len(stacks) != CLI_TEST_PAIRS:
            raise AssertionError(f"test --checkpoint wrote {len(stacks)} stacks")

        # the timed runs, pool and then stream (PrefetchLoader +
        # device_prefetch(via_uint8)): 16 epochs, no sample hook, the one
        # checkpoint save inside the window (epoch 0's) taken out
        rate_steps = 1 + CLI_RATE_EPOCHS * spe
        timed = ["--n-epochs", str(CLI_RATE_EPOCHS), "--sample-interval", str(10 * rate_steps),
                 "--checkpoint-interval", str(CLI_RATE_EPOCHS)]
        clocks = {}
        for staging in ("pool", "stream"):
            workers = ["--num-workers", "4"] if staging == "stream" else []
            reset_counts()
            with _CliClock(rate_steps).running() as clocks[staging]:
                cli.main(["train", *common, *timed, "--staging", staging, *workers,
                          "--out-dir", os.path.join(tmp, staging)])
            expect_counts(f"fft_glo cli train --staging {staging}", FFT_GLO_STEP, rate_steps)
            torch.cuda.empty_cache()
        if not _bits_equal(clocks["stream"].first, pool_clock.first):
            raise AssertionError("the stream path's first batch differs from the pool's")
        cold_first_s = pool_clock.first_step_s()
        pool_rate, first_s = clocks["pool"].rate(CLI_BATCH)
        stream_rate, stream_first_s = clocks["stream"].rate(CLI_BATCH)

        _library_resume(device, args, card, tmp)
        torch.cuda.empty_cache()

        # tfc_diff: cli train, then gen --checkpoint (the whole chain)
        diff_data, diff_runs = os.path.join(tmp, "diff"), os.path.join(tmp, "diff_runs")
        _write_pairs(diff_data, seed=CLI_SEED + 2, count=DIFF_CLI_PAIRS, split="train",
                     size=DIFF_SIZE)
        _write_pairs(diff_data, seed=CLI_SEED + 3, count=4, size=DIFF_SIZE)
        diff_common = ["--config", "tfc_diff", "--data-root", diff_data, "--image-size",
                       str(DIFF_SIZE), "--dtype", "bfloat16", "--device", "cuda"]
        reset_counts()
        diff_steps = 1 + DIFF_CLI_PAIRS // DIFF_CLI_BATCH
        # the sample hook after the last step: the whole chain on the 4 test pairs
        cli.main(["train", *diff_common, "--batch-size", str(DIFF_CLI_BATCH), "--n-epochs", "1",
                  "--sample-interval", str(diff_steps), "--out-dir", diff_runs])
        chain = diffusion_recipe.schedule_of(get_experiment("tfc_diff")).num_timesteps
        expect_counts("tfc_diff cli train", {
            k: DIFF_STEP_BF16.get(k, 0) * diff_steps + DIFF_FORWARD.get(k, 0) * chain
            for k in COUNTED}, 1)
        _log_rows(os.path.join(diff_runs, "logs", "tfc_diff.jsonl"))
        diff_samples = sorted(os.listdir(os.path.join(diff_runs, "samples")))
        if diff_samples != [f"{diff_steps:07d}.png", "index.html"]:
            raise AssertionError(f"tfc_diff cli train: samples {diff_samples}")
        gen_out = os.path.join(tmp, "gen")
        cli.main(["gen", *diff_common, "--checkpoint", latest_checkpoint(diff_runs),
                  "--out-dir", gen_out])
        diff_run = expect_counts("tfc_diff cli train + gen --checkpoint", {
            k: DIFF_STEP_BF16.get(k, 0) * diff_steps + DIFF_FORWARD.get(k, 0) * 2 * chain
            for k in COUNTED}, 1)
        if len([f for f in os.listdir(gen_out) if f.endswith(".png")]) != 4:
            raise AssertionError("gen --checkpoint did not write 4 stacks")
    print(f"cli train fft_glo bf16 B={CLI_BATCH} {SIZE}², pool staging: {steps} steps, "
          f"checkpoints {ckpts}, {len(logged)} finite log records, {hooks} sample grids + "
          f"gallery; resume to step {steps}; test --checkpoint {len(stacks)} stacks; launches "
          f"{fft_run['blurpool_fwd']} forward, {fft_run['blurpool_bwd']} backward blur-pool "
          f"({FFT_GLO_STEP} a step, 11 forward a sample); pool and stream first batches equal "
          f"batch_iterator's bit for bit")
    print(f"cli train fft_glo bf16 B={CLI_BATCH} {SIZE}² wall, data loading included (no "
          f"sample hook; epoch 0's checkpoint save taken out): time to first step "
          f"{cold_first_s:.2f} s in the phase's first cli train; pool {pool_rate:.1f} img/s "
          f"over {rate_steps - 1} epoch steps, time to first step {first_s:.2f} s; stream (4 "
          f"workers, the first epoch decoding, later ones from the cache) {stream_rate:.1f} "
          f"img/s over {rate_steps - 1} epoch steps, time to first step {stream_first_s:.2f} "
          f"s; peak memory {peak:.2f} GiB (the 2-epoch run) [{card}]")
    print(f"cli train tfc_diff bf16 B={DIFF_CLI_BATCH} {DIFF_SIZE}²: {diff_steps} steps + a "
          f"sample hook + gen --checkpoint over 4 images ({chain}-step chains): launches "
          f"{ {k: n for k, n in diff_run.items() if n} }")
    print(f"cli train phase: {time.perf_counter() - t_phase:.1f} s [{card}]")
    return {"fft_glo_cli_train": fft_run, "tfc_diff_cli_train": diff_run}


def _serve_rate(what: str, fwd, batch: int, card: str) -> None:
    """Images/s of ``fwd`` on the kernel path and on the plain path, in turns."""
    with torch.inference_mode():
        with plain_path():
            p1 = cuda_ms(fwd, 10)
        k1 = cuda_ms(fwd, 10)
        k2 = cuda_ms(fwd, 10)
        with plain_path():
            p2 = cuda_ms(fwd, 10)
    k, p = (k1 + k2) / 2, (p1 + p2) / 2
    print(f"{what} bf16 B={batch}: kernel path {k:.3f} ms = {batch * 1000 / k:.1f} img/s, "
          f"plain path {p:.3f} ms = {batch * 1000 / p:.1f} img/s [{card}]")


def phase_compare(device, g: GeneratorUNet, batches: list, card: str) -> None:
    """The same weights in float32, kernel path vs plain path; G-forward img/s."""
    # float32, the same weights: kernel path vs plain path on the card, and vs the CPU
    g32 = GeneratorUNet(dtype=torch.float32, device=device).eval()
    g32.load_state_dict(g.state_dict())
    x = torch.as_tensor(batches[0]["A"][:2], device=device)
    with torch.inference_mode():
        y_kernel = g32(x)
        with plain_path():
            y_plain = g32(x)
        g32_cpu = GeneratorUNet(dtype=torch.float32).eval()
        g32_cpu.load_state_dict(g32.state_dict())
        y_cpu = g32_cpu(x.cpu())
    err = float((y_kernel - y_plain).abs().max())
    err_cpu = float((y_kernel.cpu() - y_cpu).abs().max())
    if err > 1e-4:
        raise AssertionError(f"fp32 G: kernel path vs plain path max abs err {err}")
    if err_cpu > 2e-3:
        raise AssertionError(f"fp32 G: card vs CPU max abs err {err_cpu}")
    print(f"serve fp32 G (2 x {SIZE}²): kernel path vs plain path on the card max abs err "
          f"{err:.3g} (atol 1e-4); card vs CPU {err_cpu:.3g} (atol 2e-3, cuDNN vs CPU convs)")

    gen = torch.Generator(device=device).manual_seed(1)
    for bsz in THROUGHPUT_BATCHES:
        xb = torch.rand((bsz, SIZE, SIZE, 3), device=device, generator=gen) * 2 - 1
        _serve_rate("G forward", lambda: g(xb), bsz, card)


# --------------------------------------------------------------- train steps
def _cfg(name: str, dtype: str):
    cfg = get_experiment(name)
    return cfg.replace(train=dataclasses.replace(cfg.train, compute_dtype=dtype))


def _device_batch(batch_size: int, seed: int, device, size: int = SIZE,
                  with_labels: bool = False) -> dict[str, torch.Tensor]:
    batch = synthetic_batch(batch_size=batch_size, image_size=size, seed=seed,
                            with_labels=with_labels)
    return {k: torch.as_tensor(v, device=device) for k, v in batch.items()}


class _Rows:
    """Trainer logger: each step's metrics with the kernels' launch counts."""

    def __init__(self):
        self.rows = []

    def write(self, row: dict) -> None:
        self.rows.append({**row, "counts": counts()})


def phase_train(device, args, name: str, terms, per_step: dict[str, int], after=None,
                size: int = SIZE, moving: str = "loss_G") -> dict[str, int]:
    """3 bf16 steps of the full-width recipe ``name`` at B=8, ``size``²;
    returns the run's launch counts. ``after(trainer, state, batches)`` runs
    once they are read. The term ``moving`` must differ between the steps."""
    cfg = _cfg(name, "bfloat16")
    recipe = build_recipe(cfg, device)
    log = _Rows()
    trainer = Trainer(cfg, recipe, logger=log)
    state = trainer.init_state(args.init_seed)
    labels = cfg.recipe == "diffusion" or cfg.loss.conditional
    batches = [_device_batch(8, 20 + i, device, size, labels) for i in range(3)]
    reset_counts()
    t0 = time.perf_counter()
    trainer.fit(state, batches, num_steps=3, log_every=1, check_finite=True)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    for i, row in enumerate(log.rows, 1):
        if row["counts"] != scaled(per_step, i):
            raise AssertionError(f"{name} after step {i}: launches {row['counts']}; want "
                                 f"{per_step} a step")
        print(f"{name} train step {row['step']}: "
              + ", ".join(f"{k} {row[k]:.5g}" for k in terms))
    losses = [row[moving] for row in log.rows]
    if len(log.rows) != 3 or state.step != 3 or len(set(losses)) != 3:
        raise AssertionError(f"{name} train: {len(log.rows)} rows, step {state.step}, "
                             f"{moving} {losses}")
    run = expect_counts(f"{name} train", per_step, 3)
    print(f"{name} train: 3 bf16 steps at B=8, {size}² in {seconds:.2f} s (first steps include "
          f"set-up), all terms finite, {moving} moves; launches a step {per_step}")
    if after is not None:
        after(trainer, state, batches)
    return run


def _step_terms_and_grads(recipe, batch, draws, extra=None) -> tuple[dict, dict]:
    """One step's loss terms and G- and D-phase gradients, no update; the
    recipe's ``pre_d`` hook on ``extra`` between the two phases, where it has one."""
    for p in [*recipe.G.parameters(), *recipe.D.parameters()]:
        p.grad = None
    recipe.D.requires_grad_(False)
    loss_g, aux, terms = recipe.g_loss(batch, draws)
    loss_g.backward()
    recipe.D.requires_grad_(True)
    if hasattr(recipe, "pre_d"):
        _, aux = recipe.pre_d(extra, aux, draws)
    loss_d, d_terms = recipe.d_loss(batch, aux)
    if loss_d.requires_grad:  # a constant for a recipe without a discriminator
        loss_d.backward()
    grads = {f"{prefix}.{n}": p.grad.detach().clone()
             for prefix, m in (("G", recipe.G), ("D", recipe.D)) for n, p in m.named_parameters()}
    return {k: float(v.detach()) for k, v in {**terms, **d_terms}.items()}, grads


def _random_dtheta_head(stn, seed: int) -> None:
    """Small random weights for the STN's zero-initialized dtheta head: a warp
    a few hundredths off the identity, so that it and its gradients do work."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        stn.fc4.weight.copy_(torch.randn(stn.fc4.weight.shape, generator=gen) * 0.004)
        stn.fc4.bias.copy_(torch.randn(stn.fc4.bias.shape, generator=gen) * 0.01)


def phase_train_compare(device, args, name: str, terms, per_step: dict[str, int],
                        references, size: int = SIZE, batch_size: int = 2) -> None:
    """fp32, TF32 off: one step's losses and gradients at B=``batch_size``, ``size``², through the
    kernels and through each of ``references`` (label, context manager,
    elementwise tolerance, L2 tolerance or None), from one set of weights and
    draws. Loss terms rtol 1e-4; every gradient within the elementwise
    tolerance x max|g_reference| + 1e-7 and, where given, within the L2
    tolerance x its norm."""
    cfg = _cfg(name, "float32")
    recipe = build_recipe(cfg, device)
    recipe.init(torch.Generator().manual_seed(args.init_seed))
    if cfg.recipe == "stn":
        _random_dtheta_head(recipe.STN, args.init_seed)
    if cfg.recipe == "nemar":
        _random_offset_head(recipe.R, args.init_seed)
    batch = _device_batch(batch_size, 30, device, size,
                          cfg.recipe == "diffusion" or cfg.loss.conditional)
    draws = recipe.draw(torch.Generator(device).manual_seed(args.init_seed), batch)
    spectral_power_iteration(recipe.D, order="vu")
    reset_counts()
    k_terms, k_grads = _step_terms_and_grads(recipe, batch, draws)
    expect_counts(f"{name} fp32 step", per_step, 1)
    # exactly zero in exact arithmetic, rounding noise in float32: the key bias
    # (softmax is shift-invariant) and a conv bias in front of an instance norm
    # (held here to stay below 1e-4 of its kernel's gradient)
    skip = [n for n in k_grads if n.endswith("attn.key.bias")]
    skip += [n for n, g in k_grads.items() if n.endswith(".bias") and float(g.abs().max())
             < 1e-4 * float(k_grads[n[:-4] + "weight"].abs().max())]
    zero = [n for n, g in k_grads.items() if n not in skip and not bool(g.any())]
    if zero:
        raise AssertionError(f"{name} fp32 step: all-zero gradients for {zero}")
    for label, context, tol, tol_l2 in references:
        before = counts()
        with context():
            p_terms, p_grads = _step_terms_and_grads(recipe, batch, draws)
        torch.cuda.synchronize()
        launched = {k: v - before[k] for k, v in counts().items() if v != before[k]}
        for k in terms:
            if abs(k_terms[k] - p_terms[k]) > 1e-4 * abs(p_terms[k]):
                raise AssertionError(f"{name} fp32 {k}: kernel path {k_terms[k]}, "
                                     f"{label} {p_terms[k]}")
        worst, worst_name = 0.0, ""
        for pname, g in p_grads.items():
            if pname in skip:
                continue
            diff = k_grads[pname] - g
            ratio = float(diff.abs().max()) / (tol * float(g.abs().max()) + 1e-7)
            if tol_l2 is not None:
                ratio = max(ratio, float(diff.norm()) / (tol_l2 * float(g.norm()) + 1e-7))
            if ratio > worst:
                worst, worst_name = ratio, pname
        if worst > 1.0:
            raise AssertionError(f"{name} fp32 gradient {worst_name} against the {label}: "
                                 f"{worst:.3g} x its bound ({tol} max|g| + 1e-7 elementwise, "
                                 f"{tol_l2} x the norm)")
        print(f"{name} train compare fp32 (B={batch_size}, {size}², TF32 off), kernel path vs {label} "
              f"(which launched {launched or 'no kernel'}): {len(terms)} loss terms within "
              f"rtol 1e-4 (max rel "
              f"{max(abs(k_terms[k] - p_terms[k]) / max(abs(p_terms[k]), 1e-30) for k in terms):.3g}); "
              f"{len(p_grads) - len(skip)} gradients, none all-zero, within {tol} max|g| + "
              f"1e-7" + (f" and {tol_l2} of their L2 norm" if tol_l2 else "")
              + f", worst {worst:.3g} of the bound ({worst_name})")


def phase_train_rate(device, args, card: str, name: str, batch_sizes, paths=None,
                     size: int = SIZE) -> dict[tuple[int, str], float]:
    """Train-step img/s and peak memory, bf16, at ``size``², on each of
    ``paths`` (label -> context manager, timed in their order; the kernel path
    and the plain path unless given). Returns the step ms by (batch, label)."""
    paths = paths or {"kernel": contextlib.nullcontext, "plain": plain_path}
    readings = {}
    cfg = _cfg(name, "bfloat16")
    cfg = cfg.replace(data=dataclasses.replace(cfg.data, image_size=size))
    for bsz in batch_sizes:
        recipe = build_recipe(cfg, device)
        trainer = Trainer(cfg, recipe)
        state = trainer.init_state(args.init_seed)
        batch = _device_batch(bsz, 40, device, size)
        for path, context in paths.items():
            with context():
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                for _ in range(2):
                    trainer.step(state, batch)
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                for _ in range(5):
                    metrics = trainer.step(state, batch)
                end.record()
                end.synchronize()
            ms = readings[bsz, path] = start.elapsed_time(end) / 5
            if not all(bool(torch.isfinite(v)) for v in metrics.values()):
                raise AssertionError(f"{name} train rate B={bsz} {path}: a loss is not finite")
            peak = torch.cuda.max_memory_allocated() / 2**30
            print(f"{name} train step bf16 B={bsz} {size}² {path} path: {ms:.2f} ms = "
                  f"{bsz * 1000 / ms:.1f} img/s, peak memory {peak:.2f} GiB [{card}]")
        del recipe, trainer, state, batch, metrics
        torch.cuda.empty_cache()
    return readings


# ------------------------------------------------------------- stn_newmodel3
STN_OUTPUTS = {"fake_B": torch.bfloat16, "fake_A1": torch.bfloat16,
               "warped_B": torch.float32, "fake_A2": torch.bfloat16}


def phase_stn_serve(device, args, card: str) -> dict[str, int]:
    """The full-width stn_newmodel3 serve path through ``Inferencer``,
    ``run_test_set`` and the CLI; returns the run's launch counts."""
    from PIL import Image

    cfg = _cfg("stn_newmodel3", "bfloat16")
    nets = build_generators(cfg, device, torch.Generator().manual_seed(args.init_seed))
    _random_dtheta_head(nets["STN"], args.init_seed)
    n_params = {k: sum(p.numel() for p in m.parameters()) for k, m in nets.items()}
    inf = Inferencer(cfg, nets)
    batches = [synthetic_batch(batch_size=8, image_size=SIZE, seed=50 + i) for i in range(2)]
    reset_counts()
    t0 = time.perf_counter()
    served = 0
    for b in batches:
        out = inf(b)
        served += 1
        for k, dtype in STN_OUTPUTS.items():
            if out[k].shape != (8, SIZE, SIZE, 3) or out[k].dtype != dtype:
                raise AssertionError(f"stn serve {k}: {tuple(out[k].shape)} {out[k].dtype}")
            if not bool(torch.isfinite(out[k]).all()):
                raise AssertionError(f"stn serve {k} is not finite")
        moved = float((out["warped_B"] - torch.as_tensor(b["B"], device=device)).abs().max())
        if not 1e-3 < moved < 2.5:  # bicubic overshoot stays near [-1, 1]
            raise AssertionError(f"stn serve: warped_B differs from B by {moved}")
    with tempfile.TemporaryDirectory() as tmp:
        data, out_dir, cli_out, crops = (os.path.join(tmp, d)
                                         for d in ("data", "out", "cli_out", "crops"))
        written = inf.run_test_set(batches, out_dir)
        served += len(batches)
        stacks = sorted(f for f in os.listdir(out_dir) if f.endswith(".png"))
        with Image.open(os.path.join(out_dir, stacks[0])) as img:
            size = img.size
        _write_pairs(data, seed=11)
        cli.main(["test", "--config", "stn_newmodel3", "--data-root", data, "--image-size",
                  str(SIZE), "--batch-size", "4", "--dtype", "bfloat16", "--out-dir", cli_out,
                  "--device", "cuda", "--init-seed", str(args.init_seed)])
        served += 2
        roles = "real_A,real_B,warped_B,fake_A1,fake_A2,fake_B"
        cli.main(["prep-crop", "--stack-dir", cli_out, "--out-root", crops, "--roles", roles])
        cli_stacks = [f for f in os.listdir(cli_out) if f.endswith(".png")]
        cropped = {r: len(os.listdir(os.path.join(crops, r))) for r in roles.split(",")}
    seconds = time.perf_counter() - t0
    if written != 16 or len(stacks) != 16 or size != (SIZE, 6 * SIZE):
        raise AssertionError(f"stn serve wrote {written} ({len(stacks)} stacks of size {size})")
    if len(cli_stacks) != 8 or set(cropped.values()) != {8}:
        raise AssertionError(f"stn cli: {len(cli_stacks)} stacks, crops {cropped}")
    run = expect_counts("stn serve", STN_SERVE_BATCH, served)
    print(f"stn serve: G1 {n_params['G1']:,} + G2 {n_params['G2']:,} + STN (ViT-Base) "
          f"{n_params['STN']:,} parameters, bf16; {served} batches (2 x 8 through Inferencer, "
          f"2 x 8 through run_test_set, 2 x 4 through cli test) in {seconds:.2f} s: "
          f"{len(stacks)} + {len(cli_stacks)} six-image stacks of {size[0]}x{size[1]}, "
          f"prep-crop {cropped}; launches a batch {STN_SERVE_BATCH}")

    # float32, the same weights: kernel path vs plain path on the card
    cfg32 = _cfg("stn_newmodel3", "float32")
    nets32 = build_generators(cfg32, device)
    nets32.load_state_dict(nets.state_dict())
    inf32 = Inferencer(cfg32, nets32)
    small = {k: v[:2] for k, v in batches[0].items()}
    y_kernel = inf32(small)
    # fake_B and fake_A1 do not pass the warp: 1e-4. The two outputs behind it
    # get 1e-3: cuDNN's float32 results differ by 1e-6 between two identical
    # calls, that reaches theta, and one float32 ulp of theta moves a sample by
    # 1.5e-5 pixel (warped_B measured 4e-5 against the same kernels upstream)
    for label, context, behind_warp in (("plain resampling with the blur-pool kernels",
                                         plain_resample, 1e-3), ("plain path", plain_path, 1e-3)):
        with context():
            y_plain = inf32(small)
        errs = {k: float((y_kernel[k] - y_plain[k]).abs().max()) for k in STN_OUTPUTS}
        tols = {"fake_B": 1e-4, "fake_A1": 1e-4, "warped_B": behind_warp, "fake_A2": behind_warp}
        if any(errs[k] > tols[k] for k in errs):
            raise AssertionError(f"stn serve fp32: kernel path vs {label} max abs err {errs}, "
                                 f"tolerances {tols}")
        print(f"stn serve fp32 (2 x {SIZE}²): kernel path vs {label} on the card max abs err "
              + ", ".join(f"{k} {v:.3g} (atol {tols[k]})" for k, v in errs.items()))
    del nets32, inf32

    gen = torch.Generator(device=device).manual_seed(3)
    for bsz in (8, 32):
        batch = {k: torch.rand((bsz, SIZE, SIZE, 3), device=device, generator=gen) * 2 - 1
                 for k in ("A", "B")}
        _serve_rate("stn serve (3 G forwards, ViT-Base, warp)", lambda: inf(batch), bsz, card)
    return run


# --------------------------------------------------------------------- nemar
NEMAR_OUTPUTS = {"registered_A": torch.float32, "fake_B": torch.bfloat16,
                 "fake_TR_B": torch.bfloat16, "fake_RT_B": torch.bfloat16}
NEMAR_ROLES = "real_A,real_B,reg_A,fake_B,fake_TR_B,fake_RT_B"


def _random_offset_head(r, seed: int) -> None:
    """A working warp for the deformable STN, whose offset head is zero at
    init (the identity warp: every sample on an integer coordinate, no signal
    to the ResUnet): biases normal(0, 0.1) through the ResUnet, which has no
    norm and whose activations die at zero biases, a random offset kernel and
    offsets around (0.3, -0.2) pixel."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in r.named_parameters():
            if name.endswith("bias"):
                p.copy_(torch.randn(p.shape, generator=gen) * 0.1)
        r.offset.weight.copy_(torch.randn(r.offset.weight.shape, generator=gen) * 0.02)
        r.offset.bias.copy_(torch.tensor([0.3, -0.2]) * (2.0 / SIZE))


def phase_nemar_serve(device, args, card: str) -> dict[str, int]:
    """The full-width nemar serve path (ResNet-9 translator twice, the
    deformable ResUnet STN, one dense sampling call) through ``Inferencer``,
    ``run_test_set`` and the CLI; returns the run's launch counts."""
    from PIL import Image

    cfg = _cfg("nemar", "bfloat16")
    nets = nemar_recipe.build_generators(cfg, device,
                                         torch.Generator().manual_seed(args.init_seed))
    _random_offset_head(nets["R"], args.init_seed)
    n_params = {k: sum(p.numel() for p in m.parameters()) for k, m in nets.items()}
    inf = Inferencer(cfg, nets)
    batches = [synthetic_batch(batch_size=8, image_size=SIZE, seed=60 + i) for i in range(2)]
    reset_counts()
    t0 = time.perf_counter()
    served = 0
    for b in batches:
        out = inf(b)
        served += 1
        expect_counts("nemar serve", NEMAR_SERVE_BATCH, served)
        for k, dtype in NEMAR_OUTPUTS.items():
            if out[k].shape != (8, SIZE, SIZE, 3) or out[k].dtype != dtype:
                raise AssertionError(f"nemar serve {k}: {tuple(out[k].shape)} {out[k].dtype}")
            if not bool(torch.isfinite(out[k]).all()) or float(out[k].abs().max()) > 1.0:
                raise AssertionError(f"nemar serve {k} is not finite or leaves [-1, 1]")
        moved = float((out["registered_A"] - torch.as_tensor(b["A"], device=device)).abs().max())
        if not 1e-3 < moved <= 2.0:
            raise AssertionError(f"nemar serve: registered_A differs from A by {moved}")
    with tempfile.TemporaryDirectory() as tmp:
        data, out_dir, cli_out, crops = (os.path.join(tmp, d)
                                         for d in ("data", "out", "cli_out", "crops"))
        written = inf.run_test_set(batches, out_dir)
        served += len(batches)
        stacks = sorted(f for f in os.listdir(out_dir) if f.endswith(".png"))
        with Image.open(os.path.join(out_dir, stacks[0])) as img:
            size = img.size
        _write_pairs(data, seed=12)
        cli.main(["test", "--config", "nemar", "--data-root", data, "--image-size", str(SIZE),
                  "--batch-size", "4", "--dtype", "bfloat16", "--out-dir", cli_out,
                  "--device", "cuda", "--init-seed", str(args.init_seed)])
        served += 2
        cli.main(["prep-crop", "--stack-dir", cli_out, "--out-root", crops,
                  "--roles", NEMAR_ROLES])
        cli_stacks = [f for f in os.listdir(cli_out) if f.endswith(".png")]
        cropped = {r: len(os.listdir(os.path.join(crops, r))) for r in NEMAR_ROLES.split(",")}
    seconds = time.perf_counter() - t0
    if written != 16 or len(stacks) != 16 or size != (SIZE, 6 * SIZE):
        raise AssertionError(f"nemar serve wrote {written} ({len(stacks)} stacks of size {size})")
    if len(cli_stacks) != 8 or set(cropped.values()) != {8}:
        raise AssertionError(f"nemar cli: {len(cli_stacks)} stacks, crops {cropped}")
    run = expect_counts("nemar serve", NEMAR_SERVE_BATCH, served)
    print(f"nemar serve: T (ResNet, 9 blocks) {n_params['T']:,} + R (deformable ResUnet) "
          f"{n_params['R']:,} parameters, bf16; {served} batches (2 x 8 through Inferencer, "
          f"2 x 8 through run_test_set, 2 x 4 through cli test) in {seconds:.2f} s: "
          f"{len(stacks)} + {len(cli_stacks)} six-image stacks of {size[0]}x{size[1]}, "
          f"prep-crop {cropped}; launches a batch {NEMAR_SERVE_BATCH}, no other kernel")

    # float32, the same weights: kernel path vs plain path on the card. fake_B
    # does not pass the sampling: 1e-4. The three behind it get 1e-3: cuDNN's
    # float32 results differ by 1e-6 between two identical calls, that reaches
    # the offsets, and 1e-6 of the normalized grid is 1.3e-4 pixel
    cfg32 = _cfg("nemar", "float32")
    nets32 = nemar_recipe.build_generators(cfg32, device)
    nets32.load_state_dict(nets.state_dict())
    inf32 = Inferencer(cfg32, nets32)
    small = {k: v[:2] for k, v in batches[0].items()}
    y_kernel = inf32(small)
    with plain_path():
        before = counts()
        y_plain = inf32(small)
        if counts() != before:
            raise AssertionError("nemar serve: the plain path launched a kernel")
    errs = {k: float((y_kernel[k] - y_plain[k]).abs().max()) for k in NEMAR_OUTPUTS}
    tols = {k: 1e-4 if k == "fake_B" else 1e-3 for k in NEMAR_OUTPUTS}
    if any(errs[k] > tols[k] for k in errs):
        raise AssertionError(f"nemar serve fp32: kernel path vs plain path max abs err {errs}, "
                             f"tolerances {tols}")
    print(f"nemar serve fp32 (2 x {SIZE}²): kernel path vs plain path on the card max abs err "
          + ", ".join(f"{k} {v:.3g} (atol {tols[k]})" for k, v in errs.items()))
    del nets32, inf32

    gen = torch.Generator(device=device).manual_seed(5)
    for bsz in (8, 32):
        batch = {k: torch.rand((bsz, SIZE, SIZE, 3), device=device, generator=gen) * 2 - 1
                 for k in ("A", "B")}
        _serve_rate("nemar serve (2 T forwards, R, sampling)", lambda: inf(batch), bsz, card)
    return run


def check_decayed_lr(trainer, state, batches) -> None:
    """One more step far into the schedule: the lr it used against the closed
    form of ``linear_decay`` (constant until ``decay_start_epoch``, then a line
    to 0 at ``n_epochs``; without ``steps_per_epoch`` a step counts as an
    epoch)."""
    cfg = trainer.cfg
    o, n = cfg.optim, cfg.train.n_epochs
    if o.schedule != "linear_decay" or cfg.train.steps_per_epoch:
        raise AssertionError(f"nemar's schedule is {o.schedule!r}, steps_per_epoch "
                             f"{cfg.train.steps_per_epoch}")
    if state.opt_g.param_groups[0]["lr"] != o.lr:
        raise AssertionError("the lr moved before decay_start_epoch")
    state.step = (o.decay_start_epoch + n) // 2
    trainer.step(state, batches[0])
    want = o.lr * (1.0 - (state.step - 1 - o.decay_start_epoch) / (n - o.decay_start_epoch))
    used = [opt.param_groups[0]["lr"] for opt in (state.opt_g, state.opt_d)]
    if not 0 < want < o.lr or any(abs(lr - want) > 1e-12 for lr in used):
        raise AssertionError(f"lr at step {state.step - 1}: used {used}, closed form {want}")
    print(f"nemar lr: {o.lr} up to step {o.decay_start_epoch}; the step at count "
          f"{state.step - 1} used {used[0]:.6g} in both Adams = the closed form {want:.6g}")


# ------------------------------------------------------- flash attention (K4)
# (forward, gradients, floor): an error is held to its tolerance x max(floor,
# max|plain|). float32: exp2f and sums over S keys in another order, on values
# of order 1. bfloat16: two to three ulps (2^-7) of the largest value, whatever
# its size (at S = 4096 the outputs and gradients are 0.03 typical, 0.15 at
# most, so a window taken at 1 would hold nothing): kernel and plain version
# round their result to bfloat16 apart, the kernel rounds the unnormalised
# probability, and the plain version's autograd also rounds dp and ds. The floor
# keeps the bfloat16 window no tighter than the float32 one where the plain
# gradient is exactly 0 (a single key)
FLASH_TOL = {torch.float32: (2e-5, 1e-4, 1.0), torch.bfloat16: (2e-2, 2e-2, 5e-3)}
# pairs of (tensor-core, float32-unit) operations a query-key pair: the
# products of each kernel, 2 D flops each, D padded to 16 on the tensor cores
FLASH_PRODUCTS = {"flashattn_fwd": 2, "flashattn_bwd_dq": 3, "flashattn_bwd_dkv": 4}
# (images, S) of the path's attention calls at 128², batch 8 and 32, 8 heads of
# D = 8, and a 256² input's S; then (S, calls a U-Net pass) at the timed batch
FLASH_PATH = ((8, 4096), (8, 1024), (32, 4096), (32, 1024))
FLASH_TIMED, FLASH_TIMED_BATCH = ((4096, 3), (1024, 4)), 32


def _projection_views(n: int, heads: int, d: int, s: int, dtype, gen, count: int = 4) -> list:
    """``count`` (N, heads, D, S) views of random (N, S, heads * D) tensors: what
    ``AttentionBlock`` hands to ``flash_attention`` and gets as upstream gradient."""
    return [torch.randn((n, s, heads * d), device=gen.device, generator=gen).to(dtype)
            .view(n, s, heads, d).permute(0, 2, 3, 1) for _ in range(count)]


def _dense_views(n: int, heads: int, d: int, s: int, dtype, gen, count: int = 4) -> list:
    return [torch.randn((n, heads, d, s), device=gen.device, generator=gen).to(dtype)
            for _ in range(count)]


def _flash_grads(fn, q, k, v, g, scale: float):
    q, k, v = (t.detach().requires_grad_() for t in (q, k, v))
    out = fn(q, k, v, scale)
    return (out.detach(), *torch.autograd.grad(out, (q, k, v), g))


def check_flashattn(q, k, v, g, scale: float, what: str) -> tuple[tuple, tuple]:
    """The three kernels through autograd on one case against the plain version
    and autograd of it: max abs errors of (forward, dq, the larger of dk and
    dv), and the same as shares of max|plain|."""
    tol_f, tol_g, floor = FLASH_TOL[q.dtype]
    got = _flash_grads(flashattn.flash_attention, q, k, v, g, scale)
    want = _flash_grads(flashattn.flash_attention_plain, q, k, v, g, scale)
    if got[0].stride() != torch.empty_like(q).stride():
        raise AssertionError(f"{what}: output strides {got[0].stride()} for q {q.stride()}")
    errs = [_within(a, b, tol, f"{what} {name}", floor) for a, b, tol, name in zip(
        got, want, (tol_f, tol_g, tol_g, tol_g), ("forward", "dq", "dk", "dv"))]
    scales = [float(w.abs().max()) for w in want]
    shares = [e / s if s else (float("inf") if e else 0.0) for e, s in zip(errs, scales)]
    return ((errs[0], errs[1], max(errs[2:])), (shares[0], shares[1], max(shares[2:])))


def _flash_work(names, bh: int, s: int, d: int, element_size: int, sk: int | None = None
                ) -> dict[str, tuple]:
    """(bytes, exponentials, tensor-core flops, float32-unit flops) of each
    kernel on (BH, S, D) queries and (BH, ``sk``, D) keys (``sk`` default S):
    q, k, v (and do) read once, results written once, lse and di in float32;
    one exponential a query-key pair; each product 2 D flops a pair, D padded
    to the tensor cores' depth of 16."""
    sk = s if sk is None else sk
    pairs = bh * s * sk
    tq, tk, stat = bh * s * d * element_size, bh * sk * d * element_size, bh * s * 4
    n_bytes = {"flashattn_fwd": 2 * tq + 2 * tk + stat,
               "flashattn_bwd_dq": 3 * tq + 2 * tk + 2 * stat,
               "flashattn_bwd_dkv": 2 * tq + 4 * tk + 2 * stat}
    return {k: (n_bytes[k], pairs, pairs * FLASH_PRODUCTS[k] * 2 * max(d, 16),
                pairs * FLASH_PRODUCTS[k] * 2 * d) for k in names}


def phase_flashattn(device, card: str) -> dict[str, dict]:
    """The K4 kernels vs plain; one result dict per kernel."""
    gen = torch.Generator(device=device).manual_seed(6)
    names = KERNELS[7:10]
    worst = dict.fromkeys(names, 0.0)
    # over the path's shapes in bfloat16, what the main path launches: (error,
    # its share of max|plain|)
    worst_path = dict.fromkeys(names, (0.0, 0.0))

    def run(views, mult: float, what: str, scale: float | None = None, path: bool = False):
        q, k, v, g = views
        before = counts()
        errs, shares = check_flashattn(q * mult, k, v, g, scale or q.shape[2] ** -0.5, what)
        torch.cuda.synchronize()
        tc = [counts()[c] - before[c] for c in FLASH_TC]
        if tc != [int(q.dtype == torch.bfloat16)] * len(FLASH_TC):
            raise AssertionError(f"{what}: tensor-core launches (fwd, dq, dk/dv) {tc}")
        if mult == 1.0:  # max_abs_err is over unit-variance inputs
            for name, e in zip(names, errs):
                worst[name] = max(worst[name], e)
        if path and q.dtype == torch.bfloat16:
            for name, pair in zip(names, zip(errs, shares)):
                worst_path[name] = max(worst_path[name], pair, key=lambda p: p[1])
        print(f"kernel flashattn {what}: max abs err fwd {errs[0]:.3g}, dq {errs[1]:.3g}, "
              f"dk/dv {errs[2]:.3g} = {shares[0]:.3g}, {shares[1]:.3g}, {shares[2]:.3g} of "
              f"max|plain|")

    for dtype in (torch.float32, torch.bfloat16):
        tag = str(dtype).split(".")[1]
        # the path's shapes through the model's views, then a 256² input's S
        for n, s in FLASH_PATH:
            run(_projection_views(n, 8, 8, s, dtype, gen), 1.0,
                f"path ({n}x8, 8, {s}) {tag} (N, S, C) views", path=True)
        run(_projection_views(2, 8, 8, 16384, dtype, gen), 1.0,
            f"(2x8, 8, 16384) {tag} (N, S, C) views")
        for s in (1, 7, 255, 1000):  # ragged: the tail is masked in the kernels
            run(_projection_views(2, 3, 8, s, dtype, gen), 1.0, f"(2x3, 8, {s}) {tag} views")
            run(_dense_views(2, 3, 8, s, dtype, gen), 1.0, f"(2x3, 8, {s}) {tag} (N, H, D, S)")
        for d in (16, 32, 64):
            run(_projection_views(2, 2, d, 1000, dtype, gen), 1.0, f"(2x2, {d}, 1000) {tag} views")
            run(_dense_views(1, 2, d, 512, dtype, gen), 1.0, f"(1x2, {d}, 512) {tag} (N, H, D, S)")
        # scores of several hundred: exp without the running maximum overflows
        # (gradients up to several hundred too: held to the same relative bound)
        run(_projection_views(2, 4, 8, 700, dtype, gen), 40.0, f"(2x4, 8, 700) {tag} q x 40",
            scale=1.0)
        # the JAX entry point's (BH, D, S)
        q, k, v, g = (t[0] for t in _dense_views(1, 6, 8, 300, dtype, gen))
        got = flashattn.flash_attention(q, k, v, 0.35)
        _within(got, flashattn.flash_attention_plain(q, k, v, 0.35), FLASH_TOL[dtype][0],
                f"(6, 8, 300) {tag} 3-D", FLASH_TOL[dtype][2])

    # only what autograd asks for, bit for bit what the full backward gives
    q, k, v, g = _projection_views(4, 8, 8, 1000, torch.bfloat16, gen)
    full = _flash_grads(flashattn.flash_attention, q, k, v, g, 0.35)[1:]
    for need in ((1, 0, 0), (0, 1, 0), (0, 0, 1), (1, 1, 0), (0, 1, 1), (1, 0, 1), (1, 1, 1)):
        ts = [t.detach().requires_grad_(bool(r)) for t, r in zip((q, k, v), need)]
        before = counts()
        out = flashattn.flash_attention(*ts, 0.35)
        grads = torch.autograd.grad(out, [t for t in ts if t.requires_grad], g)
        torch.cuda.synchronize()
        launched = {name: counts()[name] - before[name] for name in names + FLASH_TC}
        want = {"flashattn_fwd": 1, "flashattn_bwd_dq": need[0],
                "flashattn_bwd_dkv": int(bool(need[1] or need[2]))}
        want.update(zip(FLASH_TC, (1, want["flashattn_bwd_dq"], want["flashattn_bwd_dkv"])))
        if launched != want:
            raise AssertionError(f"flashattn needs_input_grad {need}: launched {launched}")
        for got, ref in zip(grads, [f for f, r in zip(full, need) if r]):
            if not torch.equal(got, ref):
                raise AssertionError(f"flashattn needs_input_grad {need}: a gradient differs "
                                     "from the full backward's")
    again = _flash_grads(flashattn.flash_attention, q, k, v, g, 0.35)[1:]
    if not all(torch.equal(a, b) for a, b in zip(full, again)):
        raise AssertionError("flashattn: two identical bf16 backward runs differ")
    # the bf16 forward at the path's shapes: output and lse bit for bit
    for s in (4096, 1024):
        qkv = _projection_views(FLASH_TIMED_BATCH, 8, 8, s, torch.bfloat16, gen, 3)
        first, second = (fkernel.flashattn_fwd(*qkv, 8 ** -0.5) for _ in range(2))
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(first, second)):
            raise AssertionError(f"flashattn: two identical bf16 forward runs differ at S={s}")
    del qkv, first, second
    # what the wrappers refuse
    bad_calls = [(_dense_views(1, 1, 24, 8, torch.float32, gen, 3), ValueError),
                 ([t.half() for t in (q, k, v)], TypeError),
                 ((q, k[:, :4], v), ValueError), ((q, k.float(), v), ValueError),
                 ((q[0], k[0], v[0]), ValueError)]
    refused = 0
    for tensors, error in bad_calls:
        try:
            fkernel.flashattn_fwd(*tensors, 1.0)
        except error:
            refused += 1
    if refused != 5:
        raise AssertionError(f"flashattn wrappers refused {refused} of 5 bad calls")
    print("kernel flashattn: every bf16 forward and backward on the tensor cores, no float32 "
          "one; 7 needs_input_grad subsets launch only their kernels and repeat the full "
          "backward bit for bit; two identical bf16 backward runs, and two bf16 forward runs at "
          f"({FLASH_TIMED_BATCH}x8, 8, 4096) and 1024, bit-identical; head_dim 24, float16, "
          "mismatched shapes and dtypes and 3-D views refused")

    # times and bounds: the 7 calls of one B=32 U-Net pass at 128², bf16
    results = {name: {"max_abs_err": worst[name], "ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0}
               for name in names}
    work = {name: [0.0, 0.0, 0.0, 0.0] for name in names}
    bh = FLASH_TIMED_BATCH * 8
    for s, calls in FLASH_TIMED:
        q, k, v, g = _projection_views(FLASH_TIMED_BATCH, 8, 8, s, torch.bfloat16, gen)
        scale = 8 ** -0.5
        o, lse = fkernel.flashattn_fwd(q, k, v, scale)
        di = (o.float() * g.float()).sum(dim=2).contiguous()
        qp, kp, vp = (t.detach().requires_grad_() for t in (q, k, v))
        plain_out = flashattn.flash_attention_plain(qp, kp, vp, scale)
        # the library yardstick, (N, heads, S, D) views of the same memory
        ql, kl, vl = (t.detach().permute(0, 1, 3, 2).requires_grad_() for t in (q, k, v))
        gl = g.permute(0, 1, 3, 2)
        lib_out = F.scaled_dot_product_attention(ql, kl, vl, scale=scale)
        _within(lib_out.detach().permute(0, 1, 3, 2), o, 2e-2, f"flashattn S={s} vs the library",
                FLASH_TOL[torch.bfloat16][2])

        def plain_fwd():
            with torch.no_grad():
                return flashattn.flash_attention_plain(q, k, v, scale)

        def lib_fwd():
            with torch.no_grad():
                return F.scaled_dot_product_attention(ql, kl, vl, scale=scale)

        k_f, p_f = in_turns(plain_fwd, lambda: fkernel.flashattn_fwd(q, k, v, scale), 5)
        k_dq = cuda_ms(lambda: fkernel.flashattn_bwd(q, k, v, g, lse, di, scale, True, False,
                                                     False), 5)
        k_dkv = cuda_ms(lambda: fkernel.flashattn_bwd(q, k, v, g, lse, di, scale, False, True,
                                                      True), 5)
        # autograd of the plain version recomputes each chunk's forward (checkpoint)
        p_b = cuda_ms(lambda: torch.autograd.grad(plain_out, (qp, kp, vp), g, retain_graph=True),
                      3)
        l_f = cuda_ms(lib_fwd, 5)
        l_b = cuda_ms(lambda: torch.autograd.grad(lib_out, (ql, kl, vl), gl, retain_graph=True),
                      5)
        del plain_out, lib_out
        per_call = _flash_work(names, bh, s, 8, 2)
        times = {"flashattn_fwd": (k_f, p_f, l_f), "flashattn_bwd_dq": (k_dq, p_b, l_b),
                 "flashattn_bwd_dkv": (k_dkv, p_b, l_b)}
        for name in names:
            n_bytes, n_exp, n_tensor, n_fp32 = per_call[name]
            b, _ = bound_ms(n_bytes, n_tensor, n_exp, BF16_FLOP_PER_S)
            print(f"kernel {name} at ({bh}, 8, {s}) bf16 views: kernel {times[name][0]:.4f} ms, "
                  f"plain {times[name][1]:.4f} ms, F.scaled_dot_product_attention "
                  f"{times[name][2]:.4f} ms"
                  + (" (its whole backward)" if name != "flashattn_fwd" else "")
                  + f", bound {b:.4f} ms (bytes {n_bytes / HBM_BYTES_PER_S * 1e3:.4f}, "
                  f"exponentials {n_exp / EXP_PER_S * 1e3:.4f}, tensor cores "
                  f"{n_tensor / BF16_FLOP_PER_S * 1e3:.4f}); float32 units "
                  f"{n_fp32 / FP32_FLOP_PER_S * 1e3:.4f} ms [{card}]")
            for key, t in zip(("ms", "plain_ms", "library_ms"), times[name]):
                results[name][key] += calls * t
            for j, w in enumerate(per_call[name]):
                work[name][j] += calls * w
    for name in names:
        n_bytes, n_exp, n_tensor, n_fp32 = work[name]
        b, by = bound_ms(n_bytes, n_tensor, n_exp, BF16_FLOP_PER_S)
        term = "bytes" if by == "bytes" else (
            "exponentials" if n_exp / EXP_PER_S >= n_tensor / BF16_FLOP_PER_S else "tensor cores")
        results[name].update(bound_ms=b, bound_by=by, bound_term=term)
        r = results[name]
        print(f"kernel {name}: all cases within tolerance, worst {worst[name]:.3g}; at the path's "
              f"shapes in bf16 worst {worst_path[name][0]:.3g} = {worst_path[name][1]:.3g} of "
              f"max|plain|; the 7 calls "
              f"of one B={FLASH_TIMED_BATCH} U-Net pass at 128² bf16: kernel {r['ms']:.4f} ms, "
              f"plain "
              f"{r['plain_ms']:.4f} ms, library {r['library_ms']:.4f} ms, bound {b:.4f} ms "
              f"({term}; float32 units {n_fp32 / FP32_FLOP_PER_S * 1e3:.4f} ms) [{card}]")
    return results


# ------------------------------------------------------------------ tfc_diff
def _diff_cfg(name: str, dtype: str, timesteps: int | None = None):
    cfg = _cfg(name, dtype)
    cfg = cfg.replace(data=dataclasses.replace(cfg.data, image_size=DIFF_SIZE))
    return cfg.replace(extra={**cfg.extra, "timesteps": timesteps}) if timesteps else cfg


DIFF_CHAINS = 1     # 500-step chains at B=8 through Inferencer
DIFF_GEN_PAIRS = 4  # test pairs of cli gen: one chain at its batch of 4


def phase_diff_serve(device, args, card: str) -> dict[str, int]:
    """The full-width tfc_diff serve path (the whole ancestral chain on the
    card) through ``Inferencer`` and ``cli gen``; returns the run's launch
    counts."""
    from PIL import Image

    cfg = _diff_cfg("tfc_diff", "bfloat16")
    steps = diffusion_recipe.schedule_of(cfg).num_timesteps
    nets = diffusion_recipe.build_generators(cfg, device,
                                             torch.Generator().manual_seed(args.init_seed))
    n_params = sum(p.numel() for p in nets.parameters())
    inf = Inferencer(cfg, nets)
    batches = [synthetic_batch(batch_size=8, image_size=DIFF_SIZE, seed=70 + i)
               for i in range(DIFF_CHAINS)]
    reset_counts()
    t0 = time.perf_counter()
    chains = 0
    for i, b in enumerate(batches):
        out = inf(b, seed=i)
        chains += 1
        expect_counts("tfc_diff serve", DIFF_FORWARD, chains * steps)
        if out.shape != (8, DIFF_SIZE, DIFF_SIZE, 1) or out.dtype != torch.float32:
            raise AssertionError(f"tfc_diff sample {tuple(out.shape)} {out.dtype}")
        if not bool(torch.isfinite(out).all()) or float(out.abs().max()) > 1.0:
            raise AssertionError("tfc_diff sample not finite or outside [-1, 1]")
        if float(out.std()) < 1e-3:
            raise AssertionError("tfc_diff sample is constant")
    torch.cuda.synchronize()
    chain_s = (time.perf_counter() - t0) / chains
    with tempfile.TemporaryDirectory() as tmp:
        data, out_dir = os.path.join(tmp, "data"), os.path.join(tmp, "out")
        pairs = synthetic_batch(batch_size=DIFF_GEN_PAIRS, image_size=DIFF_SIZE, seed=13)
        for i in range(DIFF_GEN_PAIRS):
            save_image_grid([pairs["A"][i], pairs["B"][i]],
                            os.path.join(data, "test", f"{i:03d}.png"), axis=1)
        cli.main(["gen", "--config", "tfc_diff", "--data-root", data, "--image-size",
                  str(DIFF_SIZE), "--dtype", "bfloat16", "--out-dir", out_dir,
                  "--init-seed", str(args.init_seed), "--seed", "3", "--device", "cuda"])
        gen_chains = -(-DIFF_GEN_PAIRS // 4)  # batch 4 by default
        chains += gen_chains
        stacks = sorted(f for f in os.listdir(out_dir) if f.endswith(".png"))
        with Image.open(os.path.join(out_dir, stacks[0])) as img:
            size = img.size
    seconds = time.perf_counter() - t0
    if len(stacks) != DIFF_GEN_PAIRS or size != (DIFF_SIZE, 2 * DIFF_SIZE):
        raise AssertionError(f"cli gen wrote {len(stacks)} stacks of size {size}")
    run = expect_counts("tfc_diff serve", DIFF_FORWARD, chains * steps)
    print(f"tfc_diff serve: CondUNet {n_params:,} parameters, bf16, {DIFF_SIZE}²; {chains} chains "
          f"of {steps} steps ({DIFF_CHAINS} x 8 images through Inferencer, {chain_s:.2f} s a "
          f"chain = {8 / chain_s:.2f} sampled img/s; {gen_chains} x 4 through cli gen) in "
          f"{seconds:.2f} s: samples "
          f"finite and in [-1, 1], {len(stacks)} real_A | sample stacks of {size[0]}x{size[1]}; "
          f"launches a U-Net forward {DIFF_FORWARD}, {run['flashattn_fwd']} in all, no backward "
          f"launch, no other kernel [{card}]")

    # float32, the same weights: one U-Net forward and a 20-step chain, kernel
    # path vs plain path on the card
    cfg32 = _diff_cfg("tfc_diff", "float32", timesteps=20)
    nets32 = diffusion_recipe.build_generators(cfg32, device)
    nets32.load_state_dict(nets.state_dict())
    gen = torch.Generator(device=device).manual_seed(7)
    small = {"A": torch.as_tensor(batches[0]["A"][:2], device=device)}
    x = torch.randn((2, DIFF_SIZE, DIFF_SIZE, 1), device=device, generator=gen)
    t = torch.tensor([3, steps - 1], device=device)
    short = diffusion_recipe.schedule_of(cfg32)
    noise = torch.randn((short.num_timesteps + 1, *x.shape), device=device, generator=gen)
    with torch.no_grad():
        cond = nets32.cond(small)
        y_kernel = nets32.unet(x, t, cond)
        chain_kernel = diffusion_recipe.diffusion_sample(nets32, short, small, noise=noise)
        with plain_path():
            before = counts()
            y_plain = nets32.unet(x, t, cond)
            chain_plain = diffusion_recipe.diffusion_sample(nets32, short, small, noise=noise)
            if counts() != before:
                raise AssertionError("tfc_diff serve: the plain path launched a kernel")
    err, err_chain = (float((a - b).abs().max()) for a, b in ((y_kernel, y_plain),
                                                              (chain_kernel, chain_plain)))
    if err > 1e-4 or err_chain > 1e-3:
        raise AssertionError(f"tfc_diff fp32: kernel path vs plain path max abs err U-Net "
                             f"forward {err}, {short.num_timesteps}-step chain {err_chain}")
    print(f"tfc_diff serve fp32 (2 x {DIFF_SIZE}²): kernel path vs plain path on the card max abs "
          f"err U-Net forward {err:.3g} (atol 1e-4), {short.num_timesteps}-step chain with the "
          f"same noise {err_chain:.3g} (atol 1e-3)")
    del nets32

    for bsz in (8, 32):
        xb = torch.randn((bsz, DIFF_SIZE, DIFF_SIZE, 1), device=device, generator=gen)
        cb = torch.rand((bsz, DIFF_SIZE, DIFF_SIZE, 1), device=device, generator=gen) * 2 - 1
        tb = torch.full((bsz,), steps // 2, device=device)
        with torch.inference_mode():
            with plain_path():
                p1 = cuda_ms(lambda: nets.unet(xb, tb, cb), 10)
            k1 = cuda_ms(lambda: nets.unet(xb, tb, cb), 10)
            k2 = cuda_ms(lambda: nets.unet(xb, tb, cb), 10)
            with plain_path():
                p2 = cuda_ms(lambda: nets.unet(xb, tb, cb), 10)
        ms, plain = (k1 + k2) / 2, (p1 + p2) / 2
        print(f"tfc_diff U-Net forward bf16 B={bsz} {DIFF_SIZE}²: kernel path {ms:.3f} ms = "
              f"{1000 / ms:.1f} forwards/s = {bsz * 1000 / ms / steps:.3f} sampled img/s over a "
              f"{steps}-step chain; plain path {plain:.3f} ms = {1000 / plain:.1f} forwards/s = "
              f"{bsz * 1000 / plain / steps:.3f} sampled img/s [{card}]")
    return run


# ------------------------------------------- the rest of the TFC-GAN-FFT family
# the 12 tfcgan entries the debiased slice ports: the label-conditional chain
# V1-V7, the saliency mask, the regional FFT loss in both forms and favtgan's
# two temperature forms
FAMILY = ("fft_patch_debiased_v1", "fft_patch_debiased_v2", "fft_patch_debiased_v3",
          "fft_patch_debiased_v4", "fft_patch_debiased_v5", "fft_patch_debiased_v6",
          "fft_patch_debiased", "fft_patch_mask", "fft_patch_region", "fft_patch_region_kl",
          "favtgan_l1", "favtgan_tempmap")
DEBIASED_TERMS = ("g_adv", "g_triplet", "g_temp", "g_lpips", "g_fft", "g_ce", "loss_G",
                  "loss_D", "d_ce")
MASK_TERMS = TRAIN_TERMS + ("g_mask",)
# their float32 steps at B=4 against a reference: elementwise x max|g|, and L2 (see main)
DEBIASED_TOL, MASK_TOL = (3e-2, 1.2e-2), (7e-1, 4e-1)
FAMILY_RATE_STEPS = 10  # timed steps a variant, after 3 warm-up steps
FAMILY_SERVE_BATCHES = (8, 32)
FAMILY_CLI_PAIRS = 64   # cli train --annots at batch 32: 2 steps an epoch


def _family_terms(cfg) -> set[str]:
    """The terms an entry of the family must report beside every step's."""
    lc = cfg.loss
    return ({"g_ce", "d_ce"} if lc.conditional else set()) | \
        ({"g_region_fft"} if lc.region_fft != "off" else set()) | \
        ({"g_mask"} if lc.use_mask else set())


def phase_family_train(device, args) -> dict[str, int]:
    """Every one of the 12 entries at full width: 3 bf16 steps at B=8, 256², on
    labelled synthetic batches, every term finite and taking 3 values, 27
    forward and 23 backward blur-pool launches a step read after each step;
    returns the run's launch counts."""
    reset_counts()
    t0 = time.perf_counter()
    for name in FAMILY:
        cfg = _cfg(name, "bfloat16")
        log = _Rows()
        trainer = Trainer(cfg, build_recipe(cfg, device), logger=log)
        state = trainer.init_state(args.init_seed)
        batches = [_device_batch(8, 60 + i, device, SIZE, True) for i in range(3)]
        before = counts()
        trainer.fit(state, batches, num_steps=3, log_every=1, check_finite=True)
        for i, row in enumerate(log.rows, 1):
            got = {k: row["counts"][k] - before[k] for k in COUNTED}
            if got != scaled(FFT_GLO_STEP, i):
                raise AssertionError(f"{name} after step {i}: launches {got}; want "
                                     f"{FFT_GLO_STEP} a step")
        terms = sorted(k for k in log.rows[0] if k not in ("step", "wall_s", "counts"))
        # the frozen pyramid's L1 is taken in the outputs' dtype, as in JAX: in
        # bf16 (8 bits of mantissa) it may round to one value for 3 batches
        coarse = ("g_vae_gan",) if name == "thermalgan" else ()
        stuck = [k for k in terms if len({row[k] for row in log.rows}) != 3 and k not in coarse]
        missing = _family_terms(cfg) - set(terms)
        if len(log.rows) != 3 or state.step != 3 or stuck or missing:
            raise AssertionError(f"{name} train: {len(log.rows)} rows, step {state.step}, "
                                 f"terms not moving {stuck}, missing {missing}")
        cnns = state.cnns.values() if state.cnns is not None else ()
        params = f"G {count_params(state.G):,}, D {count_params(state.D):,}" + "".join(
            f", regional ResNet-18 {count_params(c):,}" for c in list(cnns)[:1])
        print(f"{name} train ({params} parameters): 3 bf16 steps at B=8, {SIZE}², {len(terms)} "
              f"terms finite and moving; step 3: "
              + ", ".join(f"{k} {log.rows[-1][k]:.5g}" for k in terms))
        del trainer, state
        torch.cuda.empty_cache()
    run = expect_counts("the family's 12 entries", FFT_GLO_STEP, 3 * len(FAMILY))
    print(f"family train: 12 entries x 3 steps in {time.perf_counter() - t0:.1f} s (with "
          f"set-up); blur-pool launches {FFT_GLO_STEP} a step, {run['blurpool_fwd']} + "
          f"{run['blurpool_bwd']} in all")
    return run


def phase_family_rate(device, args, card: str) -> None:
    """V7 and V4 at full width: train-step img/s over ``FAMILY_RATE_STEPS``
    steps at B=32, 256², bf16, after 3 warm-up steps (CUDA events around
    every step: median, min and max), the launches over the timed steps and
    the peak memory."""
    for name in ("fft_patch_debiased", "fft_patch_debiased_v4"):
        cfg = _cfg(name, "bfloat16")
        trainer = Trainer(cfg, build_recipe(cfg, device))
        state = trainer.init_state(args.init_seed)
        batch = _device_batch(32, 70, device, SIZE, True)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for _ in range(3):
            trainer.step(state, batch)
        events = [torch.cuda.Event(enable_timing=True) for _ in range(FAMILY_RATE_STEPS + 1)]
        reset_counts()
        events[0].record()
        for i in range(FAMILY_RATE_STEPS):
            metrics = trainer.step(state, batch)
            events[i + 1].record()
        events[-1].synchronize()
        expect_counts(f"{name} timed steps", FFT_GLO_STEP, FAMILY_RATE_STEPS)
        if not all(bool(torch.isfinite(v)) for v in metrics.values()):
            raise AssertionError(f"{name} rate: a loss is not finite")
        step_ms = sorted(a.elapsed_time(b) for a, b in zip(events, events[1:]))
        total = events[0].elapsed_time(events[-1])
        peak = torch.cuda.max_memory_allocated() / 2**30
        print(f"{name} train step bf16 B=32 {SIZE}²: {32 * 1000 * FAMILY_RATE_STEPS / total:.1f} "
              f"img/s over {FAMILY_RATE_STEPS} steps ({total / FAMILY_RATE_STEPS:.2f} ms a step; "
              f"median {step_ms[len(step_ms) // 2]:.2f}, min {step_ms[0]:.2f}, max "
              f"{step_ms[-1]:.2f} ms), peak memory {peak:.2f} GiB [{card}]")
        del trainer, state, batch, metrics
        torch.cuda.empty_cache()


def phase_family_serve(device, args, card: str) -> None:
    """The conditional G (V7, full width) served by ``Inferencer`` with the
    batches' labels: bf16 outputs finite, in [-1, 1] and depending on the
    labels, 11 blur-pool forward launches a batch; float32 kernel path
    against the plain path (atol 1e-4); img/s at B=8 and 32."""
    cfg = _cfg("fft_patch_debiased", "bfloat16")
    g = build_generator(cfg, device, torch.Generator().manual_seed(args.init_seed))
    inf = Inferencer(cfg, g)
    for bsz in FAMILY_SERVE_BATCHES:
        batch = _device_batch(bsz, 80, device, SIZE, True)
        reset_counts()
        out = inf(batch)
        expect_counts(f"conditional serve B={bsz}", {"blurpool_fwd": 11}, 1)
        other = inf({**batch, "LAB3": (batch["LAB3"] + 1) % 2})
        if out.shape != (bsz, SIZE, SIZE, 3) or not bool(torch.isfinite(out).all()) or \
                float(out.abs().max()) > 1.0 or torch.equal(out, other):
            raise AssertionError(f"conditional serve B={bsz}: shape {tuple(out.shape)}, "
                                 "values not finite, outside [-1, 1] or blind to LAB3")
        ms = cuda_ms(lambda: inf(batch), 10)
        print(f"conditional serve bf16 B={bsz} {SIZE}² (Inferencer, LAB3): {ms:.3f} ms = "
              f"{bsz * 1000 / ms:.1f} img/s [{card}]")
    g32 = build_generator(_cfg("fft_patch_debiased", "float32"), device)
    g32.load_state_dict(g.state_dict())
    batch = _device_batch(2, 81, device, SIZE, True)
    with torch.inference_mode():
        lab = batch["LAB3"].float()
        y_kernel = g32(batch["A"], lab)
        with plain_path():
            y_plain = g32(batch["A"], lab)
    err = float((y_kernel - y_plain).abs().max())
    if err > 1e-4:
        raise AssertionError(f"fp32 conditional G: kernel path vs plain path max abs err {err}")
    print(f"conditional serve fp32 G (2 x {SIZE}²): kernel path vs plain path max abs err "
          f"{err:.3g} (atol 1e-4)")


def phase_family_cli(device, args, card: str) -> None:
    """``cli train --annots`` for V7 at full width (64 labelled A|B PNG pairs
    at 256², batch 32, bf16, 2 epochs: 5 steps, 27 + 23 blur-pool launches a
    step, checkpoints after each epoch, no sample grids), ``--resume`` to the
    same step, ``test`` refused; then the library resume of V4 (B=8: 3 steps
    straight against 1, save, load into a fresh recipe, 2) bit for bit where
    the straight run repeats bit for bit with cudnn.deterministic."""
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        data = os.path.join(tmp, "data")
        _write_pairs(data, seed=CLI_SEED + 20, count=FAMILY_CLI_PAIRS, split="train", size=SIZE)
        _write_pairs(data, seed=CLI_SEED + 21, count=4, size=SIZE)
        annots = os.path.join(tmp, "annots.csv")
        rng = np.random.RandomState(CLI_SEED + 22)
        with open(annots, "w", newline="") as f:
            out = csv.writer(f)
            out.writerow(["file", "gender", "ethnicity", "age"])
            for i in range(FAMILY_CLI_PAIRS):
                out.writerow([f"train/{i:03d}.png", rng.randint(2), rng.randint(4),
                              rng.randint(3)])
        common = ["--experiment", "fft_patch_debiased", "--data-root", data, "--image-size",
                  str(SIZE), "--batch-size", "32", "--dtype", "bfloat16", "--device", "cuda",
                  "--annots", annots, "--checkpoint-interval", "1"]
        runs, resumed = os.path.join(tmp, "runs"), os.path.join(tmp, "resumed")
        spe = FAMILY_CLI_PAIRS // 32
        reset_counts()
        cli.main(["train", *common, "--n-epochs", "2", "--out-dir", runs])
        run = expect_counts("cli train --annots", FFT_GLO_STEP, 1 + 2 * spe)
        ckpts = sorted(d for d in os.listdir(runs) if d.startswith("step_"))
        rows = _log_rows(os.path.join(runs, "logs", "fft_patch_debiased.jsonl"))
        if ckpts != [f"step_{1 + spe:08d}", f"step_{1 + 2 * spe:08d}"] or \
                not all({"g_ce", "d_ce"} <= set(r) for r in rows) or \
                os.path.exists(os.path.join(runs, "samples")):
            raise AssertionError(f"cli train --annots: checkpoints {ckpts}, log {rows}")
        cli.main(["train", *common, "--n-epochs", "1", "--out-dir", resumed,
                  "--resume", os.path.join(runs, ckpts[0])])
        if latest_checkpoint(resumed) != os.path.join(resumed, ckpts[1]):
            raise AssertionError(f"cli train --annots --resume: {latest_checkpoint(resumed)}")
        try:
            cli.main(["test", *common, "--checkpoint", latest_checkpoint(runs), "--out-dir",
                      os.path.join(tmp, "served")])
            raise AssertionError("cli test of a conditional experiment did not refuse")
        except SystemExit as e:
            refusal = str(e)
            if "conditional" not in refusal:
                raise
        print(f"cli train --annots fft_patch_debiased bf16 B=32 {SIZE}²: {1 + 2 * spe} steps, "
              f"checkpoints {ckpts}, {len(rows)} finite log records with g_ce and d_ce, no "
              f"sample grids; --resume to {ckpts[1]}; test refused ({refusal}); launches "
              f"{run['blurpool_fwd']} + {run['blurpool_bwd']} blur-pool")
        _library_resume(device, args, card, tmp, "fft_patch_debiased_v4", batch=8, steps=3,
                        resume_at=1)
    print(f"family cli phase: {time.perf_counter() - t0:.1f} s [{card}]")


# ---------------------------------------------- the baselines: ThermalGAN, CycleGAN
THERMAL_TERMS = ("loss_G", "g_ge", "g_kl", "g_vae_gan", "g_pixel_bic", "g_latent", "g_gan_pix",
                 "g_pixel_pix", "loss_D", "d_pix")
BASELINES = {"thermalgan": THERMAL_TERMS, "thermalgan_bn": THERMAL_TERMS + ("d_vae",),
             "cyclegan": ("loss_G", "g_adv", "g_cycle", "g_id", "loss_D", "d_A", "d_B")}
BASELINE_RATES = (("thermalgan", 32), ("thermalgan", 128), ("thermalgan_bn", 32),
                  ("cyclegan", 16))
BASELINE_RATE_STEPS = 10
# their float32 step on the card against the CPU: (L2, elementwise x max|g|), see main
BASELINE_TOL = (3e-2, 0.3)
BASELINE_CLI_BATCH = 8
BASELINE_CLI_PAIRS = 16  # 2 steps an epoch


def phase_baselines_train(device, args) -> dict[str, dict[str, int]]:
    """3 bf16 steps at B=8, 256², of each baseline entry: every term finite
    and taking 3 values, no kernel launched (read after each step). Returns
    the launch counts by path."""
    by_path = {}
    for name, terms in BASELINES.items():
        cfg = _cfg(name, "bfloat16")
        log = _Rows()
        trainer = Trainer(cfg, build_recipe(cfg, device), logger=log)
        state = trainer.init_state(args.init_seed)
        batches = [_device_batch(8, 100 + i, device) for i in range(3)]
        reset_counts()
        t0 = time.perf_counter()
        trainer.fit(state, batches, num_steps=3, log_every=1, check_finite=True)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        for i, row in enumerate(log.rows, 1):
            if row["counts"] != scaled({}, i):
                raise AssertionError(f"{name} after step {i}: launches {row['counts']}, want none")
        # the frozen pyramid's L1 is taken in the outputs' dtype, as in JAX: in
        # bf16 (8 bits of mantissa) it may round to one value for 3 batches
        coarse = ("g_vae_gan",) if name == "thermalgan" else ()
        stuck = [k for k in terms if len({row[k] for row in log.rows}) != 3 and k not in coarse]
        if len(log.rows) != 3 or state.step != 3 or stuck:
            raise AssertionError(f"{name} train: {len(log.rows)} rows, step {state.step}, "
                                 f"terms not moving {stuck}")
        by_path[f"{name}_train"] = expect_counts(f"{name} train", {}, 3)
        extra = ""
        if state.extra is not None:
            extra = ", replay buffers " + ", ".join(
                f"{k} {int(v['count'])}" for k, v in state.extra.items())
        frozen = "" if state.frozen is None else \
            f", frozen D_vae {count_params(state.frozen):,}"
        print(f"{name} train (G {count_params(state.G):,}, D {count_params(state.D):,}"
              f"{frozen} parameters): 3 bf16 steps at B=8, {SIZE}² in {seconds:.2f} s (with "
              f"set-up), {len(terms)} terms finite and moving, no kernel launched{extra}; step 3: "
              + ", ".join(f"{k} {log.rows[-1][k]:.5g}" for k in terms))
        del trainer, state
        torch.cuda.empty_cache()
    return by_path


def _to(obj, device):
    """``obj`` (a tensor, a dict or a dataclass of them, or None) on ``device``."""
    if isinstance(obj, torch.Tensor):
        return obj.to(device)
    if isinstance(obj, dict):
        return {k: _to(v, device) for k, v in obj.items()}
    if dataclasses.is_dataclass(obj):
        return dataclasses.replace(obj, **{f.name: _to(getattr(obj, f.name), device)
                                           for f in dataclasses.fields(obj)})
    return obj


def phase_baselines_compare(device, args) -> None:
    """fp32, TF32 off: one step of ``thermalgan`` (detached D_vae, G2's
    dropout on with the same keep-masks) and of ``cyclegan`` (both replay
    buffers full, the same coins and slots) at B=2, 256², on the card and on
    the CPU from the same weights, batch and draws. Loss terms rtol 1e-4;
    every gradient within ``BASELINE_TOL``."""
    l2_tol, elem_tol = BASELINE_TOL
    for name in ("thermalgan", "cyclegan"):
        t0 = time.perf_counter()
        cfg = _cfg(name, "float32")
        host = build_recipe(cfg, "cpu")
        host.init(torch.Generator().manual_seed(args.init_seed))
        card_recipe = build_recipe(cfg, device)
        card_recipe.G.load_state_dict(host.G.state_dict())
        card_recipe.D.load_state_dict(host.D.state_dict())
        if getattr(host, "frozen", None) is not None:
            card_recipe.frozen.load_state_dict(host.frozen.state_dict())
        batch = {k: torch.as_tensor(v) for k, v in synthetic_batch(2, SIZE, seed=110).items()}
        draws = host.draw(torch.Generator().manual_seed(args.init_seed), batch)
        extra = None
        if hasattr(host, "initial_extra"):
            extra = host.initial_extra()
            gen = torch.Generator().manual_seed(111)
            for buf in extra.values():
                buf["data"].copy_(torch.rand(buf["data"].shape, generator=gen) * 2 - 1)
                buf["count"].fill_(buf["data"].shape[0])
        reset_counts()
        c_terms, c_grads = _step_terms_and_grads(card_recipe, _to(batch, device),
                                                 _to(draws, device), _to(extra, device))
        expect_counts(f"{name} fp32 step", {}, 1)
        c_grads = {k: v.double().cpu() for k, v in c_grads.items()}
        h_terms, h_grads = _step_terms_and_grads(host, batch, draws, extra)
        h_grads = {k: v.double() for k, v in h_grads.items()}
        for k, v in h_terms.items():
            if abs(c_terms[k] - v) > 1e-4 * abs(v):
                raise AssertionError(f"{name} fp32 {k}: card {c_terms[k]}, CPU {v}")
        # a bias in front of an instance norm: zero in exact arithmetic
        skip = [n for n, g in h_grads.items() if n.endswith(".bias") and
                float(g.abs().max()) < 1e-4 * float(h_grads[n[:-4] + "weight"].abs().max())]
        worst, worst_name = 0.0, ""
        for n, g in h_grads.items():
            if n in skip:
                continue
            diff = c_grads[n] - g
            ratio = max(float(diff.norm()) / (l2_tol * float(g.norm()) + 1e-12),
                        float(diff.abs().max()) / (elem_tol * float(g.abs().max()) + 1e-7))
            if ratio > worst:
                worst, worst_name = ratio, n
        if worst > 1.0:
            raise AssertionError(f"{name} fp32 gradient {worst_name}: {worst:.3g} x its bound")
        rel = max(abs(c_terms[k] - v) / max(abs(v), 1e-30) for k, v in h_terms.items())
        print(f"{name} train compare fp32 (B=2, {SIZE}², TF32 off), card vs CPU: "
              f"{len(h_terms)} loss terms within rtol 1e-4 (max rel {rel:.3g}); "
              f"{len(h_grads) - len(skip)} gradients within {l2_tol} of their L2 norm and "
              f"{elem_tol} max|g|, worst {worst:.3g} of the bound ({worst_name}); no kernel "
              f"launched; {time.perf_counter() - t0:.1f} s")
        del host, card_recipe
        torch.cuda.empty_cache()


def phase_baselines_rate(device, args, card: str) -> None:
    """Train-step img/s over ``BASELINE_RATE_STEPS`` steps after 3 warm-up
    steps (CUDA events around every step: median, min, max), no kernel
    launched, and the peak memory, for each of ``BASELINE_RATES``. A batch
    that does not fit in the card's memory is reported as such."""
    for name, bsz in BASELINE_RATES:
        cfg = _cfg(name, "bfloat16")
        trainer = Trainer(cfg, build_recipe(cfg, device))
        state = trainer.init_state(args.init_seed)
        batch = _device_batch(bsz, 120, device)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        events = [torch.cuda.Event(enable_timing=True) for _ in range(BASELINE_RATE_STEPS + 1)]
        try:
            for _ in range(3):
                trainer.step(state, batch)
            reset_counts()
            events[0].record()
            for i in range(BASELINE_RATE_STEPS):
                metrics = trainer.step(state, batch)
                events[i + 1].record()
            events[-1].synchronize()
        except torch.cuda.OutOfMemoryError:
            print(f"{name} train step bf16 B={bsz} {SIZE}²: does not fit in the card's memory "
                  f"(peak before the failure {torch.cuda.max_memory_allocated() / 2**30:.2f} "
                  f"GiB) [{card}]")
            del trainer, state, batch
            torch.cuda.empty_cache()
            continue
        expect_counts(f"{name} timed steps", {}, BASELINE_RATE_STEPS)
        if not all(bool(torch.isfinite(v)) for v in metrics.values()):
            raise AssertionError(f"{name} rate B={bsz}: a loss is not finite")
        step_ms = sorted(a.elapsed_time(b) for a, b in zip(events, events[1:]))
        total = events[0].elapsed_time(events[-1])
        peak = torch.cuda.max_memory_allocated() / 2**30
        print(f"{name} train step bf16 B={bsz} {SIZE}²: "
              f"{bsz * 1000 * BASELINE_RATE_STEPS / total:.1f} img/s over "
              f"{BASELINE_RATE_STEPS} steps ({total / BASELINE_RATE_STEPS:.2f} ms a step; median "
              f"{step_ms[len(step_ms) // 2]:.2f}, min {step_ms[0]:.2f}, max {step_ms[-1]:.2f} "
              f"ms), no kernel launched, peak memory {peak:.2f} GiB [{card}]")
        del trainer, state, batch, metrics
        torch.cuda.empty_cache()


def phase_baselines_serve(device, args, card: str) -> dict[str, dict[str, int]]:
    """``Inferencer`` of both families at full width in bf16, B=8 and 32:
    outputs finite, in [-1, 1], of the batch's shape, no kernel launched;
    img/s; then ``cli test`` of each over 8 A|B PNG pairs (3-image stacks for
    thermalgan, 4-image for cyclegan). Returns the launch counts by path."""
    by_path = {}
    builders = {"thermalgan": thermalgan_recipe.build_generators,
                "cyclegan": cyclegan_recipe.build_generators}
    with tempfile.TemporaryDirectory() as tmp:
        data = os.path.join(tmp, "data")
        _write_pairs(data, seed=CLI_SEED + 40, count=8, size=SIZE)
        for name, build in builders.items():
            cfg = _cfg(name, "bfloat16")
            inf = Inferencer(cfg, build(cfg, device, torch.Generator().manual_seed(args.init_seed)))
            reset_counts()
            for bsz in (8, 32):
                batch = _device_batch(bsz, 130, device)
                out = inf(batch)
                for k, y in (out.items() if isinstance(out, dict) else [("fake_B", out)]):
                    if y.shape != batch["A"].shape or not bool(torch.isfinite(y).all()) or \
                            float(y.abs().max()) > 1.0:
                        raise AssertionError(f"{name} serve B={bsz} {k}: shape {tuple(y.shape)}, "
                                             "values not finite or outside [-1, 1]")
                ms = cuda_ms(lambda: inf(batch), 10)
                print(f"{name} serve bf16 B={bsz} {SIZE}² (Inferencer"
                      f"{', both generators' if name == 'cyclegan' else ', G2(G1(A, T_B))'}): "
                      f"{ms:.3f} ms = {bsz * 1000 / ms:.1f} img/s [{card}]")
            out_dir = os.path.join(tmp, f"served_{name}")
            cli.main(["test", "--experiment", name, "--init-seed", str(args.init_seed),
                      "--data-root", data, "--image-size", str(SIZE), "--dtype", "bfloat16",
                      "--device", "cuda", "--out-dir", out_dir])
            stacks = sorted(f for f in os.listdir(out_dir) if f.endswith(".png"))
            from PIL import Image

            with Image.open(os.path.join(out_dir, stacks[0])) as im:
                height = im.size[1]
            images = 4 if name == "cyclegan" else 3
            if len(stacks) != 8 or height != images * SIZE:
                raise AssertionError(f"cli test {name}: {len(stacks)} stacks, {height} px high")
            by_path[f"{name}_serve"] = expect_counts(f"{name} serve", {}, 1)
            print(f"cli test {name}: 8 stacks of {images} images; no kernel launched")
            del inf
            torch.cuda.empty_cache()
    return by_path


def phase_baselines_cli(device, args, card: str) -> None:
    """``cli train`` of cyclegan at full width, B=8, bf16, on 16 identical A|B
    pairs (2 steps an epoch): 2 epochs straight, then ``--resume`` from the
    first epoch's checkpoint for 1 epoch, both under ``cudnn.deterministic``;
    the two final checkpoints' weights, replay buffers, Adam states and
    generator state equal bit for bit, no kernel launched."""
    t0 = time.perf_counter()
    deterministic, benchmark = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        with tempfile.TemporaryDirectory() as tmp:
            data = os.path.join(tmp, "data")
            pair = synthetic_batch(batch_size=1, image_size=SIZE, seed=CLI_SEED + 50)
            for i in range(BASELINE_CLI_PAIRS):
                save_image_grid([pair["A"][0], pair["B"][0]],
                                os.path.join(data, "train", f"{i:03d}.png"), axis=1)
            common = ["--experiment", "cyclegan", "--data-root", data, "--image-size", str(SIZE),
                      "--batch-size", str(BASELINE_CLI_BATCH), "--dtype", "bfloat16",
                      "--device", "cuda", "--checkpoint-interval", "1"]
            runs, resumed = os.path.join(tmp, "runs"), os.path.join(tmp, "resumed")
            spe = BASELINE_CLI_PAIRS // BASELINE_CLI_BATCH
            reset_counts()
            cli.main(["train", *common, "--n-epochs", "2", "--out-dir", runs])
            ckpts = sorted(d for d in os.listdir(runs) if d.startswith("step_"))
            if ckpts != [f"step_{1 + spe:08d}", f"step_{1 + 2 * spe:08d}"]:
                raise AssertionError(f"cli train cyclegan: checkpoints {ckpts}")
            cli.main(["train", *common, "--n-epochs", "1", "--out-dir", resumed,
                      "--resume", os.path.join(runs, ckpts[0])])
            expect_counts("cli train cyclegan", {}, 1)
            straight = torch.load(os.path.join(runs, ckpts[1], STATE_FILE), weights_only=True)
            again = torch.load(os.path.join(resumed, ckpts[1], STATE_FILE), weights_only=True)
            flat = {}
            for label, ckpt in (("straight", straight), ("resumed", again)):
                flat[label] = {
                    **{f"G.{k}": v for k, v in ckpt["G"].items()},
                    **{f"D.{k}": v for k, v in ckpt["D"].items()},
                    **{f"extra.{b}.{k}": v for b, buf in ckpt["extra"].items()
                       for k, v in buf.items()},
                    **{f"opt_{o}.{i}.{k}": v for o in ("g", "d")
                       for i, st in ckpt[f"opt_{o}"]["state"].items() for k, v in st.items()},
                    "generator": ckpt["generator"]}
            if not _bits_equal(flat["straight"], flat["resumed"]):
                bad = [k for k in flat["straight"] if not torch.equal(
                    torch.as_tensor(flat["straight"][k]), torch.as_tensor(flat["resumed"][k]))]
                raise AssertionError(f"cli train cyclegan --resume differs from the straight "
                                     f"run in {len(bad)} tensors, first {bad[:4]}")
            counts_ = {b: int(buf["count"]) for b, buf in straight["extra"].items()}
            rows = _log_rows(os.path.join(runs, "logs", "cyclegan.jsonl"))
            print(f"cli train cyclegan bf16 B={BASELINE_CLI_BATCH} {SIZE}²: {1 + 2 * spe} "
                  f"steps, checkpoints {ckpts}, {len(rows)} finite log records; --resume from "
                  f"{ckpts[0]} to {ckpts[1]}: {len(flat['straight'])} tensors (weights, replay "
                  f"buffers {counts_}, Adam states, generator) bit for bit against the straight "
                  f"run; no kernel launched")
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = \
            deterministic, benchmark
    print(f"baseline cli leg: {time.perf_counter() - t0:.1f} s [{card}]")


# ------------------------------------------------- the data and evaluation chain
DATA_FILES = ((320, 32), (SIZE, 32))  # A|B files (side, count): resized, and not
DATA_BATCH = 32
HIST_EPOCHS, HIST_EVERY = 4, 4  # 2 steps an epoch: each epoch's first step is logged
G_PARAMS, D_PARAMS = 29_238_275, 2_767_808  # fft_glo's G and D (phase 6b prints them)
IQA_PAIRS = 32
REG_TOL = (1e-4, 1e-5)  # registration_metrics, card against the CPU: rtol, atol


def _noisy_pairs(root: str, side: int, count: int, seed: int, offset: int) -> None:
    """``count`` synthetic A|B PNG pairs of ``side``² halves with noise (so
    that a resize has work to do), named from ``offset``."""
    pairs = synthetic_batch(batch_size=count, image_size=side, seed=seed)
    noise = np.random.RandomState(seed).uniform(-0.3, 0.3, pairs["A"].shape).astype(np.float32)
    os.makedirs(root, exist_ok=True)
    for i in range(count):
        a = np.clip(pairs["A"][i] + noise[i], -1, 1)
        b = np.clip(pairs["B"][i] - noise[i], -1, 1)
        write_png(os.path.join(root, f"{offset + i:03d}.png"),
                  np.concatenate([to_uint8(a), to_uint8(b)], axis=1))


def _decode_rates(root: str, stack: np.ndarray, card: str) -> None:
    """a's decode rates on the card machine's host: a dataset item (PNG read,
    split, resize, normalise, temperature) through the native decoder and
    through PIL, one thread; and the decoder's split-resize-normalise stage
    alone on ``stack``, the decoded 320x640 files, 1 and 8 threads."""
    rates = {}
    for label, use_native in (("native", True), ("PIL", False)):
        ds = PairedImageDataset(root, "train", SIZE, use_native=use_native)
        ds[0]
        t0 = time.perf_counter()
        for i in range(len(ds)):
            ds[i]
        rates[label] = len(ds) / (time.perf_counter() - t0)
    stage = {}
    for threads in (1, 8):
        native.process_pair_batch(stack[:2], SIZE, threads=threads)
        t0 = time.perf_counter()
        native.process_pair_batch(stack, SIZE, threads=threads)
        stage[threads] = len(stack) / (time.perf_counter() - t0)
    print(f"decode on the card machine's host ({os.cpu_count()} cores): dataset items "
          f"(PNG read + split + resize + normalise + temperature, one thread, {len(ds)} "
          f"files, half resized from {DATA_FILES[0][0]}²) native {rates['native']:.1f} img/s, "
          f"PIL {rates['PIL']:.1f} img/s; the decoder's split-resize-normalise stage alone on "
          f"{len(stack)} {DATA_FILES[0][0]}x{2 * DATA_FILES[0][0]} images: 1 thread "
          f"{stage[1]:.1f} img/s, 8 threads {stage[8]:.1f} img/s [{card}]")


def _native_decoder(device, data: str, card: str) -> None:
    """a. The native decoder: the batch call equals the single one, and the
    default dataset's batches equal the device pool's and the uint8 stream's."""
    files = sorted(os.path.join(data, "train", f) for f in os.listdir(os.path.join(data, "train")))
    big = np.stack([_read_rgb(f) for f in files[:DATA_FILES[0][1]]])
    batched = native.process_pair_batch(big, SIZE, threads=8)
    for i in range(len(big)):
        for got, want in zip(batched, native.process_pair(big[i], SIZE)):
            if got[i].tobytes() != want.tobytes():
                raise AssertionError(f"process_pair_batch differs from process_pair at {i}")
    ds = PairedImageDataset(data, "train", SIZE)
    if ds._native is None:
        raise AssertionError("the default dataset does not decode natively")
    want = list(batch_iterator(ds, DATA_BATCH, seed=42, epochs=1))
    pool = DevicePool(ds, device)
    for idx, w in zip(pool.index_batches(DATA_BATCH, seed=42, epochs=1), want, strict=True):
        if not _bits_equal(pool.batch(idx), w):
            raise AssertionError("a device pool batch differs from the native dataset's")
    loader = PrefetchLoader(ds, DATA_BATCH, num_workers=4, seed=42, epochs=1, raw=True)
    for got, w in zip(device_prefetch(iter(loader), device, via_uint8=True), want, strict=True):
        if not _bits_equal(got, w):
            raise AssertionError("a uint8-stream batch differs from the native dataset's")
    print(f"native decoder: process_pair_batch (8 threads) = process_pair bit for bit on "
          f"{len(big)} {big.shape[1]}x{big.shape[2]} files; the default dataset's "
          f"{len(want)} batches of {DATA_BATCH} = the device pool's and the uint8 stream's "
          f"bit for bit ({len(files)} files, {DATA_FILES[0][1]} resized)")
    _decode_rates(data, big, card)


def _hist_train(device, data: str, out: str, card: str) -> dict[str, int]:
    """b. cli train fft_glo --hist-every: the records, the page, the launches
    after every step, and a histogram step's time against a plain one's."""
    steps = 1 + HIST_EPOCHS * (sum(n for _, n in DATA_FILES) // DATA_BATCH)
    times, states = [], []
    step, write = Trainer.step, histograms.HistogramLogger.write

    def timed_step(trainer, state, batch):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        metrics = step(trainer, state, batch)
        torch.cuda.synchronize()
        times.append([t0, time.perf_counter(), None])
        states[:] = [state]
        expect_counts(f"cli train --hist-every, step {len(times)}", FFT_GLO_STEP, len(times))
        return metrics

    def timed_write(logger, *a, **kw):
        write(logger, *a, **kw)  # reads the histograms: the card synchronises
        times[-1][2] = time.perf_counter()

    reset_counts()
    with mock.patch.object(Trainer, "step", timed_step), \
            mock.patch.object(histograms.HistogramLogger, "write", timed_write):
        cli.main(["train", "--experiment", "fft_glo", "--data-root", data, "--image-size",
                  str(SIZE), "--batch-size", str(DATA_BATCH), "--dtype", "bfloat16",
                  "--device", "cuda", "--n-epochs", str(HIST_EPOCHS), "--hist-every",
                  str(HIST_EVERY), "--checkpoint-interval", str(10 * HIST_EPOCHS),
                  "--sample-interval", str(10 * steps), "--out-dir", out])
    run = expect_counts("cli train --hist-every", FFT_GLO_STEP, steps)
    sizes = {f"{m}/{k}": p.numel() for m, module in (("G", states[0].G), ("D", states[0].D))
             for k, p in module.named_parameters()}
    with open(os.path.join(out, "hists.jsonl")) as f:
        records = [json.loads(line) for line in f]
    spe = (steps - 1) // HIST_EPOCHS
    logged = [2 + spe * e for e in range(HIST_EPOCHS)]  # each epoch's first step
    if [(r["step"], r["kind"]) for r in records] != [(n, k) for n in logged
                                                     for k in ("weights", "grads")]:
        raise AssertionError(f"hists.jsonl records {[(r['step'], r['kind']) for r in records]}")
    for r in records:
        leaves = r["leaves"]
        if {k: sum(v["counts"]) for k, v in leaves.items()} != sizes:
            raise AssertionError(f"step {r['step']} {r['kind']}: a leaf's counts do not sum "
                                 "to its size, or a parameter is missing")
        for m, want in (("G", G_PARAMS), ("D", D_PARAMS)):
            if sum(sum(v["counts"]) for k, v in leaves.items() if k.startswith(m + "/")) != want:
                raise AssertionError(f"step {r['step']} {r['kind']}: {m} is not {want:,}")
        if not all(np.isfinite(v[s]) for v in leaves.values()
                   for s in ("lo", "hi", "mean", "std", "l2")):
            raise AssertionError(f"step {r['step']} {r['kind']}: a stat is not finite")
    if not os.path.getsize(os.path.join(out, "hists.html")):
        raise AssertionError("hists.html is empty")
    hist_ms = [(t[2] - t[0]) * 1e3 for t in times if t[2] is not None]
    plain_ms = [(t[1] - t[0]) * 1e3 for i, t in enumerate(times) if t[2] is None and i > 0]
    print(f"cli train fft_glo --hist-every {HIST_EVERY} bf16 B={DATA_BATCH} {SIZE}²: {steps} "
          f"steps, records at steps {logged} (weights and grads of G {G_PARAMS:,} and D "
          f"{D_PARAMS:,} parameters, {len(sizes)} tensors, every count summing to its "
          f"tensor's size, every stat finite), hists.html written; {FFT_GLO_STEP} blur-pool "
          f"launches after every step; median step {np.median(plain_ms):.2f} ms plain, "
          f"{np.median(hist_ms):.2f} ms with its histograms written [{card}]")
    return run


def _registered_set(device, args, data: str, tmp: str, card: str) -> tuple[dict, str]:
    """c. make_registered_dataset through the full-width stn Inferencer."""
    cfg = _cfg("stn_newmodel3", "bfloat16")
    nets = build_generators(cfg, device, torch.Generator().manual_seed(args.init_seed))
    _random_dtheta_head(nets["STN"], args.init_seed)
    ds = PairedImageDataset(data, "train", SIZE)
    batches = list(batch_iterator(ds, DATA_BATCH, shuffle=False, epochs=1))
    out = os.path.join(tmp, "registered")
    inf = Inferencer(cfg, nets)
    inf({k: v[:2] for k, v in batches[0].items()})  # warm-up, not counted
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    written = make_registered_dataset(inf, batches, out)
    seconds = time.perf_counter() - t0
    run = expect_counts("make_registered_dataset", STN_SERVE_BATCH, len(batches))
    pngs = sorted(f for f in os.listdir(out) if f.endswith(".png"))
    if written != len(ds) or pngs != [f"{i:05d}.png" for i in range(len(ds))]:
        raise AssertionError(f"make_registered_dataset wrote {written}: {pngs[:3]}...")
    # the eval dirs: real_A and reg_B from the registered pairs, real_B from the set
    for role in ("real_A", "real_B", "reg_B"):
        os.makedirs(os.path.join(tmp, role))
    n = 0
    for batch in batches:
        for b in batch["B"]:
            pair = _read_rgb(os.path.join(out, f"{n:05d}.png"))
            write_png(os.path.join(tmp, "real_A", f"{n:05d}.png"), np.array(pair[:, :SIZE]))
            write_png(os.path.join(tmp, "reg_B", f"{n:05d}.png"), np.array(pair[:, SIZE:]))
            write_png(os.path.join(tmp, "real_B", f"{n:05d}.png"), _to_u8(b))
            n += 1
    print(f"make_registered_dataset (stn_newmodel3, full width, bf16, dtheta head random): "
          f"{written} A|warped_B PNGs from {len(batches)} batches of {DATA_BATCH} in "
          f"{seconds:.2f} s, {written / seconds:.1f} img/s with the PNG writes; launches a "
          f"batch {STN_SERVE_BATCH} [{card}]")
    return run, out


def _eval_chain(device, tmp: str, card: str) -> None:
    """d. eval-reg on the card, and registration_metrics card against CPU;
    e. eval --iqa niqe."""
    dirs = [os.path.join(tmp, r) for r in ("real_A", "real_B", "reg_B")]
    csv_path = os.path.join(tmp, "reg.csv")
    t0 = time.perf_counter()
    cli.main(["eval-reg", "--real-a-dir", dirs[0], "--real-b-dir", dirs[1], "--reg-b-dir",
              dirs[2], "--out-csv", csv_path, "--device", "cuda"])
    reg_s = time.perf_counter() - t0
    with open(csv_path, newline="") as f:
        rows = list(csv.reader(f))
    values = np.array([r[1:] for r in rows[1:]], np.float64)
    if rows[0] != ["file", "ssim_before", "ssim_after", "ncc_before", "ncc_after", "mi_before",
                   "mi_after"] or values.shape != (len(os.listdir(dirs[0])), 6) \
            or not np.isfinite(values).all():
        raise AssertionError(f"eval-reg: header {rows[0]}, values {values.shape}, finite "
                             f"{np.isfinite(values).all()}")
    arrays = [torch.from_numpy(_load_dir(d)[1] / 127.5 - 1.0) for d in dirs]
    on_card = registration_metrics(*(x.to(device) for x in arrays))
    on_cpu = registration_metrics(*arrays)
    errs = {}
    for k in on_cpu:
        got, want = on_card[k].cpu(), on_cpu[k]
        errs[k] = float((got - want).abs().max())
        if not torch.allclose(got, want, rtol=REG_TOL[0], atol=REG_TOL[1]):
            raise AssertionError(f"registration_metrics {k}: card vs CPU max abs err {errs[k]}")
    print(f"eval-reg --device cuda over {values.shape[0]} real_A/real_B/reg_B images in "
          f"{reg_s:.2f} s: 6 finite columns, means "
          + ", ".join(f"{k} {v:.4f}" for k, v in zip(rows[0][1:], values.mean(0)))
          + f"; registration_metrics on the card vs the CPU (float32) max abs err "
          + ", ".join(f"{k} {v:.3g}" for k, v in errs.items())
          + f" (rtol {REG_TOL[0]}, atol {REG_TOL[1]}) [{card}]")

    fake, real = (os.path.join(tmp, f"iqa_{r}") for r in ("fake", "real"))
    for src, dst in ((dirs[2], fake), (dirs[1], real)):
        os.makedirs(dst)
        for f in sorted(os.listdir(src))[:IQA_PAIRS]:
            shutil.copyfile(os.path.join(src, f), os.path.join(dst, f))
    iqa_csv = os.path.join(tmp, "iqa.csv")
    t0 = time.perf_counter()
    cli.main(["eval", "--fake-dir", fake, "--real-dir", real, "--iqa", "niqe", "--out-csv",
              iqa_csv, "--device", "cuda"])
    iqa_s = time.perf_counter() - t0
    with open(iqa_csv, newline="") as f:
        rows = list(csv.reader(f))
    columns = rows[0]
    values = np.array([r[1:] for r in rows[1:]], np.float64)
    if columns[-2:] != ["niqe_fake", "niqe_real"] or values.shape[0] != IQA_PAIRS \
            or not np.isfinite(values).all():
        raise AssertionError(f"eval --iqa niqe: columns {columns}, values {values.shape}")
    print(f"eval --iqa niqe --device cuda over {IQA_PAIRS} pairs at {SIZE}²: columns "
          f"{columns[1:]}; niqe_fake mean {values[:, -2].mean():.4f}, niqe_real mean "
          f"{values[:, -1].mean():.4f}; {iqa_s:.2f} s, {iqa_s / (2 * IQA_PAIRS):.4f} s an image "
          f"(pair metrics on the card, NIQE on the host) [{card}]")


def _host_commands(device, tmp: str, registered: str, card: str) -> None:
    """f. prep-combine, prep-crop, prep-morphs (card = CPU bit for bit),
    gallery, and mesh's refusal without mediapipe."""
    a_dir, b_dir, reg_dir = (os.path.join(tmp, r) for r in ("real_A", "real_B", "reg_B"))
    combined = os.path.join(tmp, "combined")
    cli.main(["prep-combine", "--dir-a", a_dir, "--dir-b", reg_dir, "--dir-ab", combined,
              "--device", "cuda"])
    first = sorted(os.listdir(combined))
    if len(first) != len(os.listdir(a_dir)) or _read_rgb(os.path.join(combined, first[0])).shape \
            != (SIZE, 2 * SIZE, 3):
        raise AssertionError(f"prep-combine wrote {len(first)} files")
    stacks = os.path.join(tmp, "stacks")
    os.makedirs(stacks)
    names = sorted(os.listdir(a_dir))[:8]
    for f in names:
        write_png(os.path.join(stacks, f), np.concatenate(
            [_read_rgb(os.path.join(d, f)) for d in (a_dir, reg_dir, b_dir)], axis=0))
    crops = os.path.join(tmp, "crops")
    cli.main(["prep-crop", "--stack-dir", stacks, "--out-root", crops, "--device", "cuda"])
    for role, src in (("real_A", a_dir), ("fake_B", reg_dir), ("real_B", b_dir)):
        for f in names:
            if not np.array_equal(_read_rgb(os.path.join(crops, role, f)),
                                  _read_rgb(os.path.join(src, f))):
                raise AssertionError(f"prep-crop {role}/{f} differs from its source")
    morphs = {}
    for dev in ("cuda", "cpu"):
        morphs[dev] = os.path.join(tmp, f"morphs_{dev}")
        cli.main(["prep-morphs", "--in-dir", b_dir, "--out-dir", morphs[dev], "--device", dev])
    files = sorted(os.listdir(morphs["cpu"]))
    if sorted(os.listdir(morphs["cuda"])) != files or len(files) != len(os.listdir(b_dir)):
        raise AssertionError("prep-morphs wrote other files on the card than on the CPU")
    for f in files:
        if not np.array_equal(_read_rgb(os.path.join(morphs["cuda"], f)),
                              _read_rgb(os.path.join(morphs["cpu"], f))):
            raise AssertionError(f"prep-morphs {f}: the card's output differs from the CPU's")
    cli.main(["gallery", "--dir", registered, "--device", "cuda"])
    if not os.path.getsize(os.path.join(registered, "index.html")):
        raise AssertionError("gallery wrote an empty index.html")
    try:
        cli.main(["mesh", "--src-dir", a_dir, "--out-dir", os.path.join(tmp, "mesh"),
                  "--device", "cuda"])
    except ImportError as e:  # the expected outcome: no mediapipe here
        refusal = str(e)
        if "mediapipe" not in refusal:
            raise
    else:
        raise AssertionError("mesh ran: mediapipe is not expected on this machine")
    print(f"host commands: prep-combine {len(first)} A|B files of {SIZE}x{2 * SIZE}; "
          f"prep-crop {len(names)} stacks into 3 roles equal to their sources; prep-morphs "
          f"{len(files)} images, card = CPU bit for bit; gallery index.html; mesh refused as "
          f"expected: {refusal!r} [{card}]")


def _test_time_augment(device, data: str) -> None:
    """g. test_time_augment with erasing: the card = the CPU for the same draws."""
    batch = next(batch_iterator(PairedImageDataset(data, "train", SIZE), DATA_BATCH,
                                shuffle=False))
    draws = draw_test_time_augment(torch.Generator().manual_seed(7), DATA_BATCH)
    on_cpu = test_time_augment(batch, draws, erase=True)
    on_card = test_time_augment({k: torch.as_tensor(v, device=device) for k, v in batch.items()},
                                {k: v.to(device) for k, v in draws.items()}, erase=True)
    erased = 0
    for k in ("A", "B"):
        if not torch.equal(on_card[k].cpu(), on_cpu[k]):
            raise AssertionError(f"test_time_augment {k}: the card differs from the CPU")
        erased += int((on_cpu[k] == 0).all(-1).sum())
    print(f"test_time_augment with erasing at {tuple(on_cpu['A'].shape)}: card = CPU bit for "
          f"bit (flips {int(draws['hflip'].sum())} h, {int(draws['vflip'].sum())} v of "
          f"{DATA_BATCH}; {erased} erased pixels over A and B)")


def phase_data_eval(device, args, card: str) -> dict[str, dict[str, int]]:
    """Phase 19, the data and evaluation chain; returns the launch counts of
    ``cli train --hist-every`` and of ``make_registered_dataset``."""
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        data = os.path.join(tmp, "data")
        offset = 0
        for i, (side, count) in enumerate(DATA_FILES):
            _noisy_pairs(os.path.join(data, "train"), side, count, seed=90 + i, offset=offset)
            offset += count
        _native_decoder(device, data, card)
        hist = _hist_train(device, data, os.path.join(tmp, "hist_run"), card)
        torch.cuda.empty_cache()
        registered, reg_dir = _registered_set(device, args, data, tmp, card)
        torch.cuda.empty_cache()
        _eval_chain(device, tmp, card)
        _host_commands(device, tmp, reg_dir, card)
        _test_time_augment(device, data)
    print(f"data and evaluation phase: {time.perf_counter() - t_phase:.1f} s [{card}]")
    return {"hist_train": hist, "registered_set": registered}


# ----------------------------------------------------------------- 20. parallel
DP_SEED = 60            # the two-rank phase's batches
DP_BATCH = 32           # global batch of the two-rank runs (16 a rank)
DP_STEPS = 3            # two-rank steps whose replicas are compared
DP_RATE_BATCH = 128     # the world-of-one timing: fft_glo B=128 bf16
DP_RATE_STEPS = 5
DP_NAMES = ("fft_glo", "thermalgan_bn")
PIPE_BLOCKS, PIPE_BATCH = 9, 8  # the CycleGAN/NeMAR trunk at 256²: 9 x 256 ch at 64²
# the CPU tests' bounds of world 2 against world 1 (test_torch_parallel_dp.py);
# on the card at least 3 x the floor of one process: its step on A moved by
# one float32 step, up and down (cuDNN's benchmarked algorithms against the
# deterministic ones, whose search took about a minute a model at B=32, gave
# the same floor on an NVIDIA H100 80GB HBM3: 0.139 and 0.177 x max|g|
# against the nudges' 0.139 and 0.176)
DP_METRIC_TOL = (1e-5, 1e-6)  # rel, abs
DP_GRAD_TOL = 1e-4            # x max|g| of each tensor
DP_NUDGES = (np.inf, -np.inf)
_PLAIN_CLI_LOG: list[dict] = []  # phase 6b's plain fft_glo run, its log records


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _metric_values(rows: list[dict]) -> list[dict]:
    """The log records without their clock fields."""
    return [{k: v for k, v in r.items() if k not in ("ts", "wall_s")} for r in rows]


def _dp_cfg(name: str):
    cfg = _cfg(name, "float32")
    return cfg.replace(data=dataclasses.replace(cfg.data, batch_size=DP_BATCH, image_size=SIZE))


def _dp_grads(state) -> dict[str, torch.Tensor]:
    return {k: p.grad.detach().float().cpu().clone() for k, p in state.G.named_parameters()
            if p.grad is not None}


def _dp_rank(rank: int, world: int, port: int, tmp: str, results) -> None:
    """One of two gloo ranks on card 0: for each of ``DP_NAMES`` the float32
    step of the global batch from seed 0 (metrics; rank 0 saves the averaged
    G gradients), then ``DP_STEPS`` - 1 more steps and the replicas' checksums."""
    import datetime

    import torch.distributed as dist

    from tfcgan_tpu_torch.parallel import make_mesh

    try:
        torch.cuda.set_device(0)
        device = torch.device("cuda", 0)
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
        dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                                world_size=world, timeout=datetime.timedelta(seconds=300))
        mesh = make_mesh(world, device=device)
        out = {}
        for name in DP_NAMES:
            cfg = _dp_cfg(name)
            trainer = Trainer(cfg, build_recipe(cfg, device), mesh=mesh)
            state = trainer.init_state(0)
            reset_counts()
            metrics, sums = [], []
            for i in range(DP_STEPS):
                batch = synthetic_batch(DP_BATCH, SIZE, seed=DP_SEED + i)
                try:
                    m = trainer.step(state, batch)
                except RuntimeError as e:  # name the op gloo refused
                    raise RuntimeError(f"{name} step {i} on two gloo ranks, CUDA tensors: {e}")
                metrics.append({k: float(v) for k, v in m.items()})
                if i == 0 and rank == 0:
                    torch.save(_dp_grads(state), os.path.join(tmp, f"{name}_grads.pt"))
                sums.append(float(sum(float(p.double().sum()) * (j + 1) for j, p in
                                      enumerate(list(state.G.state_dict().values())
                                                + list(state.D.state_dict().values())))))
            torch.cuda.synchronize()
            gathered = [None] * world
            dist.all_gather_object(gathered, sums)
            out[name] = {"metrics": metrics, "sums": gathered, "counts": counts(),
                         "allreduces": trainer.stats.grad_allreduces,
                         "bytes": trainer.stats.flat_bytes}
            del trainer, state
            torch.cuda.empty_cache()
        results.put((rank, out))
        dist.destroy_process_group()
    except BaseException as e:
        import traceback

        results.put((rank, RuntimeError(traceback.format_exc())))
        raise SystemExit(1) from e


def _two_ranks(card: str) -> dict[str, int]:
    """Two gloo ranks on the one card (NCCL refuses two ranks on one device)
    against one process at the same global batch."""
    import multiprocessing as mp

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        ctx = mp.get_context("spawn")
        results = ctx.Queue()
        port = _free_port()
        procs = [ctx.Process(target=_dp_rank, args=(r, 2, port, tmp, results)) for r in range(2)]
        for p in procs:
            p.start()
        got = {}
        try:
            while len(got) < 2:
                rank, out = results.get(timeout=600)
                if isinstance(out, BaseException):
                    raise AssertionError(f"two-rank phase, rank {rank}: {out}")
                got[rank] = out
        finally:
            for p in procs:
                p.join(timeout=60)
                if p.is_alive():
                    p.kill()
                    p.join()
        two_s = time.perf_counter() - t0

        # one process, the same first step with the deterministic algorithms,
        # and the floor's runs (``DP_NUDGES``): the same step on A moved by
        # one float32 step, whose rounding moves the ReLU kinks as the ranks'
        # half batches' other sums do
        deterministic = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
        device = torch.device("cuda", 0)
        try:
            torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
            for name in DP_NAMES:
                cfg = _dp_cfg(name)
                runs, run_s = [], []
                for nudge in (0.0, *DP_NUDGES):
                    t1 = time.perf_counter()
                    trainer = Trainer(cfg, build_recipe(cfg, device))
                    state = trainer.init_state(0)
                    batch = synthetic_batch(DP_BATCH, SIZE, seed=DP_SEED)
                    if nudge:
                        batch["A"] = np.nextafter(batch["A"], np.float32(nudge)).astype(np.float32)
                    m = trainer.step(state, batch)
                    runs.append(({k: float(v) for k, v in m.items()}, _dp_grads(state)))
                    del trainer, state
                    torch.cuda.empty_cache()
                    run_s.append(time.perf_counter() - t1)
                two = got[0][name]
                g2 = torch.load(os.path.join(tmp, f"{name}_grads.pt"))

                def metric_err(a, b):
                    return max(abs(a[k] - b[k]) / max(abs(b[k]), DP_METRIC_TOL[1] /
                                                      DP_METRIC_TOL[0]) for k in b)

                def grad_errs(a, b):
                    return {k: float((a[k] - b[k]).abs().max() / (b[k].abs().max() + 1e-12))
                            for k in b}

                def l2(a, b):
                    num = sum(float((a[k] - b[k]).double().square().sum()) for k in b)
                    return (num / sum(float(b[k].double().square().sum()) for k in b)) ** 0.5

                floors = []
                for nudge, (fm, fg) in zip(DP_NUDGES, runs[1:]):
                    fe = grad_errs(fg, runs[0][1])
                    floors.append((metric_err(fm, runs[0][0]), max(fe.values()),
                                   l2(fg, runs[0][1]), nudge, sorted(fe, key=fe.get)[-1]))
                floor = tuple(max(f[i] for f in floors) for i in range(3))
                errs = grad_errs(g2, runs[0][1])
                err = (metric_err(two["metrics"][0], runs[0][0]), max(errs.values()),
                       l2(g2, runs[0][1]))
                bound = (max(DP_METRIC_TOL[0], 3 * floor[0]), max(DP_GRAD_TOL, 3 * floor[1]))
                worst = sorted(errs, key=errs.get)[-3:]
                if sorted(two["metrics"][0]) != sorted(runs[0][0]):
                    raise AssertionError(f"{name}: two-rank metrics {sorted(two['metrics'][0])}")
                named = "; ".join(f"A one step {'up' if n > 0 else 'down'}: {m:.3g}, {g:.3g} "
                                  f"(worst {k}), {e:.3g} in L2" for m, g, e, n, k in floors)
                detail = (f"metrics {err[0]:.3g} relative (bound {bound[0]:.3g}), G gradients "
                          f"{err[1]:.3g} x max|g| (bound {bound[1]:.3g}; worst "
                          f"{ {k: round(errs[k], 6) for k in worst} }), {err[2]:.3g} in L2; the "
                          f"floor, one process against its deterministic step: {named}")
                if err[0] > bound[0] or err[1] > bound[1]:
                    raise AssertionError(f"{name} two gloo ranks vs one process, float32 "
                                         f"B={DP_BATCH} {SIZE}²: {detail}")
                sums = two["sums"]
                if sums[0] != sums[1] or got[1][name]["sums"] != sums:
                    raise AssertionError(f"{name}: the replicas differ after {DP_STEPS} steps: "
                                         f"{sums}")
                want = scaled(FFT_GLO_STEP if name == "fft_glo" else {}, DP_STEPS)
                for r in (0, 1):
                    if got[r][name]["counts"] != want or got[r][name]["allreduces"] != 2 * DP_STEPS:
                        raise AssertionError(f"{name} rank {r}: launches "
                                             f"{got[r][name]['counts']}, want {want}; "
                                             f"{got[r][name]['allreduces']} gradient all-reduces")
                print(f"parallel {name} two gloo ranks on one card, float32 global B={DP_BATCH} "
                      f"{SIZE}² ({DP_BATCH // 2} a rank), against one process: {detail}; replicas' "
                      f"checksums equal after {DP_STEPS} steps "
                      f"({sums[0][-1]:.17g}); {two['allreduces']} gradient all-reduces, flat "
                      f"buffers {{{', '.join(f'{k}: {v / 2**20:.2f} MiB' for k, v in two['bytes'].items())}}}; "
                      f"launches a rank {two['counts']['blurpool_fwd']} / "
                      f"{two['counts']['blurpool_bwd']} K1; the one-process runs took "
                      f"{', '.join(f'{t:.1f}' for t in run_s)} s (the step, then the floor's) "
                      f"with their set-up [{card}]")
        finally:
            torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = deterministic
    print(f"parallel two-rank part: {two_s:.1f} s for the ranks [{card}]")
    return got[0]["fft_glo"]["counts"]


def _torchrun_cli_train(card: str) -> dict[str, int]:
    """Phase 6b's first ``cli train`` (fft_glo, bf16, B=32, pool staging, 2
    epochs, checkpoints, samples) under ``torchrun --nproc_per_node 1``: a
    world of one over NCCL; its log must equal the plain run's bit for bit."""
    spe = CLI_PAIRS // CLI_BATCH
    steps = 1 + 2 * spe
    hooks = steps // 2
    with tempfile.TemporaryDirectory() as tmp:
        data, runs = os.path.join(tmp, "data"), os.path.join(tmp, "runs")
        _write_pairs(data, seed=CLI_SEED, count=CLI_PAIRS, split="train")
        _write_pairs(data, seed=CLI_SEED + 1, count=CLI_TEST_PAIRS)
        t0 = time.perf_counter()
        cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
               "--nproc_per_node", "1", "-m", "tfcgan_tpu_torch.cli", "train",
               "--experiment", "fft_glo", "--data-root", data, "--image-size", str(SIZE),
               "--batch-size", str(CLI_BATCH), "--dtype", "bfloat16", "--device", "cuda",
               "--n-epochs", "2", "--checkpoint-interval", "1", "--sample-interval", "2",
               "--out-dir", runs]
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600,
                              cwd=os.path.dirname(os.path.abspath(__file__)))
        wall = time.perf_counter() - t0
        if proc.returncode != 0:
            raise AssertionError(f"torchrun cli train exited {proc.returncode}:\n"
                                 f"{proc.stdout[-3000:]}\n{proc.stderr[-6000:]}")
        summary = [line for line in proc.stdout.splitlines()
                   if line.startswith("data-parallel run: ")]
        if len(summary) != 1:
            raise AssertionError(f"torchrun cli train printed no summary:\n{proc.stdout[-3000:]}")
        run = json.loads(summary[0][len("data-parallel run: "):])
        rows = _metric_values(_log_rows(os.path.join(runs, "logs", "fft_glo.jsonl")))
        plain = _metric_values(_PLAIN_CLI_LOG)
        want = scaled({"blurpool_fwd": FFT_GLO_STEP["blurpool_fwd"] * steps + 11 * hooks,
                       "blurpool_bwd": FFT_GLO_STEP["blurpool_bwd"] * steps}, 1)
        if run["kernel_launches"] != want or run["grad_allreduces"] != 2 * steps or \
                run["world"] != 1 or run["steps"] != steps:
            raise AssertionError(f"torchrun cli train: {run}, want launches {want} and "
                                 f"{2 * steps} gradient all-reduces")
        if rows != plain:
            raise AssertionError(f"torchrun cli train's log differs from the plain run's:\n"
                                 f"{rows}\n{plain}")
        ckpts = sorted(d for d in os.listdir(runs) if d.startswith("step_"))
        if ckpts != [f"step_{1 + spe:08d}", f"step_{steps:08d}"]:
            raise AssertionError(f"torchrun cli train checkpoints {ckpts}")
    print(f"parallel torchrun --nproc_per_node 1 cli train (NCCL world of one): fft_glo bf16 "
          f"B={CLI_BATCH} {SIZE}², {steps} steps: its {len(rows)} log records equal phase 6b's "
          f"plain run bit for bit; {run['grad_allreduces']} gradient all-reduces (2 a step), "
          f"flat buffers {{{', '.join(f'{k}: {v / 2**20:.2f} MiB' for k, v in run['flat_buffer_bytes'].items())}}}; "
          f"launches {want['blurpool_fwd']} / {want['blurpool_bwd']} K1; {wall:.1f} s with "
          f"the process start [{card}]")
    return run["kernel_launches"]


def _world_of_one(device, card: str) -> None:
    """An NCCL world of one in this process: the fft_glo ``Trainer`` at
    B=128 bf16 with and without the mesh in turns, and the GPipe trunk at
    one stage against the serial trunk."""
    import torch.distributed as dist

    from tfcgan_tpu_torch.models.resnet_gen import ResidualBlock
    from tfcgan_tpu_torch.parallel import make_mesh, make_pipe_mesh, resnet_trunk_pipeline

    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{_free_port()}",
                            world_size=1, rank=0, device_id=device)
    try:
        mesh = make_mesh(1, device=device)
        cfg = _cfg("fft_glo", "bfloat16")
        recipe = build_recipe(cfg, device)
        plain, meshed = Trainer(cfg, recipe), Trainer(cfg, recipe, mesh=mesh)
        state = plain.init_state(0)
        batch = _device_batch(DP_RATE_BATCH, DP_SEED, device)

        def timed(trainer):
            trainer.step(state, batch)  # warm-up
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(DP_RATE_STEPS):
                trainer.step(state, batch)
            torch.cuda.synchronize()
            return (time.perf_counter() - t0) / DP_RATE_STEPS * 1e3

        reset_counts()
        ms = {"plain": [], "mesh": []}
        for which in ("plain", "mesh", "mesh", "plain"):
            ms[which].append(timed(plain if which == "plain" else meshed))
        expect_counts("fft_glo Trainer, plain and world-of-one mesh", FFT_GLO_STEP,
                      4 * (DP_RATE_STEPS + 1))
        if meshed.stats.grad_allreduces != 2 * 2 * (DP_RATE_STEPS + 1):
            raise AssertionError(f"{meshed.stats.grad_allreduces} gradient all-reduces")
        mib = {k: v / 2**20 for k, v in meshed.stats.flat_bytes.items()}
        print(f"parallel fft_glo Trainer bf16 B={DP_RATE_BATCH} {SIZE}², step ms in turns "
              f"(plain, mesh, mesh, plain; {DP_RATE_STEPS} steps after 1 warm-up each): plain "
              f"{ms['plain'][0]:.3f} / {ms['plain'][1]:.3f}, NCCL world-of-one mesh "
              f"{ms['mesh'][0]:.3f} / {ms['mesh'][1]:.3f}; flat buffers "
              f"{{{', '.join(f'{k}: {v:.2f} MiB' for k, v in mib.items())}}} a step [{card}]")
        del plain, meshed, state, recipe, batch
        torch.cuda.empty_cache()

        # the GPipe trunk at one stage over NCCL: the serial trunk bit for bit
        pipe = make_pipe_mesh(1, device=device)
        gen = torch.Generator().manual_seed(0)
        block = ResidualBlock(256, device=device)
        params = [{k: (torch.randn(v.shape, generator=gen) * 0.02).to(device)
                   for k, v in block.named_parameters()} for _ in range(PIPE_BLOCKS)]
        x = torch.randn(PIPE_BATCH, SIZE // 4, SIZE // 4, 256, generator=gen).to(device)

        def apply(p, h):
            return torch.func.functional_call(block, p, (h,))

        with torch.no_grad():
            serial = x
            for p in params:
                serial = apply(p, serial)
            one = resnet_trunk_pipeline(apply, params, x, mesh=pipe, microbatches=1)
            four = resnet_trunk_pipeline(apply, params, x, mesh=pipe, microbatches=4)
        if not torch.equal(one, serial):
            raise AssertionError("the one-stage GPipe trunk differs from the serial trunk")
        err4 = float((four - serial).abs().max())
        if err4 > 1e-4 * float(serial.abs().max()):
            raise AssertionError(f"GPipe at 4 microbatches: {err4} from the serial trunk")
        print(f"parallel GPipe trunk ({PIPE_BLOCKS} ResidualBlocks of 256 channels, "
              f"({PIPE_BATCH}, {SIZE // 4}, {SIZE // 4}, 256) float32): one stage on NCCL, 1 "
              f"microbatch = the serial trunk bit for bit, 4 microbatches within {err4:.3g}; "
              f"more than one stage is held on the CPU only (one card hosts one NCCL rank, "
              f"and gloo's send/recv is not tried on CUDA tensors) [{card}]")
    finally:
        dist.destroy_process_group()


def phase_parallel(device, args, card: str) -> dict[str, dict[str, int]]:
    """``parallel/``: ``cli train`` under ``torchrun`` as a world of one over
    NCCL, the fft_glo Trainer with and without that mesh, the GPipe trunk at
    one stage, and two gloo ranks on the card against one process."""
    t0 = time.perf_counter()
    parts = {}
    by_path = {"dp_cli_train": _torchrun_cli_train(card)}
    parts["torchrun cli train"] = time.perf_counter() - t0
    _world_of_one(device, card)
    torch.cuda.empty_cache()
    parts["world of one"] = time.perf_counter() - t0 - sum(parts.values())
    by_path["dp_two_ranks"] = _two_ranks(card)
    torch.cuda.empty_cache()
    parts["two ranks"] = time.perf_counter() - t0 - sum(parts.values())
    print(f"parallel phase: {time.perf_counter() - t0:.1f} s "
          f"({', '.join(f'{k} {v:.1f} s' for k, v in parts.items())}) [{card}]")
    return by_path



# ------------------------------------------------------------------ 21. tensor
TENSOR_BATCH = 8        # global batch of both legs
TENSOR_STEPS = 3        # fft_glo steps a rank; the first's metrics and G gradients compared
TENSOR_DIFF_STEPS = 2   # tfc_diff bf16 steps a rank
TENSOR_SEED = 70        # the legs' batches
# tfc_diff in bfloat16 on a (1 x 2) tensor pair against one process: the
# first step's metrics, relative. The pair computes each conv over half the
# out-channels (cuDNN may take other algorithms there) and sums the input
# gradients' two halves in bfloat16 (ulp 7.8e-3); the forward of step 1 sees
# the same weights, so its losses differ only by the forward's rounding
TENSOR_DIFF_TOL = 2e-2


def _tensor_cfg(job: str):
    if job == "fft_glo":
        cfg = _cfg("fft_glo", "float32")
        size = SIZE
    else:
        cfg = _cfg("tfc_diff", "bfloat16")
        size = DIFF_SIZE
    return cfg.replace(data=dataclasses.replace(cfg.data, batch_size=TENSOR_BATCH,
                                                image_size=size))


def _tensor_batches(job: str) -> list[dict]:
    cfg = _tensor_cfg(job)
    steps = TENSOR_STEPS if job == "fft_glo" else TENSOR_DIFF_STEPS
    return [synthetic_batch(TENSOR_BATCH, cfg.data.image_size, seed=TENSOR_SEED + i,
                            with_labels=job != "fft_glo") for i in range(steps)]


def _state_bytes(state) -> dict[str, int]:
    """Bytes of G's, D's and LPIPS's parameters and of their Adam moments
    held by this process."""
    out = {}
    for name, module, opt in (("G", state.G, state.opt_g), ("D", state.D, state.opt_d),
                              ("lpips", state.lpips, None)):
        if module is None:
            continue
        params = list(module.parameters())
        out[name] = sum(p.numel() * p.element_size() for p in params)
        if opt is not None:
            out[name] += sum(t.numel() * t.element_size() for p in params
                             for k, t in opt.state.get(p, {}).items()
                             if k in ("exp_avg", "exp_avg_sq"))
    return out


def _tensor_rank(rank: int, world: int, port: int, tmp: str, results, job: str) -> None:
    """One gloo rank on card 0 of a (world / 2 data x 2 tensor) mesh: the
    leg's steps from seed 0 (metrics, step ms, launch counts, this rank's
    bytes of parameters and Adam moments); for fft_glo rank 0 saves the first
    step's G gradients, gathered."""
    import datetime

    import torch.distributed as dist

    from tfcgan_tpu_torch.parallel import make_mesh
    from tfcgan_tpu_torch.parallel.tensor import full_tensors

    try:
        torch.cuda.set_device(0)
        device = torch.device("cuda", 0)
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
        dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                                world_size=world, timeout=datetime.timedelta(seconds=300))
        mesh = make_mesh(world, tensor=2, device=device)
        cfg = _tensor_cfg(job)
        trainer = Trainer(cfg, build_recipe(cfg, device), mesh=mesh)
        state = trainer.init_state(0)
        reset_counts()
        metrics, ms = [], []
        for i, batch in enumerate(_tensor_batches(job)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            m = trainer.step(state, batch)
            metrics.append({k: float(v) for k, v in m.items()})  # reads sync
            ms.append((time.perf_counter() - t0) * 1e3)
            if i == 0 and job == "fft_glo":
                grads = full_tensors(state.G, {k: p.grad for k, p in state.G.named_parameters()
                                               if p.grad is not None})
                if rank == 0:
                    torch.save({k: g.float().cpu() for k, g in grads.items()},
                               os.path.join(tmp, "tensor_grads.pt"))
        torch.cuda.synchronize()
        results.put((job, rank, {"metrics": metrics, "ms": ms, "counts": counts(),
                                 "bytes": _state_bytes(state),
                                 "coords": (mesh.data_rank, mesh.tensor.rank)}))
        dist.destroy_process_group()
    except BaseException as e:
        import traceback

        results.put((job, rank, RuntimeError(traceback.format_exc())))
        raise SystemExit(1) from e


def _run_tensor_ranks(tmp: str, legs: dict[str, int]) -> tuple[dict, float]:
    """For each leg (job -> world) ``world`` gloo ranks of ``_tensor_rank``
    on the card, the legs' process groups all started together; their
    results, {job: {rank: result}}, and the seconds they took."""
    import multiprocessing as mp

    t0 = time.perf_counter()
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    procs = []
    for job, world in legs.items():
        port = _free_port()
        procs += [ctx.Process(target=_tensor_rank, args=(r, world, port, tmp, results, job))
                  for r in range(world)]
    for p in procs:
        p.start()
    got = {job: {} for job in legs}
    try:
        for _ in range(sum(legs.values())):
            job, rank, out = results.get(timeout=600)
            if isinstance(out, BaseException):
                raise AssertionError(f"tensor phase, {job} rank {rank}: {out}")
            got[job][rank] = out
    finally:
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.kill()
                p.join()
    return got, time.perf_counter() - t0


def _tensor_fft_glo(device, tmp: str, card: str, got: dict, seconds: float) -> dict[str, int]:
    """fft_glo float32 at global B=8, 256², on four gloo ranks as (2 data x
    2 tensor) (their results ``got``) against one process (deterministic
    algorithms, and cuDNN's benchmarked ones for the floor)."""
    cfg = _tensor_cfg("fft_glo")
    batch = _tensor_batches("fft_glo")[0]
    deterministic = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    runs = []
    try:
        for det in (True, False):
            torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = det, not det
            trainer = Trainer(cfg, build_recipe(cfg, device))
            state = trainer.init_state(0)
            m = trainer.step(state, batch)
            runs.append(({k: float(v) for k, v in m.items()}, _dp_grads(state), _state_bytes(state)))
            if det:  # one more step, timed as a rank times its steps
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                float(trainer.step(state, _tensor_batches("fft_glo")[1])["loss_G"])
                one_ms = (time.perf_counter() - t0) * 1e3
            del trainer, state
            torch.cuda.empty_cache()
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = deterministic
    g4 = torch.load(os.path.join(tmp, "tensor_grads.pt"))

    def metric_err(a, b):
        return max(abs(a[k] - b[k]) / max(abs(b[k]), DP_METRIC_TOL[1] / DP_METRIC_TOL[0])
                   for k in b)

    def grad_errs(a, b):
        return {k: float((a[k] - b[k]).abs().max() / (b[k].abs().max() + 1e-12)) for k in b}

    floor_g = grad_errs(runs[1][1], runs[0][1])
    errs = grad_errs(g4, runs[0][1])
    floor = (metric_err(runs[1][0], runs[0][0]), max(floor_g.values()))
    err = (metric_err(got[0]["metrics"][0], runs[0][0]), max(errs.values()))
    bound = (max(DP_METRIC_TOL[0], 3 * floor[0]), max(DP_GRAD_TOL, 3 * floor[1]))
    worst = sorted(errs, key=errs.get)[-3:]
    detail = (f"metrics {err[0]:.3g} relative (bound {bound[0]:.3g}, floor {floor[0]:.3g}), "
              f"G gradients {err[1]:.3g} x max|g| (bound {bound[1]:.3g}, floor {floor[1]:.3g}; "
              f"worst { {k: round(errs[k], 6) for k in worst} })")
    if sorted(got[0]["metrics"][0]) != sorted(runs[0][0]) or sorted(g4) != sorted(runs[0][1]):
        raise AssertionError(f"fft_glo tensor mesh: metrics {sorted(got[0]['metrics'][0])}, "
                             f"{len(g4)} gradients")
    if err[0] > bound[0] or err[1] > bound[1]:
        raise AssertionError(f"fft_glo (2 data x 2 tensor) vs one process, float32 "
                             f"B={TENSOR_BATCH} {SIZE}²: {detail}")
    if any(got[r]["metrics"][0] != got[0]["metrics"][0] for r in got):
        raise AssertionError(f"fft_glo tensor mesh: the ranks' step-1 metrics differ: "
                             f"{[got[r]['metrics'][0] for r in got]}")
    want = scaled(FFT_GLO_STEP, TENSOR_STEPS)
    for r in got:
        if got[r]["counts"] != want:
            raise AssertionError(f"fft_glo tensor rank {r}: launches {got[r]['counts']}, "
                                 f"want {want}")
    one = runs[0][2]
    share = {r: sum(got[r]["bytes"].values()) / sum(one.values()) for r in got}
    if not all(0.5 <= v < 0.6 for v in share.values()):
        raise AssertionError(f"fft_glo tensor mesh: parameter + Adam bytes a rank against one "
                             f"process {share}")
    mib = {k: f"{got[0]['bytes'][k] / 2**20:.2f} / {one[k] / 2**20:.2f}" for k in one}
    ms = {r: [round(t, 3) for t in got[r]["ms"]] for r in got}
    print(f"tensor fft_glo (2 data x 2 tensor) on four gloo ranks of one card, float32 global "
          f"B={TENSOR_BATCH} {SIZE}² (2 a data share), against one process: {detail}; step-1 "
          f"metrics equal on the four ranks; launches a rank {want['blurpool_fwd']} / "
          f"{want['blurpool_bwd']} K1 over {TENSOR_STEPS} steps ({FFT_GLO_STEP['blurpool_fwd']} / "
          f"{FFT_GLO_STEP['blurpool_bwd']} a step, one process's); parameters + Adam moments a "
          f"rank / one process, MiB: {mib}, share {share[0]:.4f} (rank 0; "
          f"{ {r: round(v, 4) for r, v in share.items()} }); step ms a rank {ms} (step 1 with "
          f"set-up; the four ranks share the card and move activations through gloo on the "
          f"host), one process's step 2 {one_ms:.3f} ms; both legs' ranks took {seconds:.1f} s "
          f"with their start [{card}]")
    return got[0]["counts"]


def _tensor_tfc_diff(device, tmp: str, card: str, got: dict, seconds: float) -> dict[str, int]:
    """tfc_diff bf16 at global B=8, 128², on two gloo ranks as (1 data x 2
    tensor) (their results ``got``) against one process from the same init,
    batches and draws."""
    cfg = _tensor_cfg("tfc_diff")
    trainer = Trainer(cfg, build_recipe(cfg, device))
    state = trainer.init_state(0)
    one, one_ms = [], []
    for b in _tensor_batches("tfc_diff"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        one.append({k: float(v) for k, v in trainer.step(state, b).items()})
        one_ms.append((time.perf_counter() - t0) * 1e3)
    del trainer, state
    torch.cuda.empty_cache()
    want = scaled(DIFF_STEP_BF16, TENSOR_DIFF_STEPS)
    for r in got:
        if got[r]["counts"] != want:
            raise AssertionError(f"tfc_diff tensor rank {r}: launches {got[r]['counts']}, "
                                 f"want {want}")
    two = got[0]["metrics"]
    if not all(np.isfinite(v) for m in two for v in m.values()) or sorted(two[0]) != sorted(one[0]):
        raise AssertionError(f"tfc_diff tensor pair: metrics {two}")
    err = {k: abs(two[0][k] - one[0][k]) / max(abs(one[0][k]), 1e-6) for k in one[0]
           if one[0][k] != 0}
    if max(err.values()) > TENSOR_DIFF_TOL:
        raise AssertionError(f"tfc_diff (1 x 2 tensor) vs one process, bf16: step-1 metrics "
                             f"{two[0]} against {one[0]}: {err} (bound {TENSOR_DIFF_TOL})")
    ms = {r: [round(t, 3) for t in got[r]["ms"]] for r in got}
    print(f"tensor tfc_diff (1 data x 2 tensor) on two gloo ranks of one card, bf16 global "
          f"B={TENSOR_BATCH} {DIFF_SIZE}²: step-1 metrics {two[0]} against one process's "
          f"{one[0]} (relative {max(err.values()):.3g}, bound {TENSOR_DIFF_TOL}); step 2 "
          f"{two[1]} against {one[1]}; launches a rank "
          f"{ {k: v for k, v in got[0]['counts'].items() if v} } over {TENSOR_DIFF_STEPS} steps "
          f"(7 / 7 / 7 a step, all on the tensor cores); step ms a rank {ms}, one process "
          f"{[round(t, 3) for t in one_ms]}; both legs' ranks took {seconds:.1f} s with their "
          f"start [{card}]")
    return got[0]["counts"]


def phase_tensor(device, card: str) -> dict[str, dict[str, int]]:
    """The tensor axis on gloo ranks of the one card: fft_glo on (2 data x 2
    tensor) and tfc_diff on (1 x 2)."""
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        # both legs' ranks at once (six processes on the card)
        got, seconds = _run_tensor_ranks(tmp, {"fft_glo": 4, "tfc_diff": 2})
        by_path = {"tensor_fft_glo": _tensor_fft_glo(device, tmp, card, got["fft_glo"],
                                                     seconds)}
        torch.cuda.empty_cache()
        by_path["tensor_tfc_diff"] = _tensor_tfc_diff(device, tmp, card, got["tfc_diff"],
                                                      seconds)
        torch.cuda.empty_cache()
    print(f"tensor phase: {time.perf_counter() - t0:.1f} s [{card}]")
    return by_path


# ----------------------------------------------------------------- 22. spatial
SPATIAL_SPLITS = (2, 3)  # ranks a map's rows are split over in the row-edge K1 check
SPATIAL_BATCH = 4        # global batch of the float32 (1 data x 2 spatial) comparison
SPATIAL_SEED = 80        # the phase's batches


def _row_windows(h: int, stride: int, ranks: int) -> list[tuple[int, int, int, int]]:
    """(a, b, o_lo, ho) of each of ``ranks`` row shards of an h-row map: the
    output rows [o_lo, o_lo + ho) by the axis's balanced split and the input
    rows [a, b) they read (``window_rows``); shards without output skipped."""
    out = []
    for s in range(ranks):
        o_lo, o_hi = spatial.row_bounds(kernel.out_len(h, stride), s, ranks)
        if o_hi > o_lo:
            out.append((*kernel.window_rows(h, o_lo, o_hi - o_lo, stride), o_lo, o_hi - o_lo))
    return out


def _row_edge_check(x: torch.Tensor, stride: int, gen) -> tuple[float, float]:
    """The row-edge K1 on every shard of ``x``'s rows over 2 and 3 ranks: the
    forward bit for bit the whole-map launch's rows and within ``_check`` of
    the plain row form; the backward within ``_check`` of autograd of the
    plain row form. Returns the largest (forward, backward) errors."""
    n, h, w, c = x.shape
    full = kernel.blur_pool_fwd(x, stride)
    errs = [0.0, 0.0]
    for ranks in SPATIAL_SPLITS:
        for a, b, o_lo, ho in _row_windows(h, stride, ranks):
            what = f"row-edge blurpool {x.dtype} s{stride} {tuple(x.shape)} rows [{a}, {b})"
            xw = x[:, a:b].contiguous()
            y = kernel.blur_pool_fwd(xw, stride, (h, a, o_lo), ho)
            if not torch.equal(y, full[:, o_lo:o_lo + ho]):
                raise AssertionError(f"{what}: not the whole-map launch's rows bit for bit")
            errs[0] = max(errs[0], _check(y, blur_pool_padded(xw.float(), stride, (h, a, o_lo),
                                                              ho), what + " fwd"))
            dy = torch.randn((n, ho, kernel.out_len(w, stride), c), device=x.device,
                             generator=gen).to(x.dtype)
            xp = torch.zeros((n, b - a, w, c), device=x.device, requires_grad=True)
            want = torch.autograd.grad(blur_pool_padded(xp, stride, (h, a, o_lo), ho), xp,
                                       dy.float())[0]
            errs[1] = max(errs[1], _check(kernel.blur_pool_bwd(dy, b - a, w, stride,
                                                               (h, a, o_lo)), want, what + " bwd"))
    return errs[0], errs[1]


def _row_edge_step_ms(device, gen) -> dict[str, float]:
    """Rank 0's share of one fft_glo step's bf16 blur-pool calls at batch
    ``STEP_BATCH`` on a spatial mesh of 2: the row-edge kernels on its windows
    (its rows and the halo rows below them), and the copy that builds each
    window from the shard and the halo (``parallel.spatial.fetch_rows``)."""
    out = {"blurpool_fwd": 0.0, "blurpool_bwd": 0.0, "halo_copy": 0.0}
    for name, calls in zip(("blurpool_fwd", "blurpool_bwd"), fft_glo_step_calls(STEP_BATCH)):
        for shape, stride, count in calls:
            n, h, w, c = shape
            a, b, o_lo, ho = _row_windows(h, stride, 2)[0]
            lo, hi = spatial.row_bounds(h, 0, 2)
            if name == "blurpool_fwd":
                own = torch.randn((n, hi - lo, w, c), device=device, generator=gen).to(
                    torch.bfloat16)
                halo = torch.randn((n, b - hi, w, c), device=device, generator=gen).to(
                    torch.bfloat16)
                xw = torch.cat([own, halo], dim=1)
                out[name] += count * cuda_ms(
                    lambda: kernel.blur_pool_fwd(xw, stride, (h, a, o_lo), ho), 10)
                out["halo_copy"] += count * cuda_ms(lambda: torch.cat([own, halo], dim=1), 10)
                del own, halo, xw
            else:
                dy = torch.randn((n, ho, kernel.out_len(w, stride), c), device=device,
                                 generator=gen).to(torch.bfloat16)
                out[name] += count * cuda_ms(
                    lambda: kernel.blur_pool_bwd(dy, b - a, w, stride, (h, a, o_lo)), 10)
                del dy
            torch.cuda.empty_cache()
    return out


def phase_spatial_kernels(device, card: str, results: dict) -> None:
    """(a) The row-edge K1 against its plain version at the path's 11 blur
    shapes (batch 8), float32 and bfloat16, both strides, split over 2 and 3
    ranks; its time for rank 0 of 2 over one fft_glo step's calls at batch
    128, beside the default form's (phase 3) and the halo copy's. Adds the
    ``row_edge_*`` keys to the blur-pool results."""
    gen = torch.Generator(device=device).manual_seed(SPATIAL_SEED)
    fwd = bwd = 0.0
    path = [(s, 2) for s in STRIDE2_SHAPES] + [(s, 1) for s in STRIDE1_SHAPES]
    for dtype in (torch.float32, torch.bfloat16):
        for shape, _ in path:
            x = torch.randn(shape, device=device, generator=gen).to(dtype)
            for stride in (1, 2):
                f, b = _row_edge_check(x, stride, gen)
                fwd, bwd = max(fwd, f), max(bwd, b)
            del x
    torch.cuda.empty_cache()
    step = _row_edge_step_ms(device, gen)
    for k in ("blurpool_fwd", "blurpool_bwd"):
        results[k].update({"row_edge_max_abs_err": fwd if k == "blurpool_fwd" else bwd,
                           "row_edge_step_ms": step[k]})
    results["blurpool_fwd"]["row_edge_halo_copy_ms"] = step["halo_copy"]
    print(f"spatial K1 row-edge form: {len(path)} path shapes x both strides x float32 and "
          f"bfloat16, every shard of 2 and 3 ranks (odd first rows included): forward bit for "
          f"bit the whole-map launch's rows, max_abs_err against the plain row form fwd "
          f"{fwd:.3g}, bwd {bwd:.3g}; rank 0 of 2 over one fft_glo step's bf16 calls at "
          f"B={STEP_BATCH}: fwd {step['blurpool_fwd']:.4f} ms (27 calls), bwd "
          f"{step['blurpool_bwd']:.4f} ms (23 calls), the windows' halo copies "
          f"{step['halo_copy']:.4f} ms; the whole-map (default) form's step calls in phase 3: "
          f"fwd {results['blurpool_fwd']['step_ms']:.4f} ms, bwd "
          f"{results['blurpool_bwd']['step_ms']:.4f} ms [{card}]")


# the spatial comparisons' jobs: (registry entry, image side, global batch,
# kernel launches of one step in one process, which a rank must make too)
SPATIAL_JOBS = {"fft_glo": ("fft_glo", SIZE, SPATIAL_BATCH, FFT_GLO_STEP),
                "stn": ("stn_newmodel3", SIZE, 4, STN_STEP),
                "tfc_diff": ("tfc_diff", DIFF_SIZE, 8, DIFF_STEP),
                "nemar": ("nemar", SIZE, 4, NEMAR_STEP),
                "cyclegan": ("cyclegan", SIZE, 4, {}),
                "thermalgan_bn": ("thermalgan_bn", SIZE, 4, {}),
                "debiased": ("fft_patch_debiased", SIZE, 4, FFT_GLO_STEP),
                "mask": ("fft_patch_mask", SIZE, 4, FFT_GLO_STEP)}
# layers a step that run on the whole map on each rank (fewer rows than
# ranks): the pix2pix G2's innermost conv, on its 1 x 1 map at 256²
SPATIAL_REPLICATED = {"thermalgan_bn": 1}
# a gradient below this share of its set's largest is compared at that scale:
# tfc_diff's conv biases and time projections in front of a GroupNorm of one
# channel a group are zero in exact arithmetic and come back as float32
# rounding, and so are the conv biases in front of an instance norm (the
# ResNetGenerator's every conv but its head; the PatchGANs' second conv on).
# SPATIAL_FLOORED names those biases where a job has them (tfc_diff: every
# tensor). The attention key biases' gradients are zero too (the softmax
# drops a constant of the scores): those are compared at the scale of their
# key kernel's gradient
SPATIAL_GRAD_FLOOR = {"tfc_diff": 1e-3, "nemar": 1e-3, "cyclegan": 1e-3, "thermalgan_bn": 1e-3}
_RESNET_NORMED = r"(stem|down\d|res\d+\.conv[12]|up\d)\.bias"
SPATIAL_FLOORED = {"nemar": re.compile(rf"T\.{_RESNET_NORMED}|D\.conv[1-9]\.bias"),
                   "cyclegan": re.compile(rf"G_(AB|BA)\.{_RESNET_NORMED}|D_[AB]\.conv[1-9]\.bias"),
                   "thermalgan_bn": re.compile(r"D_(pix|vae)\.conv[1-9]\.bias")}
KEY_BIASES = ("key.bias", "to_k.bias")
# the floor's one-process runs with A moved by one float32 step, up (and down
# too where that has set the floor: the STN's deep instance norms behind ReLU
# kinks, and CycleGAN's and ThermalGAN's, make one nudge a small sample of
# what a rounding difference does; nemar's floor is cuDNN's algorithms'; the
# saliency mask's batch-wide extremes send their gradient to one pixel each,
# which a rounding difference moves)
SPATIAL_NUDGES = {"fft_glo": (np.inf,), "stn": (np.inf, -np.inf), "tfc_diff": (np.inf, -np.inf),
                  "nemar": (np.inf,), "cyclegan": (np.inf, -np.inf),
                  "thermalgan_bn": (np.inf, -np.inf), "debiased": (np.inf, -np.inf),
                  "mask": (np.inf, -np.inf)}


def _spatial_cfg(dtype: str, job: str = "fft_glo"):
    name, size, batch, _ = SPATIAL_JOBS[job]
    cfg = _cfg(name, dtype)
    return cfg.replace(data=dataclasses.replace(cfg.data, batch_size=batch, image_size=size))


def _spatial_batches(job: str = "fft_glo") -> list[dict]:
    """The job's two batches; labelled (``LAB3``) for a conditional entry."""
    _, size, batch, _ = SPATIAL_JOBS[job]
    labels = _spatial_cfg("float32", job).loss.conditional
    return [synthetic_batch(batch, size, seed=SPATIAL_SEED + i, with_labels=labels)
            for i in range(2)]


def _save_spatial_modules(job: str, path: str) -> None:
    """The job's weights from seed 0 (the STN's dtheta head random, as in
    phase 9), drawn once on the host and saved for every process of the job."""
    cfg = _spatial_cfg("float32", job)
    with layers.without_draws():
        recipe = build_recipe(cfg, "cpu")
    recipe.init(torch.Generator().manual_seed(0))
    if cfg.recipe == "stn":
        _random_dtheta_head(recipe.STN, 0)
    if cfg.recipe == "nemar":
        _random_offset_head(recipe.R, 0)
    torch.save({k: getattr(recipe, k).state_dict() for k in ("G", "D", "lpips", "cnns")
                if getattr(recipe, k, None) is not None}, path)


def _spatial_trainer(cfg, device, mesh, modules: str):
    """A Trainer and its state at step 0 with the saved weights (step draws
    from seed 0), placed on ``mesh``."""
    with layers.without_draws():
        recipe = build_recipe(cfg, device)
    trainer = Trainer(cfg, recipe, mesh=mesh)
    state = trainer.init_state(0, draw=False)
    for name, sd in torch.load(modules, map_location=device).items():
        getattr(recipe, name).load_state_dict(sd)
    if mesh is not None:
        place_state(state, mesh)
    return trainer, state


def _grads_of(module) -> dict[str, torch.Tensor]:
    return {k: p.grad.detach().float().cpu().clone() for k, p in module.named_parameters()
            if p.grad is not None}


def _step_memory(trace: list[dict]) -> dict:
    """One step's memory from its allocator history (``device_traces[0]``):
    the peak of the bytes allocated since the step began; the same peak
    without transient blocks, those freed before any other allocation (the
    convolution workspaces, whose size cuDNN's heuristics take from the free
    memory and not from the step's tensors); and the largest transient block
    with the innermost frame of this repo that allocated it."""
    events = [e for e in trace if e["action"] in ("alloc", "free_completed")]
    transient, opened, allocs = set(), {}, 0
    for i, e in enumerate(events):
        if e["action"] == "alloc":
            allocs += 1
            opened[e["addr"]] = (i, allocs)
        elif e["addr"] in opened:
            j, at = opened.pop(e["addr"])
            if at == allocs:  # no allocation since its own
                transient.add(j)
    live, total, kept, peak, kept_peak, largest = {}, 0, 0, 0, 0, (0, "")
    for i, e in enumerate(events):
        sign = 1 if e["action"] == "alloc" else -1
        if sign > 0:
            live[e["addr"]] = i
        elif live.pop(e["addr"], None) in transient:
            total -= e["size"]
            continue
        total += sign * e["size"]
        if i not in transient:
            kept += sign * e["size"]
        elif e["size"] > largest[0]:
            frames = [f"{os.path.basename(f['filename'])}:{f['line']}" for f in e["frames"]
                      if "tfcgan_tpu_torch" in f["filename"]]
            largest = (e["size"], frames[0] if frames else "autograd")
        peak, kept_peak = max(peak, total), max(kept_peak, kept)
    return {"peak": peak, "tensors": kept_peak, "transient": largest}


def _spatial_job(world: int, rank: int, mesh, device, tmp: str, job: str) -> dict:
    """Two float32 steps of ``job`` from the saved weights (step 1's metrics
    and reduced G and D gradients, saved to ``tmp``; step 2's peak memory
    above what was allocated before it, and ``_step_memory`` of its
    allocator history; the kernel launches of both steps), then one bfloat16
    step's metrics."""
    modules = os.path.join(tmp, f"spatial_modules_{job}.pt")
    trainer, state = _spatial_trainer(_spatial_cfg("float32", job), device, mesh, modules)
    replicated = spatial.REPLICATED_LAYERS
    reset_counts()
    out = {"metrics": [], "ms": []}
    for i, batch in enumerate(_spatial_batches(job)):
        torch.cuda.synchronize()
        if i == 1:
            before = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            torch.cuda.memory._record_memory_history(max_entries=1_000_000, stacks="python",
                                                     clear_history=True)
        t0 = time.perf_counter()
        m = trainer.step(state, batch)
        out["metrics"].append({k: float(v) for k, v in m.items()})  # reads sync
        out["ms"].append((time.perf_counter() - t0) * 1e3)
        if i == 0 and rank == 0:
            torch.save({"G": _grads_of(state.G), "D": _grads_of(state.D)},
                       os.path.join(tmp, f"spatial_grads_{job}_{world}.pt"))
    torch.cuda.synchronize()
    traced = _step_memory(torch.cuda.memory._snapshot()["device_traces"][0])
    torch.cuda.memory._record_memory_history(enabled=None)
    out.update(counts=counts(), replicated=spatial.REPLICATED_LAYERS - replicated,
               held=before, peak=torch.cuda.max_memory_allocated() - before, traced=traced)
    del trainer, state
    torch.cuda.empty_cache()
    trainer, state = _spatial_trainer(_spatial_cfg("bfloat16", job), device, mesh, modules)
    out["bf16"] = {k: float(v) for k, v in trainer.step(state, _spatial_batches(job)[0]).items()}
    del trainer, state
    torch.cuda.empty_cache()
    return out


def _spatial_rank(rank: int, world: int, port: int, tmp: str, results, jobs: list[str]) -> None:
    """One process on card 0: with ``world`` 2 a gloo rank of a (1 data x 2
    spatial) mesh, with ``world`` 1 the one process it is held to; runs
    ``_spatial_job`` for each of ``jobs`` in turn (one process start and one
    process group for a phase's jobs)."""
    import datetime

    import torch.distributed as dist

    from tfcgan_tpu_torch.parallel import make_mesh

    try:
        torch.cuda.set_device(0)
        device = torch.device("cuda", 0)
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
        mesh = None
        if world > 1:
            dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                                    world_size=world, timeout=datetime.timedelta(seconds=300))
            mesh = make_mesh(world, spatial=world, device=device)
        for job in jobs:
            results.put((world, rank, job, _spatial_job(world, rank, mesh, device, tmp, job)))
        if mesh is not None:
            dist.destroy_process_group()
    except BaseException as e:
        import traceback

        results.put((world, rank, None, RuntimeError(traceback.format_exc())))
        raise SystemExit(1) from e


def _run_spatial_ranks(tmp: str, jobs: list[str], worlds=(2, 1)) -> tuple[dict, float]:
    """The processes of ``_spatial_rank`` for each world of ``worlds`` (the
    pair and the one process it is held to), all started together on the
    card, each running ``jobs`` in turn; {job: {world: {rank: result}}} and
    the seconds they took."""
    import multiprocessing as mp

    t0 = time.perf_counter()
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    procs = []
    for world in worlds:
        port = _free_port()
        procs += [ctx.Process(target=_spatial_rank, args=(r, world, port, tmp, results, jobs))
                  for r in range(world)]
    for p in procs:
        p.start()
    got = {job: {world: {} for world in worlds} for job in jobs}
    try:
        for _ in range(len(jobs) * sum(worlds)):
            world, rank, job, out = results.get(timeout=600)
            if isinstance(out, BaseException):
                raise AssertionError(f"spatial phase {jobs}, world {world} rank {rank}: {out}")
            got[job][world][rank] = out
    finally:
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.kill()
                p.join()
    return got, time.perf_counter() - t0


def _spatial_compare(device, card: str, jobs: dict[str, str]) -> dict[str, dict[str, int]]:
    """Each of ``jobs`` (job -> what its line says of the path) float32 at
    its global batch on two gloo ranks of the card as (1 data x 2 spatial)
    against one process (a process of its own, for its memory, run beside
    the pair; the pair and the process run the jobs in turn,
    ``_run_spatial_ranks``), each within 3 x the float32 floor (one process,
    benchmarked cuDNN algorithms against deterministic ones, or A moved by
    one float32 step, whichever moves it more), no layer on the whole map,
    each rank's kernel launches (one process's a step), each rank's peak
    step memory against one process's; one bfloat16 step on the pair,
    finite. Returns rank 0's launches over its two float32 steps, by job."""
    with tempfile.TemporaryDirectory() as tmp:
        for job in jobs:
            _save_spatial_modules(job, os.path.join(tmp, f"spatial_modules_{job}.pt"))
        got, seconds = _run_spatial_ranks(tmp, list(jobs))
        print(f"spatial jobs {list(jobs)}: the three processes took {seconds:.1f} s with their "
              f"start [{card}]")
        return {job: _spatial_check(device, card, job, what, got[job], tmp)
                for job, what in jobs.items()}


def _spatial_check(device, card: str, job: str, what: str, worlds: dict, tmp: str
                   ) -> dict[str, int]:
    """``_spatial_compare``'s checks of one job from its processes' results
    ``worlds`` and the gradients they saved in ``tmp``."""
    name, size, batch_size, per_step = SPATIAL_JOBS[job]
    pair, one = worlds[2], worlds[1][0]
    g2 = torch.load(os.path.join(tmp, f"spatial_grads_{job}_2.pt"))
    g1 = torch.load(os.path.join(tmp, f"spatial_grads_{job}_1.pt"))
    cfg = _spatial_cfg("float32", job)
    deterministic = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    floor_runs = []
    try:  # the floor: one process with cuDNN's benchmarked algorithms, and one
        # with the deterministic ones whose A moved by one float32 step (the
        # benchmark may pick the deterministic algorithms and show no floor)
        for nudge in (None, *SPATIAL_NUDGES[job]):
            benchmark = nudge is None
            torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = (
                not benchmark, benchmark)
            trainer, state = _spatial_trainer(
                cfg, device, None, os.path.join(tmp, f"spatial_modules_{job}.pt"))
            batch = _spatial_batches(job)[0]
            if not benchmark:
                batch["A"] = np.nextafter(batch["A"], np.float32(nudge)).astype(np.float32)
            floor_runs.append(({k: float(v) for k, v in trainer.step(state, batch).items()},
                               {"G": _grads_of(state.G), "D": _grads_of(state.D)}))
            del trainer, state
            torch.cuda.empty_cache()
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = deterministic

    def metric_err(a, b):
        return max(abs(a[k] - b[k]) / max(abs(b[k]), DP_METRIC_TOL[1] / DP_METRIC_TOL[0])
                   for k in b)

    least = SPATIAL_GRAD_FLOOR.get(job, 0.0) * max(
        float(t.abs().max()) for m in g1 for t in g1[m].values())

    floored = SPATIAL_FLOORED.get(job)

    def scale(grads, k):
        ref = grads[k[:-len("bias")] + "weight"] if k.endswith(KEY_BIASES) else grads[k]
        at_least = least if floored is None or floored.fullmatch(k) else 0.0
        return max(float(ref.abs().max()), at_least) + 1e-12

    def grad_errs(a, b):
        return {f"{m}.{k}": float((a[m][k] - b[m][k]).abs().max()) / scale(b[m], k)
                for m in b for k in b[m]}

    want_m = one["metrics"][0]
    floors = [(metric_err(fm, want_m), max(grad_errs(fg, g1).values())) for fm, fg in floor_runs]
    floor = (max(f[0] for f in floors), max(f[1] for f in floors))
    errs = grad_errs(g2, g1)
    err = (metric_err(pair[0]["metrics"][0], want_m), max(errs.values()))
    bound = (max(DP_METRIC_TOL[0], 3 * floor[0]), max(DP_GRAD_TOL, 3 * floor[1]))
    worst = sorted(errs, key=errs.get)[-3:]
    detail = (f"metrics {err[0]:.3g} relative (bound {bound[0]:.3g}, floor {floor[0]:.3g}), "
              f"G and D gradients {err[1]:.3g} x max|g| (bound {bound[1]:.3g}, floor "
              f"{floor[1]:.3g}: cuDNN's algorithms {floors[0][1]:.3g}, one step of A "
              f"{', '.join(f'{f[1]:.3g}' for f in floors[1:])}; worst "
              f"{ {k: round(errs[k], 6) for k in worst} })")
    if sorted(pair[0]["metrics"][0]) != sorted(want_m) or sorted(errs) != sorted(
            grad_errs(g1, g1)):
        raise AssertionError(f"{name} spatial mesh: metrics {sorted(pair[0]['metrics'][0])}, "
                             f"{len(errs)} gradients")
    if err[0] > bound[0] or err[1] > bound[1]:
        raise AssertionError(f"{name} (1 data x 2 spatial) vs one process, float32 "
                             f"B={batch_size} {size}²: {detail}")
    if any(pair[r]["metrics"] != pair[0]["metrics"] for r in pair):
        raise AssertionError(f"{name} spatial mesh: the ranks' metrics differ: "
                             f"{[pair[r]['metrics'] for r in pair]}")
    want = scaled(per_step, 2)
    whole_map = 2 * SPATIAL_REPLICATED.get(job, 0)
    for r in pair:
        if pair[r]["counts"] != want or pair[r]["replicated"] != whole_map:
            raise AssertionError(f"{name} spatial rank {r}: launches {pair[r]['counts']}, want "
                                 f"{want}; {pair[r]['replicated']} layers on the whole map, "
                                 f"want {whole_map}")
    bf16, bf16_one = pair[0]["bf16"], one["bf16"]
    bf16_err = {k: abs(bf16[k] - bf16_one[k]) / max(abs(bf16_one[k]), 1e-6) for k in bf16_one}
    if (not all(np.isfinite(v) for v in bf16.values()) or sorted(bf16) != sorted(want_m)
            or max(bf16_err.values()) > TENSOR_DIFF_TOL):
        raise AssertionError(f"{name} spatial mesh, bfloat16 step: {bf16} against one "
                             f"process's {bf16_one} (bound {TENSOR_DIFF_TOL} relative)")
    share = {r: pair[r]["peak"] / one["peak"] for r in pair}
    tensors = {r: pair[r]["traced"]["tensors"] / one["traced"]["tensors"] for r in pair}
    mib = 2.0 ** 20

    def transient(t):
        return f"{t['transient'][0] / mib:.1f} MiB at {t['transient'][1]}"
    launched = {k: v for k, v in per_step.items() if v}
    print(f"spatial {name} (1 data x 2 spatial) on two gloo ranks of one card, float32 global "
          f"B={batch_size} {size}² (rows 0-{size // 2 - 1} and {size // 2}-{size - 1} of every "
          f"image; {what}), against one process: {detail}; metrics equal on both ranks; "
          f"{whole_map} layers on the whole map over 2 steps; launches a rank over 2 steps "
          f"{launched or 'none'} a step (one process's); step 2's peak memory above what was held before it, a rank / one "
          f"process: {pair[0]['peak'] / mib:.1f} / {one['peak'] / mib:.1f} MiB, share "
          f"{share[0]:.4f} (rank 1 {share[1]:.4f}; held before the step {pair[0]['held'] / mib:.1f}"
          f" / {one['held'] / mib:.1f} MiB); without transient blocks (the workspaces) "
          f"{pair[0]['traced']['tensors'] / mib:.1f} / {one['traced']['tensors'] / mib:.1f} MiB, "
          f"share {tensors[0]:.4f} (rank 1 {tensors[1]:.4f}; the largest transient block "
          f"{transient(pair[0]['traced'])} / {transient(one['traced'])}; the traced peaks "
          f"{pair[0]['traced']['peak'] / mib:.1f} / {one['traced']['peak'] / mib:.1f} MiB); "
          f"step ms a rank "
          f"{ {r: [round(t, 3) for t in pair[r]['ms']] for r in pair} } (step 1 with set-up; "
          f"the halos and gathers through gloo on the host), one process beside them "
          f"{[round(t, 3) for t in one['ms']]}; bf16 step on the pair {bf16}, one process's "
          f"{bf16_one} (relative {max(bf16_err.values()):.3g}, bound {TENSOR_DIFF_TOL}) "
          f"[{card}]")
    return pair[0]["counts"]


def phase_spatial(device, card: str, results: dict) -> dict[str, dict[str, int]]:
    """The spatial axis (``parallel/spatial.py``): (a) the row-edge K1
    (``phase_spatial_kernels``); (b) fft_glo float32 at 256², global B=4, on
    two gloo ranks of the card against one process (``_spatial_compare``);
    (c) one bfloat16 step on the pair, finite."""
    t0 = time.perf_counter()
    phase_spatial_kernels(device, card, results)
    run = _spatial_compare(device, card, {"fft_glo": "no layer reads beyond its halo"})
    print(f"spatial phase 22: {time.perf_counter() - t0:.1f} s [{card}]")
    return {"spatial_fft_glo": run["fft_glo"]}


# --------------------------------------------- 23. spatial: the STN and TFC-Diff
# K4 with local queries: (images, heads, D) of a 128² tfc_diff step's 64²
# attention at global B=32, its 4096 keys, and the query shares of 2 and 3 ranks
SPATIAL_FLASH = (32, 8, 8, 4096)
SPATIAL_WARP = (32, SIZE, SIZE, 3)  # K2 windows: the stn warp at its training batch


def _flash_shards(s: int, ranks: int, w: int = 64) -> list[tuple[int, int]]:
    """The query spans [lo, hi) of each rank's rows of a w-wide map of s / w rows."""
    return [(lo * w, hi * w) for lo, hi in (spatial.row_bounds(s // w, r, ranks)
                                            for r in range(ranks))]


def _spatial_flash(device, card: str, gen, results: dict) -> None:
    """(a) K4 with local queries (``sq`` < ``sk``) through ``flash_attention``
    and autograd against the plain version, float32 and bfloat16, every
    shard of 2 and 3 ranks of the path's (32 x 8, 8, 4096) attention: within
    phase 13's tolerances; each shard's forward (output, lse) and dq bit for
    bit the whole-sequence launch's rows. Times of the three kernels for rank
    0 of 2 (sq 2048) against the whole-sequence call (sq 4096) at sk 4096,
    bfloat16, with their bounds."""
    n, heads, d, s = SPATIAL_FLASH
    names = KERNELS[7:10]
    worst = dict.fromkeys(names, 0.0)
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v, g = _projection_views(n, heads, d, s, dtype, gen)
        scale = d ** -0.5
        o, lse = fkernel.flashattn_fwd(q, k, v, scale)
        di = (o.float() * g.float()).sum(dim=2).contiguous()
        dq = fkernel.flashattn_bwd(q, k, v, g, lse, di, scale, True, False, False)[0]
        for ranks in (2, 3):
            for lo, hi in _flash_shards(s, ranks):
                what = f"local queries [{lo}, {hi}) of {s} ({n}x{heads}, {d}) {dtype}"
                qs, gs = q[..., lo:hi], g[..., lo:hi]
                errs, _ = check_flashattn(qs, k, v, gs, scale, what)
                for name, e in zip(names, errs):
                    worst[name] = max(worst[name], e)
                os_, lses = fkernel.flashattn_fwd(qs, k, v, scale)
                dis = (os_.float() * gs.float()).sum(dim=2).contiguous()
                dqs = fkernel.flashattn_bwd(qs, k, v, gs, lses, dis, scale, True, False,
                                            False)[0]
                if not (torch.equal(os_, o[..., lo:hi]) and torch.equal(lses, lse[..., lo:hi])
                        and torch.equal(dqs, dq[..., lo:hi])):
                    raise AssertionError(f"{what}: forward or dq not the whole-sequence "
                                         "launch's rows bit for bit")
        del q, k, v, g, o, lse, di, dq
        torch.cuda.empty_cache()
    # times: rank 0 of 2's queries against the whole sequence's, bf16, sk = 4096
    q, k, v, g = _projection_views(n, heads, d, s, torch.bfloat16, gen)
    scale = d ** -0.5
    timed = {}
    for label, sq in (("local", s // 2), ("whole", s)):
        qs, gs = q[..., :sq], g[..., :sq]
        o, lse = fkernel.flashattn_fwd(qs, k, v, scale)
        di = (o.float() * gs.float()).sum(dim=2).contiguous()
        timed[label] = {
            "flashattn_fwd": cuda_ms(lambda: fkernel.flashattn_fwd(qs, k, v, scale), 5),
            "flashattn_bwd_dq": cuda_ms(lambda: fkernel.flashattn_bwd(
                qs, k, v, gs, lse, di, scale, True, False, False), 5),
            "flashattn_bwd_dkv": cuda_ms(lambda: fkernel.flashattn_bwd(
                qs, k, v, gs, lse, di, scale, False, True, True), 5)}
    del q, k, v, g
    torch.cuda.empty_cache()
    for name in names:
        work = _flash_work([name], n * heads, s // 2, d, 2, sk=s)[name]
        b, _ = bound_ms(work[0], work[2], work[1], BF16_FLOP_PER_S)
        results[name].update(local_query_max_abs_err=worst[name],
                             local_query_ms=timed["local"][name],
                             local_query_whole_ms=timed["whole"][name],
                             local_query_bound_ms=b)
        print(f"spatial K4 {name} with local queries: every shard of 2 and 3 ranks within "
              f"phase 13's tolerances (worst {worst[name]:.3g}), forward and dq bit for bit the "
              f"whole sequence's rows; ({n * heads}, {d}) bf16 at sk {s}: sq {s // 2} (rank 0 "
              f"of 2) {timed['local'][name]:.4f} ms, bound {b:.4f} ms; the whole sequence "
              f"(sq {s}) {timed['whole'][name]:.4f} ms [{card}]")


def _spatial_warp_windows(device, card: str, gen, results: dict) -> None:
    """(b) K2's output windows: the y-pass of the stn warp at (32, 256, 256, 3)
    float32 cubic with near-identity thetas, split over 2 and 3 ranks (each
    rank's rows [lo, hi) from the whole intermediate, ``o_base`` = lo): the
    forward bit for bit the whole launch's rows and within phase 4's bounds of
    the plain window; the windows' adjoints and position gradients summed over
    the ranks within phase 4's bounds of the whole launch's (float32 sums in
    another order), each window's within them of autograd of the plain
    window."""
    src = torch.rand(SPATIAL_WARP, device=device, generator=gen) * 2 - 1
    theta = _near_identity_theta(SPATIAL_WARP[0], gen)
    x, p, q, l_out, mode, border, channels = record_passes(src, theta)[1]  # the y-pass
    args = (mode, border, channels)
    g = torch.randn((x.shape[0], l_out, x.shape[2]), device=device, generator=gen)
    whole = rkernel.resample_fwd(x, p, q, l_out, *args)
    whole_dx = rkernel.resample_adjoint(g, p, q, x.shape[1], *args)
    whole_gp, whole_gq = rkernel.resample_gradpos(x, g, p, q, *args)
    worst = [0.0, 0.0, 0.0]
    for ranks in (2, 3):
        dx = torch.zeros_like(whole_dx)
        gp, gq = torch.zeros_like(whole_gp), torch.zeros_like(whole_gq)
        for r in range(ranks):
            lo, hi = spatial.row_bounds(l_out, r, ranks)
            what = f"K2 window [{lo}, {hi}) of {l_out} over {ranks} ranks"
            gw = g[:, lo:hi].contiguous()
            out = rkernel.resample_fwd(x, p, q, hi - lo, *args, o_base=lo)
            if not torch.equal(out, whole[:, lo:hi]):
                raise AssertionError(f"{what}: not the whole launch's rows bit for bit")
            errs = check_resample(x, p, q, gw, *args, what, o_base=lo)
            worst = [max(a, b) for a, b in zip(worst, errs)]
            dx += rkernel.resample_adjoint(gw, p, q, x.shape[1], *args, o_base=lo)
            gpr, gqr = rkernel.resample_gradpos(x, gw, p, q, *args, o_base=lo)
            gp += gpr
            gq += gqr
        _within(dx, whole_dx, 2e-5, f"K2 windows' adjoints over {ranks} ranks")
        _within(gp, whole_gp, 2e-4, f"K2 windows' gp over {ranks} ranks")
        _within(gq, whole_gq, 2e-4, f"K2 windows' gq over {ranks} ranks")
    for name, e in zip(KERNELS[2:5], worst):
        results[name]["window_max_abs_err"] = e
    print(f"spatial K2 output windows: the stn y-pass {tuple(x.shape)} -> {l_out} rows, every "
          f"window of 2 and 3 ranks: forward bit for bit the whole launch's rows, "
          f"max_abs_err against the plain window fwd {worst[0]:.3g}, adjoint {worst[1]:.3g}, "
          f"gp/gq {worst[2]:.3g}; the windows' adjoints and position gradients summed over "
          f"the ranks within phase 4's bounds of the whole launch's [{card}]")


def phase_spatial_families(device, card: str, results: dict) -> dict[str, dict[str, int]]:
    """The spatial axis for the STN family and TFC-Diff: (a) K4's local-query
    form (``_spatial_flash``); (b) K2's output windows
    (``_spatial_warp_windows``); (c)-(f) stn_newmodel3 float32 at 256², global
    B=4, and tfc_diff float32 at 128², global B=8, each on two gloo ranks of
    the card as (1 data x 2 spatial) against one process, with one bf16 step
    each, each rank's K1, K2 and K4 launches and its peak step memory
    (``_spatial_compare``)."""
    t0 = time.perf_counter()
    gen = torch.Generator(device=device).manual_seed(SPATIAL_SEED + 3)
    _spatial_flash(device, card, gen, results)
    _spatial_warp_windows(device, card, gen, results)
    torch.cuda.empty_cache()
    runs = _spatial_compare(device, card, {
        "stn": "the localizer on the gathered (A, fake_A1) pair; the warp's intermediate "
               "gathered, K2's y-pass on the rank's rows",
        "tfc_diff": "the attention's normed map gathered, K4 with the rank's queries against "
                    "every key"})
    by_path = {f"spatial_{job}": run for job, run in runs.items()}
    print(f"spatial phase 23: {time.perf_counter() - t0:.1f} s [{card}]")
    return by_path


# ------------------------------- 24. spatial: NeMAR, CycleGAN and ThermalGAN
SPATIAL_K3 = (32, SIZE, SIZE, 6)  # K3 on row windows: NeMAR's stacked A and fake_B at B=32


def _rows_reached(grid: torch.Tensor, h: int) -> int:
    """The image rows that a zeros-padded, align_corners=False grid's
    bilinear taps read, counted for each image and summed over the batch."""
    iy = ((grid[..., 1].double() + 1) * h - 1) / 2
    y0 = iy.floor().long().flatten(1)
    hit = torch.zeros(grid.shape[0], h + 2, dtype=torch.bool, device=grid.device)
    for tap in (y0, y0 + 1):  # row -1 and row h stand for the padding
        idx = tap.clamp(-1, h) + 1
        hit.scatter_(1, idx, torch.ones_like(idx, dtype=torch.bool))
    return int(hit[:, 1:h + 1].sum())


def _spatial_k3_windows(device, card: str, gen, results: dict) -> None:
    """(a) K3 on row windows: the image (32, 256, 256, 6) whole, the dense
    grid (the identity and offsets of up to 5 pixels) cut into the rows of
    2 and 3 ranks in float32, of 2 in bfloat16. Each window's forward and grid
    gradient bit for bit the whole launch's rows, and within phase 5's
    tolerances of the plain version (``check_gridsample``: the plain sampler
    on the same image at the window's grid rows, and autograd of it); the
    windows' image gradients summed over the ranks within ``GRAD_TOL`` x
    max(1, max|g|) of the whole launch's (float32 atomics, in another order).
    Times for rank 0 of 2's window against the whole launch, float32."""
    n, h, w, c = SPATIAL_K3
    base = _identity_grid(n, h, w, device)
    grid = (base + (torch.rand(base.shape, device=device, generator=gen) * 2 - 1)
            * (5.0 * 2 / SIZE)).contiguous()
    worst, summed_err = [0.0, 0.0, 0.0], 0.0
    for dtype, splits in ((torch.float32, (2, 3)), (torch.bfloat16, (2,))):
        inp = torch.randn(SPATIAL_K3, device=device, generator=gen).to(dtype)
        g = torch.randn(SPATIAL_K3, device=device, generator=gen).to(dtype)
        whole = gkernel.gridsample_fwd(inp, grid)
        whole_di, whole_dg = gkernel.gridsample_bwd(g, inp, grid)
        for ranks in splits:
            summed = torch.zeros_like(whole_di)
            for r in range(ranks):
                lo, hi = spatial.row_bounds(h, r, ranks)
                what = f"K3 rows [{lo}, {hi}) of {h} over {ranks} ranks {dtype}"
                gr, gg = grid[:, lo:hi].contiguous(), g[:, lo:hi].contiguous()
                out = gkernel.gridsample_fwd(inp, gr)
                di, dg = gkernel.gridsample_bwd(gg, inp, gr)
                if not (torch.equal(out, whole[:, lo:hi]) and torch.equal(dg, whole_dg[:, lo:hi])):
                    raise AssertionError(f"{what}: forward or grid gradient not the whole "
                                         "launch's rows bit for bit")
                errs = check_gridsample(inp, gr, gg, "zeros", False, what)
                worst = [max(a, b) for a, b in zip(worst, errs)]
                summed += di
            summed_err = max(summed_err, _within(
                summed, whole_di, GRAD_TOL, f"K3 windows' image gradients over {ranks} ranks "
                                            f"{dtype}"))
        del inp, g, whole, whole_di, whole_dg, summed
        torch.cuda.empty_cache()
    inp = torch.randn(SPATIAL_K3, device=device, generator=gen)
    g = torch.randn(SPATIAL_K3, device=device, generator=gen)
    lo, hi = spatial.row_bounds(h, 0, 2)
    gr, gg = grid[:, lo:hi].contiguous(), g[:, lo:hi].contiguous()
    timed = {"gridsample_fwd": (cuda_ms(lambda: gkernel.gridsample_fwd(inp, gr)),
                                cuda_ms(lambda: gkernel.gridsample_fwd(inp, grid))),
             "gridsample_bwd": (cuda_ms(lambda: gkernel.gridsample_bwd(gg, inp, gr)),
                                cuda_ms(lambda: gkernel.gridsample_bwd(g, inp, grid)))}
    del inp, g
    torch.cuda.empty_cache()
    pixels, reached = n * (hi - lo) * w, _rows_reached(gr, h)
    # the window reads the image rows its taps reach; the backward writes the
    # whole image gradient (the wrapper zero-fills it)
    nb = {"in": reached * w * c * 4, "whole": n * h * w * c * 4, "grid": pixels * 2 * 4,
          "out": pixels * c * 4}
    bounds = {"gridsample_fwd": bound_ms(nb["in"] + nb["grid"] + nb["out"], pixels * (40 + 8 * c)),
              "gridsample_bwd": bound_ms(nb["out"] + nb["in"] + nb["whole"] + 2 * nb["grid"],
                                         pixels * (40 + 24 * c))}
    for i, k in enumerate(("gridsample_fwd", "gridsample_bwd")):
        err = worst[0] if i == 0 else max(worst[1:])
        (ms, whole_ms), (b, by) = timed[k], bounds[k]
        results[k].update(row_window_max_abs_err=err, row_window_ms=ms,
                          row_window_whole_ms=whole_ms, row_window_bound_ms=b)
        print(f"spatial K3 {k} on row windows: the whole {SPATIAL_K3} image, every grid window "
              f"of 2 and 3 ranks, float32 and bfloat16: forward and grid gradient bit for bit "
              f"the whole launch's rows, within phase 5's tolerances of the plain version "
              f"(worst {err:.3g}), the windows' image gradients summed {summed_err:.3g} from "
              f"the whole launch's (bound {GRAD_TOL} x max(1, max|g|)); float32, rank 0 of 2 "
              f"(rows {lo}-{hi - 1}; its taps reach {reached / n:.1f} image rows an image)"
              f" {ms:.4f} ms, bound {b:.4f} ms ({by}), the whole launch {whole_ms:.4f} ms "
              f"[{card}]")


def phase_spatial_baselines(device, card: str, results: dict) -> dict[str, dict[str, int]]:
    """The spatial axis for NeMAR, CycleGAN and ThermalGAN: (a) K3 on row
    windows (``_spatial_k3_windows``); (b)-(e) nemar (the deformable STN, its
    targets gathered and sampled by K3 at the rank's grid rows), cyclegan
    (the buffers whole on both ranks) and thermalgan_bn (the batch norms'
    moments over the group; G2's 1 x 1 map on the whole map) float32 at 256²,
    global B=4, each on two gloo ranks of the card as (1 data x 2 spatial)
    against one process, with one bf16 step each, each rank's launches (K3's
    for nemar, none for the others) and its peak step memory
    (``_spatial_compare``)."""
    t0 = time.perf_counter()
    gen = torch.Generator(device=device).manual_seed(SPATIAL_SEED + 4)
    _spatial_k3_windows(device, card, gen, results)
    torch.cuda.empty_cache()
    runs = _spatial_compare(device, card, {
        "nemar": "the STN's targets gathered, K3 at the rank's grid rows",
        "cyclegan": "the replay buffers whole on both ranks",
        "thermalgan_bn": "the batch norms' moments over the group; the Encoder's 2 x 2 map "
                         "gathered"})
    by_path = {f"spatial_{job}": run for job, run in runs.items()}
    print(f"spatial phase 24: {time.perf_counter() - t0:.1f} s [{card}]")
    return by_path


# ---------------------- 25. spatial: the debiased chain and the saliency mask
def phase_spatial_debiased(device, card: str) -> dict[str, dict[str, int]]:
    """The spatial axis for the debiased chain and the saliency-mask entry:
    fft_patch_debiased (V7: the conditional U-Net's label plane whole, then
    cut; the aux classifier's head a row-sharded product summed over the
    pair; the frozen regional ResNet-18s on the bands of the gathered fake)
    and fft_patch_mask (the mask of A gathered, cut to the rank's rows; the
    mask term on the gathered images) float32 at 256², global B=4, each on
    two gloo ranks of the card as (1 data x 2 spatial) against one process,
    with one bf16 step each, each rank's K1 launches (one process's: 27 + 23
    a step) and its peak step memory (``_spatial_compare``). No kernel is
    new on these paths: K1's row-edge form runs in every U-Net and PatchGAN
    block."""
    t0 = time.perf_counter()
    runs = _spatial_compare(device, card, {
        "debiased": "the label plane cut, the aux head's partial products summed, the "
                    "regional CNNs on the gathered fake",
        "mask": "the saliency mask of the gathered images"})
    by_path = {f"spatial_{job}": run for job, run in runs.items()}
    print(f"spatial phase 25: {time.perf_counter() - t0:.1f} s [{card}]")
    return by_path


# Phase 26: two short learning journeys at the journey shapes (128², B=16,
# bf16; tools/family_journey_torch.py), steps and the thresholds each
# family's last evaluation must pass and its first (step 1) must fail. The
# TPU trajectories of the JAX package (tools/artifacts/*_journey.json) reached
# at these steps: nemar reg_ncc_gt 0.9678 from reg_ncc_init 0.9281 (+0.040)
# and fakeTRB_psnr 30.05 dB (11.19 at step 1); tfc_diff held_noise_mse 0.0376
# (0.971 at step 1).
JOURNEY_STEPS = {"nemar": 200, "tfc_diff": 250}
JOURNEY_THRESHOLDS = {
    "nemar": (("reg_ncc_gain", ">=", 0.02), ("fakeTRB_psnr", ">=", 25.0)),
    "tfc_diff": (("held_noise_mse", "<=", 0.1),)}
# launches a train step and an evaluation of the held-out batch: nemar's task
# runs T and R once (one K3 forward), tfc_diff's one U-Net forward in bf16
JOURNEY_LAUNCHES = {"nemar": (NEMAR_STEP, NEMAR_SERVE_BATCH),
                    "tfc_diff": (DIFF_STEP_BF16, DIFF_FORWARD)}


def _journey_passes(row: dict, checks) -> bool:
    values = {**row, "reg_ncc_gain": row.get("reg_ncc_gt", 0.0) - row.get("reg_ncc_init", 0.0)}
    return all(values[k] >= v if op == ">=" else values[k] <= v for k, op, v in checks)


def phase_journeys(device, card: str) -> dict[str, dict[str, int]]:
    """Short learning journeys through ``run_journey`` of
    tools/family_journey_torch.py: nemar 200 steps and tfc_diff 250 steps at
    128², B=16, bf16, from seed 0, on the tool's face-scene (nemar,
    misaligned) and labelled pools. Every step's and every evaluation's
    kernel launches are read and reset as they happen (K3 forward and
    backward a nemar step, K3 forward an evaluation; K4 forward, dq and dk/dv
    a tfc_diff step, all on the tensor cores, and 7 forward launches an
    evaluation); the last evaluation must pass ``JOURNEY_THRESHOLDS``, the
    first (step 1) must not, and loss_G must end below step 1's. One JSON
    line a family: step-1 and final metrics, ms a step, launches."""
    by_path = {}
    for family, steps in JOURNEY_STEPS.items():
        per_step, per_eval = JOURNEY_LAUNCHES[family]
        total = dict.fromkeys(COUNTED, 0)

        def on_event(kind: str, step: int) -> None:
            got, want = counts(), scaled(per_step if kind == "step" else per_eval, 1)
            if got != want:
                raise AssertionError(f"{family} journey {kind} {step}: launches {got}, "
                                     f"want {want}")
            for k, n in got.items():
                total[k] += n
            reset_counts()

        reset_counts()
        rec = journeys.run_journey(family, device, steps=steps, on_event=on_event,
                                   log=lambda msg: None)
        first, last = rec["history"][0], rec["history"][-1]
        checks = JOURNEY_THRESHOLDS[family]
        if _journey_passes(first, checks) or not _journey_passes(last, checks):
            raise AssertionError(f"{family} journey: step 1 {first}, step {last['step']} "
                                 f"{last}; the last must pass {checks} and step 1 must not")
        if not last["loss_G"] < first["loss_G"]:
            raise AssertionError(f"{family} journey: loss_G {first['loss_G']} -> "
                                 f"{last['loss_G']}")
        evals = len(rec["history"])
        want = {k: per_step.get(k, 0) * steps + per_eval.get(k, 0) * evals for k in COUNTED}
        if total != want:
            raise AssertionError(f"{family} journey: launches {total}, want {want}")
        by_path[f"{family}_journey"] = total
        print(json.dumps({"journey": family, "steps": steps, "step_1": first, "final": last,
                          "thresholds": checks, "ms_per_step": rec["ms_per_step"],
                          "first_step_s": rec["first_step_s"], "seconds": rec["seconds"],
                          "launches": {k: n for k, n in total.items() if n},
                          "card": card}))
        torch.cuda.empty_cache()
    return by_path


NEMAR_CLI = {"pairs": 32, "test": 8, "size": 128, "batch": 16, "epochs": 2}
REG_COLUMNS = ("ssim_before", "ssim_after", "ncc_before", "ncc_after", "mi_before", "mi_after")
PAIR_COLUMNS = ("psnr", "ssim", "ssim_gray", "bhatt", "fft_mag_mse", "fft_mag_mae",
                "niqe_fake", "niqe_real")


def _csv_columns(path: str, want) -> list[dict]:
    """The rows of ``path``, whose columns must be file + ``want``, all finite."""
    with open(path, newline="") as f:
        rows = list(csv.DictReader(f))
    if not rows or list(rows[0]) != ["file", *want]:
        raise AssertionError(f"{path}: {len(rows)} rows, columns {list(rows[0]) if rows else []}")
    if not all(np.isfinite(float(r[k])) for r in rows for k in want):
        raise AssertionError(f"{path}: a value is not finite")
    return rows


def phase_nemar_cli(device, card: str) -> dict[str, dict[str, int]]:
    """nemar through the user's commands (tools/run_e2e_nemar_journey_torch.sh
    cut to 2 epochs): 32 face pairs whose B is misaligned, at 128²
    (tools/make_e2e_dataset_torch.py --scene face --warp-b), ``cli train``
    (batch 16, bf16, a checkpoint every epoch), ``cli test`` from the last
    checkpoint, the 6-role ``prep-crop``, ``eval-reg`` over (real_B, real_A,
    reg_A) and ``eval --iqa niqe`` of fake_TR_B against real_B. K3's launches
    are read and reset after every train step (forward and backward once
    each, in both STN warps' one sampling call) and every served batch (one
    forward); the metric CSVs must have their columns, every value finite."""
    t0 = time.perf_counter()
    spec = NEMAR_CLI
    total = dict.fromkeys(COUNTED, 0)
    events = {"step": 0, "batch": 0}

    def check(kind: str, per_unit: dict[str, int]) -> None:
        events[kind] += 1
        got = counts()
        if got != scaled(per_unit, 1):
            raise AssertionError(f"nemar cli {kind} {events[kind]}: launches {got}, "
                                 f"want {per_unit}")
        for k, n in got.items():
            total[k] += n
        reset_counts()

    step, serve = Trainer.step, Inferencer.__call__

    def counted_step(self, state, batch):
        out = step(self, state, batch)
        check("step", NEMAR_STEP)
        return out

    def counted_serve(self, batch):
        out = serve(self, batch)
        check("batch", NEMAR_SERVE_BATCH)
        return out

    with tempfile.TemporaryDirectory() as tmp:
        data, runs, out = (os.path.join(tmp, d) for d in ("data", "runs", "eval"))
        _load_tool("make_e2e_dataset_torch").main(
            ["--root", data, "--scene", "face", "--warp-b", "--n", str(spec["pairs"]),
             "--test", str(spec["test"]), "--size", str(spec["size"])])
        common = ["--experiment", "nemar", "--data-root", data, "--image-size",
                  str(spec["size"]), "--batch-size", str(spec["batch"]), "--dtype", "bfloat16",
                  "--device", "cuda"]
        reset_counts()
        with mock.patch.object(Trainer, "step", counted_step), \
                mock.patch.object(Inferencer, "__call__", counted_serve):
            cli.main(["train", *common, "--n-epochs", str(spec["epochs"]),
                      "--checkpoint-interval", "1", "--out-dir", runs])
            steps = events["step"]
            ckpt = latest_checkpoint(runs)
            cli.main(["test", *common, "--checkpoint", ckpt, "--out-dir",
                      os.path.join(out, "stacks")])
        batches = events["batch"]
        cli.main(["prep-crop", "--device", "cpu", "--stack-dir", os.path.join(out, "stacks"),
                  "--out-root", out, "--roles", NEMAR_ROLES])
        reg_csv, pair_csv = os.path.join(out, "reg_metrics.csv"), os.path.join(out, "pair.csv")
        cli.main(["eval-reg", "--device", "cpu", "--real-a-dir", os.path.join(out, "real_B"),
                  "--real-b-dir", os.path.join(out, "real_A"), "--reg-b-dir",
                  os.path.join(out, "reg_A"), "--out-csv", reg_csv])
        cli.main(["eval", "--device", "cpu", "--fake-dir", os.path.join(out, "fake_TR_B"),
                  "--real-dir", os.path.join(out, "real_B"), "--out-csv", pair_csv,
                  "--iqa", "niqe"])
        reg = _csv_columns(reg_csv, REG_COLUMNS)
        pair = _csv_columns(pair_csv, PAIR_COLUMNS)
        rows = _log_rows(os.path.join(runs, "logs", "nemar.jsonl"))
    spe = spec["pairs"] // spec["batch"]
    want_steps, want_batches = 1 + spec["epochs"] * spe, -(-spec["test"] // spec["batch"])
    if steps != want_steps or batches != want_batches or not len(reg) == len(pair) == spec["test"]:
        raise AssertionError(f"nemar cli: {steps} steps (want {want_steps}), {batches} served "
                             f"batches (want {want_batches}), {len(reg)} / {len(pair)} rows")
    if os.path.basename(ckpt) != f"step_{want_steps:08d}":
        raise AssertionError(f"nemar cli: last checkpoint {ckpt}")
    want = {k: NEMAR_STEP.get(k, 0) * steps + NEMAR_SERVE_BATCH.get(k, 0) * batches
            for k in COUNTED}
    if total != want:
        raise AssertionError(f"nemar cli: launches {total}, want {want}")
    means = {k: float(np.mean([float(r[k]) for r in tab])) for tab, cols in
             ((reg, REG_COLUMNS), (pair, PAIR_COLUMNS)) for k in cols}
    print(json.dumps({"nemar_cli": {"pairs": spec["pairs"], "size": spec["size"],
                                    "batch": spec["batch"], "steps": steps,
                                    "served_batches": batches, "log_rows": len(rows),
                                    "means": means,
                                    "launches": {k: n for k, n in total.items() if n},
                                    "seconds": round(time.perf_counter() - t0, 1),
                                    "card": card}}))
    return {"nemar_cli": total}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--params", default=None, help="g_params.npz (tools/export_g_params.py)")
    p.add_argument("--init-seed", type=int, default=0)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is false; this script needs a CUDA card")

    # 1. environment
    t_start = time.perf_counter()
    phase_s, last = {}, [t_start]

    def mark(phase: str) -> None:  # the seconds since the previous mark
        now = time.perf_counter()
        phase_s[phase] = round(now - last[0], 1)
        last[0] = now
    device = torch.device("cuda", 0)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    print(f"env: python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, device {torch.cuda.get_device_name(0)}, "
          f"count {torch.cuda.device_count()}; TF32 off")
    print(card)

    # 2. build: all sources at once, one nvcc each
    t0 = time.perf_counter()
    symbols = {"fastpair": ("process_pair", "process_pair_batch"),  # g++: the pair decoder
               "blurpool": ("tfcgan_blurpool_fwd", "tfcgan_blurpool_bwd"),
               "resample": ("tfcgan_resample_fwd", "tfcgan_resample_adjoint",
                            "tfcgan_resample_gradpos"),
               "gridsample": ("tfcgan_gridsample_fwd", "tfcgan_gridsample_bwd"),
               "flashattn": ("tfcgan_flashattn_fwd", "tfcgan_flashattn_bwd_dq",
                             "tfcgan_flashattn_bwd_dkv")}
    _build.build_libraries(list(symbols))
    for name, functions in symbols.items():
        lib = _build.load_library(name)
        for symbol in functions:
            getattr(lib, symbol)
    print(f"build: {', '.join(_build._source(n).name for n in symbols)} "
          f"({', '.join(sum(symbols.values(), ()))}) in {time.perf_counter() - t0:.2f} s -> "
          f"{_build.BUILD_DIR}")

    mark("build")

    # 3. to 5. every kernel against its plain version
    results = dict(zip(KERNELS[:2], phase_kernels(device)))
    results.update(phase_resample(device, card))
    results.update(phase_gridsample(device, card))
    torch.cuda.empty_cache()

    mark("3-5")

    # 6. the fft_glo serve path and its CLI
    by_path = {}
    reset_counts()
    g, batches, forwards = phase_serve(device, args)
    forwards += phase_cli(args)
    by_path["fft_glo_serve"] = expect_counts(
        "fft_glo serve", {"blurpool_fwd": 11}, forwards)
    print(f"fft_glo serve path: {forwards} G forwards, blurpool launches "
          f"{by_path['fft_glo_serve']['blurpool_fwd']} (11 per forward), no other kernel")

    mark("6")

    # 6b. cli train: fft_glo and tfc_diff through the user's commands
    by_path.update(phase_cli_train(device, args, card))
    torch.cuda.empty_cache()

    mark("6b")

    # 7. float32 kernel path vs plain path, and G-forward img/s
    phase_compare(device, g, batches, card)
    del g, batches
    torch.cuda.empty_cache()

    mark("7")

    # 8. the fft_glo train step
    by_path["fft_glo_train"] = phase_train(device, args, "fft_glo", TRAIN_TERMS, FFT_GLO_STEP)
    phase_train_compare(device, args, "fft_glo", TRAIN_TERMS, FFT_GLO_STEP,
                        [("plain path", plain_path, 1e-3, None)])
    phase_train_rate(device, args, card, "fft_glo", TRAIN_RATE_BATCHES)

    mark("8")

    # 9. the stn_newmodel3 serve path
    by_path["stn_serve"] = phase_stn_serve(device, args, card)
    torch.cuda.empty_cache()

    mark("9")

    # 10. the stn_newmodel3 train step
    # This step's gradients do not repeat from run to run: cuDNN's float32
    # algorithms differ by 1e-6 between two identical calls, one float32 ulp of
    # theta moves a sample by 1.5e-5 pixel, and G2's deep instance norms
    # (random weights, small variances) amplify that. The first reference is
    # therefore the kernel path itself, which measured up to 3.3e-3 in L2 norm
    # and 2.0e-2 of max|g| elementwise over several runs on an NVIDIA H100 80GB
    # HBM3; every reference is held to three times that floor. The resampling
    # kernels themselves are held tightly in phase 4.
    phase_train_compare(device, args, "stn_newmodel3", STN_TERMS, STN_STEP,
                        [("kernel path again", contextlib.nullcontext, 6e-2, 1e-2),
                         ("plain resampling with the blur-pool kernels", plain_resample,
                          6e-2, 1e-2),
                         ("plain path", plain_path, 6e-2, 1e-2)])
    phase_train_rate(device, args, card, "stn_newmodel3", (32,),
                     {"kernel": contextlib.nullcontext, "plain-resampling": plain_resample,
                      "plain": plain_path})
    by_path["stn_train"] = phase_train(device, args, "stn_newmodel3", STN_TERMS, STN_STEP)
    torch.cuda.empty_cache()

    mark("10")

    # 11. the nemar serve path
    by_path["nemar_serve"] = phase_nemar_serve(device, args, card)
    torch.cuda.empty_cache()

    mark("11")

    # 12. the nemar train step. At random weights its gradients are
    # ill-conditioned in float32 (D's output is next to constant, so its
    # instance norms' backward removes nearly all of the upstream gradient: on
    # the CPU a 1e-6 perturbation of A moves them by 0.5 to 1.5 % in L2 norm),
    # so whatever differs between two runs is amplified. On an NVIDIA H100 80GB
    # HBM3 only the order of K3-bwd's atomics differs (the forward repeats bit
    # for bit, kernel path = plain path): three runs measured 4.3e-6 in L2 norm
    # against the kernel path again and against the plain path alike. The
    # bounds are NEMAR_TOL_L2 = 2e-3 and NEMAR_TOL = 1e-2 x max|g|; the K3
    # kernels themselves are held tightly in phase 5.
    phase_train_compare(device, args, "nemar", NEMAR_TERMS, NEMAR_STEP,
                        [("kernel path again", contextlib.nullcontext, NEMAR_TOL, NEMAR_TOL_L2),
                         ("plain path", plain_path, NEMAR_TOL, NEMAR_TOL_L2)])
    phase_train_rate(device, args, card, "nemar", (32,))
    phase_train_rate(device, args, card, "nemar", (128,), size=128)
    by_path["nemar_train"] = phase_train(device, args, "nemar", NEMAR_TERMS, NEMAR_STEP,
                                         after=check_decayed_lr)

    mark("12")

    # 13. flash attention against its plain version
    torch.cuda.empty_cache()
    results.update(phase_flashattn(device, card))
    torch.cuda.empty_cache()

    mark("13")

    # 14. the tfc_diff serve path: the ancestral sampler
    by_path["tfc_diff_serve"] = phase_diff_serve(device, args, card)
    torch.cuda.empty_cache()

    mark("14")

    # 15. the tfc_diff train step. The float32 step repeats bit for bit but for
    # cuDNN's float32 convolutions (1e-6 run to run); the flash attention
    # kernels themselves are held tightly in phase 13.
    phase_train_compare(device, args, "tfc_diff", DIFF_TERMS["tfc_diff"], DIFF_STEP,
                        [("kernel path again", contextlib.nullcontext, 1e-3, None),
                         ("plain path", plain_path, 1e-3, None)], size=DIFF_SIZE)
    phase_train_rate(device, args, card, "tfc_diff", (16, 32), size=DIFF_SIZE)
    for name, per_step in (("tfc_diff_label", DIFF_STEP_BF16),
                           ("tfc_diff_hybrid", DIFF_HYBRID_STEP), ("tfc_diff", DIFF_STEP_BF16)):
        by_path["tfc_diff_train"] = phase_train(device, args, name, DIFF_TERMS[name], per_step,
                                                size=DIFF_SIZE, moving="g_noise_mse")
        torch.cuda.empty_cache()

    mark("15")

    # 16. the rest of the TFC-GAN-FFT family: the debiased chain V1-V7, the
    # saliency mask, the regional FFT loss and favtgan's temperature forms
    # The float32 steps at B=4 do not repeat to the fft_glo B=2 bounds: on an
    # NVIDIA H100 80GB HBM3 the kernel path run twice differed by 7.4e-3 of
    # max|g| (1.5e-3 in L2) for fft_patch_debiased (cuDNN's float32 algorithms
    # and ReLU kinks: one ulp more on every blur output moved it by 7.5e-3,
    # and fft_glo's own B=4 step by 1.9e-2), and by 0.22 (0.12 in L2) for
    # fft_patch_mask: the saliency mask's batch-wide min and max send their
    # gradient to one pixel each, and a rounding difference moves that pixel.
    # The plain path sat 7.4e-3 / 4.0e-3 and 0.21 / 0.11 away. Each reference
    # is held to about three times those floors (DEBIASED_TOL, MASK_TOL); the
    # blur-pool kernels themselves are held tightly in phase 3.
    by_path["debiased_train"] = phase_family_train(device, args)
    phase_train_compare(device, args, "fft_patch_debiased", DEBIASED_TERMS, FFT_GLO_STEP,
                        [("kernel path again", contextlib.nullcontext, *DEBIASED_TOL),
                         ("plain path", plain_path, *DEBIASED_TOL)], batch_size=4)
    phase_train_compare(device, args, "fft_patch_mask", MASK_TERMS, FFT_GLO_STEP,
                        [("kernel path again", contextlib.nullcontext, *MASK_TOL),
                         ("plain path", plain_path, *MASK_TOL)], batch_size=4)
    phase_family_rate(device, args, card)
    phase_family_serve(device, args, card)
    phase_family_cli(device, args, card)
    torch.cuda.empty_cache()

    mark("16")

    # 17. the baselines: ThermalGAN (thermalgan, thermalgan_bn) and CycleGAN.
    # No kernel lies on their paths. Their float32 step on the card is held to
    # the same step on the CPU: on the CPU (tests/test_torch_thermalgan.py,
    # tests/test_torch_cyclegan.py) the port's float32 gradients are 7e-4 to
    # 1e-2 (L2) and up to 0.12 x max|g| (elementwise) from the JAX package's
    # and from the port's own float64 ones, since the generators' (leaky) ReLU
    # kinks behind instance norms over up to 128 x 128 x 64 values turn the
    # convs' rounding differences into gradient differences; the card's cuDNN
    # rounds otherwise again, so BASELINE_TOL is about three times that.
    t0 = time.perf_counter()
    by_path.update(phase_baselines_train(device, args))
    phase_baselines_compare(device, args)
    phase_baselines_rate(device, args, card)
    by_path.update(phase_baselines_serve(device, args, card))
    phase_baselines_cli(device, args, card)
    torch.cuda.empty_cache()
    print(f"baseline phase: {time.perf_counter() - t0:.1f} s [{card}]")

    mark("17")

    # 19. the data and evaluation chain: the native decoder, cli train
    # --hist-every, the registered set, eval-reg, eval --iqa, the host
    # commands and test-time augmentation
    by_path.update(phase_data_eval(device, args, card))
    torch.cuda.empty_cache()

    mark("19")

    # 20. parallel/: cli train under torchrun (an NCCL world of one), the
    # Trainer with and without that mesh, the GPipe trunk at one stage, and
    # two gloo ranks on the card
    by_path.update(phase_parallel(device, args, card))

    mark("20")

    # 21. the tensor axis: column-parallel layers over gloo ranks of the card
    by_path.update(phase_tensor(device, card))

    mark("21")

    # 22. the spatial axis: the row-edge K1, and row shards over gloo ranks of the card
    by_path.update(phase_spatial(device, card, results))

    mark("22")

    # 23. the spatial axis for the STN family and TFC-Diff: K4's local queries,
    # K2's output windows, both families on row shards over gloo ranks of the card
    by_path.update(phase_spatial_families(device, card, results))

    mark("23")

    # 24. the spatial axis for NeMAR, CycleGAN and ThermalGAN: K3 on row
    # windows, the three families on row shards over gloo ranks of the card
    by_path.update(phase_spatial_baselines(device, card, results))

    mark("24")

    # 25. the spatial axis for the debiased chain and the saliency mask: both
    # entries on row shards over gloo ranks of the card
    by_path.update(phase_spatial_debiased(device, card))

    mark("25")

    # 26. two learning journeys: nemar and tfc_diff for 200 and 250 bf16 steps
    by_path.update(phase_journeys(device, card))

    mark("26")

    # 27. nemar through the CLI: train, test, prep-crop, eval-reg, eval --iqa niqe
    by_path.update(phase_nemar_cli(device, card))

    mark("27")

    # 18. result
    print(f"chip_smoke: seconds by phase {phase_s}")
    print(f"chip_smoke: all phases passed in {time.perf_counter() - t_start:.1f} s")
    print(card)
    sources = {"blurpool": "tfcgan_tpu_torch/csrc/blurpool.cu",
               "resample": "tfcgan_tpu_torch/csrc/resample.cu",
               "gridsample": "tfcgan_tpu_torch/csrc/gridsample.cu",
               "flashattn": "tfcgan_tpu_torch/csrc/flashattn.cu"}
    replaces = {"blurpool_fwd": "tfcgan_tpu/ops/pallas_kernels/blurpool.py:158",
                "blurpool_bwd": "tfcgan_tpu/ops/pallas_kernels/blurpool.py:266",
                "resample_fwd": "tfcgan_tpu/ops/pallas_kernels/resample.py:115",
                "resample_adjoint": "tfcgan_tpu/ops/pallas_kernels/resample.py:155",
                "resample_gradpos": "tfcgan_tpu/ops/pallas_kernels/resample.py:134",
                "gridsample_fwd": "tfcgan_tpu/ops/pallas_kernels/gridsample.py:178",
                "gridsample_bwd": "tfcgan_tpu/ops/pallas_kernels/gridsample.py:197",
                "flashattn_fwd": "tfcgan_tpu/ops/pallas_kernels/flashattn.py:248",
                "flashattn_bwd_dq": "tfcgan_tpu/ops/pallas_kernels/flashattn.py:302",
                "flashattn_bwd_dkv": "tfcgan_tpu/ops/pallas_kernels/flashattn.py:302"}
    # a kernel's main path: the last train path driven that runs it
    main_path = {k: {"gridsample": "nemar_train", "flashattn": "tfc_diff_train"}.get(
        k.split("_")[0], "stn_train") for k in KERNELS}
    for k in KERNELS:
        if by_path[main_path[k]][k] < 1:
            raise AssertionError(f"{k} was not launched on {main_path[k]}")
    print(json.dumps({"kernels": [
        {"name": k, "route": "cuda", "source": sources[k.split("_")[0]],
         "replaces": replaces[k], "launches": by_path[main_path[k]][k],
         "main_path": main_path[k],
         "launches_by_path": {path: c[k] for path, c in by_path.items()},
         **({"tensor_core_launches": by_path[main_path[k]][f"{k}_tc"]}
            if f"{k}_tc" in COUNTED else {}), **results[k]}
        for k in KERNELS]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
