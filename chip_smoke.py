#!/usr/bin/env python3
"""Drive the PyTorch port (mxnet_tpu_torch) on one NVIDIA GPU and check it.

    python3 chip_smoke.py [--seed N] [--reps N]

Phases, each of which must pass (nothing is caught; any failure exits
non-zero):

1. device: requires CUDA; prints the card's name and power limit
   (nvidia-smi) and the float32 convolution precision the port uses.
2. build: compiles every CUDA kernel of the port from the sources in the
   checkout (one nvcc per source, all started together) and prints each
   ptxas report.
3. nms kernel: holds the MultiBox NMS kernel against its plain PyTorch
   version on the same CUDA tensors (the masks must be exactly equal), on
   the route the wrapper picks and on the l2 route: the served shapes, the
   route boundary (k_max - 1, k_max, k_max + 1), B in {1, 8, 32} with and
   without force, duplicates, zero scores, IoUs exactly at the threshold
   and degenerate boxes. Then times the smem and l2 routes in turns on the
   same tensors at B=32 and B=1 (k=400): profiler device time by kernel,
   back to back on CUDA events, host cost a call, beside the bound; the
   smem route must be the faster at B=32.
4. matmul_stats kernel: holds the matmul-with-BatchNorm-statistics kernel
   against its plain version (TF32 off) at the 12 shapes of ResNet-50's 33
   fused Conv1x1->BatchNorm pairs (batch 128, 224x224, NHWC, bf16), all on
   the wgmma route, at edge shapes in float32 (the SIMT f32 kernel,
   forced) and bfloat16, and at the wgmma and tf32x3 routes' edge shapes
   (every launch on that route); checks that the results are bitwise
   reproducible; per shape, times the wgmma kernel, the wmma kernel (the
   wrapper's route entry, same tensors), torch.matmul (the product alone,
   cuBLAS) and the plain version, in turns, as device time summed by the
   profiler and back to back on CUDA events, beside the bound, and sums one
   step's 33 launches.
5. serve: builds the SSD detector at its full width (models/ssd.py
   get_symbol() defaults, 3x300x300 input) with weights from --seed,
   writes symbol JSON and .params through the port, loads them in
   ServingEngine on cuda:0 with buckets (1, 8, 32) and serves requests of
   1, 5, 8, 32 and 40 images. Checks shapes, finiteness, that the NMS
   kernel ran once per bucket dispatch, each on its smem route, and that
   the detections equal MultiBoxDetection with the plain NMS on the same
   heads. Then times p50 latency per bucket.
6. train: ResNet-50 (NHWC, 224x224, batch 128, 1000 classes) through
   TrainStep on cuda:0, f32 master weights with bf16 compute,
   SGD(lr 0.1, momentum 0.9, wd 1e-4), weights from --seed, random data and
   labels made on the card. One step with MXTPU_FUSE_CONV_BN=1 must launch
   matmul_stats 33 times, all on the wgmma route, with no layout copy, and
   agree with the same step unfused (loss sum within 1%, every BatchNorm
   moving statistic within rtol 2e-2, atol 1e-3). Then run_steps with K=4 (all losses finite),
   step times and images/s fused, unfused and run_steps, and
   torch.profiler tables of one fused step and of one fused float32 step
   (TF32 off, cuDNN deterministic; the step Module.fit runs in phase 10),
   each printed only when two profiles in a row record the same kernel
   counts (the profiler has been seen to drop kernel records). After it,
   the SSD training step of phase 12 (TrainStep, Adam, b=32) is profiled
   the same way, with the share of the NMS kernel and of the sort, scatter
   and gather kernels (MultiBoxTarget's and MultiBoxDetection's).

7. rtc: the user-kernel wrappers (B3). The JAX package's two PallasKernel
   test kernels, scale (o = 2x) and addmul (o = a*b + a), as user Triton
   kernels through rtc.TritonKernel and as CUDA bodies through rtc.Rtc
   (NVRTC), at (8, 128), at a ragged 1,000,003 and at 25,557,032 float32
   values: scale equal to its plain version, addmul within one float32 ulp
   of |a*b| + |a| (a compiler may contract it into one fused multiply-add).
   Rtc writing into a first-axis slice changes exactly that slice of the
   parent; a float16 array, a CPU array and a 2048-thread block raise.
   Times at 25.5M beside the bound, torch.mul/torch.addcmul and the plain
   version; the host cost of each wrapper beside a direct launch, in turns
   (with the ways of reading the stream handle, and a push whose arrays
   change every call, whose results must land in those arrays).
8. bind: ResNet-50 (NCHW, 224x224, batch 128, float32, TF32 off) through
   simple_bind on gpu(0), weights from --seed (Xavier), random data and
   labels made on the card. The main path is two hand-written steps:
   forward(is_train=True), backward(), then the SGD-momentum update of all
   161 parameter arrays as a user kernel: step 1 through Rtc (161 pushes),
   step 2 through TritonKernel (161 launches). Each update is held
   against nd.sgd_mom_update on the same tensors; the two steps against two
   TrainStep(compute_dtype=None) steps from the same state and batches;
   grad_req="add" over two backward passes against twice the gradient.
   The Rtc update is also captured once into a CUDA graph and replayed
   from step 1's start: it must equal the eager Rtc update bit for bit.
   Times: the bind step and the TrainStep step (images/s), the update's
   device time and back-to-back time (the graph replay among them) beside
   its bound, nd.sgd_mom_update and torch._fused_sgd_, and peak device
   memory.
9. imperative: nd arithmetic and reductions on the card against the CPU;
   an autograd gradient of a two-layer network written with nd ops
   against Executor.backward of the same symbol; a CustomOp whose forward
   and backward push Rtc kernels, inside a bound symbol, against the same
   network with nd's _mul_scalar.
10. module: ResNet-50 (NHWC, 224x224, batch 128, float32, TF32 off,
   cuDNN deterministic, MXTPU_FUSE_CONV_BN=1) trained through
   Module(context=gpu(0)).fit, 2 epochs of 8 host batches from --seed, Xavier
   arg_params from --seed, SGD(lr 0.1, momentum 0.9, wd 1e-4): (a) one
   step a dispatch, (b) 4 steps a dispatch with dispatch_pipeline=1. Each
   fit must launch matmul_stats 33 x 16 times, all on its tf32x3 route.
   Checks: the parameters and moving statistics after each fit against a
   TrainStep driven by hand over the same batches (rtol 1e-4, atol 1e-5
   elementwise, and finite); the metric, Accuracy and CrossEntropy, from
   (a) (host) and (b) (device sums) against the sums of the hand-driven
   step's outputs (correct to the count, cross-entropy within rtol 1e-5); a
   checkpoint with its .states saved and loaded by Module on the card
   scores as the trained module and carries its momentum; at each of the
   12 shapes the tf32x3 route and the SIMT f32 kernel (forced) against the
   plain version. Prints images/s of each fit beside TrainStep.step alone;
   on CUDA events, in turns, the tf32x3 route's time a step beside the
   SIMT kernel's, torch.matmul f32 (TF32 off) and the plain version, with
   the tf32x3 bound (3 x 2MNK at the TF32 peak) and the FP32 SIMT bound
   (the tf32x3 route must be below the SIMT kernel and the plain version);
   and a fused step's time against unfused.
11. resnet serve: ResNet-50 (NCHW, 3x224x224, 1000 classes, Xavier from
   --seed) served through ServingEngine with buckets (1, 8, 32): finite
   probabilities for requests of 1, 5, 8 and 32 images, p50 latency per
   bucket.
12. ssd train: the SSD training net at its full width
   (models/ssd.py get_symbol_train() defaults: 4 classes, width 32,
   nms_topk 400; 3x300x300, batch 32, float32, TF32 off, cuDNN
   deterministic) trained through Module(context=gpu(0)).fit with Adam
   (lr 1e-3, rescale_grad 1, as example/ssd/train.py), Xavier arg_params
   and synthetic scenes (example/ssd/train.py's synth_det_batch, copied)
   from --seed, eval_metric MultiBoxMetric, 2 epochs of 4 batches: (a) one
   step a dispatch, (b) 4 steps a dispatch with dispatch_pipeline=1. Each
   fit must launch the NMS kernel once a training step (8), all on its
   smem route, and its cross-entropy must be finite and fall from epoch 1
   to epoch 2. Checks: the parameters after (a) equal a TrainStep driven
   by hand over the same batches bit for bit ((b) within rtol 1e-4); the
   MultiBoxMetric sums of (a) (host) and (b) (device sums) equal the host
   metric over the hand-driven step's outputs within rtol 1e-5; the last
   step's det_out equals MultiBoxDetection with the plain NMS on the same
   cls_prob, loc_preds and anchors, exactly. Prints ms a step and
   images/s of each fit and of TrainStep alone (host clock), a step on
   CUDA events, the convolutions' operations (from the shapes) beside
   cuDNN's time, and the NMS kernel's time in the step (phase 6's
   profile) beside its bound. Fit (a)'s module is saved through
   save_checkpoint for phase 13.
13. serving tier (float32, TF32 off, cuDNN deterministic): the full-width
   SSD (as phase 5, weights from --seed) and ResNet-50 NCHW (phase 11's).
   (a) SSD engines quantized bf16 and int8: detections for 1, 5, 8 and 32
   images equal, bit for bit, f32 engines loaded with the same weights
   dequantized on the host; weight_bytes against f32 (bf16 <= 0.51, int8
   <= 0.30). (b) ResNet-50 in none, bf16 and int8: weight_bytes, the
   engine's peak device memory, quality_report over 64 images. (c) 400
   one-image requests at 200/s from 4 clients (open_loop_run) through a
   Batcher over the f32 SSD: all complete, none fails, every answer equals
   the engine's own answer for that image at one of the buckets and
   positions (the engine's answers for 32 pool images at every bucket and
   position, and the most distinct answers one image gets across
   positions, are computed first); B2 once a dispatch, all smem; p50,
   p99, requests/s, images a dispatch, padded fraction, and constructor
   to first answer against the warm p50. (d) 300 requests of 1-8 images
   at 100/s, interactive and batch, through a FleetRouter of two
   replicas; under the traffic one replica drains, a third joins and the
   fleet hot-reloads phase 12's checkpoint (the serving symbol's 25
   arguments are a subset of the training symbol's 26): no request
   fails, each answer equals the old weights' answers or the new
   weights', never a mix, and after the reload a fresh engine of the
   checkpoint's, bit for bit; B2 once a dispatch (and once a bucket in
   the joined engine's warm-up), all smem; p50 and p99 by class. (e) the
   Predictor on gpu(0), reshaped over 1, 8 and 32 images, against
   ServingEngine (absolute 1e-6), and its executor cache.
14. training API: the train phase's ResNet-50 (NHWC, 224x224, batch 128,
   bf16 compute over float32 masters, MXTPU_FUSE_CONV_BN=1), TF32 off and
   cuDNN deterministic, SGD(lr 0.1, momentum 0.9, wd 1e-4), Xavier
   arg_params and 8 host batches from --seed. (a) Module(compute_dtype=
   "bfloat16").fit, 2 epochs at 4 steps a dispatch, checkpoints every 4
   batches, the guard on: uninterrupted with async saves (A), and stopped
   by a callback after 6 batches then resumed with resume="auto", sync
   saves (B); A and B must end with equal parameters and moving
   statistics, bit for bit; each fit must launch matmul_stats 33 times a
   step, all wgmma; prints the seconds a save takes on the training
   thread, async against sync. (b) TrainStep.step(guard=True): a clean
   guarded step must equal an unguarded one bit for bit, and with
   guard.grad_nan armed must leave every tensor and the step counter as
   they were and report skipped 1; prints both steps' times (CUDA
   events). (c) two steps from one state at remat False, True and "conv":
   the states must be equal bit for bit; prints matmul_stats launches a
   step (33, 66, 66 expected and checked) and peak device memory. (d)
   MXTPU_BF16_STATS=1 and =opt: bfloat16 aux (and optimizer states with
   opt), finite losses over 4 steps, the step time, and a Module.fit
   checkpoint whose arrays are all float32. (e) the zoo through
   FeedForward.fit, NCHW float32 (TF32 off), Xavier, SGD, 8 steps each:
   Inception-BN 3x224x224 at batch 64, AlexNet at 128, VGG-16 at 32:
   finite cross-entropy and parameters, images/s; Dropout p=0.5 on a
   4096x4096 tensor on the card keeps 0.5 +- 0.005 of it, and equal seeds
   give equal masks.
15. data: the data tier from JPEG records. (a) a probe, printed on its
   own line: Pillow, <jpeglib.h>, libjpeg in ldconfig, g++ and the cores,
   nvjpeg.h, libnvjpeg and whether nvJPEG's hardware backend initialises;
   the native reader library (no libjpeg) must build; the host route
   follows the probe: "native" (libjpeg's header and library present:
   the native decoder library must build), "pillow" (no libjpeg: the
   decoder's build must fail with the compiler's message; decoding falls
   back to Pillow as in the reference) or "none". (b) an indexed .rec of 1024 classification
   JPEGs at 257x257 (quality 90, 8 classes; bench.py's realdata textures)
   and one of 256 detection JPEGs at 300x300 with 1-4 boxes, written with
   Pillow from --seed. (c) ResNet-50 NCHW, 8 classes, bf16 compute, b=128,
   k=4 through Module.fit: 1 warm-up and 1 timed epoch (2 before phase
   28) from the records
   through ImageRecordIter's host route (native route) or ImageIter with
   the Python augmenters (pillow route), with bench.py's augmentation
   (random crop of 224 after a resize to 246, mirror, mean/std) on
   min(4, cores) decode workers, against the same fit over a
   device-resident NDArrayIter of the same shapes (images/s, their ratio,
   PipelineStats, DataHealth), the workers decoding alone, and the
   NDArrayIter fit again (a quarter of the images, cut from half for
   phase 28; 2 epochs) with the workers decoding beside it; the
   first two superbatches that reached the card must equal a 1-worker
   pass bit for bit. (d) drills: data.worker_die makes
   next() raise naming the site within 5 s; io.record_read@3=transient*2
   leaves DATA_HEALTH.retries at 2 and the clean pass's batches; the
   registry carries data_health, pipeline_stats and training_health. (e)
   the SSD training net (phase 12's settings: f32, TF32 off, cuDNN
   deterministic, Adam) from the detection records through
   ImageDetIter(b=32, rand_mirror, label_shape=(4, 5)) and Module.fit at
   k=1, 8 steps: the NMS kernel once a step on smem, and the last step's
   det_out equal to MultiBoxDetection with the plain NMS on its inputs;
   images/s. Without Pillow and libjpeg only (d) runs, on the reader and
   the decode pool.
16. lstm: variable-length training, example/rnn/lstm_bucketing.py's
   model at its published widths (a 2-layer, 200-unit FusedRNNCell LSTM
   over a 200-wide embedding, vocabulary 10000, batch 32, buckets 10, 20,
   30, 40 and 60, Adam at lr 0.01, Perplexity(ignore_label=0), float32)
   on 1600 synthetic sentences from --seed (next token = token + 1). (a)
   the RNN op (LSTM and GRU) at bucket 60 on the card against the same op
   on the CPU, outputs within 2e-5 and gradients within 1e-4 of the
   largest; its time beside torch._VF.lstm (cuDNN, TF32 off and on) on
   the same unpacked weights, in turns. (b) BucketingModule.fit at K=1 and
   K=4 for 2 epochs: the perplexity must fall, and K=4 must equal K=1 bit
   for bit (or within 1e-3 of each parameter's norm where a fused step
   repeated from one state does not repeat its bits). (c) the example's
   own loop (forward, backward, update, update_metric a batch, switching
   buckets) against fit's fused step over the first 4 batches from one
   state (1e-3 of each parameter's norm), then over 2 epochs (its
   perplexity must fall). (d) fit with Monitor(pattern=".*weight") on the
   card and on the CPU port, the monitored batch's rows within 1e-4. (e) a
   child process (chip_smoke.py --lstm-profile-child DIR) with
   MXNET_PROFILER_AUTOSTART=1: the profile starts at the first dispatch
   of a bucket-60 fit under a faults.plan_scope (fired_counts checked),
   a profiler.Scope brackets 8 more steps, the Chrome trace must hold CUDA
   kernel events and the Scope's span, and REGISTRY.to_prometheus() is
   printed; a step's kernels by device time, and the card's idle share.
   (f) tokens/s and the host and CUDA-event ms a step by bucket, and
   tokens/s over a fit's second epoch. No kernel of B1-B3 may launch.
17. lm: the transformer LM at bench.py lm_main's widths (vocabulary 1024,
   embed 256, 8 heads, 4 layers, seq 128, batch 32, bf16 compute, SGD lr
   0.1, momentum 0.9, wd 1e-4, the gradient the mean over tokens) on a
   synthetic next-token task from --seed (each row counts up from a
   random start). Profiled right after phase 6 (before the profiler drops
   records): one training step, one float32 decode step and one
   speculative round (device ms and launches, the matrix products' and
   the int64 elementwise kernels' shares, and CUDA-event ms back to
   back), the threefry uniforms of one decode step alone, and the
   attention core beside scaled_dot_product_attention.
   (a) Module(compute_dtype="bfloat16").fit at K=1 and K=4 for 2 epochs
   of 64 batches: the perplexity must fall, and K=4 must equal K=1 bit for
   bit (or within 1e-3 of each parameter's norm); tokens/s and a step on
   CUDA events; stack_layers=True over the trained weights stacked
   against the per-layer build (float32, within 1e-5 of the largest
   value); a one-layer draft trained the same way. (b) DecodeLoop over the
   trained float32 weights, max_len 128, 8 slots, 16 requests of an
   8-token shared prefix plus a 2-4 token tail, 48 new tokens each (96
   before phase 28), each
   leg warmed once and then timed: greedy (every token the argmax of the
   full forward at its position, teacher-forced on the stream, but where
   its two probabilities are within 1e-5; the loop built on other
   weights and hot-reloaded, bit for bit), sampled (temperature 0.8, top_k
   50, top_p 0.95), bf16 and int8 (reloaded bit for bit; their greedy
   streams reproduce at least 0.98 of the float32 leg's tokens, each
   stream counted to its first difference; int8's quality gate through a
   ServingEngine pair), prefix (streams equal to the sampled leg's) and
   spec_k 2 with the draft (token-identical to the sampled leg); 8
   requests whose prompt plus new tokens fill max_len, speculative with
   the target as a perfect draft (a window starting at max_len - 2,
   past the positional table) and with the one-layer draft, greedy and
   sampled, token-identical to target-only; serve.sample raising at the
   3rd step sheds every
   sequence with ServingClosedError; tokens/s, ms a decode step and the
   weight bytes of each leg. (c) No kernel of B1-B3 may launch.
18. mesh: data parallelism over a 2-replica 'data' mesh whose replicas
   both lie on cuda:0 (the machine has one card), through TrainStep(mesh=),
   shard_superbatch and run_steps at K=4. (a) bench.py main()'s ResNet-50
   (NHWC, global batch 128, MXTPU_FUSE_CONV_BN=1, SGD lr 0.1, momentum
   0.9, wd 1e-4) in float32 with TF32 off and deterministic cuDNN: B1 on
   its tf32x3 route 66 times a step (33 pairs on each replica's shard),
   no op run on the gathered batch, the replicas bit for bit; each of the
   4 steps run on the mesh from the one-device state before it: the
   moving statistics within 1e-3 |one device| + 1e-5 of the one-device
   step's, the parameters' update within 5% of its norm (a step's f32
   update on random labels is itself some 2% off its float64 value:
   MESH_F32_UPDATE_RTOL); free-running, the steps amplify each other's
   differences (printed, not held). B1 held against its plain version, in
   float32 (tf32x3) and bf16 (wgmma), on every (M, K, N) the pairs give
   one replica's shard. (b) The same model in bf16 compute: the replicas
   bit for bit; each step from the one-device state before it: the moving
   statistics within 0.5% of the norm of their one-device change, the
   parameters' update within 100% of its norm (MESH_BF16_*: one bf16
   step's update is mostly rounding here); for 1 and 2 replicas the ms a
   step between CUDA events around a dispatch, the host ms until the
   dispatch returned, B1's launches and the cross-replica sums a step. In
   (a) and (b) a control step with BatchNorm's whole-batch rule taken away
   (per-replica statistics) must fail the checks. (c) A guarded dispatch
   with a NaN in the
   last replica's half of one step: one skip on every replica; the mesh
   state saved, resumed in a fresh TrainStep, bit for bit over 2 more
   dispatches. (d) Phase 17's LM (bf16) 4 steps on the mesh against one
   device (each parameter's difference within 5% of its one-device
   update's norm), tokens/s for 1 and 2 replicas. Both replicas share
   the card: no scaling figure.
19. axes: the 'model', 'seq' and 'pipe' axes, every position on cuda:0,
   through TrainStep(mesh=, param_shardings=, group2ctx=). (a) Phase 17's
   LM (bf16, SGD as there) over seq=2 and data=2,seq=2 (ring attention,
   preserve_shape, pos_embed_weight on P('seq', None)) and pipe=2
   (stack_layers, the stacked weights on P('pipe'), 2 microbatches): 4
   steps each from the one-device state before it, each parameter's
   difference within 10% of its one-device update's norm
   (AXES_LM_RTOL: twice phase 18's measured bf16 floor), the ring's
   rotations and no gather, the pipeline's hops; ms a step (CUDA events)
   and host ms a step against one device, the device launches of one
   step against one device's (torch.profiler), B1-B3 launches and the
   collectives by kind a step; a control step of seq=2 with the
   gradients summed over 'data' only must fail the bound; then one
   float32 step of seq=2 with TF32 off within 1% (AXES_F32_RTOL), a
   float64 step on one device printed beside it as the floor, and as its
   control the same mesh step in bf16 compute, which must fail that
   bound (a TF32 mesh step printed beside it). (b)
   example/model-parallel-lstm/lstm.py's LSTM at its defaults (seq 16, 4
   layers, hidden 128, embed 64, vocab 64, batch 32) with every group on
   a 2-position 'model' axis, 60 Adam steps at lr 0.01 from the
   one-device start: the loss halves, the first 10 losses and the
   parameters after them within the example's check bound (rtol 1e-4,
   atol 1e-4) of the one-device run, the i2h weight held as shards; ms
   a step. No kernel of B1-B3 may launch. The positions share the card:
   no scaling figure.

20. ops: the slice's 23 ops (ops/spatial.py and the rest of ops/nn.py
   and ops/contrib.py) and the three examples that need them. (a) Each op
   forward and backward on cuda:0 (float32, TF32 off) at a width its
   users run, from --seed: Deconvolution + Crop as FCN-32s' head
   ((1, 21, 22, 22), kernel 64, stride 32, cropped to 500x500 at (19,
   19)); ROIPooling as Fast R-CNN on VGG-16 ((1, 512, 38, 63), 128 rois,
   7x7, scale 1/16), whose peak extra memory must stay under 2 GiB;
   Correlation as FlowNetC (two (8, 256, 48, 64), displacement 20,
   stride2 2, pad 20: 441 channels); CTCLoss at T 300, batch 32, 29
   symbols, labels of 20-100; SpatialTransformer, GridGenerator (affine
   and warp) and BilinearSampler on (32, 3, 224, 224) to 224x224;
   InstanceNorm (4, 32, 256, 256); Pad reflect, edge and constant around
   (4, 3, 256, 256) by 40; LeakyReLU's four modes and UpSampling (nearest,
   x2, two inputs) on (64, 128, 32, 32); fft, ifft and count_sketch at
   (6272, 512) to 8192; log_softmax (32, 32000); SVMOutput (L1, L2) and
   the three regression outputs on (128, 1000); quantize and dequantize
   of a (1000, 2048) weight. Each result (output and gradients) stays on
   the card and is held against the same op on the CPU in float64 from
   the same inputs within its tolerance (OP_TOL_*; ROIPooling on 32 of
   its channels, Correlation on its first sample, each of which depends
   on its own inputs only; rrelu's card draws by their range and its
   gradient, its inference against float64; quantize against the CPU in
   float32, level for level). Prints each op's ms forward and backward
   and forward alone (CUDA events), its launches (the kernel, copy and
   memset nodes of one call captured into a CUDA graph) and peak extra
   memory. (b) example/autograd/mnist_autograd.py,
   example/nce-loss/nce_lm.py and example/recommenders/matrix_fact.py,
   rebuilt on the port, on gpu(0) at their own sizes: each must pass its
   own line (accuracy above 0.95; ranking accuracy at least 0.95; holdout
   RMSE below 0.35 of the label spread).

21. model-parallel serving, every position of a 2-position 'model' mesh
   on cuda:0 (float32, TF32 off, cuDNN deterministic; run after phase 19
   and before phase 20, so its one-step profiles come before phase 20's
   captures). (a) The full-width SSD of phase 5 (3x300x300, buckets 1, 8,
   32, weights from --seed) through ServingEngine(contexts=2): at every
   bucket each output of a detections engine and of a heads engine
   (cls_prob, loc_pred, anchors) against the single-device engine's on
   the same rows, as the largest |difference| over the largest |value|
   (the heads within MP_SSD_TOL; the detections, which sorting and greedy
   NMS make move where scores nearly tie, printed with the share of the
   single engine's kept detections found among the sharded engine's),
   and the detections equal to MultiBoxDetection with the plain
   NMS on the sharded heads, bit for bit; B2 once a dispatch on its smem
   route; p50 by bucket in turns with the single engine; gathers a
   dispatch; each position's parameter bytes against the whole set's.
   (b) Sharded bf16 and int8 engines against sharded f32 engines of the
   host-dequantized weights, bit for bit, with each int8 scale's shard
   shapes following its payload's. (c) Phase 17's trained LM through
   DecodeLoop(contexts=2): greedy and sampled streams of phase 17's 32
   requests against the single-device loop's (the share of streams
   exactly equal, and the teacher-forced agreement: each reference stream
   fed to the sharded loop as its prompt, at least MP_LM_AGREE of its
   tokens picked again); the prefix-cache and spec_k 2 legs token for
   token with the sharded target-only loop; the cache shard shape,
   tokens/s, ms a step and device launches a step (torch.profiler) beside
   the single-device loop's. (d) A FleetRouter over one single-device and
   one sharded SSD replica, each behind its own Batcher: phase 13's 300
   open-loop requests of 1-8 images at 100/s across a drain of the
   sharded replica and the join of another; every answer equal, bit for
   bit, to one of the two engines' answers for its image at some bucket
   and position, nothing shed, report() naming each replica's
   model_devices, B2 once a dispatch.

22. dist: distributed training and chaos, every rank on cuda:0 (the
   machine has one card: the figures are the card's own cost of a dist
   step, not a scaling figure). Ranks start through the port's launcher
   (python -m mxnet_tpu_torch.tools.launch, a free port) into this
   script's hidden modes (--dist-sync-child, --dist-async-child); a rank
   that fails fails the phase. (a) bench.py main()'s ResNet-50 (NHWC,
   bf16 compute, MXTPU_FUSE_CONV_BN=1, SGD lr 0.1, momentum 0.9, wd 1e-4)
   through Module.fit(kvstore="dist_sync") over 2 ranks of batch 64
   (global 128), each on its shard of synthetic data from --seed, 8 steps
   at k=1: the parameters equal bit for bit across the ranks, step 1's
   reduced gradient vector equal bit for bit to the member-order sum of
   the ranks' own, B1 on its wgmma route 33 times a step a rank; ms a
   step, the exchange's ms and bytes a step, and global images/s against
   phase 6's one-device step. (b) tests/chaos_plans/
   dist_worker_die_slow_leader_s13.json through the port's chaos runner:
   3 ranks, rank 2 SIGKILLed at its 18th ring collective, a slow re-form
   leader; every invariant green, the survivors' parameter hashes equal,
   one re-form, and the seconds from the kill (the survivors' last step of
   generation 0) to their first step of generation 1. (c) dist_async at
   MXTPU_KV_STALENESS=4 over 2 ranks on the chaos dist scenario's MLP:
   the largest staleness lag at most 4 and the training accuracy at least
   0.95. (d) serve_composed_deaths_s1.json and
   train_torn_ckpt_midrun_raise_s7.json through the runner on the card:
   every invariant green.

23. capi: the C ABI on the card (last). Builds libmxnet_tpu_torch.so and
   the pure-C card_client (mxnet_tpu_torch/csrc/capi/) with cc from the
   checkout, then runs the client in this process through ctypes, the
   launches counted: (a) MXSymbolCreateFromJSON of bench.py main()'s
   ResNet-50 (NHWC, float32, batch 32, MXTPU_FUSE_CONV_BN=1),
   MXExecutorBind with dev_type 2, one training forward and backward and
   an SGD-momentum update through MXKVStoreCreate("local") with a C
   updater (MXKVStoreSetUpdater calling sgd_mom_update): B1 on its tf32x3
   route once for each fused pair; (b) MXPredCreate of the SSD of phase 5
   at bucket 8 from two C threads at once: B2 once a forward; (c)
   MXRtcCreate of a CUDA SGD-momentum body and one MXRtcPush for each of
   (a)'s 161 parameter arrays: B3. Holds (a)'s loss (METRIC_CE_RTOL) and
   updated parameters (MODULE_RTOL, MODULE_ATOL) against the same step
   through the Python API, B1 against its plain version at the step's
   shapes, (b)'s detections bit for bit against the Python API's
   Predictor and against the plain NMS on the same heads, (c) against
   nd.sgd_mom_update (update_excess's bound); runs card_client gpu as a
   child process (its own embedded interpreter), both with cuDNN's
   deterministic algorithms (MXNET_ENFORCE_DETERMINISM=1 in the child),
   whose sums and dumped arrays must equal the in-process run's bit for
   bit; prints the ABI's host cost a call beside the
   Python API's for MXNDArraySyncCopyFromCPU of (a)'s batch and
   MXExecutorForward, and the host's libpython and python3-config.

24. memcheck: the tuner and the memory analyzer on the card (last).
   (a) bench.py main()'s ResNet-50 step (NHWC, b=128, bf16 compute,
   MXTPU_FUSE_CONV_BN=1, SGD momentum) priced by memcheck.analyze, a
   shape-only dry run on fake cuda:0 tensors: B1 on its shape-only route
   33 times and no launch, torch.cuda.max_memory_allocated unmoved; then
   one real step of the same configuration from a fresh state, its
   allocator peak above the memory allocated before it: the static peak
   within MEMCHECK_BAND of it, B1 on its wgmma route 33 times. The same
   step at b=1024 priced: flagged hbm-budget against the card's memory,
   the allocator's peak unmoved. (b) the SSD (get_symbol() defaults,
   3x300x300, buckets 1, 8, 32) through ServingEngine: memory_report()
   per bucket (B2 on its shape-only route once a bucket, no launch, each
   convolution's cuDNN workspace priced as the engine's warm-up took it)
   within MEMCHECK_BAND of each bucket's allocator peak over one real
   forward (B2 once a bucket, and once a bucket at load). (c)
   autotune.tune on the card: img_per_sec on the zoo's mlp (budget 4),
   serve_p99 on mlp (budget 3, 100 requests), decode_tokens_per_sec
   (budget 2), each printing its
   winner and speedup_vs_default; then img_per_sec on mlp under
   MXTPU_AUTOTUNE_BUDGET=4K, every candidate pruned and the allocator's
   peak unmoved.
25. tracecheck: the program registry, the retrace watch and the
   analyzers' check methods on the card. (a) phase 24 (a)'s
   ResNet-50 TrainStep dispatches step and run_steps (K=2), guarded and
   unguarded (B1 on its wgmma route 33 times a step): its four registered
   programs audit with no unsuppressed finding (tracecheck.check_registered,
   its seconds logged); a float32 -> float16 flip of data on the next step
   is one retrace event at .../step[bs=128] naming data; under
   set_tracecheck("error") the same flip on the guarded step raises
   RetraceError, whose result's step counter advanced. (b) the hook's host
   cost: MXTPU_TRACECHECK off against warn in turns (off, warn, warn, off)
   on the zoo's mlp at batch 32 and on (a)'s step, microseconds a dispatch,
   and a call of the hook on the same arguments (2000 back to back a
   turn): at most 50 us on the mlp under warn, under 1% of the ResNet-50
   step's host time. (c) the SSD engine at buckets 8 and 32
   (B2 in its warm-up and forwards): check(memory=True) with no
   hbm-budget finding, each bucket's static peak within MEMCHECK_BAND of
   its real forward's; DecodeLoop.check(memory=True) on phase 17's LM
   widths and BucketingModule.check(memory=True) over the LSTM's bucket
   set after a short fit, every finding logged. (d) python -m
   mxnet_tpu_torch.tracecheck --zoo --json --device cuda:0 in a child
   process started with the phase and running beside (a)-(c): exit 0,
   its programs, findings and seconds.
26. flopcheck: the roofline analyzer on the card (last). (a) phase 25
   (a)'s ResNet-50 bf16 TrainStep at b=128: flopcheck.check_train_step
   over its four programs (kernel count, predicted step ms and MFU, top
   hotspot, findings, seconds), then 10 real steps on CUDA events after 3
   warm-ups (B1 wgmma 33 times a step): the step program's B1 entries
   are the 33 launches of B1_STEP_SHAPES, their summed predicted time
   the 33 priced by ops/matmul_stats.bound_seconds within 1e-9 relative,
   and the predicted step at most the measured one. (b) the SSD engine
   at buckets 8 and 32: each bucket program of tracecheck's registry
   priced by flopcheck.analyze (B2 one entry priced by
   ops/multibox_nms.bound_seconds), its predicted forward beside the
   bucket program's measured on CUDA events; at 32 the prediction at
   most the measurement. (c) phase 17's LM bf16 training step:
   autotune.hotspot_report(top=10), predicted against measured ms. (d)
   the audit hook on the zoo's mlp: under set_flopcheck("warn") each of
   four dispatch keys audited once (seconds logged), under "error" with
   MXTPU_FLOPCHECK_TINY_COUNT=1 the first dispatch raises MXNetError,
   under "off" no dry run runs. (e) python -m mxnet_tpu_torch.flopcheck
   --zoo --json --hotspots 5 --device cuda:0 in a child beside (a)-(d):
   exit 0, its programs, findings and seconds.
27. commscheck: the communication analyzer on the card (last). (a) phase
   18's two-position 'data' mesh on cuda:0, ResNet-50 NHWC bf16 at
   global batch 128: commscheck.check_train_step(k=1) on fake cuda:0
   tensors, then one real dispatch of the step: the inventory's forward
   collectives by kind equal the dispatch's parallel.mesh.COUNTERS by
   kind, B1 launched 66 times (33 a position), the gradient all-reduces
   102,228,128 bytes (phase 22's per-rank bytes; a difference is named by
   entry), and the step's collective count, bytes, wire bytes,
   comm_seconds and predicted efficiency at the card's devspec row. (b)
   phase 21's model-parallel SSD engine (two positions on cuda:0, B2 once
   a dispatch) and the LM's sharded DecodeLoop at phase 17's widths:
   each comms_report, a real dispatch of each bucket counting what its
   inventory holds, check(comms=True) with every finding of an expected
   kind (replicated-large on the engine's gathered convolution outputs,
   resharding-copy on the loop's LayerNorm parameters, which the
   placement rule splits and the loop gathers whole), and
   FleetRouter.check(comms=True) over a fleet of the sharded engine.
   (c) the audit hook on a 'data' mesh: under set_commscheck("warn") one
   audit of the first dispatch key and none on its second dispatch, under
   "error" the first K-step dispatch of a step whose batch sum gathers
   along 'data' in the loop raises naming the node, under "off" no dry
   run. (d) python -m mxnet_tpu_torch.commscheck --sharded --device cuda:0
   --json and python -m mxnet_tpu_torch.flopcheck --sharded --device
   cuda:0 --json in children started with the phase: each sharded
   program's comm_seconds, non-zero, and no unsuppressed finding but the
   expected ones (COMMSCHECK_SHARDED_EXPECTED: the flat-head transformer
   step's resharding-copy of its label, comms-bound on the gate's tiny
   programs at the H100's peak, flopcheck's tiny-dispatch).
28. imagenet: ImageRecordIter on the card (last), with
   example/image-classification/train_imagenet.py's data settings. (a)
   1024 JPEG records from --seed (896 baseline 4:2:0 at 500x375 or
   375x500, 64 at 1024x768, 32 progressive, 32 grayscale; quality 90),
   their MB and seconds to write. (b) two batches decoded by nvJPEG:
   image_augment against its plain version on the same CUDA tensors
   (max_abs_err 0), and on an extra descriptor mix (D1_EXTRA: denom 8, a
   3.1x shrink, crops under a 227x227 output), the descriptors from
   nvJPEG's header sizes against the Python draws on Pillow's; the
   kernel's ms on CUDA events beside its bound and its share of it, the
   plain version's and F.interpolate + flip + normalize's
   (composite_ms; no single library call does the stage); nvJPEG's decode
   ms a image by route. (c) nvJPEG's pixels against Pillow's decode of the
   same bytes by route, and the denom-2 images' box average against
   libjpeg's 1/2 decode, held to NVJPEG_BOUNDS. (d) 4 workers decoding
   one epoch alone; ResNet-50 NCHW bf16 b=128 k=4, 1000 classes,
   Xavier(gaussian, in, 2), SGD lr 0.1 momentum 0.9 wd 1e-4 through
   Module.fit from ImageRecordIter(resize 256, random crop and mirror,
   the example's mean/std, 4 workers) on cuda:0 over 1 warm-up and 2
   timed epochs against a device-resident NDArrayIter of the same shapes;
   PipelineStats; image_augment launched once a batch and nvJPEG's calls
   by route (counts at 0 just before the fit). (e) the first 2
   superbatches that reached the card equal a 1-worker pass bit for bit;
   set_epoch(1) equals the uninterrupted epoch 1; four threads decoding
   beside a busy card equal one thread's decode. (f) a record cut inside
   its header raises the corrupt-image error; the io.record_read retry
   drill on the card route.

The line before the ops line is the card's name and power limit; then
{"ops": [...], "examples": {...}} (phase 20's figures); then
{"kernels": [...]} (per kernel: launches on
its main path (phase 16's LSTM path and phase 17's LM path launch none;
B1's include phase 18's mesh dispatches, bf16 and f32, and phase 22's
dist ranks, launches_dist; every kernel's include phase 23's through the
C ABI, launches_capi; B1's bf16 and B2's include phase 24's real step and
forwards, launches_memcheck, phase 25's, launches_tracecheck, phase
26's, launches_flopcheck, and phase 27's, launches_commscheck),
max error against the plain version, times and bound; the
NMS kernel's launches also by path: serving, training, the serving tier,
training from JPEG records and model-parallel serving (phase 21); the
matmul_stats kernel's by path: the
train phase and the training API; image_augment's from phase 28's fit,
with its composite_ms and nvJPEG's decode ms a image by route); the last
line is {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import re
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np

# the port's devspec table holds the card's peaks, so a bound here and the
# analyzers' rooflines cannot drift apart (fails outside a checkout)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from mxnet_tpu_torch import devspec as _devspec  # noqa: E402

#: H100 SXM peaks (NVIDIA data sheet, at the 700 W limit): HBM bytes/s,
#: float32 operations/s outside the tensor cores, dense TF32 tensor-core
#: operations/s (B1's and B2's bounds: their modules' ``bound_seconds``)
HBM_BYTES_PER_S = _devspec.DEVICE_SPECS["NVIDIA H100"].hbm_bytes_per_s
FP32_OPS_PER_S = _devspec.PEAK_BY_DTYPE["NVIDIA H100"]["float32"]
TF32_OPS_PER_S = _devspec.PEAK_BY_DTYPE["NVIDIA H100"]["tf32"]

#: the training configuration bench.py main() runs (ResNet-50, NHWC)
RESNET_BATCH = 128
RESNET_IMAGE = 224
RESNET_CLASSES = 1000
#: (M, K, N) of the fused Conv1x1->BatchNorm pairs of one such step and how
#: many pairs have each; the train phase checks it against the symbol
B1_STEP_SHAPES = {
    (401408, 64, 64): 1, (401408, 64, 256): 4, (401408, 256, 64): 2,
    (401408, 256, 128): 1, (100352, 128, 512): 4, (100352, 512, 128): 3,
    (100352, 512, 256): 1, (25088, 256, 1024): 6, (25088, 1024, 256): 5,
    (25088, 1024, 512): 1, (6272, 512, 2048): 3, (6272, 2048, 512): 2}
B1_EDGE_SHAPES = [(m, k, n) for m in (1, 17, 1000) for k in (1, 3, 64)
                  for n in (1, 64, 65)]
#: bfloat16 shapes at the edges of the wgmma route: ragged M-tiles, fewer
#: tiles than SMs and many tiles a block (M); one partial K box and a ragged
#: last box (K); a ragged N-tile and a change of N-tile width (N)
B1_WGMMA_EDGE_SHAPES = [(m, k, n) for m in (1, 17, 1000, 100003)
                        for k in (8, 72) for n in (8, 264, 520)]
#: float32 shapes at the edges of the tf32x3 route: ragged M-tiles and many
#: tiles a block (M); one partial K box and a ragged last box (K); a ragged
#: N-tile and more than one N-tile (N)
B1_F32_TMA_EDGE_SHAPES = [(m, k, n) for m in (1, 17, 1000, 100003)
                          for k in (4, 36) for n in (4, 132, 260)]
SSD_INPUT = (3, 300, 300)
BUCKETS = (1, 8, 32)
REQUESTS = (1, 5, 8, 32, 40)


def log(*a):
    print(*a, flush=True)


def gpu_name_and_power():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    return out[0].strip()


def cuda_time_ms(fn, reps, warmup=3):
    """Mean milliseconds per call of ``fn`` over ``reps`` calls, by CUDA
    events around the whole run."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# ---------------------------------------------------------------------------
# kernel phase
# ---------------------------------------------------------------------------

def nms_inputs(rng, b, k, dup=0, zeros=0, ncls=3):
    """Score-sorted boxes for the NMS kernel: corners in [0, 1], ``dup``
    rows copied from earlier rows, the last ``zeros`` scores 0."""
    c = rng.random((b, k, 2), dtype=np.float32)
    wh = rng.random((b, k, 2), dtype=np.float32) * np.float32(0.3)
    boxes = np.clip(np.concatenate([c - wh / 2, c + wh / 2], axis=2), 0, 1)
    score = -np.sort(-rng.random((b, k), dtype=np.float32), axis=1)
    cls = rng.integers(0, ncls, (b, k)).astype(np.float32)
    if dup and k > 1:
        src = rng.integers(0, k - 1, dup)
        dst = np.minimum(src + 1 + rng.integers(0, 5, dup), k - 1)
        boxes[:, dst] = boxes[:, src]
        cls[:, dst] = cls[:, src]
    if zeros:
        score[:, k - zeros:] = 0.0
    return boxes.astype(np.float32), score, cls


def nms_bound_ms(b, k):
    """Least time for the mask, in ms, and what bounds it: each input read
    once, the output written once, and ~15 FP32 operations for each of the
    k(k-1)/2 pairs (``ops/multibox_nms.bound_seconds``, the formula
    flopcheck prices a launch by)."""
    from mxnet_tpu_torch.ops import multibox_nms
    t, by = multibox_nms.bound_seconds(b, k)
    return 1e3 * t, by


def profiled_kernels(fn, reps):
    """torch.profiler over ``reps`` calls of ``fn``: the CUDA kernels with
    device time, or None when the profiler lost records. Every call
    launches the same kernels, so a kernel recorded a number of times that
    ``reps`` does not divide was dropped from the trace (late in a long
    run the profiler on the chip machine has been seen to keep 2 of 5
    launches)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if str(getattr(e, "device_type", "")).endswith("CUDA")
               and _device_us(e) > 0]
    lost = [e.key for e in kernels if e.count % reps
            and not e.key.startswith(("Memset", "Memcpy"))]
    if lost:
        log("profile: kernel records lost over %d calls (%s); not used"
            % (reps, ", ".join(_kernel_name(k) for k in lost[:3])))
        return None
    return kernels


def device_ms_by_kernel(fn, reps=5):
    """{kernel name: device ms per call of ``fn``} summed by
    torch.profiler over ``reps`` calls (host gaps excluded); empty when
    the profiler records no device time, or lost records
    (:func:`profiled_kernels`)."""
    fn()
    kernels = profiled_kernels(fn, reps) or []
    return {e.key: _device_us(e) / 1e3 / reps for e in kernels}


def _kernel_name(key):
    """A profiler key's function name (``nms_mask_kernel`` of
    ``(anonymous namespace)::nms_mask_kernel(float4 const*, ...)``)."""
    m = re.search(r"(\w+)\(", key)
    return m.group(1) if m else key[:60]


def nms_times(fn, reps):
    """One NMS call ``fn`` timed three ways: device ms by kernel and in
    total (profiler), back-to-back ms (CUDA events) and the host us a call
    (enqueue only). Raises when the profiler records no device time in
    three tries: the routes are compared by device time only."""
    split = {}
    for _ in range(3):
        split = device_ms_by_kernel(fn)
        if split:
            break
    if not split:
        raise SystemExit("nms: the profiler recorded no device time")
    return {"ms": sum(split.values()),
            "by_kernel": {_kernel_name(k): v for k, v in split.items()},
            "event_ms": cuda_time_ms(fn, reps),
            "host_us": host_us(fn, 500)}


def nms_grid_inputs(rng, b, k, degenerate=False):
    """Score-sorted boxes with corners on a 1/8 grid, so that many IoUs
    fall exactly on simple fractions (0.5 among them), two classes;
    ``degenerate`` gives every tenth box zero width (area 0)."""
    c = rng.integers(0, 8, (b, k, 2)).astype(np.float32) / 8
    wh = rng.integers(1, 5, (b, k, 2)).astype(np.float32) / 8
    boxes = np.concatenate([c, c + wh], axis=2).astype(np.float32)
    if degenerate:
        boxes[:, ::10, 2] = boxes[:, ::10, 0]
    score = -np.sort(-rng.random((b, k), dtype=np.float32), axis=1)
    cls = rng.integers(0, 2, (b, k)).astype(np.float32)
    return boxes, score, cls


def kernel_phase(rng, reps, card):
    """B2 against its plain version, exactly, on the wrapper's route and
    on the l2 route; then both routes timed in turns."""
    import torch
    from mxnet_tpu_torch.ops import multibox_nms as mnms
    dev = torch.device("cuda", 0)
    kmax = mnms.SMEM_MAX_K
    # (B, k, force, duplicates, zero scores, inputs, threshold)
    cases = [(32, 400, False, 0, 0, "rand", 0.5),
             (32, 400, True, 0, 0, "rand", 0.5)]
    cases += [(4, k, False, 0, 0, "rand", 0.5)
              for k in (1, 63, 64, 65, 400, 2000)]
    cases += [(4, 400, False, 40, 100, "rand", 0.5),
              (4, 400, True, 40, 100, "rand", 0.5),
              (2, 2000, False, 200, 500, "rand", 0.5)]
    # the route boundary, and the served batches with duplicates and zero
    # scores, with and without force
    cases += [(2, k, f, k // 10, k // 5, "rand", 0.5)
              for k in (kmax - 1, kmax, kmax + 1) for f in (False, True)]
    cases += [(b, 400, f, 40, 80, "rand", 0.5)
              for b in (1, 8, 32) for f in (False, True)]
    # IoUs exactly at the threshold (the exact redo of the fast test), and
    # degenerate boxes (the correctly rounded division for every pair)
    cases += [(4, 400, f, 0, 0, kind, th) for kind in ("grid", "degenerate")
              for f in (False, True) for th in (0.5, 0.25)]
    max_err = 0.0
    for b, k, force, dup, zeros, kind, th in cases:
        arrs = (nms_inputs(rng, b, k, dup, zeros) if kind == "rand" else
                nms_grid_inputs(rng, b, k, kind == "degenerate"))
        boxes, score, cls = (torch.from_numpy(a).to(dev) for a in arrs)
        route = mnms.kernel_route(b, k)
        before = dict(mnms.LAUNCHES_BY_ROUTE)
        got = mnms.nms_alive(boxes, score, cls, th, force)
        other = mnms._launch(boxes, score, cls, th, force, "l2")
        want = mnms.nms_alive_reference(boxes, score, cls, th, force)
        torch.cuda.synchronize()
        took = {r: mnms.LAUNCHES_BY_ROUTE[r] - before[r] for r in before}
        err = float((got - want).abs().max())
        log("nms case B=%d k=%d force=%s dup=%d zero_scores=%d %s "
            "thresh=%g: kept %d/%d; %s route max |kernel - plain| = %g, l2 "
            "route equal: %s" % (b, k, force, dup, zeros, kind, th,
                                 int(want.sum()), b * k, route, err,
                                 torch.equal(other, want)))
        if took != ({"smem": 1, "l2": 1} if route == "smem" else
                    {"smem": 0, "l2": 2}):
            raise SystemExit("NMS kernel took routes %s at k=%d" % (took, k))
        if not (torch.equal(got, want) and torch.equal(other, want)):
            raise SystemExit("NMS kernel disagrees with its plain version "
                             "at B=%d k=%d force=%s %s" % (b, k, force, kind))
        max_err = max(max_err, err)

    # the routes in turns on the same tensors (smem, l2, l2, smem): device
    # time by the profiler, back to back on CUDA events, host cost a call
    times = {}
    for b, k in ((32, 400), (1, 400)):
        boxes, score, cls = (torch.from_numpy(a).to(dev)
                             for a in nms_inputs(rng, b, k, 40, 80))
        got = {}
        for route in ("smem", "l2", "l2", "smem"):
            t = nms_times(lambda: mnms._launch(boxes, score, cls, 0.5, False,
                                               route), reps)
            for key, v in t.items():
                if key == "by_kernel":
                    got.setdefault((route, key), {}).update(v)
                else:
                    got.setdefault((route, key), []).append(v)
        bound_ms, bound_by = nms_bound_ms(b, k)
        for route in ("smem", "l2"):
            times[(b, route)] = {
                key: float(np.mean(got[(route, key)]))
                for key in ("ms", "event_ms", "host_us")}
            times[(b, route)]["by_kernel"] = got[(route, "by_kernel")]
            t = times[(b, route)]
            log("nms timing B=%d k=%d route %s: device %.6f ms (profiler; by "
                "kernel %s), back to back %.6f ms (CUDA events), host %.2f "
                "us a call; bound %.6f ms (%s) [%s]"
                % (b, k, route, t["ms"], {n: round(v, 6) for n, v in
                                    t["by_kernel"].items()},
                   t["event_ms"], t["host_us"], bound_ms, bound_by, card))
        if b == 32:
            plain_ms = cuda_time_ms(
                lambda: mnms.nms_alive_reference(boxes, score, cls, 0.5),
                max(3, reps // 20), warmup=1)
            bound32 = (bound_ms, bound_by)
    smem, l2 = times[(32, "smem")], times[(32, "l2")]
    if not smem["ms"] < l2["ms"]:
        raise SystemExit("NMS smem route %.6f ms is not below the l2 route's "
                         "%.6f ms at B=32, k=400" % (smem["ms"], l2["ms"]))
    log("nms plain version B=32 k=400: %.6f ms [%s]" % (plain_ms, card))
    return {"name": "multibox_nms", "route": "cuda", "kernel_route": "smem",
            "source": "mxnet_tpu_torch/csrc/multibox_nms.cu",
            "replaces": "mxnet_tpu/ops/pallas_multibox.py:29",
            "launches": None, "max_abs_err": max_err,
            "ms": smem["ms"], "ms_source": "profiler",
            "event_ms": smem["event_ms"], "host_us": smem["host_us"],
            "plain_ms": plain_ms, "bound_ms": bound32[0],
            "bound_by": bound32[1], "library_ms": None,
            "l2_ms": l2["ms"], "l2_event_ms": l2["event_ms"],
            "b1_ms": times[(1, "smem")]["ms"],
            "b1_l2_ms": times[(1, "l2")]["ms"]}


# ---------------------------------------------------------------------------
# matmul_stats kernel phase
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def no_tf32():
    """Float32 products and convolutions in full FP32 (cuBLAS's and
    cuDNN's TF32 off), restored after."""
    import torch
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev


@contextlib.contextmanager
def deterministic_cudnn():
    """cuDNN's deterministic algorithms (its default weight-gradient
    algorithms may sum in another order on every call), restored after."""
    import torch
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = prev


def b1_bound_ms(m, k, n, arith):
    """Least time for one launch, in ms, and what bounds it: x, w read
    once, y and the (2, N) f32 statistics written once; the operations of
    ``arith`` (``ops/matmul_stats.ARITH``) at their peak: 2MNK at the bf16
    tensor-core peak (bf16), at the FP32 peak (f32), 3 x 2MNK at the TF32
    peak (tf32x3). ``ops/matmul_stats.bound_seconds``, the formula
    flopcheck prices a launch by."""
    from mxnet_tpu_torch.ops import matmul_stats
    t, by = matmul_stats.bound_seconds(m, k, n, arith)
    return 1e3 * t, by


def b1_check(ms, x, w, route=None):
    """Kernel against plain version on x, w: returns (max |y - y_plain|,
    worst s1 and s2 error relative to their scales below); raises on a miss
    of the tolerances or on results that differ between two runs. ``route``
    forces a kernel (matmul_stats._launch); None takes the wrapper's.

    The two sum the K products of each element in different orders in f32
    (and tf32x3 drops terms of some 2^-22 of each product), so their
    accumulators differ by up to some 1e-5 of P = |x| @ |w|.T, the sum of
    the products' magnitudes (not of |acc|: where the sum cancels, acc is
    far smaller than its terms). Tolerances: y float32 1e-5 P; bfloat16 one
    ulp of the larger magnitude plus 1e-5 P; s1 1e-5 sum_m P, s2 1e-5
    sum_m P^2, per column."""
    import torch

    def call():
        return (ms.matmul_stats(x, w) if route is None
                else ms._launch(x, w, route))
    y, s1, s2 = call()
    y2, t1, t2 = call()
    yr, r1, r2 = ms.matmul_stats_reference(x, w)
    torch.cuda.synchronize()
    shape = (x.shape[0], x.shape[1], w.shape[0], str(x.dtype), route)
    if not (torch.equal(y, y2) and torch.equal(s1, t1)
            and torch.equal(s2, t2)):
        raise SystemExit("matmul_stats %s: two runs differ" % (shape,))
    p = x.float().abs() @ w.float().abs().t()
    yf, yrf = y.float(), yr.float()
    diff = (yf - yrf).abs()
    allowed = 1e-5 * p
    if x.dtype == torch.bfloat16:
        mag = torch.maximum(yf.abs(), yrf.abs())
        allowed += torch.where(mag > 0, torch.exp2(torch.floor(torch.log2(
            mag.clamp_min(1e-30))) - 7), torch.zeros_like(mag))
    if bool((diff > allowed).any()):
        raise SystemExit("matmul_stats %s: y off by %g, beyond tolerance"
                         % (shape, float(diff.max())))
    e1 = float(((s1 - r1).abs() / p.sum(0).clamp_min(1e-30)).max())
    e2 = float(((s2 - r2).abs() / (p * p).sum(0).clamp_min(1e-30)).max())
    if e1 > 1e-5 or e2 > 1e-5:
        raise SystemExit("matmul_stats %s: statistics off by %g, %g of "
                         "sum P, sum P^2" % (shape, e1, e2))
    return float(diff.max()), e1, e2


def device_ms(fn, what):
    """Device milliseconds per call of ``fn`` summed by torch.profiler
    (kernel_ms); the profiler is asked up to three times. None, with a log
    line, when it records no device time."""
    for _ in range(3):
        t = kernel_ms(fn, reps=5)
        if t is not None:
            return t
    log("profile: no device time recorded for %s" % what)
    return None


def b1_routes_since(ms, before):
    return {r: ms.LAUNCHES_BY_ROUTE[r] - before[r] for r in before}


def b1_phase(seed, reps, card):
    import torch
    from mxnet_tpu_torch.ops import matmul_stats as ms
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)

    def operands(m, k, n, dtype):
        x = torch.randn((m, k), generator=gen, device=dev).to(dtype)
        w = (torch.randn((n, k), generator=gen, device=dev)
             / k ** 0.5).to(dtype)
        return x, w

    max_err = 0.0
    with no_tf32():
        # (dtype, shapes, route forced, the route every launch must take):
        # the float32 edge shapes on the SIMT kernel, forced where tf32x3
        # would take them
        edge_sets = [(torch.float32, B1_EDGE_SHAPES, "f32", "f32"),
                     (torch.bfloat16, B1_EDGE_SHAPES, None, None),
                     (torch.bfloat16, B1_WGMMA_EDGE_SHAPES, None, "wgmma"),
                     (torch.float32, B1_F32_TMA_EDGE_SHAPES, None, "tf32x3")]
        for dtype, shapes, force, want in edge_sets:
            worst = (0.0, 0.0, 0.0)
            before = dict(ms.LAUNCHES_BY_ROUTE)
            for m, k, n in shapes:
                errs = b1_check(ms, *operands(m, k, n, dtype), force)
                worst = tuple(max(a, b) for a, b in zip(worst, errs))
            routes = b1_routes_since(ms, before)
            max_err = max(max_err, worst[0])
            log("matmul_stats edge shapes %s, M in %s, K in %s, N in %s: "
                "max |y - plain| %g, s1 %g, s2 %g (of sum P, sum P^2), "
                "bitwise repeatable; launches by route %s"
                % (str(dtype).replace("torch.", ""),
                   sorted({sh[0] for sh in shapes}),
                   sorted({sh[1] for sh in shapes}),
                   sorted({sh[2] for sh in shapes}), *worst, routes))
            if want is not None and routes[want] != 2 * len(shapes):
                raise SystemExit("matmul_stats: %s edge shapes took routes "
                                 "%s" % (want, routes))
        keys = ("wgmma", "wmma", "torch.matmul", "plain")
        step = {"event": dict.fromkeys(keys, 0.0),
                "device": dict.fromkeys(keys, 0.0),
                "bound_ms": 0.0, "bytes_ms": 0.0}
        fell_back = []      # device times the profiler did not record
        for (m, k, n), count in B1_STEP_SHAPES.items():
            x, w = operands(m, k, n, torch.bfloat16)
            before = dict(ms.LAUNCHES_BY_ROUTE)
            err, e1, e2 = b1_check(ms, x, w)
            if b1_routes_since(ms, before)["wgmma"] != 2:
                raise SystemExit("matmul_stats (%d, %d, %d) did not take the "
                                 "wgmma route" % (m, k, n))
            max_err = max(max_err, err)
            fns = {"wgmma": lambda: ms.matmul_stats(x, w),
                   "wmma": lambda: ms._launch(x, w, "wmma"),
                   "torch.matmul": lambda: torch.matmul(x, w.t()),
                   "plain": lambda: ms.matmul_stats_reference(x, w)}
            # CUDA events around back-to-back calls, in turns (each kernel
            # timed twice, in the order a b c d d c b a); then the device
            # time the profiler sums over the calls' kernels
            event = dict.fromkeys(keys, 0.0)
            for name in keys + keys[::-1]:
                event[name] += cuda_time_ms(
                    fns[name], max(3, reps // 4) if name == "plain"
                    else reps) / 2
            device = {name: device_ms(fns[name], "%s at %s" % (
                name, (m, k, n))) for name in keys}
            for name in keys:
                if device[name] is None:
                    device[name] = event[name]
                    fell_back.append("%s at %s" % (name, (m, k, n)))
            bound, by = b1_bound_ms(m, k, n, "bf16")
            log("matmul_stats bf16 (M, K, N) = (%d, %d, %d) x%d: max |y - "
                "plain| %g, s1 %.3g, s2 %.3g (of sum P, sum P^2); device ms "
                "(profiler): wgmma %.6f, wmma %.6f, torch.matmul alone %.6f, "
                "plain %.6f; back to back (CUDA events): wgmma %.6f, wmma "
                "%.6f, torch.matmul %.6f, plain %.6f; bound %.6f ms (%s); "
                "wgmma/bound %.2f, roofline share bound/wgmma %.3f, "
                "wmma/bound %.2f [%s]"
                % (m, k, n, count, err, e1, e2, device["wgmma"],
                   device["wmma"], device["torch.matmul"], device["plain"],
                   event["wgmma"], event["wmma"], event["torch.matmul"],
                   event["plain"], bound, by, device["wgmma"] / bound,
                   bound / device["wgmma"], device["wmma"] / bound, card))
            for name in keys:
                step["event"][name] += count * event[name]
                step["device"][name] += count * device[name]
            step["bound_ms"] += count * bound
            if by == "bytes":
                step["bytes_ms"] += count * bound
            del x, w
    launches = sum(B1_STEP_SHAPES.values())
    dv, ev = step["device"], step["event"]
    log("matmul_stats per ResNet-50 step (%d launches), device ms: wgmma "
        "%.6f, wmma %.6f, torch.matmul alone %.6f, plain %.6f; back to "
        "back: wgmma %.6f, wmma %.6f, torch.matmul %.6f, plain %.6f; bound "
        "%.6f ms, roofline share of the wgmma kernel %.3f [%s]"
        % (launches, dv["wgmma"], dv["wmma"], dv["torch.matmul"],
           dv["plain"], ev["wgmma"], ev["wmma"], ev["torch.matmul"],
           ev["plain"], step["bound_ms"], step["bound_ms"] / dv["wgmma"],
           card))
    return {"name": "matmul_stats", "route": "cuda", "kernel_route": "wgmma",
            "source": "mxnet_tpu_torch/csrc/matmul_stats.cu",
            "replaces": "mxnet_tpu/ops/pallas_fused.py:49",
            "launches": None, "max_abs_err": max_err, "ms": dv["wgmma"],
            "ms_source": ("profiler" if not fell_back else
                          "profiler; CUDA events for " + ", ".join(fell_back)),
            "plain_ms": dv["plain"], "bound_ms": step["bound_ms"],
            "bound_by": ("bytes" if 2 * step["bytes_ms"] >= step["bound_ms"]
                         else "operations"),
            "library_ms": dv["torch.matmul"], "wmma_ms": dv["wmma"],
            "event_ms": ev["wgmma"], "wmma_event_ms": ev["wmma"],
            "library_event_ms": ev["torch.matmul"],
            "plain_event_ms": ev["plain"]}


# ---------------------------------------------------------------------------
# serve phase
# ---------------------------------------------------------------------------

def ssd_checkpoint(prefix, seed, ssd_input=None, **ssd_kw):
    """Full-width SSD inference symbol (``get_symbol(**ssd_kw)``, by
    default its defaults) + random weights from ``seed``, written through
    the port as prefix-symbol.json / prefix-0000.params."""
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch.models import ssd
    with mt.symbol.NameManager():
        net = ssd.get_symbol(**ssd_kw)
    arg_shapes, out_shapes, _ = net.infer_shape(
        data=(1,) + tuple(ssd_input or SSD_INPUT))
    rng = np.random.default_rng(seed)
    params = {}
    for name, shape in zip(net.list_arguments(), arg_shapes):
        if name == "data":
            continue
        if name.endswith("_weight"):
            fan_in = int(np.prod(shape[1:]))
            v = rng.standard_normal(shape) * np.sqrt(2.0 / fan_in)
        else:
            v = rng.standard_normal(shape) * 0.1
        params["arg:" + name] = mt.nd.array(v.astype(np.float32),
                                            ctx=mt.cpu())
    net.save(prefix + "-symbol.json")
    mt.nd.save(prefix + "-0000.params", params)
    nparam = sum(int(np.prod(v.shape)) for v in params.values())
    return net, nparam, out_shapes[0]


def serve_phase(seed, reps, card):
    import torch
    from mxnet_tpu_torch.ops import contrib, multibox_nms as mnms
    from mxnet_tpu_torch.serving import ServingEngine
    rng = np.random.default_rng(seed + 1)
    with tempfile.TemporaryDirectory() as tmp:
        prefix = os.path.join(tmp, "ssd")
        net, nparam, out_shape = ssd_checkpoint(prefix, seed)
        A = out_shape[1]
        log("ssd: get_symbol() defaults, input %s, %d parameters, %d anchors"
            % (SSD_INPUT, nparam, A))
        t0 = time.perf_counter()
        eng = ServingEngine(prefix + "-symbol.json", prefix + "-0000.params",
                            {"data": SSD_INPUT}, buckets=BUCKETS)
        heads = ServingEngine(
            prefix + "-symbol.json", prefix + "-0000.params",
            {"data": SSD_INPUT}, buckets=BUCKETS,
            output_names=["cls_prob", "multibox_loc_pred",
                          "multibox_anchors"])
        log("serve: two engines loaded on %s in %.3f s"
            % (eng.device, time.perf_counter() - t0))
        det_node = [n for n in _nodes(net) if n.name == "detection"][0]
        attrs = contrib._mbd_attrs(det_node.attrs)
        requests = {n: rng.random((n,) + SSD_INPUT, dtype=np.float32)
                    for n in REQUESTS}

        # the main path: counts at 0 just before, read just after
        mnms.reset_launches()
        batches0 = eng.health.batches
        served = {n: eng.infer({"data": x})[0] for n, x in requests.items()}
        launches = mnms.LAUNCHES
        routes = dict(mnms.LAUNCHES_BY_ROUTE)
        dispatched = eng.health.batches - batches0
        log("serve: requests %s -> %d bucket dispatches, multibox_nms "
            "launches %d (by route %s)" % (list(REQUESTS), dispatched,
                                           launches, routes))
        if launches != dispatched or routes["smem"] != dispatched:
            raise SystemExit("multibox_nms ran %d times (by route %s) for %d "
                             "dispatches; each should take the smem route"
                             % (launches, routes, dispatched))

        for n, det in served.items():
            if det.shape != (n, A, 6):
                raise SystemExit("request n=%d: detections %s, expected %s"
                                 % (n, det.shape, (n, A, 6)))
            if not np.isfinite(det).all():
                raise SystemExit("request n=%d: non-finite detections" % n)
            kept = int((det[:, :, 0] >= 0).sum())
            if kept == 0:
                raise SystemExit("request n=%d: no detection kept" % n)
            cls_prob, loc, anc = (torch.from_numpy(h).cuda() for h in
                                  heads.infer({"data": requests[n]}))
            with torch.inference_mode():
                plain = contrib.multibox_detection(
                    cls_prob, loc, anc[:1], nms=mnms.nms_alive_reference,
                    **attrs).cpu().numpy()
            if not np.array_equal(det, plain):
                bad = np.argwhere((det != plain).any(axis=2))
                raise SystemExit(
                    "request n=%d: served detections differ from the plain "
                    "NMS path in %d rows, first %s" % (n, len(bad),
                                                       bad[:5].tolist()))
            log("serve n=%d: output %s, %d rows kept, equal to the plain "
                "NMS path" % (n, det.shape, kept))

        lat = {}
        for b in BUCKETS:
            x = {"data": rng.random((b,) + SSD_INPUT, dtype=np.float32)}
            eng.infer(x)
            ts = []
            for _ in range(reps):
                t = time.perf_counter()
                eng.infer(x)
                ts.append(time.perf_counter() - t)
            lat[b] = 1e3 * float(np.median(ts))
            log("serve latency bucket %d: p50 %.3f ms over %d requests "
                "(host clock, input copy and output copy included) [%s]"
                % (b, lat[b], reps, card))
        log("serve throughput at b=32: %.1f images/s [%s]"
            % (32e3 / lat[32], card))
    return launches


# ---------------------------------------------------------------------------
# train phase
# ---------------------------------------------------------------------------

def fused_shapes(sym, dshape):
    """(M, K, N) -> count over the Conv1x1->BatchNorm pairs the port's
    fusion pass selects in ``sym`` at input shape ``dshape``."""
    from collections import Counter
    from mxnet_tpu_torch import executor
    inter = sym.get_internals()
    _, outs, _ = inter.infer_shape(data=dshape,
                                   softmax_label=(dshape[0],))
    shape_of = dict(zip(inter.list_outputs(), outs))
    convs, _ = executor.fusion_pairs(_nodes(sym))
    shapes = Counter()
    for node in convs.values():
        src, idx = node.inputs[0]
        b, h, w, c = shape_of[src.output_names()[idx]]
        shapes[(b * h * w, c, int(node.attrs["num_filter"]))] += 1
    return dict(shapes)


def clone_state(state):
    return {"params": {n: v.clone() for n, v in state["params"].items()},
            "aux": {n: v.clone() for n, v in state["aux"].items()},
            "opt": {n: (None if v is None else v.clone())
                    for n, v in state["opt"].items()},
            "step": state["step"].clone()}


def time_steps(fn, n):
    """Median host-clock seconds of ``n`` calls of ``fn``, each ended by a
    synchronize, after one warm-up call."""
    import torch
    fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(n):
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        ts.append(time.perf_counter() - t)
    return float(np.median(ts))


def _device_us(e):
    return float(getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0.0)))


def kernel_ms(fn, reps=3):
    """Milliseconds of device time per call of ``fn``, summed over its
    kernels by torch.profiler (host gaps between launches excluded); None
    when the profiler records no device time."""
    split = device_ms_by_kernel(fn, reps)
    return sum(split.values()) if split else None


def profile_step(fn, card, what="one fused step",
                 shares=(("matmul_stats", ("mm_stats", "reduce_partials",
                                           "split_tf32")),),
                 tries=4):
    """torch.profiler over one call of ``fn``: prints the ten CUDA kernels
    with the most device time and the share of the kernels named by each
    of ``shares`` (a label and substrings of their names, or a predicate
    over a name). A dropped kernel
    record (:func:`profiled_kernels`) changes the counts, so the call is
    profiled until two profiles in a row record every kernel the same
    number of times, at most ``tries`` times, and else prints no
    breakdown. (A profile of several calls cannot be held to the count
    rule: a step's first calls launch a copy or a convolution kernel once
    more or less than later ones.) Returns ``{"total": device ms, label:
    ms, ...}``, or None without a breakdown."""
    fn()
    fn()
    prev = None
    for _ in range(tries):
        kernels = profiled_kernels(fn, 1)
        counts = {e.key: e.count for e in kernels}
        if counts == prev:
            break
        prev = counts
    else:
        log("profile of %s: no two profiles in a row of %d recorded the "
            "same kernel counts; no breakdown [%s]" % (what, tries, card))
        return
    total = sum(_device_us(e) for e in kernels)
    if total == 0:
        log("profile: torch.profiler recorded no device time")
        return None
    def named(key, keys):
        return keys(key) if callable(keys) else any(k in key for k in keys)
    parts = {label: sum(_device_us(e) for e in kernels
                        if named(e.key, keys)) / 1e3
             for label, keys in shares}
    log("profile of %s (the same %d kernel launches as the profile "
        "before it): %d kernel names, %.3f ms of device time; %s [%s]"
        % (what, sum(counts.values()), len(kernels), total / 1e3,
           "; ".join("%s %.6f ms (%.2f%%)" % (label, ms, 1e5 * ms / total)
                     for label, ms in parts.items()), card))
    for e in sorted(kernels, key=_device_us, reverse=True)[:10]:
        log("  %8.3f ms %5.1f%% x%-5d %s" % (_device_us(e) / 1e3,
                                            100.0 * _device_us(e) / total,
                                            e.count, e.key[:100]))
    return dict(parts, total=total / 1e3, launches=sum(counts.values()))


def train_phase(seed, card):
    import torch
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch import models
    from mxnet_tpu_torch.ops import matmul_stats as ms
    from mxnet_tpu_torch.train_step import TrainStep, _metric_step_sums
    bsz, img = RESNET_BATCH, RESNET_IMAGE
    dshape = (bsz, img, img, 3)
    with mt.symbol.NameManager():
        sym = models.resnet(num_classes=RESNET_CLASSES, num_layers=50,
                            image_shape="3,%d,%d" % (img, img),
                            layout="NHWC")
    shapes = fused_shapes(sym, dshape)
    if shapes != B1_STEP_SHAPES:
        raise SystemExit("fusion pass selected %s, expected %s"
                         % (shapes, B1_STEP_SHAPES))
    steps = {}
    for mode in ("1", "0"):
        os.environ["MXTPU_FUSE_CONV_BN"] = mode
        steps[mode] = TrainStep(sym, optimizer="sgd", learning_rate=0.1,
                                momentum=0.9, wd=1e-4,
                                compute_dtype="bfloat16")
    os.environ["MXTPU_FUSE_CONV_BN"] = "1"
    fused, unfused = steps["1"], steps["0"]
    dev = fused.device
    t0 = time.perf_counter()
    state = fused.init({"data": dshape}, {"softmax_label": (bsz,)},
                       seed=seed)
    torch.cuda.synchronize()
    nparam = sum(v.numel() for v in state["params"].values())
    log("train: resnet-50 NHWC %dx%d, %d classes, %d parameters, state "
        "initialised on %s in %.2f s" % (img, img, RESNET_CLASSES, nparam,
                                         fused.device,
                                         time.perf_counter() - t0))
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 2)

    def batch():
        return {"data": torch.randn(dshape, generator=gen, device=dev),
                "softmax_label": torch.randint(
                    0, RESNET_CLASSES, (bsz,), generator=gen,
                    device=dev).float()}

    def loss_sum(outs, b):
        zero = torch.zeros((), device=dev)
        return float(_metric_step_sums(outs, [b["softmax_label"]], zero)[0])

    b0 = batch()
    twin = clone_state(state)
    # the main path: counts at 0 just before, read just after
    ms.reset_launches()
    state, outs_f = fused.step(state, b0)
    torch.cuda.synchronize()
    launches, copies = ms.LAUNCHES, ms.LAYOUT_COPIES
    routes = dict(ms.LAUNCHES_BY_ROUTE)
    log("train: one fused step launched matmul_stats %d times (by route "
        "%s), %d layout copies" % (launches, routes, copies))
    # checks are collected and raised at the end of the phase, so that a
    # failing run still prints its timings and profile
    problems = []
    expected = sum(B1_STEP_SHAPES.values())
    if launches != expected or copies or routes["wgmma"] != expected:
        problems.append("fused step: %d launches, %d on the wgmma route "
                        "(expected %d), %d copies"
                        % (launches, routes["wgmma"], expected, copies))
    twin, outs_u = unfused.step(twin, b0)
    torch.cuda.synchronize()
    if ms.LAUNCHES != launches:
        problems.append("the unfused step launched matmul_stats")
    lf, lu = loss_sum(outs_f, b0), loss_sum(outs_u, b0)
    excess = {n: float(((v - twin["aux"][n]).abs()
                        - (1e-3 + 2e-2 * twin["aux"][n].abs())).max())
              for n, v in state["aux"].items()}
    worst = max(excess, key=excess.get)
    max_err = max(float((v - twin["aux"][n]).abs().max())
                  for n, v in state["aux"].items())
    log("train: fused vs unfused step: loss sum %.6f vs %.6f (%.4f%% apart); "
        "BatchNorm moving statistics: max |fused - unfused| %g, closest to "
        "the tolerance (rtol 2e-2, atol 1e-3) %s with margin %g"
        % (lf, lu, 100 * abs(lf - lu) / abs(lu), max_err, worst,
           -excess[worst]))
    if not (np.isfinite(lf) and abs(lf - lu) <= 0.01 * abs(lu)):
        problems.append("fused and unfused loss sums disagree")
    if excess[worst] > 0:
        problems.append("fused and unfused moving statistics disagree")
    for st in (state, twin):
        for n, v in st["params"].items():
            if not bool(torch.isfinite(v).all()):
                problems.append("non-finite parameter %s" % n)

    k = 4
    sb = [batch() for _ in range(k)]
    superbatch = {n: torch.stack([b[n] for b in sb]) for n in sb[0]}
    for i in range(3):
        state, metrics = fused.run_steps(state, superbatch)
        log("train: run_steps K=%d dispatch %d: loss_avg %.4f, top-1 %d/%d"
            % (k, i, metrics.loss_avg, metrics.top1_correct,
               metrics.num_samples))
        if not np.isfinite(metrics.loss_sum):
            problems.append("run_steps: non-finite loss")

    b1 = batch()
    reps = 5
    timings = (("fused step", reps, time_steps(lambda: fused.step(state, b1),
                                                reps)),
               ("unfused step", reps,
                time_steps(lambda: unfused.step(twin, b1), reps)),
               ("fused run_steps K=%d, per step" % k, 2,
                time_steps(lambda: fused.run_steps(state, superbatch)[1]
                           .fetch(), 2) / k))
    for what, n, t in timings:
        log("train: %s %.3f ms, %.1f images/s (host clock, median of %d) "
            "[%s]" % (what, 1e3 * t, bsz / t, n, card))
    STEP_FIGURES["fused_ips"] = bsz / timings[0][2]
    log("train: peak device memory %.2f GiB"
        % (torch.cuda.max_memory_allocated() / 2 ** 30))
    profiles = {"unguarded": profile_step(lambda: fused.step(state, b1),
                                          card)}
    # phase 14's guarded and remat steps, profiled here for their device
    # time: after phase 8 the profiler drops kernel records
    profiles["guarded"] = profile_step(
        lambda: fused.step(state, b1, guard=True), card,
        "one guarded fused step")
    for mode in (True, "conv"):
        rs = TrainStep(sym, optimizer="sgd", learning_rate=0.1,
                       momentum=0.9, wd=1e-4, compute_dtype="bfloat16",
                       remat=mode)
        profiles["remat %r" % (mode,)] = profile_step(
            lambda: rs.step(state, b1), card,
            "one fused step with remat=%r" % (mode,))
    # the float32 step that Module.fit runs (phase 10), profiled here:
    # after phase 8 the profiler has dropped kernel records
    f32 = TrainStep(sym, optimizer="sgd", learning_rate=0.1, momentum=0.9,
                    wd=1e-4)
    st32 = f32.init({"data": dshape}, {"softmax_label": (bsz,)}, seed=seed)
    with no_tf32(), deterministic_cudnn():
        profile_step(lambda: f32.step(st32, b1), card,
                     "one fused float32 step (TF32 off)")
    if problems:
        raise SystemExit("train phase failed: " + "; ".join(problems))
    return launches, {k: v and v["total"] for k, v in profiles.items()}


# ---------------------------------------------------------------------------
# rtc phase (B3): user kernels through TritonKernel and Rtc
# ---------------------------------------------------------------------------

#: sizes phase 7 runs the user kernels at: the JAX package's test shape, a
#: ragged size and ResNet-50's parameter count
RTC_SIZES = ((8, 128), (1000003,), (25557032,))
RTC_BLOCK = 256

#: CUDA bodies for Rtc (decorated with the arrays' names and dims)
_RTC_N = ("int i = blockIdx.x * blockDim.x + threadIdx.x;\n"
          "int n = 1;\n"
          "for (int d = 0; d < {x}_ndim; ++d) n *= {x}_dims[d];\n")
RTC_SCALE = _RTC_N.format(x="x") + "if (i < n) y[i] = 2.0f * x[i];"
RTC_ADDMUL = _RTC_N.format(x="a") + "if (i < n) o[i] = a[i] * b[i] + a[i];"
#: MXNet's SGD with momentum, hp = [lr, momentum, wd, rescale_grad, size]:
#: the size is data, so one kernel serves arrays of every shape
RTC_SGD = ("int i = blockIdx.x * blockDim.x + threadIdx.x;\n"
           "const int n = (int)hp[4];\n"
           "if (i < n) {\n"
           "  float m = hp[1] * mom[i] - hp[0] * (hp[3] * g[i] + hp[2] * w[i]);\n"
           "  mom[i] = m;\n"
           "  w[i] = w[i] + m;\n"
           "}")

#: the bind phase's update (MXNet's sgd_mom_update)
SGD = dict(lr=0.1, momentum=0.9, wd=1e-4, rescale_grad=1.0 / RESNET_BATCH)
#: two backward passes over the same state agree within this fraction of
#: the array's largest gradient: with cuDNN's deterministic algorithms the
#: max-pooling backward's atomic adds may still sum in another order
GRAD_TOL = 1e-4

_TRITON = {}


def triton_kernels():
    """The user Triton kernels, wrapped in rtc.TritonKernel (built once,
    at the first call): scale(x, n) -> 2x, addmul(a, b, n) -> a*b + a,
    sgd_mom(w, g, m, n, lr, momentum, wd, rescale) -> (w', m'); and the
    raw scale kernel with its grid, for a direct launch."""
    if _TRITON:
        return _TRITON
    import triton
    import triton.language as tl
    from mxnet_tpu_torch import rtc

    @triton.jit
    def scale(x_ptr, n, o_ptr, BLOCK: tl.constexpr):
        offs = tl.program_id(0) * BLOCK + tl.arange(0, BLOCK)
        m = offs < n
        tl.store(o_ptr + offs, tl.load(x_ptr + offs, mask=m) * 2.0, mask=m)

    @triton.jit
    def addmul(a_ptr, b_ptr, n, o_ptr, BLOCK: tl.constexpr):
        offs = tl.program_id(0) * BLOCK + tl.arange(0, BLOCK)
        m = offs < n
        a = tl.load(a_ptr + offs, mask=m)
        b = tl.load(b_ptr + offs, mask=m)
        tl.store(o_ptr + offs, a * b + a, mask=m)

    @triton.jit
    def sgd_mom(w_ptr, g_ptr, m_ptr, n, lr, momentum, wd, rescale,
                w_out, m_out, BLOCK: tl.constexpr):
        offs = tl.program_id(0) * BLOCK + tl.arange(0, BLOCK)
        msk = offs < n
        w = tl.load(w_ptr + offs, mask=msk)
        g = tl.load(g_ptr + offs, mask=msk)
        mom = tl.load(m_ptr + offs, mask=msk)
        new = momentum * mom - lr * (rescale * g + wd * w)
        tl.store(m_out + offs, new, mask=msk)
        tl.store(w_out + offs, w + new, mask=msk)

    def grid(meta):
        return (triton.cdiv(meta["n"], meta["BLOCK"]),)

    _TRITON.update(
        scale=rtc.TritonKernel(scale, out_like=0, grid=grid, BLOCK=1024),
        addmul=rtc.TritonKernel(addmul, out_like=0, grid=grid, BLOCK=1024),
        sgd_mom=rtc.TritonKernel(sgd_mom, out_like=[0, 2], grid=grid,
                                 BLOCK=1024),
        raw_scale=scale, grid=grid)
    return _TRITON


def rtc_grid(n):
    return ((n + RTC_BLOCK - 1) // RTC_BLOCK,), (RTC_BLOCK,)


def addmul_excess(got, a, b):
    """How far |got - (a*b + a)| exceeds one float32 ulp of |a*b| + |a|
    (<= 0 within the tolerance): fma contraction rounds once where the
    plain version rounds twice. Returns (excess, max |diff|)."""
    import torch
    diff = (got - (a * b + a)).abs()
    allowed = 2.0 ** -23 * ((a * b).abs() + a.abs())
    return float((diff - allowed).max()), float(diff.max())


def must_raise(fn, what):
    """``fn`` must raise MXNetError; prints its message."""
    from mxnet_tpu_torch.base import MXNetError
    try:
        fn()
    except MXNetError as e:
        log("rtc: %s raises: %s" % (what, str(e).splitlines()[0][:160]))
        return
    raise SystemExit("rtc: %s did not raise" % what)


def host_us(fn, n=2000):
    """Host microseconds per call of ``fn`` (enqueue only: no synchronize
    inside the loop), after a warm-up call."""
    import torch
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(n):
        fn()
    dt = time.perf_counter() - t
    torch.cuda.synchronize()
    return 1e6 * dt / n


def rtc_phase(seed, reps, card):
    import ctypes
    import torch
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch import rtc
    nd = mt.nd
    dev = mt.gpu(0).to_device()
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 3)
    tk = triton_kernels()
    err = {"cuda": 0.0, "triton": 0.0}
    t0 = time.perf_counter()
    for shape in RTC_SIZES:
        n = int(np.prod(shape))
        x, a, b = (torch.randn(shape, generator=gen, device=dev)
                   for _ in range(3))
        X, A, B = nd.NDArray(x), nd.NDArray(a), nd.NDArray(b)
        y = nd.zeros(shape, ctx=mt.gpu(0))
        o = nd.zeros(shape, ctx=mt.gpu(0))
        grid, block = rtc_grid(n)
        rtc.Rtc("scale", [("x", X)], [("y", y)], RTC_SCALE).push(
            [X], [y], grid, block)
        rtc.Rtc("addmul", [("a", A), ("b", B)], [("o", o)],
                RTC_ADDMUL).push([A, B], [o], grid, block)
        ty = tk["scale"](X, n)
        to = tk["addmul"](A, B, n)
        torch.cuda.synchronize()
        for route, ys, os_ in (("cuda", y, o), ("triton", ty, to)):
            if not torch.equal(ys.data, x * 2.0):
                raise SystemExit("rtc %s scale %s differs from 2x" % (route,
                                                                      shape))
            excess, diff = addmul_excess(os_.data, a, b)
            if excess > 0:
                raise SystemExit("rtc %s addmul %s: off by %g, past one ulp "
                                 "of |a*b| + |a|" % (route, shape, diff))
            err[route] = max(err[route], diff)
            log("rtc %s %s: scale equal to 2x; addmul max |kernel - plain| "
                "%g, within one ulp of |a*b| + |a|" % (route, shape, diff))
    log("rtc: first calls (NVRTC and Triton builds included) %.2f s"
        % (time.perf_counter() - t0))

    # a write into a first-axis slice changes that slice of the parent only
    parent = nd.NDArray(torch.randn((6, 1000), generator=gen, device=dev))
    before = parent.data.clone()
    src = nd.NDArray(torch.randn((2, 1000), generator=gen, device=dev))
    view = parent[2:4]
    grid, block = rtc_grid(2000)
    rtc.Rtc("scale", [("x", src)], [("y", view)], RTC_SCALE).push(
        [src], [view], grid, block)
    torch.cuda.synchronize()
    want = before.clone()
    want[2:4] = 2.0 * src.data
    if not torch.equal(parent.data, want):
        raise SystemExit("rtc: a push into parent[2:4] did not change "
                         "exactly rows 2:4 of the parent")
    log("rtc: a push into parent[2:4] of a (6, 1000) array changed exactly "
        "those rows")

    x = nd.NDArray(torch.randn((8, 128), generator=gen, device=dev))
    y = nd.zeros((8, 128), ctx=mt.gpu(0))
    k = rtc.Rtc("scale", [("x", x)], [("y", y)], RTC_SCALE)
    must_raise(lambda: k.push([x.astype("float16")], [y], (4,), (256,)),
               "a float16 array")
    must_raise(lambda: k.push([x.copyto(mt.cpu())], [y], (4,), (256,)),
               "a CPU array")
    must_raise(lambda: k.push([x], [y], (1,), (2048,)),
               "a 2048-thread block")
    must_raise(lambda: tk["scale"](x.copyto(mt.cpu()), 1024),
               "TritonKernel on a CPU array without a reference")

    # times at ResNet-50's parameter count, beside the bound
    n = RTC_SIZES[-1][0]
    x, a, b = (torch.randn((n,), generator=gen, device=dev)
               for _ in range(3))
    X, A, B = nd.NDArray(x), nd.NDArray(a), nd.NDArray(b)
    Y, O = nd.zeros((n,), ctx=mt.gpu(0)), nd.zeros((n,), ctx=mt.gpu(0))
    ks = rtc.Rtc("scale", [("x", X)], [("y", Y)], RTC_SCALE)
    ka = rtc.Rtc("addmul", [("a", A), ("b", B)], [("o", O)], RTC_ADDMUL)
    grid, block = rtc_grid(n)
    for name, nbytes, cases in (
            ("scale", 8 * n, (
                ("Rtc", lambda: ks.push([X], [Y], grid, block)),
                ("TritonKernel", lambda: tk["scale"](X, n)),
                ("plain x * 2.0", lambda: x * 2.0),
                ("torch.mul", lambda: torch.mul(x, 2.0)))),
            ("addmul", 12 * n, (
                ("Rtc", lambda: ka.push([A, B], [O], grid, block)),
                ("TritonKernel", lambda: tk["addmul"](A, B, n)),
                ("plain a * b + a", lambda: a * b + a),
                ("torch.addcmul", lambda: torch.addcmul(a, a, b))))):
        bound = 1e3 * nbytes / HBM_BYTES_PER_S
        times = {what: cuda_time_ms(fn, reps) for what, fn in cases}
        log("rtc %s at %d float32: %s; bound %.6f ms (bytes) [%s]"
            % (name, n, ", ".join("%s %.6f ms" % kv for kv in times.items()),
               bound, card))

    # the wrappers' own host cost, beside direct launches, at (8, 128), in
    # turns; with it the ways a push could take the stream handle, and a
    # push whose arrays change every call
    xs = nd.NDArray(torch.randn((8, 128), generator=gen, device=dev))
    ys = nd.zeros((8, 128), ctx=mt.gpu(0))
    os_ = torch.empty((8, 128), device=dev)
    small = rtc.Rtc("scale", [("x", xs)], [("y", ys)], RTC_SCALE)
    small.push([xs], [ys], (4,), (RTC_BLOCK,))
    ctx, _mod, fn = small._function(dev.index)
    drv = rtc._lib("driver")
    ptrs = [ctypes.c_void_p(xs.data.data_ptr()),
            ctypes.c_void_p(ys.data.data_ptr())]
    params = (ctypes.c_void_p * 2)(*[ctypes.addressof(p) for p in ptrs])
    stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)
    dims = (ctypes.c_uint * 6)(4, 1, 1, RTC_BLOCK, 1, 1)
    launcher = rtc._launcher()[0]
    pool = [(nd.NDArray(torch.randn((8, 128), generator=gen, device=dev)),
             nd.zeros((8, 128), ctx=mt.gpu(0))) for _ in range(8)]
    turn = iter(range(10 ** 9))

    def fresh_push():
        x, y = pool[next(turn) % len(pool)]
        small.push([x], [y], (4,), (RTC_BLOCK,))

    raw, grid_fn = tk["raw_scale"], tk["grid"]
    fns = {
        "Rtc.push": lambda: small.push([xs], [ys], (4,), (RTC_BLOCK,)),
        "Rtc.push, new arrays every call": fresh_push,
        "cuLaunchKernel through ctypes": lambda: drv.cuLaunchKernel(
            fn, 4, 1, 1, RTC_BLOCK, 1, 1, 0, stream, params, None),
        "rtc_launch (C) through ctypes": lambda: launcher(fn, ctx, dims,
                                                          stream, params),
        "TritonKernel.__call__": lambda: tk["scale"](xs, 1024),
        "direct Triton launch": lambda: raw[grid_fn](xs.data, 1024, os_,
                                                     BLOCK=1024),
        "direct Triton launch, its output allocated": lambda: raw[grid_fn](
            xs.data, 1024, torch.empty((8, 128), device=dev), BLOCK=1024),
        "stream: torch.accelerator.current_stream(i).native_handle":
            lambda: torch.accelerator.current_stream(0).native_handle,
        "stream: torch.cuda.current_stream(i).cuda_stream":
            lambda: torch.cuda.current_stream(0).cuda_stream,
    }
    host = host_costs(fns)
    torch.cuda.synchronize()
    for x, y in pool:
        if not torch.equal(y.data, 2.0 * x.data):
            raise SystemExit("rtc: a push with new arrays every call did not "
                             "land in that call's arrays")
    ratios = {"Rtc.push": host["Rtc.push"]
              / host["cuLaunchKernel through ctypes"],
              "TritonKernel.__call__": host["TritonKernel.__call__"]
              / host["direct Triton launch"]}
    log("rtc host cost per call at (8, 128), median of 5 rounds in turns: "
        "%s; Rtc.push / cuLaunchKernel %.2f, TritonKernel / direct Triton "
        "%.2f (%.2f against the direct launch that allocates its output, as "
        "TritonKernel does); the pushes with new arrays every call landed in "
        "those arrays [%s]"
        % (", ".join("%s %.2f us" % kv for kv in host.items()),
           ratios["Rtc.push"], ratios["TritonKernel.__call__"],
           host["TritonKernel.__call__"]
           / host["direct Triton launch, its output allocated"], card))
    # the ratios of the launch path before its redesign (3.3 and 2.1 on an
    # H100 80GB HBM3 at 700 W): a wrapper may not come back above them
    if ratios["Rtc.push"] > 3.3 or ratios["TritonKernel.__call__"] > 2.1:
        raise SystemExit("rtc: wrapper host cost ratios %s past those before "
                         "the launch path's redesign (3.3, 2.1)" % ratios)
    return err, host


def host_costs(fns, rounds=5, n=2000):
    """Median host microseconds a call of each of ``fns``, timed in turns
    (the order reversed every other round)."""
    got = {name: [] for name in fns}
    for r in range(rounds):
        for name in (list(fns) if r % 2 == 0 else list(fns)[::-1]):
            got[name].append(host_us(fns[name], n))
    return {name: float(np.median(v)) for name, v in got.items()}


# ---------------------------------------------------------------------------
# bind phase: ResNet-50 bound with simple_bind, trained by hand
# ---------------------------------------------------------------------------

def rtc_update(kernel, params, grads, moms, hps):
    """The SGD-momentum update of every parameter through one Rtc kernel,
    one push per array, in place."""
    for n, w in params.items():
        grid, block = rtc_grid(w.size)
        kernel.push([grads[n], hps[n]], [w, moms[n]], grid, block)


def triton_update(kernel, params, grads, moms):
    """The same update through one TritonKernel, one launch per array; the
    arrays are rebound to its outputs."""
    for n, w in params.items():
        new_w, new_m = kernel(w, grads[n], moms[n], w.size, SGD["lr"],
                              SGD["momentum"], SGD["wd"],
                              SGD["rescale_grad"])
        w._set_data(new_w.data)
        moms[n]._set_data(new_m.data)


def plain_update(params, grads, moms):
    """nd.sgd_mom_update over every array (the plain version)."""
    import mxnet_tpu_torch as mt
    for n, w in params.items():
        mt.nd.sgd_mom_update(w, grads[n], moms[n], out=[w, moms[n]], **SGD)


def update_excess(w, m, w0, g, m0):
    """How far a kernel's (w, m) from (w0, g, m0) exceeds the stated bound
    around nd.sgd_mom_update's result: the new momentum within 2 float32
    ulps of |momentum*m0| + lr*(rescale*|g| + wd*|w0|) (fma contraction of
    the two products skips up to two roundings), the weight within that
    plus one ulp of |w0| + |m|. Returns (excess, max |diff|) over w and m."""
    import torch
    import mxnet_tpu_torch as mt
    W, M = mt.nd.NDArray(w0.clone()), mt.nd.NDArray(m0.clone())
    mt.nd.sgd_mom_update(W, mt.nd.NDArray(g), M, out=[W, M], **SGD)
    ulp = 2.0 ** -23
    mag = (SGD["momentum"] * m0.abs() + SGD["lr"] * (
        SGD["rescale_grad"] * g.abs() + SGD["wd"] * w0.abs()))
    dm = (m - M.data).abs()
    dw = (w - W.data).abs()
    excess = max(float((dm - 2 * ulp * mag).max()),
                 float((dw - 2 * ulp * mag - ulp * (w0.abs() + m.abs()))
                       .max()))
    return excess, max(float(dm.max()), float(dw.max()))


def scaled_excess(got, want, frac):
    """max |got - want| over ``frac`` times the array's largest |want|
    (a ratio <= 1 passes)."""
    return float((got - want).abs().max()) / max(
        frac * float(want.abs().max()), 1e-30)


def bind_phase(seed, reps, card):
    import torch
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch import initializer, models, rtc
    from mxnet_tpu_torch.train_step import TrainStep
    nd = mt.nd
    dev = mt.gpu(0).to_device()
    bsz, img = RESNET_BATCH, RESNET_IMAGE
    dshape = (bsz, 3, img, img)
    torch.cuda.reset_peak_memory_stats()
    with mt.symbol.NameManager():
        sym = models.resnet(num_classes=RESNET_CLASSES, num_layers=50,
                            image_shape="3,%d,%d" % (img, img),
                            layout="NCHW")
    data_names = ("data", "softmax_label")
    pnames = [n for n in sym.list_arguments() if n not in data_names]
    req = {n: ("null" if n in data_names else "write")
           for n in sym.list_arguments()}
    problems = []
    # the checks with cuDNN's deterministic algorithms, the times without
    with no_tf32(), deterministic_cudnn():
        t0 = time.perf_counter()
        exe = sym.simple_bind(mt.gpu(0), grad_req=req, data=dshape,
                              softmax_label=(bsz,))
        attrs = sym.attr_dict()
        saved = mt.random.get_state()
        mt.random.seed(seed)
        init = initializer.Xavier()
        for n in pnames + exe.aux_names:
            init(initializer.InitDesc(n, attrs.get(n, {})),
                 exe.arg_dict[n] if n in exe.arg_dict else exe.aux_dict[n])
        mt.random.set_state(saved)
        params = {n: exe.arg_dict[n] for n in pnames}
        grads = {n: exe.grad_dict[n] for n in pnames}
        nparam = sum(w.size for w in params.values())
        torch.cuda.synchronize()
        log("bind: resnet-50 NCHW %dx%d b=%d float32 bound with simple_bind "
            "on %s in %.2f s: %d parameter arrays (%d values), %d aux states"
            % (img, img, bsz, exe._device, time.perf_counter() - t0,
               len(pnames), nparam, len(exe.aux_names)))
        if (len(pnames), nparam, len(exe.aux_names)) != (161, 25557032, 106):
            raise SystemExit("bind: expected 161 arrays, 25,557,032 values "
                             "and 106 aux states")
        w0 = {n: w.data.clone() for n, w in params.items()}
        aux0 = {n: a.data.clone() for n, a in exe.aux_dict.items()}
        moms = {n: nd.zeros(w.shape, ctx=mt.gpu(0)) for n, w in
                params.items()}
        hps = {n: nd.array([SGD["lr"], SGD["momentum"], SGD["wd"],
                            SGD["rescale_grad"], w.size], ctx=mt.gpu(0))
               for n, w in params.items()}
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed + 4)
        batches = [{"data": torch.randn(dshape, generator=gen, device=dev),
                    "softmax_label": torch.randint(
                        0, RESNET_CLASSES, (bsz,), generator=gen,
                        device=dev).float()} for _ in range(2)]
        first = pnames[0]
        k_rtc = rtc.Rtc("sgd_mom", [("g", grads[first]), ("hp", hps[first])],
                        [("w", params[first]), ("mom", moms[first])],
                        RTC_SGD)
        k_tri = triton_kernels()["sgd_mom"]

        # grad_req="add": two backward passes give twice one
        exe_add = sym.bind(
            mt.gpu(0), exe.arg_dict,
            args_grad={n: nd.zeros(params[n].shape, ctx=mt.gpu(0))
                       for n in pnames},
            grad_req={n: ("add" if n in pnames else "null")
                      for n in sym.list_arguments()},
            aux_states={n: nd.NDArray(a.clone()) for n, a in aux0.items()})
        exe_add.forward(is_train=True, **batches[0])
        exe_add.backward()
        once = {n: g.data.clone() for n, g in exe_add.grad_dict.items()}
        exe_add.backward()
        worst_add = max(scaled_excess(exe_add.grad_dict[n].data, 2 * g,
                                      GRAD_TOL) for n, g in once.items())
        del exe_add
        log("bind: grad_req='add' after two backward passes: max |g - 2 g1| "
            "is %.3g of the tolerance (%g of the array's largest gradient)"
            % (worst_add, GRAD_TOL))
        if worst_add > 1:
            problems.append("grad_req='add' over two passes is not twice "
                            "the gradient")

        # the main path: two steps, counts at 0 just before, read just after
        rtc.RTC_LAUNCHES = 0
        rtc.TRITON_LAUNCHES = 0
        exe.forward(is_train=True, **batches[0])
        exe.backward()
        g1 = {n: g.data.clone() for n, g in grads.items()}
        rtc_update(k_rtc, params, grads, moms, hps)
        w1 = {n: w.data.clone() for n, w in params.items()}
        m1 = {n: m.data.clone() for n, m in moms.items()}
        aux1 = {n: a.data.clone() for n, a in exe.aux_dict.items()}
        exe.forward(is_train=True, **batches[1])
        exe.backward()
        g2 = {n: g.data.clone() for n, g in grads.items()}
        triton_update(k_tri, params, grads, moms)
        torch.cuda.synchronize()
        launches = {"cuda": rtc.RTC_LAUNCHES, "triton": rtc.TRITON_LAUNCHES}
        log("bind: two steps launched the Rtc update %d times and the "
            "TritonKernel update %d times" % (launches["cuda"],
                                             launches["triton"]))
        if launches != {"cuda": 161, "triton": 161}:
            problems.append("expected 161 launches of each update")
        for step, g in ((1, g1), (2, g2)):
            bad = [n for n, v in g.items() if not bool(torch.isfinite(v)
                                                       .all())]
            if bad:
                problems.append("step %d: non-finite gradients %s"
                                % (step, bad[:3]))
        worst_write = max(scaled_excess(g1[n], once[n], GRAD_TOL)
                          for n in pnames)
        log("bind: step-1 gradients against the grad_req='add' executor's "
            "first pass: %.3g of the tolerance" % worst_write)
        if worst_write > 1:
            problems.append("write and add gradients differ")

        # each update against nd.sgd_mom_update on the same tensors
        err = {}
        for route, (wa, ma, wb, gb, mb) in (
                ("cuda", (w1, m1, w0, g1, None)),
                ("triton", ({n: p.data for n, p in params.items()},
                            {n: m.data for n, m in moms.items()},
                            w1, g2, m1))):
            ex, diff = 0.0, 0.0
            for n in pnames:
                e, d = update_excess(wa[n], ma[n], wb[n], gb[n],
                                     torch.zeros_like(wb[n]) if mb is None
                                     else mb[n])
                ex, diff = max(ex, e), max(diff, d)
            err[route] = diff
            log("bind: %s update of step %d against nd.sgd_mom_update: max "
                "|diff| %g, %s the stated ulp bound" % (
                    "Rtc" if route == "cuda" else "TritonKernel",
                    1 if route == "cuda" else 2, diff,
                    "within" if ex <= 0 else "PAST"))
            if ex > 0:
                problems.append("%s update differs from nd.sgd_mom_update"
                                % route)

        # the Rtc update of step 1 captured once into a CUDA graph after a
        # warm eager update, replayed from a fresh copy of step 1's start
        gw = {n: nd.NDArray(w0[n].clone()) for n in pnames}
        gm = {n: nd.zeros(w0[n].shape, ctx=mt.gpu(0)) for n in pnames}
        gg = {n: nd.NDArray(g1[n].clone()) for n in pnames}
        rtc_update(k_rtc, gw, gg, gm, hps)
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            rtc_update(k_rtc, gw, gg, gm, hps)
        for n in pnames:
            gw[n].data.copy_(w0[n])
            gm[n].data.zero_()
        graph.replay()
        torch.cuda.synchronize()
        same = all(torch.equal(gw[n].data, w1[n]) and
                   torch.equal(gm[n].data, m1[n]) for n in pnames)
        ex = max(update_excess(gw[n].data, gm[n].data, w0[n], g1[n],
                               torch.zeros_like(w0[n]))[0] for n in pnames)
        log("bind: the Rtc update captured in a CUDA graph (161 kernels) and "
            "replayed from step 1's start %s the eager Rtc update bit for "
            "bit, %s the stated ulp bound around nd.sgd_mom_update"
            % ("equals" if same else "DIFFERS from",
               "within" if ex <= 0 else "PAST"))
        if not same or ex > 0:
            problems.append("the captured Rtc update differs from the eager "
                            "one")

        # the same two steps through TrainStep from the same state
        ts = TrainStep(sym, optimizer="sgd", learning_rate=SGD["lr"],
                       momentum=SGD["momentum"], wd=SGD["wd"],
                       compute_dtype=None)
        st = ts.init({"data": dshape}, {"softmax_label": (bsz,)}, seed=seed)
        finals = ({n: p.data for n, p in params.items()},
                  {n: m.data for n, m in moms.items()},
                  {n: a.data for n, a in exe.aux_dict.items()})
        starts = ((w0, None, aux0), (w1, m1, aux1))
        for step, (wb, mb, ab) in ((1, (w1, m1, aux1)), (2, finals)):
            # each step from the state the bind step started from
            sw, sm, sa = starts[step - 1]
            for n in pnames:
                st["params"][n].copy_(sw[n])
                st["opt"][n].copy_(0 if sm is None else sm[n])
            for n in exe.aux_names:
                st["aux"][n].copy_(sa[n])
            ts.step(st, batches[step - 1])
            torch.cuda.synchronize()
            # tolerances: weights and momenta within 1e-3 of the array's
            # largest momentum (the step's size), as pooling's backward
            # may still sum in another order and the user kernels contract
            # into fmas; moving statistics within 1e-5 of the array's
            # largest value
            rw = max(float((wb[n] - st["params"][n]).abs().max())
                     / max(1e-3 * float(st["opt"][n].abs().max()), 1e-30)
                     for n in pnames)
            rm = max(scaled_excess(mb[n], st["opt"][n], 1e-3) for n in pnames)
            ra = max(scaled_excess(ab[n], st["aux"][n], 1e-5)
                     for n in exe.aux_names)
            log("bind: after step %d against TrainStep(compute_dtype=None): "
                "weights %.3g, momenta %.3g (of 1e-3 of the largest "
                "momentum), moving statistics %.3g (of 1e-5 of the largest)"
                % (step, rw, rm, ra))
            if max(rw, rm, ra) > 1:
                problems.append("step %d differs from TrainStep" % step)

    with no_tf32():
        def bind_step():
            exe.forward(is_train=True, **batches[0])
            exe.backward()
            rtc_update(k_rtc, params, grads, moms, hps)

        t_bind = time_steps(bind_step, reps)
        t_ts = time_steps(lambda: ts.step(st, batches[0]), reps)
        for what, t in (("bind step (forward, backward, Rtc update)",
                         t_bind), ("TrainStep float32 step", t_ts)):
            log("bind: %s %.3f ms, %.1f images/s (host clock, median of "
                "%d) [%s]" % (what, 1e3 * t, bsz / t, reps, card))
        ws = {n: nd.NDArray(w.data.clone()) for n, w in params.items()}
        ms_ = {n: nd.NDArray(m.data.clone()) for n, m in moms.items()}
        fns = {"Rtc": lambda: rtc_update(k_rtc, ws, grads, ms_, hps),
               "TritonKernel": lambda: triton_update(k_tri, ws, grads, ms_),
               "plain nd.sgd_mom_update": lambda: plain_update(ws, grads,
                                                               ms_)}
        if hasattr(torch, "_fused_sgd_"):
            wl = [w.data for w in ws.values()]
            gl = [grads[n].data for n in ws]
            ml = [m.data for m in ms_.values()]
            fns["torch._fused_sgd_"] = lambda: torch._fused_sgd_(
                wl, gl, ml, weight_decay=SGD["wd"],
                momentum=SGD["momentum"], lr=SGD["lr"], dampening=0.0,
                nesterov=False, maximize=False, is_first_step=False)
        log("bind: torch._fused_sgd_ is one call over the 161 arrays; its "
            "momentum buffer differs by a factor lr, so it is a yardstick "
            "of time only")
        # back to back on CUDA events, in turns, the graph replay among them
        fns_ev = dict(fns, **{"Rtc captured, graph.replay()": graph.replay})
        event = dict.fromkeys(fns_ev, 0.0)
        for name in list(fns_ev) + list(fns_ev)[::-1]:
            event[name] += cuda_time_ms(fns_ev[name], 10) / 2
        host_upd = {"Rtc": host_us(fns["Rtc"], 20),
                    "TritonKernel": host_us(fns["TritonKernel"], 20)}
        nbytes = 5 * 4 * nparam + 4 * 5 * len(pnames)
        bound = 1e3 * nbytes / HBM_BYTES_PER_S
        log("bind: update of 161 arrays, CUDA-event time (launches back to "
            "back, host gaps included): %s; bound %.6f ms (%d bytes) [%s]"
            % (", ".join("%s %.6f ms" % kv for kv in event.items()), bound,
               nbytes, card))
        kern = {k: kernel_ms(f) for k, f in fns.items()}
        log("bind: update of 161 arrays, kernel time summed by "
            "torch.profiler: %s [%s]" % (", ".join(
                "%s %s" % (k, "not recorded" if v is None else "%.6f ms" % v)
                for k, v in kern.items()), card))
        upd = kern if all(v is not None for v in kern.values()) else event
        if upd is event:
            log("bind: the profiler recorded no device time: the kernels "
                "line reports CUDA-event times")
        log("bind: host time of one update (161 launches): Rtc %.1f us, "
            "TritonKernel %.1f us [%s]" % (host_upd["Rtc"],
                                           host_upd["TritonKernel"], card))
        log("bind: peak device memory %.2f GiB"
            % (torch.cuda.max_memory_allocated() / 2 ** 30))
        profile_step(bind_step, card, "one bind step",
                     (("the Rtc update", ("sgd_mom",)),))
    if problems:
        raise SystemExit("bind phase failed: " + "; ".join(problems))
    return launches, err, upd, event, bound


# ---------------------------------------------------------------------------
# imperative phase: nd, autograd and a CustomOp on the card
# ---------------------------------------------------------------------------

_RTC_OPS = {}


def register_rtc_custom_op():
    """A CustomOp (y = 2x) whose forward and backward push Rtc kernels."""
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch import rtc

    def push_scale(src, dst):
        k = _RTC_OPS.get(src.shape)
        if k is None:
            k = _RTC_OPS[src.shape] = rtc.Rtc("scale", [("x", src)],
                                              [("y", dst)], RTC_SCALE)
        grid, block = rtc_grid(src.size)
        k.push([src], [dst], grid, block)

    class RtcScale(mt.operator.CustomOp):
        def forward(self, is_train, req, in_data, out_data, aux):
            push_scale(in_data[0], out_data[0])

        def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
            push_scale(out_grad[0], in_grad[0])

    @mt.operator.register("chip_smoke_rtc_scale")
    class RtcScaleProp(mt.operator.CustomOpProp):
        def declare_backward_dependency(self, out_grad, in_data, out_data):
            return list(out_grad)

        def create_operator(self, ctx, shapes, dtypes):
            return RtcScale()


def imperative_phase(seed, card):
    import torch
    import mxnet_tpu_torch as mt
    nd = mt.nd
    rng = np.random.default_rng(seed + 5)
    gpu, cpu = mt.gpu(0), mt.cpu()
    problems = []
    with no_tf32():
        # nd on the card against the CPU, within 1e-5 of (1 + the result's
        # largest |value|): the CUDA and CPU kernels sum reductions and dot
        # products in other orders, so the error scales with the terms
        worst, worst_op = 0.0, None
        ops = {"arith": lambda x, y: (x + y) * 2 - y / 3,
               "pow": lambda x, y: x ** 2, "rsub": lambda x, y: 1 - x,
               "exp": lambda x, y: nd.exp(x) / (nd.abs(y) + 1),
               "sum": lambda x, y: nd.sum(x, axis=1),
               "max": lambda x, y: nd.max(y, axis=0),
               "mean": lambda x, y: nd.mean(x),
               "norm": lambda x, y: nd.norm(x),
               "dot": lambda x, y: nd.dot(x, y, transpose_b=True),
               "argmax": lambda x, y: nd.argmax(x, axis=1),
               "topk": lambda x, y: nd.topk(y, k=2), "sort": lambda x, y:
               nd.sort(x), "clip": lambda x, y: nd.clip(x, a_min=-0.5,
                                                        a_max=0.5)}
        for shape in ((3, 4), (17, 33), (64, 257)):
            a = rng.standard_normal(shape).astype(np.float32)
            b = rng.standard_normal(shape).astype(np.float32)
            for name, op in ops.items():
                g = op(nd.array(a, ctx=gpu), nd.array(b, ctx=gpu))
                c = op(nd.array(a, ctx=cpu), nd.array(b, ctx=cpu)).asnumpy()
                if g.context != gpu:
                    problems.append("nd.%s's result left the card" % name)
                r = float(np.abs(g.asnumpy() - c).max()) / (
                    1e-5 * (1 + float(np.abs(c).max())))
                if r > worst:
                    worst, worst_op = r, "%s at %s" % (name, shape)
        log("imperative: nd arithmetic and reductions at 3 shapes on the "
            "card against the CPU: %.3g of the tolerance (closest: %s)"
            % (worst, worst_op))
        if worst > 1:
            problems.append("nd on the card differs from the CPU")

        # autograd of a two-layer network against Executor.backward
        x = rng.standard_normal((8, 20)).astype(np.float32)
        vals = {"fc1_weight": rng.standard_normal((32, 20)) * 0.2,
                "fc1_bias": rng.standard_normal((32,)) * 0.1,
                "fc2_weight": rng.standard_normal((10, 32)) * 0.2,
                "fc2_bias": rng.standard_normal((10,)) * 0.1}
        og = rng.standard_normal((8, 10)).astype(np.float32)
        ps = [nd.array(vals[n], ctx=gpu) for n in sorted(vals)]
        gs = [nd.zeros(p.shape, ctx=gpu) for p in ps]
        mt.autograd.mark_variables(ps, gs)
        fc1_b, fc1_w, fc2_b, fc2_w = ps
        with mt.autograd.train_section():
            h = nd.Activation(nd.FullyConnected(nd.array(x, ctx=gpu), fc1_w,
                                                fc1_b, num_hidden=32),
                              act_type="relu")
            out = nd.FullyConnected(h, fc2_w, fc2_b, num_hidden=10)
        mt.autograd.compute_gradient([out], [nd.array(og, ctx=gpu)])
        with mt.symbol.NameManager():
            s = mt.sym.FullyConnected(mt.sym.Variable("data"), num_hidden=32,
                                      name="fc1")
            s = mt.sym.Activation(s, act_type="relu")
            s = mt.sym.FullyConnected(s, num_hidden=10, name="fc2")
        args = {n: nd.array(v, ctx=gpu) for n, v in vals.items()}
        args["data"] = nd.array(x, ctx=gpu)
        eg = {n: nd.zeros(a.shape, ctx=gpu) for n, a in args.items()
              if n != "data"}
        ex = s.bind(gpu, args, args_grad=eg)
        ex.forward(is_train=True)
        ex.backward([nd.array(og, ctx=gpu)])
        # the same cuBLAS products on the same tensors: rtol 1e-6
        worst = max(float(np.abs(g.asnumpy() - eg[n].asnumpy()).max()
                          / (1e-6 * np.abs(eg[n].asnumpy()).max()))
                    for g, n in zip(gs, sorted(vals)))
        log("imperative: autograd gradients of a two-layer network against "
            "Executor.backward on the card: %.3g of the tolerance" % worst)
        if worst > 1:
            problems.append("autograd and Executor gradients differ")

        # a CustomOp pushing Rtc kernels, against _mul_scalar
        register_rtc_custom_op()
        data = rng.standard_normal((8, 20)).astype(np.float32)
        res = []
        for use_rtc in (True, False):
            with mt.symbol.NameManager():
                s = mt.sym.FullyConnected(mt.sym.Variable("data"),
                                          num_hidden=16, name="fc1")
                s = (mt.sym.Custom(s, op_type="chip_smoke_rtc_scale")
                     if use_rtc else mt.sym._mul_scalar(s, scalar=2.0))
                s = mt.sym.FullyConnected(s, num_hidden=4, name="fc2")
            ex = s.simple_bind(gpu, data=(8, 20))
            for n, a in ex.arg_dict.items():
                a[:] = data if n == "data" else np.full(a.shape, 0.1,
                                                        np.float32)
            before = mt.rtc.RTC_LAUNCHES
            out = ex.forward(is_train=True)[0].asnumpy()
            ex.backward([nd.ones((8, 4), ctx=gpu)])
            res.append((out, {n: g.asnumpy() for n, g in ex.grad_dict.items()},
                        mt.rtc.RTC_LAUNCHES - before))
        (o1, g1, l1), (o2, g2, _) = res
        same = np.array_equal(o1, o2) and all(np.array_equal(g1[n], g2[n])
                                              for n in g2)
        log("imperative: a CustomOp pushing Rtc kernels (%d pushes) inside a "
            "bound symbol %s the same network with _mul_scalar"
            % (l1, "equals" if same else "DIFFERS from"))
        if not same or l1 != 2:
            problems.append("the Rtc CustomOp differs from _mul_scalar")
    if problems:
        raise SystemExit("imperative phase failed: " + "; ".join(problems))


# ---------------------------------------------------------------------------
# module phase: ResNet-50 trained through Module.fit, and ResNet-50 served
# ---------------------------------------------------------------------------

#: batches and epochs of the module phase's fits, and the steps per
#: dispatch in (b)
MODULE_BATCHES = 8
MODULE_EPOCHS = 2
MODULE_K = 4
#: the SGD hyper-parameters of the module phase
MODULE_OPT = (("learning_rate", 0.1), ("momentum", 0.9), ("wd", 1e-4))
#: trained parameters and moving statistics, fit against a TrainStep driven
#: by hand: |a - b| <= MODULE_RTOL |b| + MODULE_ATOL elementwise
MODULE_RTOL, MODULE_ATOL = 1e-4, 1e-5
#: the fits' cross-entropy sums (float32 on the host and on the card)
#: against the hand-driven step's, taken in float64
METRIC_CE_RTOL = 1e-5


def xavier_params(sym, dshape, seed, label_shapes=None):
    """Xavier ``arg_params`` of ``sym`` on the host, from ``seed`` (the
    port's initializer on CPU tensors; BatchNorm gamma 1, beta 0).
    ``label_shapes``: the label inputs (default ``softmax_label``, one a
    sample)."""
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch import initializer
    label_shapes = label_shapes or {"softmax_label": (dshape[0],)}
    shapes, _, _ = sym.infer_shape(data=dshape, **label_shapes)
    attrs = sym.attr_dict()
    saved = mt.random.get_state()
    mt.random.seed(seed)
    init = initializer.Xavier()
    params = {}
    for n, shape in zip(sym.list_arguments(), shapes):
        if n == "data" or n in label_shapes:
            continue
        params[n] = mt.nd.zeros(shape, ctx=mt.cpu())
        init(initializer.InitDesc(n, attrs.get(n, {})), params[n])
    mt.random.set_state(saved)
    return params


def max_excess(got, want):
    """(largest relative difference max|a - b| / max|b| over the tensors,
    largest excess over MODULE_RTOL |b| + MODULE_ATOL); both infinite when
    either side holds a NaN or an infinity."""
    import torch
    rel = excess = 0.0
    for n, b in want.items():
        a = got[n].float()
        b = b.float()
        if not bool(torch.isfinite(a).all() and torch.isfinite(b).all()):
            return float("inf"), float("inf")
        d = (a - b).abs()
        rel = max(rel, float(d.max()) / max(float(b.abs().max()), 1e-30))
        excess = max(excess, float(
            (d - MODULE_RTOL * b.abs() - MODULE_ATOL).max()))
    return rel, excess


def module_phase(seed, card):
    import torch
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch import models
    from mxnet_tpu_torch.callback import Speedometer
    from mxnet_tpu_torch.model import BatchEndParam
    from mxnet_tpu_torch.ops import matmul_stats as ms
    from mxnet_tpu_torch.train_step import TrainStep
    bsz, img, nb = RESNET_BATCH, RESNET_IMAGE, MODULE_BATCHES
    dshape = (bsz, img, img, 3)
    dev = mt.gpu(0).to_device()
    os.environ["MXTPU_FUSE_CONV_BN"] = "1"
    with mt.symbol.NameManager():
        sym = models.resnet(num_classes=RESNET_CLASSES, num_layers=50,
                            image_shape="3,%d,%d" % (img, img),
                            layout="NHWC")
    t0 = time.perf_counter()
    rng = np.random.default_rng(seed + 6)
    images = rng.standard_normal((nb * bsz,) + dshape[1:], dtype=np.float32)
    labels = rng.integers(0, RESNET_CLASSES, nb * bsz).astype(np.float32)
    arg_params = xavier_params(sym, dshape, seed)
    log("module: resnet-50 NHWC %dx%d b=%d float32, %d host batches and "
        "Xavier arg_params from the seed in %.2f s"
        % (img, img, bsz, nb, time.perf_counter() - t0))
    problems = []
    epochs = MODULE_EPOCHS
    expected = sum(B1_STEP_SHAPES.values()) * nb * epochs
    fits = {}
    with no_tf32(), deterministic_cudnn():
        for name, k in (("a", 1), ("b", MODULE_K)):
            it = mt.io.NDArrayIter(images, labels, batch_size=bsz,
                                   shuffle=False)
            metric = mt.metric.CompositeEvalMetric(
                [mt.metric.Accuracy(), mt.metric.CrossEntropy()])
            mod = mt.mod.Module(sym, context=mt.gpu(0))
            speedo = Speedometer(bsz, frequent=MODULE_K)
            ends, accs = [], []

            def on_batch(param, speedo=speedo):
                # the speed line without resetting the metric under check
                speedo(BatchEndParam(param.epoch, param.nbatch, None,
                                     param.locals))

            def on_epoch(epoch, *_, metric=metric, ends=ends, accs=accs):
                torch.cuda.synchronize()
                ends.append(time.perf_counter())
                accs.append([(m.sum_metric, m.num_inst)
                             for m in metric.metrics])
            torch.cuda.synchronize()
            # the main path: counts at 0 just before, read just after
            ms.reset_launches()
            t0 = time.perf_counter()
            mod.fit(it, num_epoch=epochs, eval_metric=metric, optimizer="sgd",
                    optimizer_params=MODULE_OPT, arg_params=arg_params,
                    steps_per_dispatch=k, dispatch_pipeline=1,
                    batch_end_callback=on_batch, epoch_end_callback=on_epoch)
            torch.cuda.synchronize()
            routes = dict(ms.LAUNCHES_BY_ROUTE)
            first, steady = ends[0] - t0, ends[1] - ends[0]
            spec = mod._fused_metric_spec
            fits[name] = {"mod": mod, "accs": accs, "routes": routes,
                          "step_ms": 1e3 * steady / nb,
                          "device_sums": spec is not None and spec.tag}
            log("module (%s) Module.fit steps_per_dispatch=%d, %d epochs of "
                "%d batches: epoch 0 %.3f s, %.1f images/s (bind, init and "
                "the first step included); epoch 1 %.3f s, %.1f images/s, "
                "%.3f ms a step (host clock, each epoch ended by a "
                "synchronize); metric device sums: %s; matmul_stats "
                "launches by route %s [%s]"
                % (name, k, epochs, nb, first, nb * bsz / first, steady,
                   nb * bsz / steady, 1e3 * steady / nb,
                   fits[name]["device_sums"], routes, card))
            if routes != {"wgmma": 0, "wmma": 0, "tf32x3": expected,
                          "f32": 0}:
                problems.append("fit (%s): matmul_stats routes %s, expected "
                                "%d tf32x3" % (name, routes, expected))

        # check 1: a TrainStep driven by hand over the same batches
        opt = mt.optimizer.create(
            "sgd", sym=sym, rescale_grad=1.0 / bsz,
            param_idx2name=dict(enumerate(
                fits["a"]["mod"]._exec_group.param_names)),
            **dict(MODULE_OPT))
        step = TrainStep(sym, optimizer=opt, device=dev)
        state = step.init({"data": dshape}, {"softmax_label": (bsz,)},
                          seed=seed)
        for n, v in arg_params.items():
            state["params"][n].copy_(v.data)
        # the metric's sums by epoch from the hand-driven step's outputs:
        # correct top-1 and the cross-entropy sum (float64, eps 1e-8)
        lab = torch.from_numpy(labels).to(dev).long()
        hand = torch.zeros((epochs, 2), dtype=torch.float64, device=dev)
        t0 = None
        for i in range(epochs * nb):
            if i == nb:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
            j = i % nb
            state, outs = step.step(state, {
                "data": images[j * bsz:(j + 1) * bsz],
                "softmax_label": labels[j * bsz:(j + 1) * bsz]})
            p, y = outs[0].double(), lab[j * bsz:(j + 1) * bsz]
            hand[i // nb, 0] += (p.argmax(1) == y).sum()
            hand[i // nb, 1] -= torch.log(p.gather(1, y[:, None])
                                          + 1e-8).sum()
        torch.cuda.synchronize()
        step_ms = 1e3 * (time.perf_counter() - t0) / ((epochs - 1) * nb)
        log("module: the same batches through TrainStep.step alone (host "
            "batches, as fit's k=1 path gets them): %.3f ms a step, %.1f "
            "images/s after the first epoch; Module.fit's epoch 1 took "
            "%+.3f ms a step more at k=1 and %+.3f at k=%d [%s]"
            % (step_ms, 1e3 * bsz / step_ms, fits["a"]["step_ms"] - step_ms,
               fits["b"]["step_ms"] - step_ms, MODULE_K, card))
        want = dict(state["params"], **state["aux"])
        for name in ("a", "b"):
            arg, aux = fits[name]["mod"].get_params()
            got = {n: v.data for n, v in dict(arg, **aux).items()}
            rel, excess = max_excess(got, want)
            log("module check 1 (%s): parameters and moving statistics after "
                "fit against a TrainStep driven by hand over the same %d "
                "steps: largest relative difference %g (tolerance rtol %g, "
                "atol %g elementwise)" % (name, epochs * nb, rel,
                                          MODULE_RTOL, MODULE_ATOL))
            if excess > 0:
                problems.append("fit (%s) differs from the hand-driven "
                                "TrainStep beyond the tolerance, or is not "
                                "finite" % name)
        # check 2: the host metric (a) against the device sums (b), and
        # both against the sums of the hand-driven step's outputs
        ref = [(float(c), float(ce)) for c, ce in hand.tolist()]
        for name in ("a", "b"):
            got = fits[name]["accs"]
            log("module check 2 (%s): (correct, count) and (cross-entropy "
                "sum, count) by epoch %s; from the hand-driven TrainStep's "
                "outputs (correct, cross-entropy sum) %s"
                % (name, got, ref))
            for (correct, n), (ce, n_ce), (rc, rce) in zip(
                    [e[0] for e in got], [e[1] for e in got], ref):
                if (n, n_ce) != (nb * bsz, nb * bsz) or correct != rc \
                        or not abs(ce - rce) <= METRIC_CE_RTOL * abs(rce):
                    problems.append(
                        "fit (%s) metric sums %s differ from the "
                        "hand-driven step's %s (correct to the count, "
                        "cross-entropy within rtol %g)"
                        % (name, got, ref, METRIC_CE_RTOL))
                    break
        if [e[0] for e in fits["a"]["accs"]] \
                != [e[0] for e in fits["b"]["accs"]]:
            problems.append("accuracy differs across k")
        if fits["a"]["device_sums"] or fits["b"]["device_sums"] != "acc+ce":
            problems.append("the metric took the device sums in (a) or "
                            "not in (b): %s, %s"
                            % (fits["a"]["device_sums"],
                               fits["b"]["device_sums"]))

        # check 4: a checkpoint round trip on the card
        mod = fits["b"]["mod"]
        it = mt.io.NDArrayIter(images, labels, batch_size=bsz)
        with tempfile.TemporaryDirectory() as tmp:
            prefix = os.path.join(tmp, "resnet50")
            mod.save_checkpoint(prefix, 1, save_optimizer_states=True)
            loaded = mt.mod.Module.load(prefix, 1, load_optimizer_states=True,
                                        context=mt.gpu(0))
            loaded.bind(it.provide_data, it.provide_label)
            loaded.init_optimizer(optimizer="sgd",
                                  optimizer_params=MODULE_OPT)
        score = dict(mod.score(it, ["acc", "ce"]))
        score_loaded = dict(loaded.score(it, ["acc", "ce"]))
        mod._sync_fused_opt_states()
        moms_equal = all(
            torch.equal(loaded._updater.states[i].data.cpu(), st.data.cpu())
            for i, st in mod._updater.states.items())
        log("module check 4: save_checkpoint + Module.load on the card: "
            "score %s, trained module's %s; momentum equal: %s"
            % (score_loaded, score, moms_equal))
        if score_loaded != score or not moms_equal:
            problems.append("the loaded checkpoint scores %s, the trained "
                            "module %s (momentum equal: %s)"
                            % (score_loaded, score, moms_equal))
        del loaded, fits

        # check 3: at each shape the tf32x3 route and the SIMT f32 kernel
        # (forced) against the plain version; their times a step against
        # torch.matmul f32 and the plain version, each against its bound
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed + 7)
        keys = ("tf32x3", "f32", "torch.matmul f32", "plain")
        per_step = dict.fromkeys(keys, 0.0)
        bound_step = {"tf32x3": 0.0, "f32": 0.0, "bytes": 0.0}
        max_err = 0.0
        for (m, kk, n), count in B1_STEP_SHAPES.items():
            x = torch.randn((m, kk), generator=gen, device=dev)
            w = torch.randn((n, kk), generator=gen, device=dev) / kk ** 0.5
            before = dict(ms.LAUNCHES_BY_ROUTE)
            err, e1, e2 = b1_check(ms, x, w)
            simt = b1_check(ms, x, w, "f32")
            took = b1_routes_since(ms, before)
            if (took["tf32x3"], took["f32"]) != (2, 2):
                problems.append("matmul_stats f32 %s took routes %s"
                                % ((m, kk, n), took))
            max_err = max(max_err, err, simt[0])
            fns = {"tf32x3": lambda: ms.matmul_stats(x, w),
                   "f32": lambda: ms._launch(x, w, "f32"),
                   "torch.matmul f32": lambda: torch.matmul(x, w.t()),
                   "plain": lambda: ms.matmul_stats_reference(x, w)}
            # CUDA events around back-to-back calls, in turns (a b c d d c
            # b a): at 0.09-1.3 ms a launch the wrapper's host time hides
            # under the kernel. (The profiler loses kernel records after the
            # bind phase: device_ms_by_kernel)
            ev = dict.fromkeys(keys, 0.0)
            for key in keys + keys[::-1]:
                ev[key] += cuda_time_ms(fns[key], 5) / 2
            bound, by = b1_bound_ms(m, kk, n, "tf32x3")
            simt_bound = b1_bound_ms(m, kk, n, "f32")[0]
            log("matmul_stats f32 (M, K, N) = (%d, %d, %d) x%d: max |y - "
                "plain| %g (tf32x3), %g (f32), s1 %.3g, s2 %.3g (tf32x3); "
                "ms (CUDA events, back to back, in turns): tf32x3 %.6f, f32 "
                "SIMT %.6f, torch.matmul f32 (TF32 off) %.6f, plain %.6f; "
                "tf32x3 bound %.6f ms (%s), share %.3f; FP32 SIMT bound "
                "%.6f ms [%s]"
                % (m, kk, n, count, err, simt[0], e1, e2, ev["tf32x3"],
                   ev["f32"], ev["torch.matmul f32"], ev["plain"], bound,
                   by, bound / ev["tf32x3"], simt_bound, card))
            for key in keys:
                per_step[key] += count * ev[key]
            bound_step["tf32x3"] += count * bound
            bound_step["f32"] += count * simt_bound
            if by == "bytes":
                bound_step["bytes"] += count * bound
            del x, w
        log("matmul_stats float32 per ResNet-50 step (%d launches), ms (CUDA "
            "events, in turns): tf32x3 %.6f, f32 SIMT %.6f, torch.matmul "
            "f32 %.6f, plain %.6f; tf32x3 bound %.6f ms (3xTF32 at %.0f "
            "TFLOP/s, HBM %.2f TB/s), share %.3f; FP32 SIMT bound %.6f ms "
            "(%.0f TFLOP/s), f32 SIMT share %.3f [%s]"
            % (sum(B1_STEP_SHAPES.values()), per_step["tf32x3"],
               per_step["f32"], per_step["torch.matmul f32"],
               per_step["plain"], bound_step["tf32x3"],
               TF32_OPS_PER_S / 1e12, HBM_BYTES_PER_S / 1e12,
               bound_step["tf32x3"] / per_step["tf32x3"], bound_step["f32"],
               FP32_OPS_PER_S / 1e12, bound_step["f32"] / per_step["f32"],
               card))
        if not per_step["tf32x3"] < min(per_step["f32"], per_step["plain"]):
            problems.append("the tf32x3 route (%.6f ms a step) is not below "
                            "the SIMT f32 route (%.6f) and the plain version "
                            "(%.6f)" % (per_step["tf32x3"], per_step["f32"],
                                        per_step["plain"]))

        # a step's device time, fused against unfused
        os.environ["MXTPU_FUSE_CONV_BN"] = "0"
        unfused = TrainStep(sym, optimizer=opt, device=dev)
        os.environ["MXTPU_FUSE_CONV_BN"] = "1"
        batch = {"data": torch.from_numpy(images[:bsz]).to(dev),
                 "softmax_label": torch.from_numpy(labels[:bsz]).to(dev)}
        twin = clone_state(state)
        step_ms = {"fused": cuda_time_ms(lambda: step.step(state, batch), 3),
                   "unfused": cuda_time_ms(lambda: unfused.step(twin, batch),
                                           3)}
        log("module: one float32 TrainStep step, CUDA events around 3 back "
            "to back (the card sets their pace): fused (MXTPU_FUSE_CONV_BN=1) "
            "%.3f ms, unfused %.3f ms [%s]"
            % (step_ms["fused"], step_ms["unfused"], card))
    if problems:
        raise SystemExit("module phase failed: " + "; ".join(problems))
    return {"name": "matmul_stats_f32", "route": "cuda",
            "kernel_route": "tf32x3",
            "source": "mxnet_tpu_torch/csrc/matmul_stats.cu",
            "replaces": "mxnet_tpu/ops/pallas_fused.py:49",
            "launches": 2 * expected, "max_abs_err": max_err,
            "ms": per_step["tf32x3"], "ms_source": "cuda_events",
            "plain_ms": per_step["plain"],
            "bound_ms": bound_step["tf32x3"],
            "bound_by": ("bytes" if 2 * bound_step["bytes"]
                         >= bound_step["tf32x3"] else "operations"),
            "library_ms": per_step["torch.matmul f32"],
            "simt_ms": per_step["f32"], "simt_bound_ms": bound_step["f32"]}


def resnet_serve_phase(seed, reps, card):
    """ResNet-50 (NCHW, 3x224x224, 1000 classes) served through
    ServingEngine on the card, buckets (1, 8, 32): the outputs are finite
    probabilities, and the p50 latency per bucket."""
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch import models
    from mxnet_tpu_torch.serving import ServingEngine
    shape = (3, RESNET_IMAGE, RESNET_IMAGE)
    with mt.symbol.NameManager():
        sym = models.resnet(num_classes=RESNET_CLASSES, num_layers=50,
                            image_shape="3,%d,%d" % shape[1:])
    params = xavier_params(sym, (1,) + shape, seed)
    _, _, aux_shapes = sym.infer_shape(data=(1,) + shape)
    aux = {n: (mt.nd.ones if n.endswith("_var") else mt.nd.zeros)(
        sh, ctx=mt.cpu()) for n, sh in zip(sym.list_auxiliary_states(),
                                           aux_shapes)}
    rng = np.random.default_rng(seed + 8)
    with tempfile.TemporaryDirectory() as tmp:
        prefix = os.path.join(tmp, "resnet50")
        mt.model.save_checkpoint(prefix, 0, sym, params, aux)
        eng = ServingEngine(prefix + "-symbol.json", prefix + "-0000.params",
                            {"data": shape}, buckets=BUCKETS)
    for n in (1, 5, 8, 32):
        out = eng.infer({"data": rng.random((n,) + shape,
                                            dtype=np.float32)})[0]
        sums = out.sum(axis=1)
        if (out.shape != (n, RESNET_CLASSES) or not np.isfinite(out).all()
                or np.abs(sums - 1).max() > 1e-4):
            raise SystemExit("resnet-50 serve n=%d: output %s, finite %s, "
                             "row sums off by %g" % (
                                 n, out.shape, np.isfinite(out).all(),
                                 np.abs(sums - 1).max()))
    for b in BUCKETS:
        x = {"data": rng.random((b,) + shape, dtype=np.float32)}
        eng.infer(x)
        ts = []
        for _ in range(reps):
            t = time.perf_counter()
            eng.infer(x)
            ts.append(time.perf_counter() - t)
        log("resnet-50 serve bucket %d: p50 %.3f ms over %d requests (host "
            "clock, input copy and output copy included) [%s]"
            % (b, 1e3 * float(np.median(ts)), reps, card))


# ---------------------------------------------------------------------------
# ssd train phase: the full-width SSD trained through Module.fit, with B2 in
# every training step
# ---------------------------------------------------------------------------

#: phase 12: SSD (models/ssd.get_symbol_train defaults) at batch 32, host
#: batches an epoch, epochs, steps a dispatch in (b), and the Adam settings
#: of example/ssd/train.py
SSD_TRAIN_CLASSES = 4
SSD_TRAIN_BATCH = 32
SSD_TRAIN_BATCHES = 4
SSD_TRAIN_EPOCHS = 2
SSD_TRAIN_K = 4
SSD_TRAIN_OPT = {"learning_rate": 1e-3, "rescale_grad": 1.0}
SSD_TRAIN_OBJECTS = 3
#: the packed MultiBoxMetric device sums against the host metric over the
#: same outputs
SSD_METRIC_RTOL = 1e-5
#: the kernels of an SSD training step whose share the profile reports
SSD_STEP_SHARES = (("multibox_nms (B2)", ("nms_cluster", "nms_mask",
                                          "nms_sweep")),
                   ("sort, scatter and gather (MultiBoxTarget, "
                    "MultiBoxDetection)", ("sort", "Sort", "scatter",
                                           "gather")),
                   ("convolution (cuDNN's GEMM, FFT and wgrad kernels)",
                    ("cudnn", "xmma", "fft", "pointwise_mult_and_sum",
                     "region_transform", "implicit_gemm", "convolve")))

_COLORS = np.array([[220, 40, 40], [40, 220, 40], [40, 40, 220],
                    [220, 220, 40]], np.float32)


def synth_det_batch(rng, n, size, num_classes, max_obj=SSD_TRAIN_OBJECTS):
    """Images of coloured rectangles on noise and their (class, x1, y1,
    x2, y2) labels, -1 padded: example/ssd/train.py's synthetic scenes."""
    imgs = np.full((n, 3, size, size), 110, np.float32)
    imgs += rng.normal(0, 12, imgs.shape).astype(np.float32)
    labels = -np.ones((n, max_obj, 5), np.float32)
    for i in range(n):
        for o in range(rng.integers(1, max_obj + 1)):
            k = int(rng.integers(0, num_classes))
            w = rng.uniform(0.25, 0.55)
            h = rng.uniform(0.25, 0.55)
            x1 = rng.uniform(0, 1 - w)
            y1 = rng.uniform(0, 1 - h)
            px1, py1 = int(x1 * size), int(y1 * size)
            px2, py2 = int((x1 + w) * size), int((y1 + h) * size)
            imgs[i, :, py1:py2, px1:px2] = _COLORS[k][:, None, None]
            labels[i, o] = [k, x1, y1, x1 + w, y1 + h]
    imgs = (imgs - 110.0) / 60.0
    return imgs, labels


def ssd_train_setup(seed, nbatch):
    """The training symbol, ``nbatch`` host batches of synthetic scenes
    and Xavier arg_params, all from ``seed``."""
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch.models import ssd
    with mt.symbol.NameManager():
        sym = ssd.get_symbol_train(num_classes=SSD_TRAIN_CLASSES)
    bsz = SSD_TRAIN_BATCH
    images, labels = synth_det_batch(np.random.default_rng(seed + 9),
                                     nbatch * bsz, SSD_INPUT[1],
                                     SSD_TRAIN_CLASSES)
    params = xavier_params(sym, (bsz,) + SSD_INPUT, seed,
                           {"label": (bsz, SSD_TRAIN_OBJECTS, 5)})
    return sym, images, labels, params


def conv_train_flops(sym, shapes):
    """Operations (2 x multiply-adds) of the convolutions of one training
    step of ``sym`` at input ``shapes``, from the shapes: the forward, the
    weight gradient, and the data gradient of every convolution whose
    input is not a graph input."""
    from mxnet_tpu_torch.base import attr_int, attr_tuple
    inter = sym.get_internals()
    _, outs, _ = inter.infer_shape(**shapes)
    shape_of = dict(zip(inter.list_outputs(), outs))
    total = 0
    for node in _nodes(sym):
        if node.is_variable or node.op.name != "Convolution":
            continue
        src, idx = node.inputs[0]
        cin = shape_of[src.output_names()[idx]][1]
        n, cout, h, w = shape_of[node.output_names()[0]]
        kh, kw = attr_tuple(node.attrs["kernel"], typ=int)
        groups = attr_int(node.attrs.get("num_group", 1), 1)
        fwd = 2 * n * cout * h * w * (cin // groups) * kh * kw
        total += fwd * (2 if src.is_variable else 3)
    return total


def ssd_train_profile(seed, card):
    """One SSD training step (TrainStep, Adam, b=32, float32, TF32 off)
    profiled: run beside phase 6, before phase 8, after which the profiler
    drops kernel records. Returns profile_step's numbers, or None."""
    import torch
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch.train_step import TrainStep
    sym, images, labels, params = ssd_train_setup(seed, 1)
    step = TrainStep(sym, data_names=("data",), label_names=("label",),
                     optimizer=mt.optimizer.create(
                         "adam", sym=sym, **SSD_TRAIN_OPT))
    state = step.init({"data": images.shape}, {"label": labels.shape},
                      seed=seed)
    for n, v in params.items():
        state["params"][n].copy_(v.data)
    batch = {"data": torch.from_numpy(images).to(step.device),
             "label": torch.from_numpy(labels).to(step.device)}
    with no_tf32(), deterministic_cudnn():
        return profile_step(lambda: step.step(state, batch), card,
                            "one SSD training step (b=32, 3x300x300, "
                            "Adam, float32)", SSD_STEP_SHARES)


def _multibox_sums(metric):
    """(cross-entropy sum, smooth-L1 sum, valid count) of a
    MultiBoxMetric, as Python floats."""
    return (float(metric.sum_metric[0]), float(metric.sum_metric[1]),
            float(metric.num_inst[0]))


def ssd_train_phase(seed, card, profile, ckpt_prefix):
    """Phase 12 (see the module docstring); fit (a)'s module is saved
    through ``save_checkpoint(ckpt_prefix, 1)`` for phase 13's hot
    reload."""
    import torch
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch.ops import contrib, multibox_nms as mnms
    from mxnet_tpu_torch.train_step import TrainStep
    bsz, nb, epochs = SSD_TRAIN_BATCH, SSD_TRAIN_BATCHES, SSD_TRAIN_EPOCHS
    dev = mt.gpu(0).to_device()
    t0 = time.perf_counter()
    sym, images, labels, arg_params = ssd_train_setup(seed, nb)
    dshape, lshape = (bsz,) + SSD_INPUT, (bsz, SSD_TRAIN_OBJECTS, 5)
    nparam = sum(int(np.prod(v.shape)) for v in arg_params.values())
    _, out_shapes, _ = sym.infer_shape(data=dshape, label=lshape)
    anchors = out_shapes[2][1]
    log("ssd train: get_symbol_train() defaults (%d classes, width 32, "
        "nms_topk 400), %d parameters, %d anchors; %d host batches of %d "
        "and Xavier arg_params from the seed in %.2f s"
        % (SSD_TRAIN_CLASSES, nparam, anchors, nb, bsz,
           time.perf_counter() - t0))
    problems = []
    steps = nb * epochs
    fits = {}
    with no_tf32(), deterministic_cudnn():
        for name, k in (("a", 1), ("b", SSD_TRAIN_K)):
            it = mt.io.NDArrayIter(images, labels, batch_size=bsz,
                                   shuffle=False, label_name="label")
            metric = mt.metric.MultiBoxMetric()
            mod = mt.mod.Module(sym, data_names=("data",),
                                label_names=("label",), context=mt.gpu(0))
            ends, sums = [], []

            def on_epoch(epoch, *_, metric=metric, ends=ends, sums=sums):
                torch.cuda.synchronize()
                ends.append(time.perf_counter())
                sums.append(_multibox_sums(metric))
            torch.cuda.synchronize()
            # the main path: counts at 0 just before, read just after
            mnms.reset_launches()
            t0 = time.perf_counter()
            mod.fit(it, num_epoch=epochs, eval_metric=metric,
                    optimizer="adam", optimizer_params=dict(SSD_TRAIN_OPT),
                    arg_params=arg_params, steps_per_dispatch=k,
                    dispatch_pipeline=1, epoch_end_callback=on_epoch)
            torch.cuda.synchronize()
            launches, routes = mnms.LAUNCHES, dict(mnms.LAUNCHES_BY_ROUTE)
            first, steady = ends[0] - t0, ends[1] - ends[0]
            spec = mod._fused_metric_spec
            fits[name] = {"mod": mod, "sums": sums, "launches": launches,
                          "step_ms": 1e3 * steady / nb,
                          "device_sums": spec is not None and spec.tag}
            log("ssd train (%s) Module.fit(optimizer=\"adam\") "
                "steps_per_dispatch=%d, %d epochs of %d batches: epoch 0 "
                "%.3f s (bind, init and the first step included); epoch 1 "
                "%.3f s, %.3f ms a step, %.1f images/s (host clock, each "
                "epoch ended by a synchronize); metric device sums: %s; "
                "(CE, smooth-L1, valid) by epoch %s; multibox_nms launches "
                "%d (by route %s) [%s]"
                % (name, k, epochs, nb, first, steady, 1e3 * steady / nb,
                   nb * bsz / steady, fits[name]["device_sums"], sums,
                   launches, routes, card))
            if launches != steps or routes != {"smem": steps, "l2": 0}:
                problems.append("fit (%s): multibox_nms ran %d times (by "
                                "route %s) in %d steps; once a step on smem "
                                "expected" % (name, launches, routes, steps))
            ce = [s[0] / s[2] for s in sums]
            if not (np.isfinite(ce).all() and ce[1] < ce[0]):
                problems.append("fit (%s): cross-entropy by epoch %s is not "
                                "finite and falling" % (name, ce))

        # a TrainStep driven by hand over the same batches; its last step
        # records what MultiBoxDetection got and gave
        mod_a = fits["a"]["mod"]
        mod_a.save_checkpoint(ckpt_prefix, 1)
        opt = mt.optimizer.create(
            "adam", sym=sym, param_idx2name=dict(enumerate(
                mod_a._exec_group.param_names)), **SSD_TRAIN_OPT)
        step = TrainStep(sym, data_names=("data",), label_names=("label",),
                         optimizer=opt, device=dev)
        state = step.init({"data": dshape}, {"label": lshape}, seed=seed)
        for n, v in arg_params.items():
            state["params"][n].copy_(v.data)
        hand = [mt.metric.MultiBoxMetric() for _ in range(epochs)]
        seen = {}
        plain_detection = contrib.multibox_detection

        def recording(*args, **kw):
            seen["args"] = [a.detach().clone() for a in args]
            seen["kw"] = kw
            return plain_detection(*args, **kw)
        t0 = None
        step_outs = []
        for i in range(steps):
            if i == nb:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
            j = i % nb
            batch = {"data": images[j * bsz:(j + 1) * bsz],
                     "label": labels[j * bsz:(j + 1) * bsz]}
            if i == steps - 1:
                contrib.multibox_detection = recording
            try:
                state, outs = step.step(state, batch)
            finally:
                contrib.multibox_detection = plain_detection
            # the outputs stay on the card; the host metric reads them
            # after the timed loop
            step_outs.append(outs)
        torch.cuda.synchronize()
        hand_ms = 1e3 * (time.perf_counter() - t0) / ((epochs - 1) * nb)
        for i, o in enumerate(step_outs):
            hand[i // nb].update([], [mt.nd.NDArray(t) for t in o])
        del step_outs
        log("ssd train: the same batches through TrainStep.step alone "
            "(host batches, no metric): %.3f ms a step, %.1f images/s "
            "after the first epoch; Module.fit's epoch 1 took %+.3f ms a "
            "step more at k=1 (the host metric) and %+.3f at k=%d [%s]"
            % (hand_ms, 1e3 * bsz / hand_ms, fits["a"]["step_ms"] - hand_ms,
               fits["b"]["step_ms"] - hand_ms, SSD_TRAIN_K, card))

        # check 1: fit at k=1 (and k=4) against the hand-driven steps
        for name in ("a", "b"):
            arg, _ = fits[name]["mod"].get_params()
            same = [n for n, v in arg.items()
                    if torch.equal(v.data.to(dev), state["params"][n])]
            rel, _ = max_excess({n: v.data.to(dev) for n, v in arg.items()},
                                state["params"])
            log("ssd train check 1 (%s): parameters after fit against a "
                "TrainStep driven by hand over the same %d steps: %d of %d "
                "arrays bit for bit equal, largest relative difference %g"
                % (name, steps, len(same), len(arg), rel))
            if name == "a" and len(same) != len(arg):
                problems.append("fit (a) is not bit for bit the "
                                "hand-driven TrainStep")
            if rel > MODULE_RTOL:
                problems.append("fit (%s) differs from the hand-driven "
                                "TrainStep by %g" % (name, rel))

        # check 2: the metric sums, host (a) and device (b), against the
        # host metric over the hand-driven step's outputs
        ref = [_multibox_sums(m) for m in hand]
        for name in ("a", "b"):
            got = fits[name]["sums"]
            worst = max(abs(g - r) / max(abs(r), 1e-30)
                        for gs, rs in zip(got, ref) for g, r in zip(gs, rs))
            log("ssd train check 2 (%s): MultiBoxMetric (CE, smooth-L1, "
                "valid) by epoch %s; the host metric over the hand-driven "
                "step's outputs %s; largest relative difference %g "
                "(tolerance %g)" % (name, got, ref, worst, SSD_METRIC_RTOL))
            if not worst <= SSD_METRIC_RTOL:
                problems.append("fit (%s) metric sums differ from the "
                                "host metric's" % name)
        if fits["a"]["device_sums"] or fits["b"]["device_sums"] \
                != "multibox":
            problems.append("the metric took the device sums in (a) or not "
                            "in (b): %s, %s" % (fits["a"]["device_sums"],
                                                fits["b"]["device_sums"]))

        # check 3: the last step's det_out against MultiBoxDetection with
        # the plain NMS on the same cls_prob, loc_preds and anchors
        with torch.no_grad():
            plain = plain_detection(*seen["args"],
                                    nms=mnms.nms_alive_reference,
                                    **seen["kw"])
        det = outs[3]
        kept = int((det[:, :, 0] >= 0).sum())
        log("ssd train check 3: the last step's det_out %s, %d rows kept, "
            "equal to MultiBoxDetection with the plain NMS on the same "
            "inputs: %s" % (tuple(det.shape), kept, torch.equal(det, plain)))
        if not torch.equal(det, plain) or kept == 0:
            problems.append("det_out differs from the plain NMS path, or "
                            "keeps nothing")

        # timings: a step on CUDA events, B2 in the step beside its bound
        batch = {"data": torch.from_numpy(images[:bsz]).to(dev),
                 "label": torch.from_numpy(labels[:bsz]).to(dev)}
        event_ms = cuda_time_ms(lambda: step.step(state, batch), 5)
        host_ms = 1e3 * time_steps(lambda: step.step(state, batch), 5)
        bound_ms, bound_by = nms_bound_ms(bsz, 400)
        flops = conv_train_flops(sym, {"data": dshape, "label": lshape})
        conv_ms = profile and profile[SSD_STEP_SHARES[2][0]]
        log("ssd train: the convolutions of a step do %.1f GFLOP (forward, "
            "weight and data gradients, from the shapes): %.3f ms at the "
            "FP32 peak of %.0f TFLOP/s; cuDNN's kernels took %s (phase 6's "
            "profile) [%s]"
            % (flops / 1e9, 1e3 * flops / FP32_OPS_PER_S,
               FP32_OPS_PER_S / 1e12,
               "%.3f ms, %.1f TFLOP/s" % (conv_ms, flops / conv_ms / 1e9)
               if conv_ms else "not measured", card))
        log("ssd train: one TrainStep step on device batches: %.3f ms back "
            "to back (CUDA events around 5), %.3f ms with a synchronize "
            "each (host clock, median of 5), %.1f images/s; device time of "
            "one step (phase 6's profile) %s; multibox_nms in the step %s "
            "(profiler), bound %.6f ms (%s) [%s]"
            % (event_ms, host_ms, 1e3 * bsz / host_ms,
               "%.3f ms" % profile["total"] if profile else "not measured",
               "%.6f ms" % profile[SSD_STEP_SHARES[0][0]] if profile
               else "not measured", bound_ms, bound_by, card))
    if problems:
        raise SystemExit("ssd train phase failed: " + "; ".join(problems))
    return {"launches": fits["a"]["launches"] + fits["b"]["launches"],
            "checkpoint": ckpt_prefix + "-0001.params",
            "step_ms": event_ms,
            "in_step_ms": profile[SSD_STEP_SHARES[0][0]] if profile
            else None}


# ---------------------------------------------------------------------------
# serving tier phase: quantized engines, the Batcher under open-loop
# traffic, a FleetRouter across drain, join and hot reload, the Predictor
# ---------------------------------------------------------------------------

#: open-loop run through a Batcher: requests, offered rate, client threads
TIER_REQUESTS = 400
TIER_QPS = 200.0
TIER_CLIENTS = 4
#: the same through a FleetRouter of two replicas, requests of 1-8 images
FLEET_REQUESTS = 300
FLEET_QPS = 100.0
#: distinct images the requests draw from (each answer is held against the
#: engine's answers for that image at every bucket and position)
TIER_POOL = 32
#: images of the quantized ResNet-50's quality probe
QUALITY_PROBE = 64
#: the Predictor against ServingEngine on the same images (both run the
#: same ops with the same weights; cuDNN deterministic): absolute
PREDICTOR_ATOL = 1e-6


def _pct(xs, q):
    return 1e3 * float(np.percentile(np.asarray(xs), q))


def tier_refs(eng, pool):
    """Each pool image's answers from ``eng`` at every bucket, in every
    position of the batch: {image: set of row bytes}, and per bucket the
    most distinct answers one image got across its positions."""
    refs = [set() for _ in range(len(pool))]
    spread = {}
    for b in eng.buckets:
        seen = [set() for _ in range(len(pool))]
        for s in range(len(pool)):
            idx = (np.arange(b) + s) % len(pool)
            out = eng.infer({"data": pool[idx]})[0]
            for p, j in enumerate(idx):
                seen[j].add(out[p].tobytes())
        for j, answers in enumerate(seen):
            refs[j] |= answers
        spread[b] = max(len(a) for a in seen)
    return refs, spread


def serving_tier_phase(seed, card, fit_params):
    """Phase 13 (see the module docstring). ``fit_params``: the .params
    file phase 12's Module.fit saved through save_checkpoint."""
    import threading
    import torch
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch import models
    from mxnet_tpu_torch.autotune.harness import open_loop_run
    from mxnet_tpu_torch.ops import multibox_nms as mnms
    from mxnet_tpu_torch.serving import (Batcher, FleetRouter,
                                         ServingEngine)
    from mxnet_tpu_torch.serving import quantize as tq
    problems = []
    t_phase = time.perf_counter()
    rng = np.random.default_rng(seed + 13)
    pool = rng.random((TIER_POOL,) + SSD_INPUT, dtype=np.float32)
    with no_tf32(), deterministic_cudnn(), \
            tempfile.TemporaryDirectory() as tmp:
        prefix = os.path.join(tmp, "ssd")
        ssd_checkpoint(prefix, seed)
        sym_file, par_file = prefix + "-symbol.json", prefix + "-0000.params"

        def ssd_engine(params=par_file, **kw):
            return ServingEngine(sym_file, params, {"data": SSD_INPUT},
                                 buckets=BUCKETS, **kw)

        # constructor to first answer, through a Batcher
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        f32 = ssd_engine()
        t_built = time.perf_counter()
        batcher = Batcher(f32)
        batcher.infer({"data": pool[:1]})
        cold = (t_built - t0, time.perf_counter() - t0)

        # (a) the SSD quantized: bit for bit against f32 engines loaded
        # with the weights dequantized on the host
        arg = {k[4:]: v.data for k, v in
               mt.nd.load(par_file, ctx=mt.cpu()).items()}
        wbytes = {"none": f32.weight_bytes()}
        for mode in ("bf16", "int8"):
            eng = ssd_engine(quantize=mode)
            host = {k: tq.dequant_leaf(tq.quantize_array(v, mode))
                    for k, v in arg.items()}
            deq = ssd_engine(host)
            equal = [np.array_equal(eng.infer({"data": pool[:n]})[0],
                                    deq.infer({"data": pool[:n]})[0])
                     for n in (1, 5, 8, 32)]
            wbytes[mode] = eng.weight_bytes()
            ratio = wbytes[mode] / wbytes["none"]
            limit = 0.51 if mode == "bf16" else 0.30
            log("tier (a) ssd %s: detections for 1, 5, 8, 32 images equal "
                "to an f32 engine of the host-dequantized weights: %s; "
                "weight_bytes %d against f32 %d (%.4f, limit %.2f) [%s]"
                % (mode, equal, wbytes[mode], wbytes["none"], ratio, limit,
                   card))
            if not all(equal):
                problems.append("ssd %s detections differ from the "
                                "host-dequantized f32 engine's" % mode)
            if ratio > limit:
                problems.append("ssd %s weight ratio %.4f over %.2f"
                                % (mode, ratio, limit))
            del eng, deq

        # (b) ResNet-50 quantized: quality against f32, peak memory
        rshape = (3, RESNET_IMAGE, RESNET_IMAGE)
        with mt.symbol.NameManager():
            rsym = models.resnet(num_classes=RESNET_CLASSES, num_layers=50,
                                 image_shape="3,%d,%d" % rshape[1:])
        rparams = xavier_params(rsym, (1,) + rshape, seed)
        _, _, aux_shapes = rsym.infer_shape(data=(1,) + rshape)
        raux = {n: (mt.nd.ones if n.endswith("_var") else mt.nd.zeros)(
            sh, ctx=mt.cpu()) for n, sh in zip(rsym.list_auxiliary_states(),
                                               aux_shapes)}
        rprefix = os.path.join(tmp, "resnet50")
        mt.model.save_checkpoint(rprefix, 0, rsym, rparams, raux)
        rfiles = (rprefix + "-symbol.json", rprefix + "-0000.params")
        probe = {"data": rng.random((QUALITY_PROBE,) + rshape,
                                    dtype=np.float32)}
        rengines = {}
        for mode in ("none", "bf16", "int8"):
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            eng = ServingEngine(*rfiles, {"data": rshape}, buckets=BUCKETS,
                                quantize=mode)
            eng.infer(probe)
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated() - base
            rengines[mode] = eng
            report = ("" if mode == "none" else "; quality_report over %d "
                      "images against f32: %s" % (
                          QUALITY_PROBE,
                          eng.quality_report(rengines["none"], probe)))
            log("tier (b) resnet-50 %s: weight_bytes %d, peak device memory "
                "of the engine (load, warm-up and the probe) %d bytes%s "
                "[%s]" % (mode, eng.weight_bytes(), peak, report, card))

        # (c) open-loop one-image requests through the Batcher on the f32
        # SSD: each answer against the engine's own at every bucket and
        # position
        refs_old, spread = tier_refs(f32, pool)
        log("tier (c) position probe: the most distinct answers one image "
            "got across its positions, by bucket: %s (1 = independent of "
            "the position); answers an image gets across the buckets: "
            "%d at most" % (spread, max(len(r) for r in refs_old)))
        reqs = [{"data": pool[i % TIER_POOL:i % TIER_POOL + 1]}
                for i in range(TIER_REQUESTS)]
        index = {id(r): i for i, r in enumerate(reqs)}
        answers = {}

        def serve_one(req):
            answers[index[id(req)]] = batcher.infer(req)[0]

        torch.cuda.synchronize()
        h0 = f32.health.report()
        mnms.reset_launches()
        lat, errs, wall = open_loop_run(serve_one, lambda i: reqs[i],
                                        TIER_QPS, TIER_REQUESTS,
                                        nclients=TIER_CLIENTS)
        torch.cuda.synchronize()
        launches, routes = mnms.LAUNCHES, dict(mnms.LAUNCHES_BY_ROUTE)
        h1 = f32.health.report()
        batcher.close()
        disp = h1["batches"] - h0["batches"]
        examples = h1["examples"] - h0["examples"]
        padded = h1["padded"] - h0["padded"]
        wrong = [i for i, a in answers.items()
                 if a[0].tobytes() not in refs_old[i % TIER_POOL]]
        p50 = _pct(lat, 50)
        log("tier (c) open loop, Batcher over the f32 SSD: %d requests of "
            "one image at %.0f/s from %d clients: %d completed, %d failed, "
            "%d answers equal to none of the engine's; p50 %.3f ms, p99 "
            "%.3f ms, %.1f requests/s over %.3f s; %d dispatches, %.3f "
            "images a dispatch, padded fraction %.4f; constructor to first "
            "answer %.3f s (the constructor %.3f s) against the warm p50 "
            "%.3f ms; multibox_nms launches %d (by route %s) [%s]"
            % (TIER_REQUESTS, TIER_QPS, TIER_CLIENTS, len(lat), len(errs),
               len(wrong), p50, _pct(lat, 99), TIER_REQUESTS / wall, wall,
               disp, examples / max(1, disp),
               padded / max(1, examples + padded), cold[1], cold[0], p50,
               launches, routes, card))
        if len(lat) != TIER_REQUESTS or errs or wrong:
            problems.append("open loop: %d of %d completed, errors %s, "
                            "answers off %s" % (len(lat), TIER_REQUESTS,
                                                errs[:3], wrong[:5]))
        if launches != disp or routes != {"smem": disp, "l2": 0}:
            problems.append("open loop: multibox_nms ran %d times (by route "
                            "%s) for %d dispatches" % (launches, routes,
                                                       disp))
        tier_launches = launches

        # (d) the same traffic shape through a FleetRouter of two replicas,
        # mixed classes, 1-8 images a request; drain one replica, join a
        # third, then hot-reload phase 12's checkpoint, all under traffic
        sizes = rng.integers(1, 9, FLEET_REQUESTS)
        starts = [int(rng.integers(0, TIER_POOL - n + 1)) for n in sizes]
        classes = ["batch" if i % 3 == 2 else "interactive"
                   for i in range(FLEET_REQUESTS)]
        freqs = [{"data": pool[s:s + n]} for s, n in zip(starts, sizes)]
        findex = {id(r): i for i, r in enumerate(freqs)}
        e1 = ssd_engine()
        engines = [f32, e1]
        router = FleetRouter({"r0": Batcher(f32), "r1": Batcher(e1)})
        fanswers, flat = {}, {c: [] for c in ("interactive", "batch")}
        done = [0]
        lock = threading.Lock()
        progress = threading.Condition(lock)

        def serve_fleet(req):
            i = findex[id(req)]
            t = time.perf_counter()
            out = router.infer(req, priority=classes[i])[0]
            with progress:
                fanswers[i] = out
                flat[classes[i]].append(time.perf_counter() - t)
                done[0] += 1
                progress.notify_all()

        def join_factory():
            eng = ssd_engine()
            engines.append(eng)
            return Batcher(eng)

        events = []

        def control():
            n = FLEET_REQUESTS
            for at, what in ((n // 5, "drain r0"), (2 * n // 5, "join r2"),
                             (2 * n // 3, "update_params")):
                with progress:
                    progress.wait_for(lambda: done[0] >= at, timeout=60.0)
                t = time.perf_counter()
                if what == "drain r0":
                    router.drain("r0", timeout=60.0)
                elif what == "join r2":
                    router.join("r2", join_factory)
                else:
                    router.update_params(fit_params)
                events.append("%s after %d answers (%.3f s)"
                              % (what, done[0], time.perf_counter() - t))

        torch.cuda.synchronize()
        fh0 = [e.health.batches for e in engines]
        mnms.reset_launches()
        ctl = threading.Thread(target=control)
        ctl.start()
        lat_f, errs_f, wall_f = open_loop_run(
            serve_fleet, lambda i: freqs[i], FLEET_QPS, FLEET_REQUESTS,
            nclients=TIER_CLIENTS)
        ctl.join(120.0)
        torch.cuda.synchronize()
        launches, routes = mnms.LAUNCHES, dict(mnms.LAUNCHES_BY_ROUTE)
        disp = sum(e.health.batches - b
                   for e, b in zip(engines, fh0 + [0]))
        # the joined engine's load-time warm-up launches once a bucket and
        # counts no dispatch
        expect = disp + len(BUCKETS)
        rep = router.report()
        fresh = ssd_engine(fit_params)
        refs_new, spread_new = tier_refs(fresh, pool)
        versions = {"old": 0, "new": 0}
        mixed = []
        for i, a in fanswers.items():
            rows = range(starts[i], starts[i] + sizes[i])
            old = all(a[k].tobytes() in refs_old[j]
                      for k, j in enumerate(rows))
            new = all(a[k].tobytes() in refs_new[j]
                      for k, j in enumerate(rows))
            if old:
                versions["old"] += 1
            elif new:
                versions["new"] += 1
            else:
                mixed.append(i)
        after = [np.array_equal(router.infer({"data": pool[:n]})[0],
                                fresh.infer({"data": pool[:n]})[0])
                 for n in (1, 5, 8, 32)]
        router.close()
        log("tier (d) fleet of 2 replicas (r0, r1), %d requests of 1-8 "
            "images (%d images) at %.0f/s, interactive and batch: %s; %d "
            "completed, %d failed, fleet errors %d shed %d expired %d "
            "requeued %d; answers from the old weights %d, the new %d, "
            "neither %d; after the reload equal to a fresh engine of the "
            "checkpoint (1, 5, 8, 32 images): %s; position probe of the "
            "new weights %s; multibox_nms launches %d (by route %s) for %d "
            "dispatches and %d warm-up launches of the joined engine [%s]"
            % (FLEET_REQUESTS, int(sizes.sum()), FLEET_QPS, events,
               len(lat_f), len(errs_f), rep["fleet"]["errors"],
               rep["fleet"]["shed"], rep["fleet"]["expired"],
               rep["fleet"]["requeued"], versions["old"], versions["new"],
               len(mixed), after, spread_new, launches, routes, disp,
               len(BUCKETS), card))
        for c, xs in flat.items():
            log("tier (d) fleet %s: %d requests, p50 %.3f ms, p99 %.3f ms "
                "(host clock around FleetRouter.infer) [%s]"
                % (c, len(xs), _pct(xs, 50), _pct(xs, 99), card))
        if (len(lat_f) != FLEET_REQUESTS or errs_f or mixed
                or not all(after) or len(events) != 3
                or rep["fleet"]["errors"] or rep["fleet"]["shed"]
                or rep["fleet"]["expired"] or versions["new"] == 0):
            problems.append("fleet: %d of %d completed, errors %s, answers "
                            "of neither weights %s, after reload %s, "
                            "events %s" % (len(lat_f), FLEET_REQUESTS,
                                           errs_f[:3], mixed[:5], after,
                                           events))
        if launches != expect or routes != {"smem": expect, "l2": 0}:
            problems.append("fleet: multibox_nms ran %d times (by route %s) "
                            "for %d expected" % (launches, routes, expect))
        tier_launches += launches

        # (e) the Predictor on gpu(0) against ServingEngine
        pred = mt.Predictor(*rfiles, {"data": (1,) + rshape})
        worst = 0.0
        bitwise = []
        for n in BUCKETS:
            pred.reshape({"data": (n,) + rshape})
            x = probe["data"][:n]
            got = pred.forward(data=x).get_output(0).asnumpy()
            want = rengines["none"].infer({"data": x})[0]
            worst = max(worst, float(np.abs(got - want).max()))
            bitwise.append(bool(np.array_equal(got, want)))
        log("tier (e) Predictor(ResNet-50) on %s, reshape over %s: largest "
            "|difference| from ServingEngine %g (tolerance %g), bit for bit "
            "%s; executor cache %d [%s]"
            % (pred._ctx, list(BUCKETS), worst, PREDICTOR_ATOL, bitwise,
               len(pred._exec_cache), card))
        if worst > PREDICTOR_ATOL or len(pred._exec_cache) != len(BUCKETS):
            problems.append("Predictor differs from ServingEngine by %g, "
                            "cache %d" % (worst, len(pred._exec_cache)))
    log("tier: the phase took %.1f s" % (time.perf_counter() - t_phase))
    if problems:
        raise SystemExit("serving tier phase failed: " + "; ".join(problems))
    return tier_launches


# ---------------------------------------------------------------------------
# training API phase: resume, the guard, remat, bf16 statistics and the zoo
# ---------------------------------------------------------------------------

#: phase 14 (a): host batches a epoch, epochs, steps a dispatch, the
#: checkpoint cadence in batches, and the batch after which run B stops
API_BATCHES = 8
API_EPOCHS = 2
API_K = 4
API_EVERY = 4
API_STOP = 6
#: phase 14 (e): the zoo through FeedForward.fit at 3x224x224, NCHW f32:
#: (network, its kwargs, batch), ZOO_STEPS steps each
ZOO = (("inception-bn", {}, 64), ("alexnet", {}, 128),
       ("vgg", {"num_layers": 16}, 32))
ZOO_STEPS = 8
#: Dropout's kept fraction of a 4096x4096 tensor at p = 0.5 lies within
#: 0.5 +- DROPOUT_TOL (16.7M draws: the standard deviation is 1.2e-4)
DROPOUT_TOL = 0.005


class _Stop(Exception):
    """Raised from a batch callback to stop a fit, as a kill would."""


def _equal_or_worst(a, b):
    """(True, 0.0) when the two name -> tensor dicts are equal bit for bit,
    else (False, the largest |a - b|, float64)."""
    worst = 0.0
    same = True
    for n, v in a.items():
        if not (v.dtype == b[n].dtype and bool((v == b[n]).all())):
            same = False
            worst = max(worst, float((v.double() - b[n].double()).abs()
                                     .max()))
    return same, worst


def training_api_phase(seed, card, step_profiles):
    """Phase 14; returns B1's launches in it (all on the wgmma route).
    ``step_profiles``: the train phase's profiler device times (ms) of one
    fused step unguarded, guarded and under each remat mode (None where
    no two profiles agreed)."""
    import torch
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch import faults, models
    from mxnet_tpu_torch.executor import node_generator
    from mxnet_tpu_torch.model import CheckpointManager
    from mxnet_tpu_torch.ops import matmul_stats as ms
    from mxnet_tpu_torch.ops import registry as treg
    from mxnet_tpu_torch.train_step import TrainStep, _metric_step_sums

    class CountingManager(CheckpointManager):
        calls = 0

        def save(self, *a, **kw):
            self.calls += 1
            return super().save(*a, **kw)

    t_phase = time.perf_counter()
    bsz, img, nb = RESNET_BATCH, RESNET_IMAGE, API_BATCHES
    dshape = (bsz, img, img, 3)
    per_step = sum(B1_STEP_SHAPES.values())
    dev = mt.gpu(0).to_device()
    os.environ["MXTPU_FUSE_CONV_BN"] = "1"
    with mt.symbol.NameManager():
        sym = models.resnet(num_classes=RESNET_CLASSES, num_layers=50,
                            image_shape="3,%d,%d" % (img, img),
                            layout="NHWC")
    rng = np.random.default_rng(seed + 14)
    images = rng.standard_normal((nb * bsz,) + dshape[1:], dtype=np.float32)
    labels = rng.integers(0, RESNET_CLASSES, nb * bsz).astype(np.float32)
    arg_params = xavier_params(sym, dshape, seed)
    problems = []
    launches = 0

    def wgmma_only(what, want):
        routes = dict(ms.LAUNCHES_BY_ROUTE)
        if routes != {"wgmma": want, "wmma": 0, "tf32x3": 0, "f32": 0}:
            problems.append("%s: matmul_stats routes %s, expected %d wgmma"
                            % (what, routes, want))
        return routes["wgmma"]

    with no_tf32(), deterministic_cudnn(), \
            tempfile.TemporaryDirectory() as tmp:
        # (a) Module.fit with checkpoints and the guard, uninterrupted (A)
        # against stopped after API_STOP batches and resumed (B)
        def fit(prefix, stop=None, resume=None, asyn=True):
            mgr = CountingManager(os.path.join(tmp, prefix), keep=3)
            mod = mt.mod.Module(sym, context=mt.gpu(0),
                                compute_dtype="bfloat16")

            def cb(p):
                if stop is not None and p.epoch * nb + p.nbatch + 1 >= stop:
                    raise _Stop()
            t0 = time.perf_counter()
            try:
                mod.fit(mt.io.NDArrayIter(images, labels, batch_size=bsz),
                        num_epoch=API_EPOCHS, optimizer="sgd",
                        optimizer_params=MODULE_OPT, arg_params=arg_params,
                        steps_per_dispatch=API_K, dispatch_pipeline=1,
                        batch_end_callback=cb, checkpoint_prefix=mgr,
                        checkpoint_every_n_batches=API_EVERY,
                        checkpoint_async=asyn, guard=True, resume=resume)
            except _Stop:
                pass
            torch.cuda.synchronize()
            return mod, mgr, time.perf_counter() - t0

        runs = {}
        for name, prefix, stop, resume, asyn in (
                ("A", "a", None, None, True), ("B stopped", "b", API_STOP,
                                               None, False),
                ("B resumed", "b", None, "auto", False)):
            # the main path: counts at 0 just before, read just after
            ms.reset_launches()
            mod, mgr, secs = fit(prefix, stop, resume, asyn)
            steps = {"A": nb * API_EPOCHS, "B stopped": 2 * API_K,
                     "B resumed": nb * API_EPOCHS - API_K}[name]
            n = wgmma_only("fit " + name, steps * per_step)
            launches += n
            runs[name] = mod
            log("training api (a) fit %s: %d steps in %.3f s (host clock, "
                "bind and the first step included), %d checkpoint saves "
                "%s, %.4f s a save on the training thread; matmul_stats "
                "%d launches on the wgmma route; newest checkpoint %s [%s]"
                % (name, steps, secs, mgr.calls,
                   "async" if asyn else "sync", mgr.save_time / mgr.calls,
                   n, mgr.load_latest().tag, card))
        a, b = runs["A"].get_params(), runs["B resumed"].get_params()
        for what, i in (("parameters", 0), ("aux states", 1)):
            same, worst = _equal_or_worst({n: v.data for n, v in a[i].items()},
                                          {n: v.data for n, v in b[i].items()})
            log("training api (a) the resumed fit's %s against the "
                "uninterrupted fit's: %s (largest difference %g)"
                % (what, "equal bit for bit" if same else "DIFFER", worst))
            if not same:
                problems.append("resume: %s differ by up to %g" % (what,
                                                                   worst))

        # (b) the guard: a clean guarded step against an unguarded one, and
        # a guarded step with guard.grad_nan armed
        step = TrainStep(sym, optimizer="sgd", learning_rate=0.1,
                         momentum=0.9, wd=1e-4, compute_dtype="bfloat16")
        state0 = step.init({"data": dshape}, {"softmax_label": (bsz,)},
                           seed=seed)
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed + 15)

        def batch():
            return {"data": torch.randn(dshape, generator=gen, device=dev),
                    "softmax_label": torch.randint(
                        0, RESNET_CLASSES, (bsz,), generator=gen,
                        device=dev).float()}

        b0, b1 = batch(), batch()
        plain, guarded = clone_state(state0), clone_state(state0)
        ms.reset_launches()
        step.step(plain, b0)
        _, _, packed = step.step(guarded, b0, guard=True)
        torch.cuda.synchronize()
        launches += wgmma_only("guard", 2 * per_step)
        sent = packed.cpu().numpy()
        for key in ("params", "aux", "opt"):
            same, worst = _equal_or_worst(plain[key], guarded[key])
            if not same:
                problems.append("guard: a clean guarded step's %s differ "
                                "from the unguarded step's by %g"
                                % (key, worst))
        before = clone_state(guarded)
        faults.inject("guard.grad_nan", nth=1)
        ms.reset_launches()
        _, _, packed_nan = step.step(guarded, b1, guard=True)
        torch.cuda.synchronize()
        launches += wgmma_only("guard, grad_nan", per_step)
        faults.clear()
        nan_sent = packed_nan.cpu().numpy()
        noop = all(_equal_or_worst(before[k], guarded[k])[0]
                   for k in ("params", "aux", "opt"))
        noop = noop and int(guarded["step"]) == int(before["step"])
        if not noop or nan_sent[3] != 1:
            problems.append("guard: the grad_nan step was not a no-op "
                            "(skipped %g)" % nan_sent[3])
        # in turns, plain and guarded, on one state (CUDA events: the
        # eager step is host-bound, so these include the launch gaps)
        timed = clone_state(state0)
        turns = {"unguarded": [], "guarded": []}
        for _ in range(2):
            for what, guard in (("unguarded", False), ("guarded", True)):
                turns[what].append(cuda_time_ms(
                    lambda: step.step(timed, b0, guard=guard), 3, warmup=1))
        prof = {k: step_profiles.get(k) for k in ("unguarded", "guarded")}
        log("training api (b) guard: a clean guarded step equals the "
            "unguarded one bit for bit: %s; sentinels [loss %.4f, correct "
            "%g, samples %g, skipped %g, grad norm %.6g]; with guard.grad_nan "
            "armed: every tensor and the step counter unchanged: %s, "
            "skipped %g, grad norm %s; device time of a step (train "
            "phase's profiles) %s ms guarded against %s unguarded; a step "
            "on CUDA events, in turns, %s ms guarded against %s unguarded "
            "[%s]"
            % (not any(p.startswith("guard: a clean") for p in problems),
               sent[0], sent[1], sent[2], sent[3], sent[4], noop,
               nan_sent[3], nan_sent[4], prof["guarded"], prof["unguarded"],
               ["%.3f" % t for t in turns["guarded"]],
               ["%.3f" % t for t in turns["unguarded"]], card))

        # (c) remat: two steps from one state in each mode
        remat = {}
        for mode in (False, True, "conv"):
            rs = TrainStep(sym, optimizer="sgd", learning_rate=0.1,
                           momentum=0.9, wd=1e-4, compute_dtype="bfloat16",
                           remat=mode)
            st = clone_state(state0)
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            ms.reset_launches()
            for bt in (b0, b1):
                rs.step(st, bt)
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated()
            n = wgmma_only("remat %r" % (mode,),
                           2 * per_step * (1 if mode is False else 2))
            launches += n
            t = cuda_time_ms(lambda: rs.step(clone_state(state0), b0), 3,
                             warmup=1)
            remat[mode] = st
            dev_ms = step_profiles.get("unguarded" if mode is False
                                       else "remat %r" % (mode,))
            log("training api (c) remat=%r: matmul_stats %d launches a "
                "step; peak device memory %.3f GiB over two steps (%.3f GiB "
                "held before them); a step %.3f ms (CUDA events, 3 steps), "
                "%s ms of device time (train phase's profile) [%s]"
                % (mode, n // 2, peak / 2 ** 30, base / 2 ** 30, t, dev_ms,
                   card))
        for mode in (True, "conv"):
            same, worst = _equal_or_worst(remat[False]["params"],
                                          remat[mode]["params"])
            same_aux, worst_aux = _equal_or_worst(remat[False]["aux"],
                                                  remat[mode]["aux"])
            log("training api (c) remat=%r against no remat after two "
                "steps: parameters %s (largest difference %g), moving "
                "statistics %s (%g)"
                % (mode, "equal bit for bit" if same else "DIFFER", worst,
                   "equal bit for bit" if same_aux else "DIFFER",
                   worst_aux))
            if not (same and same_aux):
                problems.append("remat=%r: the state differs from no remat "
                                "by up to %g" % (mode, max(worst,
                                                           worst_aux)))

        # (d) MXTPU_BF16_STATS: storage dtypes, finite losses, the step
        # time, and a fit's checkpoint in float32
        for mode in ("1", "opt"):
            os.environ["MXTPU_BF16_STATS"] = mode
            try:
                bs = TrainStep(sym, optimizer="sgd", learning_rate=0.1,
                               momentum=0.9, wd=1e-4,
                               compute_dtype="bfloat16")
                st = bs.init({"data": dshape}, {"softmax_label": (bsz,)},
                             seed=seed)
                dtypes = ({str(v.dtype) for v in st["aux"].values()},
                          {str(v.dtype) for v in st["opt"].values()
                           if v is not None})
                want = ({"torch.bfloat16"}, {"torch.bfloat16"
                                             if mode == "opt"
                                             else "torch.float32"})
                ms.reset_launches()
                losses = []
                for bt in (b0, b1, b0, b1):
                    _, outs = bs.step(st, bt)
                    zero = torch.zeros((), device=dev)
                    losses.append(float(_metric_step_sums(
                        outs, [bt["softmax_label"]], zero)[0]) / bsz)
                torch.cuda.synchronize()
                launches += wgmma_only("bf16 stats %s" % mode, 4 * per_step)
                # in turns with the float32-statistics step of (b)
                t = cuda_time_ms(lambda: bs.step(st, b0), 3, warmup=1)
                t32 = cuda_time_ms(lambda: step.step(timed, b0), 3,
                                   warmup=1)
                mgr = CheckpointManager(os.path.join(tmp, "bf16" + mode))
                mod = mt.mod.Module(sym, context=mt.gpu(0),
                                    compute_dtype="bfloat16")
                ms.reset_launches()
                mod.fit(mt.io.NDArrayIter(images[:API_K * bsz],
                                          labels[:API_K * bsz],
                                          batch_size=bsz),
                        num_epoch=1, optimizer="sgd",
                        optimizer_params=MODULE_OPT, arg_params=arg_params,
                        steps_per_dispatch=API_K, checkpoint_prefix=mgr)
                torch.cuda.synchronize()
                launches += wgmma_only("bf16 stats %s fit" % mode,
                                       API_K * per_step)
                ck = mgr.load_latest()
                import pickle
                with open(ck.opt_states_file, "rb") as f:
                    opt_dtypes = {str(np.asarray(v).dtype)
                                  for v in pickle.loads(f.read()).values()
                                  if v is not None}
                file_dtypes = ({str(v.dtype) for v in ck.arg_params.values()}
                               | {str(v.dtype)
                                  for v in ck.aux_params.values()}
                               | opt_dtypes)
                fused = {str(v.dtype)
                         for v in mod._fused_state["aux"].values()}
            finally:
                del os.environ["MXTPU_BF16_STATS"]
            log("training api (d) MXTPU_BF16_STATS=%s: aux %s, optimizer "
                "states %s; losses %s; a step %.3f ms against %.3f with "
                "float32 statistics, in turns (CUDA events, 3 steps each); "
                "a fit's fused aux %s, its checkpoint's arrays %s [%s]"
                % (mode, sorted(dtypes[0]), sorted(dtypes[1]),
                   ["%.4f" % v for v in losses], t, t32, sorted(fused),
                   sorted(file_dtypes), card))
            if dtypes != want or fused != {"torch.bfloat16"}:
                problems.append("bf16 stats %s: dtypes %s, fused aux %s"
                                % (mode, dtypes, fused))
            if not all(np.isfinite(losses)):
                problems.append("bf16 stats %s: non-finite loss" % mode)
            if file_dtypes != {"float32"}:
                problems.append("bf16 stats %s: the checkpoint holds %s"
                                % (mode, file_dtypes))

    # (e) the zoo at full width through FeedForward.fit, NCHW float32
    with no_tf32():
        for name, kw, b in ZOO:
            zrng = np.random.default_rng(seed + 16)
            X = zrng.standard_normal((ZOO_STEPS * b, 3, img, img),
                                     dtype=np.float32)
            y = zrng.integers(0, RESNET_CLASSES, ZOO_STEPS * b).astype(
                np.float32)
            zsym = models.get_symbol(name, num_classes=RESNET_CLASSES, **kw)
            stamps = []

            def stamp(_):
                torch.cuda.synchronize()
                stamps.append(time.perf_counter())
            metric = mt.metric.CrossEntropy()
            mt.random.seed(seed)
            model = mt.model.FeedForward(
                zsym, ctx=mt.gpu(0), num_epoch=1, numpy_batch_size=b,
                initializer=mt.initializer.Xavier(), learning_rate=0.01,
                momentum=0.9, wd=1e-4)
            model.fit(X, y, eval_metric=metric, batch_end_callback=stamp)
            ce = metric.get()[1]
            ips = (ZOO_STEPS - 1) * b / (stamps[-1] - stamps[0])
            finite = all(np.isfinite(v.asnumpy()).all()
                         for v in model.arg_params.values())
            log("training api (e) %s%s b=%d NCHW float32 (TF32 off): %d "
                "steps through FeedForward.fit, cross-entropy %.4f, params "
                "finite %s, %.1f images/s over steps 2-%d (host clock, each "
                "step ended by a synchronize) [%s]"
                % (name, kw or "", b, len(stamps), ce, finite, ips,
                   ZOO_STEPS, card))
            if len(stamps) != ZOO_STEPS or not (np.isfinite(ce) and finite):
                problems.append("zoo %s: %d steps, cross-entropy %g"
                                % (name, len(stamps), ce))
    x = torch.ones((4096, 4096), device=dev)

    def drop(key):
        return treg.get("Dropout").apply(
            treg.OpContext(is_train=True, rng=node_generator(key, 0, dev)),
            {"p": 0.5}, [x], [])[0][0]
    d1 = drop(seed)
    kept = float((d1 != 0).float().mean())
    same = bool(torch.equal(d1, drop(seed)))
    other = not bool(torch.equal(d1, drop(seed + 1)))
    log("training api (e) Dropout p=0.5 on 4096x4096: kept %.6f (0.5 +- "
        "%g), equal seeds give equal masks %s, another seed another %s"
        % (kept, DROPOUT_TOL, same, other))
    if abs(kept - 0.5) > DROPOUT_TOL or not (same and other):
        problems.append("Dropout: kept %g, same seed same mask %s"
                        % (kept, same))
    log("training api: matmul_stats %d launches in the phase, all wgmma; "
        "the phase took %.1f s" % (launches, time.perf_counter() - t_phase))
    if problems:
        raise SystemExit("training api phase failed: " + "; ".join(problems))
    return launches


# ---------------------------------------------------------------------------
# data phase: the data tier feeding ResNet-50 and SSD training from JPEG
# records, and its drills
# ---------------------------------------------------------------------------

#: phase 15 (b): classification records as bench.py's realdata run packs
#: them (int(224 * 1.15) px, quality 90, 8 classes), and detection records
#: (cut from 4096 to keep the script inside its time limit)
DATA_IMAGES = 1024
DATA_SIZE = int(224 * 1.15)
DATA_QUALITY = 90
DATA_CLASSES = 8
DET_IMAGES = 256
DET_OBJECTS = 4
#: phase 15 (c): ResNet-50 as bench.py's realdata run trains it
DATA_IMAGE = 224
DATA_BATCH = 128
DATA_RESIZE = 246
DATA_K = 4
DATA_MEAN = (123.68, 116.28, 103.53)
DATA_STD = (58.4, 57.1, 57.4)
#: warm-up and timed epochs of each ResNet-50 fit (2 timed before phase 28:
#: the script's time limit)
DATA_EPOCHS = (1, 1)
#: phase 15 (c): the device-resident fit with the decode workers busy beside
#: it trains on this share of the records (1/4, cut from 1/2: the script's
#: time limit, phase 28)
DATA_BUSY_SHARE = 4
#: phase 15 (e): SSD at phase 12's batch over the detection records
DET_BATCH = 32
#: how long a dead decode worker may take to fail the consumer
DRILL_POLL_S = 5.0


def _cls_image(seed, i, size, ang, freq, base, gx, gy):
    """Image ``i`` of the classification records: a class texture (an
    oriented stripe pattern over a base colour) with noise."""
    c = i % DATA_CLASSES
    rng = np.random.default_rng([seed, i])
    wave = np.sin(2 * np.pi * freq[c]
                  * (gx * np.cos(ang[c]) + gy * np.sin(ang[c]))
                  + rng.uniform(0, 2 * np.pi))
    img = (base[c][:, None, None] + 0.22 * wave[None]
           + rng.normal(0, 0.05, (3, size, size)))
    return (np.clip(img, 0, 1) * 255).astype(np.uint8).transpose(1, 2, 0)


def _det_image(seed, i, size):
    """Image ``i`` of the detection records: 1-4 coloured rectangles on
    noise, and its label row [2, 5, (class, x1, y1, x2, y2) * objects]."""
    rng = np.random.default_rng([seed, 1 << 20, i])
    img = np.clip(rng.normal(110, 12, (size, size, 3)), 0, 255)
    rows = []
    for _ in range(int(rng.integers(1, DET_OBJECTS + 1))):
        k = int(rng.integers(0, SSD_TRAIN_CLASSES))
        w, h = rng.uniform(0.25, 0.55, 2)
        x1, y1 = rng.uniform(0, 1 - w), rng.uniform(0, 1 - h)
        img[int(y1 * size):int((y1 + h) * size),
            int(x1 * size):int((x1 + w) * size)] = _COLORS[k]
        rows += [k, x1, y1, x1 + w, y1 + h]
    return img.astype(np.uint8), np.array([2, 5] + rows, np.float32)


def write_records(path, n, make, quality):
    """An indexed .rec of ``n`` JPEGs: ``make(i)`` gives image ``i`` and
    its label, and may give Pillow's save options for it third (a 2-D
    image is saved grayscale); images are made and encoded on 8 threads
    (numpy and Pillow release the GIL), written in index order."""
    import io as _bio
    from concurrent.futures import ThreadPoolExecutor
    from PIL import Image
    from mxnet_tpu_torch import recordio

    def encode(i):
        img, label, *opts = make(i)
        buf = _bio.BytesIO()
        Image.fromarray(img).save(buf, format="JPEG", quality=quality,
                                  **(opts[0] if opts else {}))
        return label, buf.getvalue()
    rec = recordio.MXIndexedRecordIO(os.path.splitext(path)[0] + ".idx",
                                     path, "w")
    nbytes = 0
    with ThreadPoolExecutor(8) as pool:
        for i, (label, jpg) in enumerate(pool.map(encode, range(n))):
            rec.write_idx(i, recordio.pack(
                recordio.IRHeader(0, label, i, 0), jpg))
            nbytes += len(jpg)
    rec.close()
    return nbytes


def data_probe():
    """Phase 15 (a): what the machine offers the data tier, the card's JPEG
    route included (nvJPEG's header and library, and whether its hardware
    backend initialises)."""
    import torch
    from mxnet_tpu_torch import jpeg_decode, native_build
    p = native_build.probe()
    route = "native" if p["native"] else ("pillow" if p["pillow"]
                                          else "none")
    hw = None
    if p["libnvjpeg"]:
        try:
            jpeg_decode.release(jpeg_decode.acquire(torch.device("cuda", 0)))
            hw = jpeg_decode.hardware_status()
        except Exception as e:             # reported; phase 28 fails on it
            hw = "nvJPEG did not initialise: %s" % e
    p["nvjpeg_hardware"] = hw
    log("data probe: Pillow %s; <jpeglib.h> %s; ldconfig libjpeg %s; %s; "
        "os.cpu_count() %s -> the host JPEG route is %r; nvjpeg.h %s; "
        "libnvjpeg %s; nvJPEG's hardware backend %s"
        % (p["pillow"] or "absent",
           "found" if p["jpeglib_h"] else "absent",
           p["libjpeg"] or "absent", p["cxx"] or "no C++ compiler",
           p["cpu_count"], route, p["nvjpeg_h"] or "absent",
           p["libnvjpeg"] or "absent",
           ("initialised (status 0), %d engines, %d cores each"
            % (hw["engines"], hw["cores"]) if isinstance(hw, dict)
            and hw["status"] == 0 else
            "did not initialise (nvjpegCreateEx status %s)" % hw["status"]
            if isinstance(hw, dict) else hw)))
    return p, route


def _cls_iter(route, rec, num_workers, seed, shape=None, batch=None,
              resize=None):
    """The classification iterator of ``route``: ImageRecordIter (the
    native fused decode) where libjpeg is present, else ImageIter (Pillow
    decode and the Python augmenters, the reference's fallback), with
    bench.py's realdata augmentation."""
    import mxnet_tpu_torch as mt
    shape = shape or (3, DATA_IMAGE, DATA_IMAGE)
    batch = batch or DATA_BATCH
    resize = resize or DATA_RESIZE
    if route == "native":
        return mt.image.ImageRecordIter(
            path_imgrec=rec, data_shape=shape, batch_size=batch,
            shuffle=True, rand_crop=True, rand_mirror=True, resize=resize,
            mean_r=DATA_MEAN[0], mean_g=DATA_MEAN[1], mean_b=DATA_MEAN[2],
            std_r=DATA_STD[0], std_g=DATA_STD[1], std_b=DATA_STD[2],
            num_workers=num_workers, seed=seed, device="cpu")
    augs = mt.image.CreateAugmenter(
        shape, resize=resize, rand_crop=True, rand_mirror=True,
        mean=np.array(DATA_MEAN), std=np.array(DATA_STD))
    return mt.image.ImageIter(batch, shape, path_imgrec=rec, shuffle=True,
                              aug_list=augs, num_workers=num_workers,
                              seed=seed)


def _raw_pool_epoch(rec, num_workers, batch):
    """The drills where no JPEG route exists: the reader and the decode
    pool over the records' bytes (a batch is its records' lengths)."""
    from mxnet_tpu_torch import data as tdata
    reader = tdata.ShardedRecordReader(rec, shuffle=True, seed=1)
    order = reader.epoch_order(0)
    tasks = [(order[b * batch:(b + 1) * batch], b)
             for b in range(len(order) // batch)]

    def lengths(keys, _seed):
        return np.array([len(reader.read(k)[1]) for k in keys])
    pool = tdata.DecodeWorkerPool(lengths, tasks[:4], num_workers)
    try:
        return [pool.next_batch() for _ in range(min(4, len(tasks)))]
    finally:
        pool.close()
        reader.close()


def data_drills(route, rec, seed, problems):
    """Phase 15 (d): a dead decode worker fails next() naming its site
    within the poll bound; two transient read faults are retried into the
    clean pass's batches; the registry carries the data views."""
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch import faults
    from mxnet_tpu_torch.obs.registry import REGISTRY
    shape, batch, resize = (3, 64, 64), 16, 72

    def first_batches(nw):
        if route == "none":
            return _raw_pool_epoch(rec, nw, batch)
        it = _cls_iter(route, rec, nw, seed, shape, batch, resize)
        try:
            return [it.next_host().data[0] for _ in range(4)]
        finally:
            it.close()

    faults.clear()
    faults.inject("data.worker_die", nth=2, kind="die")
    t0 = time.perf_counter()
    err = None
    try:
        first_batches(2)
    except mt.MXNetError as e:
        err = str(e)
    dt = time.perf_counter() - t0
    faults.clear()
    log("data (d) drill data.worker_die: next() raised in %.3f s (bound "
        "%.1f s): %s" % (dt, DRILL_POLL_S, err))
    if err is None or "data.worker_die" not in err or dt > DRILL_POLL_S:
        problems.append("data.worker_die: raised %r after %.1f s"
                        % (err, dt))

    clean = first_batches(2)
    mt.io.DATA_HEALTH.reset()
    faults.inject("io.record_read", nth=3, kind="transient", times=2)
    got = first_batches(2)
    faults.clear()
    retries = mt.io.DATA_HEALTH.report()["retries"]
    same = all(np.array_equal(a, b) for a, b in zip(got, clean))
    log("data (d) drill io.record_read@3=transient*2: DATA_HEALTH.retries "
        "%d, the 4 batches equal the clean pass's %s" % (retries, same))
    if retries != 2 or not same:
        problems.append("io.record_read drill: retries %d, same %s"
                        % (retries, same))
    views = sorted({k.split(".")[0] for k in REGISTRY.snapshot()})
    log("data (d) registry views: %s; data_health %s" % (
        views, mt.io.DATA_HEALTH.report()))
    for v in ("data_health", "pipeline_stats", "training_health"):
        if v not in views:
            problems.append("the registry has no %s view" % v)


def _drain(it):
    """Batches of one epoch through ``it.next_host()``."""
    n = 0
    while True:
        try:
            it.next_host()
        except StopIteration:
            return n
        n += 1


def _resnet_fit(mt, sym, it, seed, epochs):
    """Module(compute_dtype="bfloat16").fit over ``it`` at k=DATA_K; returns
    (module, epoch end times, accuracy counts)."""
    import torch
    ends = []
    metric = mt.metric.Accuracy()

    def on_epoch(*_):
        torch.cuda.synchronize()
        ends.append(time.perf_counter())
    mt.random.seed(seed)
    mod = mt.mod.Module(sym, context=mt.gpu(0), compute_dtype="bfloat16")
    torch.cuda.synchronize()
    ends.append(time.perf_counter())
    mod.fit(it, num_epoch=epochs, eval_metric=metric, optimizer="sgd",
            optimizer_params=MODULE_OPT, initializer=mt.initializer.Xavier(),
            steps_per_dispatch=DATA_K, epoch_end_callback=on_epoch)
    return mod, ends, metric.num_inst


def data_resnet(route, rec, seed, card, problems):
    """Phase 15 (c): ResNet-50 NCHW bf16 from the JPEG records against a
    device-resident NDArrayIter of the same shapes."""
    import torch
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch import data as tdata, models
    workers = min(4, os.cpu_count() or 1)
    warm, timed = DATA_EPOCHS
    n = DATA_IMAGES - DATA_IMAGES % DATA_BATCH
    sym = models.resnet(num_layers=50, num_classes=DATA_CLASSES,
                        image_shape="3,%d,%d" % (DATA_IMAGE, DATA_IMAGE))

    # the first two superbatches that reach the card during the fit
    landed = []
    real_next = tdata.DevicePrefetcher.next

    def recording(self):
        sb = real_next(self)
        if len(landed) < 2:
            landed.append([a.data.clone() for a in sb.data + sb.label])
        return sb
    it = _cls_iter(route, rec, workers, seed)
    tdata.DevicePrefetcher.next = recording
    try:
        mod, ends, count = _resnet_fit(mt, sym, it, seed, warm + timed)
    finally:
        tdata.DevicePrefetcher.next = real_next
    stats, health = it.data_stats.report(), it.data_health.report()
    it.close()
    real_ips = timed * n / (ends[-1] - ends[warm])
    finite = all(torch.isfinite(v.data).all()
                 for v in mod.get_params()[0].values())

    # the decode pool alone over one epoch, with no training beside it
    it = _cls_iter(route, rec, workers, seed)
    t0 = time.perf_counter()
    nbatch = _drain(it)
    alone_ips = nbatch * DATA_BATCH / (time.perf_counter() - t0)
    it.close()

    ref = _cls_iter(route, rec, 1, seed)
    want = []
    for _ in range(2):
        parts = [ref.next_host() for _ in range(DATA_K)]
        want.append([np.stack([p.data[0] for p in parts]),
                     np.stack([p.label[0] for p in parts])])
    ref.close()
    dev = mt.gpu(0).to_device()
    same = len(landed) == 2 and all(
        a.device.type == dev.type and np.array_equal(a.cpu().numpy(), b)
        for got, exp in zip(landed, want) for a, b in zip(got, exp))

    gen = torch.Generator(dev).manual_seed(seed)
    x = torch.randn((n, 3, DATA_IMAGE, DATA_IMAGE), generator=gen,
                    device=dev)
    y = torch.randint(0, DATA_CLASSES, (n,), generator=gen, device=dev)
    synth = mt.io.NDArrayIter(mt.nd.NDArray(x), mt.nd.NDArray(y.float()),
                              batch_size=DATA_BATCH)
    _, sends, _ = _resnet_fit(mt, sym, synth, seed, warm + timed)
    synth_ips = timed * n / (sends[-1] - sends[warm])
    # the synthetic fit again, over a share of the images (one warm-up and
    # one timed epoch), with the decode workers busy beside it (a thread
    # draining the records epoch after epoch): what the workers' threads
    # cost the training loop's own host time
    half = n // DATA_BUSY_SHARE
    synth = mt.io.NDArrayIter(mt.nd.NDArray(x[:half]),
                              mt.nd.NDArray(y[:half].float()),
                              batch_size=DATA_BATCH)
    busy = _cls_iter(route, rec, workers, seed)
    stop = threading.Event()

    def drain_forever():
        while not stop.is_set():
            try:
                busy.next_host()
            except StopIteration:
                busy.reset()
    drainer = threading.Thread(target=drain_forever, daemon=True)
    drainer.start()
    try:
        _, bends, _ = _resnet_fit(mt, sym, synth, seed, 2)
    finally:
        stop.set()
        drainer.join(timeout=60)
        busy.close()
    del x, y, synth
    busy_ips = half / (bends[-1] - bends[-2])
    log("data (c) ResNet-50 NCHW bf16 b=%d k=%d from %d JPEG records "
        "through %s(num_workers=%d): %.1f images/s over %d timed epochs "
        "(host clock, each epoch ended by a synchronize; warm-up epoch "
        "%.2f s); over a device-resident NDArrayIter of the same shapes "
        "%.1f images/s; real/synthetic %.3f; the last epoch's accuracy "
        "over %d samples, parameters finite %s [%s]"
        % (DATA_BATCH, DATA_K, n, "ImageRecordIter" if route == "native"
           else "ImageIter", workers, real_ips, timed, ends[warm] - ends[0],
           synth_ips, real_ips / synth_ips, count, finite, card))
    per_core = (stats.get("decode_n", 0)
                / max(stats.get("decode_s", 0.0), 1e-9))
    log("data (c) PipelineStats %s; decode %.1f images/s a worker thread "
        "(decode_n over decode_s); DataHealth %s" % (stats, per_core,
                                                     health))
    log("data (c) the same %d workers decoding one epoch with no training "
        "beside them: %.1f images/s; the device-resident fit (%d images, "
        "its second epoch timed) with those workers decoding beside it: "
        "%.1f images/s, against %.1f without (host clock) [%s]"
        % (workers, alone_ips, half, busy_ips, synth_ips, card))
    log("data (c) the first 2 superbatches that reached the card equal a "
        "1-worker pass bit for bit: %s" % same)
    if not same:
        problems.append("the first superbatches differ from a 1-worker "
                        "pass")
    if not finite or count != n:
        problems.append("ResNet-50 from JPEG: finite %s, %d samples"
                        % (finite, count))
    return {"real_ips": real_ips, "synthetic_ips": synth_ips,
            "decode_alone_ips": alone_ips, "synthetic_busy_ips": busy_ips,
            "stall_frac": stats.get("stall_frac")}


def data_ssd(rec, seed, card, problems):
    """Phase 15 (e): SSD trained from the detection records through
    ImageDetIter and Module.fit at phase 12's settings; B2 once a step,
    held bit for bit against the plain NMS on the last step's inputs."""
    import torch
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch.ops import contrib, multibox_nms as mnms
    from mxnet_tpu_torch.models import ssd
    with mt.symbol.NameManager():
        sym = ssd.get_symbol_train(num_classes=SSD_TRAIN_CLASSES)
    steps = DET_IMAGES // DET_BATCH
    arg_params = xavier_params(sym, (DET_BATCH,) + SSD_INPUT, seed,
                               {"label": (DET_BATCH, DET_OBJECTS, 5)})
    it = mt.image.ImageDetIter(DET_BATCH, SSD_INPUT, rec, rand_mirror=True,
                               label_shape=(DET_OBJECTS, 5), seed=seed,
                               mean_pixels=(110, 110, 110),
                               std_pixels=(60, 60, 60))
    plain_detection = contrib.multibox_detection
    seen = {}

    def recording(*args, **kw):
        out = plain_detection(*args, **kw)
        seen.update(args=[a.detach().clone() for a in args], kw=kw,
                    out=out.detach().clone())
        return out
    stamps = []

    def stamp(_):
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())
    metric = mt.metric.MultiBoxMetric()
    mod = mt.mod.Module(sym, data_names=("data",), label_names=("label",),
                        context=mt.gpu(0))
    with no_tf32(), deterministic_cudnn():
        torch.cuda.synchronize()
        contrib.multibox_detection = recording
        # the main path: counts at 0 just before, read just after
        mnms.reset_launches()
        try:
            mod.fit(it, num_epoch=1, eval_metric=metric, optimizer="adam",
                    optimizer_params=dict(SSD_TRAIN_OPT),
                    arg_params=arg_params, steps_per_dispatch=1,
                    batch_end_callback=stamp)
            torch.cuda.synchronize()
        finally:
            contrib.multibox_detection = plain_detection
        launches, routes = mnms.LAUNCHES, dict(mnms.LAUNCHES_BY_ROUTE)
        with torch.no_grad():
            plain = plain_detection(*seen["args"],
                                    nms=mnms.nms_alive_reference,
                                    **seen["kw"])
    det = seen["out"]
    kept = int((det[:, :, 0] >= 0).sum())
    sums = _multibox_sums(metric)
    ips = (len(stamps) - 1) * DET_BATCH / (stamps[-1] - stamps[0])
    log("data (e) SSD (get_symbol_train() defaults, f32, Adam) from %d "
        "JPEG records through ImageDetIter(b=%d, %s, rand_mirror, "
        "label_shape=(%d, 5)) and Module.fit k=1: %d steps, %.1f images/s "
        "over steps 2-%d (host clock, each step ended by a synchronize; "
        "phase 12's NDArrayIter fit: see its line); MultiBoxMetric (CE, "
        "smooth-L1, valid) %s; multibox_nms launches %d (by route %s); the "
        "last step's det_out %s, %d rows kept, equal to the plain NMS on "
        "its inputs: %s [%s]"
        % (DET_IMAGES, DET_BATCH, "x".join(map(str, SSD_INPUT)),
           DET_OBJECTS, len(stamps), ips, len(stamps), sums, launches,
           routes, tuple(det.shape), kept, torch.equal(det, plain), card))
    if launches != steps or routes != {"smem": steps, "l2": 0}:
        problems.append("SSD from JPEG: multibox_nms ran %d times (%s) in "
                        "%d steps" % (launches, routes, steps))
    if not torch.equal(det, plain) or kept == 0:
        problems.append("SSD from JPEG: det_out differs from the plain NMS "
                        "path, or keeps nothing")
    if not np.isfinite(sums[0] / max(sums[2], 1)):
        problems.append("SSD from JPEG: cross-entropy %r" % (sums,))
    return {"launches": launches, "ips": ips}


def data_phase(seed, card):
    """Phase 15 (see the module docstring). Returns the NMS kernel's
    launches on this path."""
    import tempfile as _tempfile
    t_phase = time.perf_counter()
    probe, route = data_probe()
    problems = []
    out = {"route": route, "launches": 0}
    with _tempfile.TemporaryDirectory() as tmp:
        cls_rec = os.path.join(tmp, "train.rec")
        if route == "none":
            from mxnet_tpu_torch import recordio
            w = recordio.MXIndexedRecordIO(
                os.path.join(tmp, "train.idx"), cls_rec, "w")
            rng = np.random.default_rng(seed)
            for i in range(256):
                w.write_idx(i, recordio.pack(
                    recordio.IRHeader(0, float(i % DATA_CLASSES), i, 0),
                    rng.bytes(int(rng.integers(100, 4000)))))
            w.close()
            log("data: neither libjpeg nor Pillow on this machine: (b), (c) "
                "and (e) cannot run here; the drills run on the reader and "
                "the decode pool over raw records")
        else:
            rng = np.random.default_rng(seed + 15)
            ang = rng.uniform(0, np.pi, DATA_CLASSES)
            freq = rng.uniform(3, 9, DATA_CLASSES)
            base = rng.uniform(0.25, 0.75, (DATA_CLASSES, 3))
            xs = np.linspace(0, 1, DATA_SIZE)
            gx, gy = np.meshgrid(xs, xs, indexing="ij")
            t0 = time.perf_counter()
            nb = write_records(cls_rec, DATA_IMAGES, lambda i: (
                _cls_image(seed, i, DATA_SIZE, ang, freq, base, gx, gy),
                float(i % DATA_CLASSES)), DATA_QUALITY)
            det_rec = os.path.join(tmp, "det.rec")
            nd_ = write_records(det_rec, DET_IMAGES, lambda i: _det_image(
                seed, i, SSD_INPUT[1]), DATA_QUALITY)
            log("data (b) records: %d classification JPEGs at %dx%d "
                "(quality %d, %d classes, %.1f MB) and %d detection JPEGs "
                "at %dx%d with 1-%d boxes (%.1f MB), written in %.2f s"
                % (DATA_IMAGES, DATA_SIZE, DATA_SIZE, DATA_QUALITY,
                   DATA_CLASSES, nb / 1e6, DET_IMAGES, SSD_INPUT[1],
                   SSD_INPUT[2], DET_OBJECTS, nd_ / 1e6,
                   time.perf_counter() - t0))
        from mxnet_tpu_torch import native_build
        t0 = time.perf_counter()
        native_build.load("reader")
        log("data: the native reader library (no libjpeg) built in %.2f s: "
            "%s" % (time.perf_counter() - t0, native_build.build("reader")))
        if route != "native":
            try:
                native_build.load("decoder")
                problems.append("the probe found no libjpeg, yet the native "
                                "decoder library built")
            except Exception as e:
                msg = str(e)
                log("data: the native decoder library does not build here, "
                    "as the probe said: %s" % " ".join(msg.split())[:300])
                if "g++ failed" not in msg and "compiler" not in msg:
                    problems.append("the failed build's error does not "
                                    "carry the compiler's message")
            log("data: libjpeg's headers and library are absent on this "
                "machine, so ImageRecordIter's host route (device='cpu', "
                "the native fused decode) cannot run here; its card route "
                "(nvJPEG) runs in phase 28%s" % (
                    "; (c) trains from the same records through ImageIter "
                    "(Pillow decode, the reference's fallback) and (e)'s "
                    "imdecode decodes with Pillow" if route == "pillow"
                    else ""))
        else:
            t0 = time.perf_counter()
            native_build.load("decoder")
            log("data: the native decoder library built in %.2f s: %s"
                % (time.perf_counter() - t0, native_build.build("decoder")))
        if route != "none":
            out.update(data_resnet(route, cls_rec, seed, card, problems))
        data_drills(route, cls_rec, seed, problems)
        if route != "none":
            ssd_out = data_ssd(det_rec, seed, card, problems)
            out.update(launches=ssd_out["launches"], ssd_ips=ssd_out["ips"])
    log("data: the phase took %.1f s" % (time.perf_counter() - t_phase))
    if problems:
        raise SystemExit("data phase failed: " + "; ".join(problems))
    return out


# ---------------------------------------------------------------------------
# phase 16: variable-length training (the LSTM language model)
# ---------------------------------------------------------------------------

#: example/rnn/lstm_bucketing.py at its published widths: a 2-layer,
#: 200-unit FusedRNNCell LSTM over a 200-wide embedding, PTB's vocabulary,
#: batch 32, buckets 10-60, Adam at lr 0.01, Perplexity(ignore_label=0)
LSTM_VOCAB = 10000
LSTM_HIDDEN = 200
LSTM_EMBED = 200
LSTM_LAYERS = 2
LSTM_BATCH = 32
LSTM_BUCKETS = (10, 20, 30, 40, 60)
LSTM_SENTENCES = 1600    # cut from 3200: the script's time limit
LSTM_LR = 0.01
LSTM_EPOCHS = 2
LSTM_K = 4
#: batches the monitor fit (d) and the child's profile (e) train
LSTM_MONITOR_BATCHES = 3
LSTM_PROFILE_STEPS = 8
#: timed steps a bucket (f)
LSTM_TIMED_STEPS = 5
#: the card against the CPU port on the same weights and inputs: the RNN
#: op's outputs (absolute) and gradients (relative to the largest
#: gradient); float32 on both, summed in other orders, through 60 steps
LSTM_OP_ATOL = 2e-5
LSTM_OP_GRAD_RTOL = 1e-4
#: the monitor's statistics, card against CPU (relative)
LSTM_MONITOR_RTOL = 1e-4
#: the example's loop against the fused step (fit's at K=1) over the first
#: LSTM_LOOP_STEPS batches from one state: the relative norm of each
#: parameter's difference after each step. The loop's Adam is the
#: per-index updater, which rounds nearly every element of its update one
#: ulp away from the fused update (folded float64 rate against a float32
#: tensor one), and each step adds such differences (measured on the card:
#: 1.8e-6 after one step, 9.7e-5 after four); over two epochs training
#: amplifies them to different trajectories, so the whole runs are held
#: by their perplexity falling, not against each other
LSTM_LOOP_STEPS = 4
LSTM_LOOP_RTOL = 1e-3
#: fit at K=4 against K=1 when they are not bit for bit (only if the
#: embedding's backward is not bitwise repeatable on this card)
LSTM_K_RTOL = 1e-3
#: where the phase runs (a CPU rehearsal sets "cpu")
LSTM_CTX = "gpu"


def _lstm_ctx():
    import mxnet_tpu_torch as mt
    return mt.gpu(0) if LSTM_CTX == "gpu" else mt.cpu()


def lstm_sentences(seed):
    """The example's learnable synthetic language (next token = token + 1,
    ids 1..vocab-1; 0 is the padding label) from ``seed``, with lengths
    spread over the buckets: each sentence picks a bucket, then a length
    above the bucket below it."""
    rng = np.random.default_rng([seed, 16])
    vocab, buckets = LSTM_VOCAB, LSTM_BUCKETS
    out = []
    lo = (1,) + tuple(buckets[:-1])
    for _ in range(LSTM_SENTENCES):
        b = int(rng.integers(len(buckets)))
        length = int(rng.integers(lo[b] + 1, buckets[b] + 1))
        s0 = int(rng.integers(1, vocab))
        out.append([(s0 + t - 1) % (vocab - 1) + 1 for t in range(length)])
    return out


def lstm_iter(seed, sentences, buckets=None, max_batches=None):
    """BucketSentenceIter over ``sentences`` with the LSTM's zero begin
    states appended to each batch (as the example's iterator does), its
    order a function of ``seed`` and the number of resets (so every fit
    sees the same batches in the same order)."""
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch import random as trandom
    batch = LSTM_BATCH
    state = (LSTM_LAYERS, batch, LSTM_HIDDEN)
    with trandom.scoped_np_rng(np.random.default_rng([seed, 0])):
        inner = mt.rnn.BucketSentenceIter(sentences, batch,
                                          buckets=list(buckets
                                                       or LSTM_BUCKETS),
                                          invalid_label=0, layout="NT")

    class StateIter(mt.io.DataIter):
        def __init__(self):
            super().__init__(batch)
            self.default_bucket_key = inner.default_bucket_key
            self.provide_data = list(inner.provide_data) + [
                mt.io.DataDesc("lstm_begin_state_0", state),
                mt.io.DataDesc("lstm_begin_state_1", state)]
            self.provide_label = inner.provide_label
            self.resets = 0
            self.served = 0
            self.zeros = np.zeros(state, np.float32)

        def reset(self):
            self.resets += 1
            self.served = 0
            with trandom.scoped_np_rng(
                    np.random.default_rng([seed, self.resets])):
                inner.reset()

        def next_host(self):
            if max_batches is not None and self.served == max_batches:
                raise StopIteration
            b = inner.next_host()
            self.served += 1
            b.data = list(b.data) + [self.zeros, self.zeros]
            b.provide_data = list(b.provide_data) + self.provide_data[1:]
            return b

        def next(self):
            b = self.next_host()
            b.data = [mt.nd.array(v, ctx=mt.cpu()) for v in b.data]
            b.label = [mt.nd.array(v, ctx=mt.cpu()) for v in b.label]
            return b

    return StateIter()


def lstm_sym_gen():
    """The example's sym_gen: embedding, FusedRNNCell LSTM (begin states
    fed as data), a softmax over the vocabulary at every step."""
    import mxnet_tpu_torch as mt
    cell = mt.rnn.FusedRNNCell(LSTM_HIDDEN, num_layers=LSTM_LAYERS,
                               mode="lstm", prefix="lstm_")

    def sym_gen(seq_len):
        data = mt.sym.Variable("data")
        label = mt.sym.Variable("softmax_label")
        embed = mt.sym.Embedding(data=data, input_dim=LSTM_VOCAB,
                                 output_dim=LSTM_EMBED, name="embed")
        outputs, _ = cell.unroll(seq_len, inputs=embed, layout="NTC",
                                 merge_outputs=True)
        pred = mt.sym.Reshape(data=outputs, shape=(-1, LSTM_HIDDEN))
        pred = mt.sym.FullyConnected(data=pred, num_hidden=LSTM_VOCAB,
                                     name="pred")
        label_flat = mt.sym.Reshape(data=label, shape=(-1,))
        pred = mt.sym.SoftmaxOutput(data=pred, label=label_flat,
                                    name="softmax")
        return pred, ("data", "lstm_begin_state_0",
                      "lstm_begin_state_1"), ("softmax_label",)
    return sym_gen


def lstm_params(seed):
    """The model's weights on the host from ``seed``: Xavier for the
    embedding and the head, the FusedRNN initializer (Xavier a gate
    block, forget bias 1) for the packed LSTM vector."""
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch import initializer as init
    from mxnet_tpu_torch.ops.rnn_op import rnn_param_size
    saved = mt.random.get_state()
    mt.random.seed(seed)
    shapes = {"embed_weight": (LSTM_VOCAB, LSTM_EMBED),
              "lstm_parameters": (rnn_param_size(
                  "lstm", LSTM_EMBED, LSTM_HIDDEN, LSTM_LAYERS, False),),
              "pred_weight": (LSTM_VOCAB, LSTM_HIDDEN),
              "pred_bias": (LSTM_VOCAB,)}
    out = {}
    for n, shape in shapes.items():
        out[n] = mt.nd.zeros(shape, ctx=mt.cpu())
        if n == "lstm_parameters":
            init.FusedRNN(init.Xavier(), LSTM_HIDDEN, LSTM_LAYERS, "lstm")(
                init.InitDesc(n), out[n])
        else:
            init.Xavier()(init.InitDesc(n), out[n])
    mt.random.set_state(saved)
    return out


def lstm_module(it, ctx=None):
    import mxnet_tpu_torch as mt
    return mt.mod.BucketingModule(lstm_sym_gen(),
                                  default_bucket_key=it.default_bucket_key,
                                  context=ctx or _lstm_ctx())


def _host_params(mod):
    args, _ = mod.get_params()
    return {n: v.asnumpy() for n, v in args.items()}


def lstm_fit(seed, sentences, params, k, **kw):
    """``BucketingModule.fit`` over the phase's batches: returns the
    module, each epoch's perplexity and each epoch's seconds."""
    import mxnet_tpu_torch as mt
    it = lstm_iter(seed, sentences)
    mod = lstm_module(it)
    metric = mt.metric.Perplexity(ignore_label=0)
    ppl, marks = [], [time.perf_counter()]

    def epoch_end(*a):
        ppl.append(metric.get()[1])
        marks.append(time.perf_counter())
    mod.fit(it, eval_metric=metric, num_epoch=LSTM_EPOCHS, arg_params=params,
            optimizer="adam", optimizer_params={"learning_rate": LSTM_LR},
            steps_per_dispatch=k, dispatch_pipeline=1,
            epoch_end_callback=epoch_end, **kw)
    return mod, ppl, [b - a for a, b in zip(marks, marks[1:])]


def lstm_op_check(seed, card):
    """(a): the RNN op on the card against the same op on the CPU (LSTM
    and GRU, forward and gradients) on the same weights, at bucket 60;
    then its time beside torch._VF.lstm on the same unpacked weights."""
    import torch
    from mxnet_tpu_torch.ops import rnn_op
    from mxnet_tpu_torch.ops.registry import OpContext
    dev = "cuda" if LSTM_CTX == "gpu" else "cpu"
    T, N, C, H, L = max(LSTM_BUCKETS), LSTM_BATCH, LSTM_EMBED, \
        LSTM_HIDDEN, LSTM_LAYERS
    rng = np.random.default_rng([seed, 161])
    for mode in ("lstm", "gru"):
        size = rnn_op.rnn_param_size(mode, C, H, L, False)
        ins = [rng.standard_normal((T, N, C)).astype(np.float32),
               (rng.uniform(-1, 1, size) / np.sqrt(H)).astype(np.float32),
               (0.5 * rng.standard_normal((L, N, H))).astype(np.float32)]
        if mode == "lstm":
            ins.append((0.5 * rng.standard_normal((L, N, H)))
                       .astype(np.float32))
        attrs = dict(state_size=H, num_layers=L, mode=mode,
                     state_outputs=True)
        cots = [rng.standard_normal(s).astype(np.float32)
                for s in [(T, N, H)] + [(L, N, H)] * (len(ins) - 2)]
        res = {}
        for where in ("cpu", dev):
            leaves = [torch.from_numpy(i).to(where).requires_grad_()
                      for i in ins]
            outs = rnn_op._rnn(OpContext(is_train=True), attrs, leaves, [])
            grads = torch.autograd.grad(
                outs, leaves, [torch.from_numpy(c).to(where) for c in cots])
            res[where] = ([o.detach().cpu().numpy() for o in outs],
                          [g.cpu().numpy() for g in grads])
        fwd = max(float(np.abs(a - b).max())
                  for a, b in zip(res[dev][0], res["cpu"][0]))
        grad = max(float(np.abs(a - b).max() / np.abs(b).max())
                   for a, b in zip(res[dev][1], res["cpu"][1]))
        log("lstm (a) RNN op %s, T=%d N=%d C=%d H=%d L=%d: card against "
            "CPU, outputs max |diff| %.3g (limit %g), gradients max |diff| "
            "/ max |g| %.3g (limit %g)" % (mode, T, N, C, H, L, fwd,
                                          LSTM_OP_ATOL, grad,
                                          LSTM_OP_GRAD_RTOL))
        if not (fwd <= LSTM_OP_ATOL and grad <= LSTM_OP_GRAD_RTOL):
            raise SystemExit("lstm (a): the card's RNN op %s disagrees with "
                             "the CPU's" % mode)
    if dev != "cuda":
        return
    # the op against cuDNN's LSTM (torch._VF.lstm) on the same weights
    size = rnn_op.rnn_param_size("lstm", C, H, L, False)
    params = torch.from_numpy((rng.uniform(-1, 1, size) / np.sqrt(H))
                              .astype(np.float32)).cuda()
    x = torch.from_numpy(rng.standard_normal((T, N, C))
                         .astype(np.float32)).cuda()
    h0 = torch.zeros(L, N, H, device="cuda")
    c0 = torch.zeros(L, N, H, device="cuda")
    slices, _ = rnn_op._param_slices("lstm", C, H, L, False)
    lstm = torch.nn.LSTM(C, H, L).cuda()
    with torch.no_grad():
        for layer in range(L):
            wx, wh, bx, bh = (rnn_op._take(params, s)
                              for s in slices[(layer, 0)])
            getattr(lstm, "weight_ih_l%d" % layer).copy_(wx)
            getattr(lstm, "weight_hh_l%d" % layer).copy_(wh)
            getattr(lstm, "bias_ih_l%d" % layer).copy_(bx)
            getattr(lstm, "bias_hh_l%d" % layer).copy_(bh)
    lstm.flatten_parameters()
    weights = lstm._flat_weights
    attrs = dict(state_size=H, num_layers=L, mode="lstm")
    leaves = [x.clone().requires_grad_(), params.clone().requires_grad_()]
    wleaves = [x.clone().requires_grad_()]

    def ours():
        return rnn_op._rnn(OpContext(is_train=True), attrs,
                           [leaves[0], leaves[1], h0, c0], [])[0]

    def cudnn():
        return torch._VF.lstm(wleaves[0], (h0, c0), weights, True, L, 0.0,
                              True, False, False)[0]

    def fwd_bwd(fn, ins):
        def run():
            out = fn()
            torch.autograd.grad(out, ins, torch.ones_like(out))
        return run

    def no_grad(fn):
        def run():
            with torch.no_grad():
                fn()
        return run

    with no_tf32():
        with torch.no_grad():
            diff = float((ours() - cudnn()).abs().max())
        times = {}
        for _ in range(2):   # in turns
            for name, fn in (("RNN op forward", no_grad(ours)),
                             ("torch._VF.lstm forward (cuDNN, TF32 off)",
                              no_grad(cudnn)),
                             ("RNN op forward+backward",
                              fwd_bwd(ours, leaves)),
                             ("torch._VF.lstm forward+backward (cuDNN, TF32 "
                              "off)", fwd_bwd(cudnn, wleaves))):
                times.setdefault(name, []).append(cuda_time_ms(fn, 5))
    torch.backends.cudnn.allow_tf32 = True
    try:
        times["torch._VF.lstm forward+backward (cuDNN, TF32 on)"] = [
            cuda_time_ms(fwd_bwd(cudnn, wleaves), 5)]
    finally:
        torch.backends.cudnn.allow_tf32 = False
    # the forward's products: each layer's input projection and recurrence
    flops = sum(2 * T * N * 4 * H * ((C if layer == 0 else H) + H)
                for layer in range(L))
    nbytes = (params.numel() + x.numel() + T * N * H + 4 * L * N * H) * 4
    bound = max(flops / FP32_OPS_PER_S, nbytes / HBM_BYTES_PER_S) * 1e3
    log("lstm (a) RNN op against torch._VF.lstm at bucket 60: outputs max "
        "|diff| %.3g; %s" % (diff, card))
    for name, ms in times.items():
        log("  %-58s %s ms (CUDA events, %d calls a turn)"
            % (name, " / ".join("%.3f" % t for t in ms), 5))
    log("  forward bound %.4f ms (%.3g GFLOP at the FP32 peak)"
        % (bound, flops / 1e9))


def lstm_bucket_times(mod, seed, sentences, card):
    """(f): each bucket's fused step on the shared state, timed on the host
    clock and on CUDA events, and its tokens/s (padded)."""
    import torch
    it = lstm_iter(seed, sentences)
    first = {}
    for b in it:
        first.setdefault(b.bucket_key, b)
        if len(first) == len(LSTM_BUCKETS):
            break
    for key in LSTM_BUCKETS:
        b = first[key]
        assert mod._try_fused_fit_step(b)     # warm
        sync = (torch.cuda.synchronize if LSTM_CTX == "gpu"
                else (lambda: None))
        sync()
        host = []
        ev = None
        if LSTM_CTX == "gpu":
            ev = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
            ev[0].record()
        for _ in range(LSTM_TIMED_STEPS):
            t0 = time.perf_counter()
            mod._try_fused_fit_step(b)
            host.append((time.perf_counter() - t0) * 1e3)
        if ev is not None:
            ev[1].record()
        sync()
        ev_ms = (ev[0].elapsed_time(ev[1]) / LSTM_TIMED_STEPS
                 if ev is not None else float("nan"))
        tokens = LSTM_BATCH * key
        step_ms = ev_ms if ev is not None else float(np.median(host))
        log("lstm (f) bucket %2d: %5d tokens a step, host %.2f ms a step "
            "(median of %d; the step returns before the card finishes), "
            "CUDA events %.2f ms a step, %.0f tokens/s; %s"
            % (key, tokens, float(np.median(host)), LSTM_TIMED_STEPS, ev_ms,
               tokens / (step_ms / 1e3), card))


def lstm_monitor_check(seed, sentences, params, card):
    """(d): fit with a Monitor on the card and on the CPU port, same
    weights and batches: the rows of the monitored batch must agree."""
    import mxnet_tpu_torch as mt
    rows = {}
    for where, ctx in (("card", _lstm_ctx()), ("cpu", mt.cpu())):
        class Rec(mt.Monitor):
            got = []

            def toc_print(self):
                self.got.extend(self.toc())
        mon = Rec(interval=LSTM_MONITOR_BATCHES, pattern=".*weight")
        mon.got = []
        it = lstm_iter(seed, sentences, max_batches=LSTM_MONITOR_BATCHES)
        mod = lstm_module(it, ctx=ctx)
        mod.fit(it, eval_metric=mt.metric.Perplexity(ignore_label=0),
                num_epoch=1, arg_params=params, optimizer="adam",
                optimizer_params={"learning_rate": LSTM_LR}, monitor=mon)
        rows[where] = mon.got
    for n, k, v in rows["card"]:
        log("lstm (d) Monitor: Batch: %7d %30s %s" % (n, k, v))
    if [r[:2] for r in rows["card"]] != [r[:2] for r in rows["cpu"]] \
            or not rows["card"]:
        raise SystemExit("lstm (d): the monitor's rows differ between the "
                         "card and the CPU: %r / %r"
                         % (rows["card"], rows["cpu"]))
    worst = max(abs(float(a[2]) / float(b[2]) - 1.0)
                for a, b in zip(rows["card"], rows["cpu"]))
    log("lstm (d) Monitor(interval=%d, pattern='.*weight'): %d rows; card "
        "against the CPU port, worst relative difference %.3g (limit %g)"
        % (LSTM_MONITOR_BATCHES, len(rows["card"]), worst,
           LSTM_MONITOR_RTOL))
    if worst > LSTM_MONITOR_RTOL:
        raise SystemExit("lstm (d): the card's monitor values disagree with "
                         "the CPU's")


def _clone_tree(x):
    if isinstance(x, dict):
        return {n: _clone_tree(v) for n, v in x.items()}
    if isinstance(x, tuple):
        return tuple(_clone_tree(v) for v in x)
    return None if x is None else x.clone()


def _embedding_repeatable(mod, seed, sentences):
    """Whether two fused steps from one state on one batch give the same
    bits (the embedding's backward accumulates through an index_put)."""
    import torch
    b = next(iter(lstm_iter(seed, sentences)))
    ts = mod._get_bucket_step(b.bucket_key)
    batch = {n: v.data for n, v in zip(ts.data_names, b.data)}
    batch.update((n, v.data) for n, v in zip(ts.label_names, b.label))
    outs = []
    for _ in range(2):
        st = _clone_tree(mod._fused_state)
        ts.step(st, batch)
        outs.append(st["params"])
    return all(torch.equal(outs[0][n], outs[1][n]) for n in outs[0])


def lstm_profile_child(out_dir, seed):
    """(e), run in a fresh process with MXNET_PROFILER_AUTOSTART=1: the
    profile starts at the first dispatch of a bucket-60 fit (K=4, under a
    fault plan); then a Scope brackets LSTM_PROFILE_STEPS more steps of
    that bucket, whose kernels give a step's breakdown; the trace is
    written as Chrome JSON and the registry printed as Prometheus text.
    The last line is one JSON object of what it saw."""
    import torch
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch import faults, profiler
    from mxnet_tpu_torch.obs import REGISTRY
    assert profiler._autostart_pending, "MXNET_PROFILER_AUTOSTART unset"
    path = os.path.join(out_dir, "lstm_profile.json")
    profiler.profiler_set_config(filename=path)
    sentences = [s for s in lstm_sentences(seed)
                 if len(s) > LSTM_BUCKETS[-2]]
    params = lstm_params(seed)
    it = lstm_iter(seed, sentences, buckets=LSTM_BUCKETS[-1:],
                   max_batches=2 * LSTM_K)
    mod = lstm_module(it)
    plan = [{"site": "io.batch_read", "kind": "transient", "nth": 2},
            {"site": "checkpoint.write", "kind": "raise", "nth": 1}]
    before = mt.io.DATA_HEALTH.report()["retries"]
    with faults.plan_scope(plan):
        pending = profiler._autostart_pending
        mod.fit(it, eval_metric=mt.metric.Perplexity(ignore_label=0),
                num_epoch=1, arg_params=params, optimizer="adam",
                optimizer_params={"learning_rate": LSTM_LR},
                steps_per_dispatch=LSTM_K)
        fired = faults.fired_counts()
    retries = mt.io.DATA_HEALTH.report()["retries"] - before
    started = pending and profiler._state["running"]
    it.reset()
    b = it.next()
    torch.cuda.synchronize()
    with profiler.Scope("lstm_bucket60_steps", steps=LSTM_PROFILE_STEPS):
        for _ in range(LSTM_PROFILE_STEPS):
            mod._try_fused_fit_step(b)
        torch.cuda.synchronize()
    profiler.dump_profile()
    doc = json.load(open(path))
    events = doc["traceEvents"]
    scope = [e for e in events if e.get("name") == "lstm_bucket60_steps"
             and e.get("ph") == "X"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    window = [e for e in kernels if scope and scope[0]["ts"] <= e["ts"]
              <= scope[0]["ts"] + scope[0]["dur"]]
    by_name = {}
    for e in window:
        by_name[e["name"]] = by_name.get(e["name"], 0.0) + e.get("dur", 0.0)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    prom = REGISTRY.to_prometheus()
    print(prom, end="")
    print(json.dumps({
        "started_at_dispatch": started, "events": len(events),
        "kernel_events": len(kernels), "scope_events": len(scope),
        "fired": fired, "io_retries": retries,
        "steps": LSTM_PROFILE_STEPS,
        "scope_ms": scope[0]["dur"] / 1e3 if scope else 0.0,
        "kernel_ms": sum(by_name.values()) / 1e3,
        "launches_a_step": len(window) / LSTM_PROFILE_STEPS,
        "top_kernels_ms_a_step": [(n[:90], d / 1e3 / LSTM_PROFILE_STEPS)
                                  for n, d in top]}), flush=True)
    return 0


def lstm_child_check(seed, card):
    """(e): run the child, check what it saw."""
    with tempfile.TemporaryDirectory() as tmp:
        env = dict(os.environ, MXNET_PROFILER_AUTOSTART="1")
        t0 = time.perf_counter()
        r = subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--seed", str(seed), "--lstm-profile-child",
                            tmp], capture_output=True, text=True, env=env,
                           timeout=300)
        took = time.perf_counter() - t0
    if r.returncode != 0:
        raise SystemExit("lstm (e): the profiler child failed (exit %d):\n"
                         "%s\n%s" % (r.returncode, r.stdout[-4000:],
                                     r.stderr[-4000:]))
    lines = r.stdout.splitlines()
    res = json.loads(lines[-1])
    prom = lines[:-1]
    log("lstm (e) child (MXNET_PROFILER_AUTOSTART=1, %.1f s): profile "
        "started at the first dispatch: %s; Chrome trace %d events, %d CUDA "
        "kernel events, the Scope's span %d; plan_scope fired %s, "
        "io.batch_read retries %d; %d Prometheus lines, e.g.:"
        % (took, res["started_at_dispatch"], res["events"],
           res["kernel_events"], res["scope_events"], res["fired"],
           res["io_retries"], len(prom)))
    for line in [p for p in prom if p and not p.startswith("#")][:12]:
        log("  " + line)
    busy = res["kernel_ms"] / max(res["scope_ms"], 1e-9)
    log("lstm (e) %d fused steps at bucket 60 under the profiler's Scope: "
        "%.2f ms of kernels a step (%.0f launches) in %.2f ms a step of "
        "wall time: the card busy %.1f%%, idle %.1f%%; %s"
        % (res["steps"], res["kernel_ms"] / res["steps"],
           res["launches_a_step"], res["scope_ms"] / res["steps"],
           100 * busy, 100 * (1 - busy), card))
    for name, ms in res["top_kernels_ms_a_step"]:
        log("  %.3f ms a step  %s" % (ms, name))
    problems = []
    if not res["started_at_dispatch"]:
        problems.append("the profile did not start at the first dispatch")
    if res["kernel_events"] == 0:
        problems.append("the trace holds no CUDA kernel events")
    if res["scope_events"] == 0:
        problems.append("the trace holds no Scope span")
    if res["fired"] != {"io.batch_read": 1} or res["io_retries"] != 1:
        problems.append("plan_scope: fired %r, retries %r"
                        % (res["fired"], res["io_retries"]))
    if not any(p.startswith("data_health_retries") for p in prom):
        problems.append("to_prometheus lacks data_health_retries")
    if problems:
        raise SystemExit("lstm (e): " + "; ".join(problems))


def rnn_phase(seed, card):
    """Phase 16 (see the module docstring)."""
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch.ops import matmul_stats, multibox_nms
    from mxnet_tpu_torch import rtc
    t_phase = time.perf_counter()
    multibox_nms.reset_launches()
    matmul_stats.reset_launches()
    rtc_before = (rtc.RTC_LAUNCHES, rtc.TRITON_LAUNCHES)
    lstm_op_check(seed, card)
    sentences = lstm_sentences(seed)
    params = lstm_params(seed)
    nparams = sum(int(np.prod(v.shape)) for v in params.values())
    nbatch = sum(1 for _ in lstm_iter(seed, sentences))
    log("lstm (b) model: %d-layer %d-unit FusedRNNCell LSTM, embedding %d, "
        "vocabulary %d, batch %d, buckets %s: %d parameters; %d synthetic "
        "sentences from --seed (next token = token + 1), %d batches an "
        "epoch" % (LSTM_LAYERS, LSTM_HIDDEN, LSTM_EMBED, LSTM_VOCAB,
                   LSTM_BATCH, list(LSTM_BUCKETS), nparams, len(sentences),
                   nbatch))
    fits = {}
    for k in (1, LSTM_K):
        mod, ppl, secs = lstm_fit(seed, sentences, params, k)
        fits[k] = (mod, ppl, secs)
        log("lstm (b) BucketingModule.fit K=%d: perplexity by epoch %s; "
            "seconds by epoch %s; %d TrainSteps (one a bucket)"
            % (k, ["%.2f" % p for p in ppl], ["%.2f" % s for s in secs],
               len(mod._bucket_fused)))
        if not (np.all(np.isfinite(ppl)) and ppl[1] < ppl[0]):
            raise SystemExit("lstm (b): perplexity did not fall at K=%d: %r"
                             % (k, ppl))
    p1, p4 = _host_params(fits[1][0]), _host_params(fits[LSTM_K][0])
    bitwise = all(np.array_equal(p1[n], p4[n]) for n in p1)
    worst = max(float(np.linalg.norm(p4[n] - p1[n])
                      / max(np.linalg.norm(p1[n]), 1e-30)) for n in p1)
    repeatable = _embedding_repeatable(fits[1][0], seed, sentences)
    log("lstm (b) K=%d against K=1: parameters %s (worst relative norm of "
        "the difference %.3g); perplexity %s against %s; a fused step "
        "repeated from one state %s"
        % (LSTM_K, "bit for bit" if bitwise else "not bit for bit", worst,
           fits[LSTM_K][1], fits[1][1],
           "gives the same bits" if repeatable else
           "does not give the same bits (the embedding's accumulating "
           "index_put backward)"))
    if not bitwise and (repeatable or worst > LSTM_K_RTOL):
        raise SystemExit("lstm (b): K=%d and K=1 disagree" % LSTM_K)
    # (c) the example's own loop over the same batches
    def loop_module(it):
        mod = lstm_module(it)
        mod.bind(data_shapes=it.provide_data, label_shapes=it.provide_label)
        mod.init_params(arg_params=params)
        mod.init_optimizer(optimizer="adam",
                           optimizer_params={"learning_rate": LSTM_LR})
        return mod

    it_l, it_f = lstm_iter(seed, sentences), lstm_iter(seed, sentences)
    loop, fused = loop_module(it_l), loop_module(it_f)
    steps = []
    for _, b, bf in zip(range(LSTM_LOOP_STEPS), it_l, it_f):
        loop.forward(b, is_train=True)
        loop.backward()
        loop.update()
        assert fused._try_fused_fit_step(bf)
        pl, pf = _host_params(loop), _host_params(fused)
        steps.append(max(float(np.linalg.norm(pl[n] - pf[n])
                               / np.linalg.norm(pf[n])) for n in pf))
    log("lstm (c) the example's loop (forward/backward/update) against fit's "
        "fused step over the first %d batches from one state: worst "
        "relative norm of a parameter's difference after each step %s "
        "(limit %g)" % (LSTM_LOOP_STEPS, ["%.3g" % d for d in steps],
                        LSTM_LOOP_RTOL))
    if max(steps) > LSTM_LOOP_RTOL:
        raise SystemExit("lstm (c): the example's loop disagrees with the "
                         "fused step")
    it = lstm_iter(seed, sentences)
    loop = loop_module(it)
    metric = mt.metric.Perplexity(ignore_label=0)
    lppl = []
    t0 = time.perf_counter()
    for epoch in range(LSTM_EPOCHS):
        if epoch:
            it.reset()
        metric.reset()
        for b in it:
            loop.forward(b, is_train=True)
            loop.backward()
            loop.update()
            loop.update_metric(metric, b.label)
        lppl.append(metric.get()[1])
    loop_s = time.perf_counter() - t0
    pl = _host_params(loop)
    lworst = max(float(np.linalg.norm(pl[n] - p1[n])
                       / np.linalg.norm(p1[n])) for n in p1)
    log("lstm (c) the example's loop over %d epochs (%d bucket executors): "
        "perplexity by epoch %s against fit's %s, %.2f s; the parameters "
        "end %.3g apart in relative norm (the per-step rounding above, "
        "amplified by training)"
        % (LSTM_EPOCHS, len(loop._buckets), ["%.2f" % p for p in lppl],
           ["%.2f" % p for p in fits[1][1]], loop_s, lworst))
    if not (np.all(np.isfinite(lppl)) and lppl[1] < lppl[0]):
        raise SystemExit("lstm (c): the loop's perplexity did not fall")
    lstm_monitor_check(seed, sentences, params, card)
    lstm_child_check(seed, card)
    lstm_bucket_times(fits[1][0], seed, sentences, card)
    total_tokens = sum(LSTM_BATCH * k for k in
                       [b.bucket_key for b in lstm_iter(seed, sentences)])
    for k in (1, LSTM_K):
        secs = fits[k][2][-1]
        log("lstm (f) fit K=%d epoch 2: %d batches, %d tokens (padded) in "
            "%.2f s: %.0f tokens/s overall; %s"
            % (k, nbatch, total_tokens, secs, total_tokens / secs, card))
    launches = (multibox_nms.LAUNCHES, matmul_stats.LAUNCHES,
                rtc.RTC_LAUNCHES - rtc_before[0],
                rtc.TRITON_LAUNCHES - rtc_before[1])
    log("lstm: B2, B1, B3 (Rtc, Triton) launches in this phase: %s (the "
        "LSTM path runs none of them)" % (launches,))
    if any(launches):
        raise SystemExit("lstm: the LSTM path launched a kernel of B1-B3")
    log("lstm: the phase took %.1f s" % (time.perf_counter() - t_phase))


# ---------------------------------------------------------------------------
# phase 17: the transformer LM, trained through Module.fit and served
# through DecodeLoop
# ---------------------------------------------------------------------------

#: bench.py lm_main's defaults (BENCH_LM_*): vocabulary, embed, heads,
#: layers, sequence, batch, compute dtype, steps a dispatch
LM_VOCAB = 1024
LM_EMBED = 256
LM_HEADS = 8
LM_LAYERS = 4
LM_SEQ = 128
LM_BATCH = 32
LM_DTYPE = "bfloat16"
LM_K = 4
#: batches an epoch and epochs of phase 17 (a)
LM_BATCHES = 64
LM_EPOCHS = 2
#: bench.py's SGD (lr 0.1, momentum 0.9, wd 1e-4); the gradient is the
#: mean over the batch's tokens (rescale 1 / (batch x seq)): at the
#: default 1 / batch the flat head's sum over 128 positions makes lr 0.1
#: diverge
LM_OPT = {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4,
          "rescale_grad": 1.0 / (LM_BATCH * LM_SEQ)}
#: K=4 against K=1 where not bit for bit (see phase 16), relative norm
LM_K_RTOL = 1e-3
#: the stacked build against the per-layer build, float32 on the card:
#: elementwise within this fraction of the output's largest value
LM_STACK_RTOL = 1e-5
#: (b): bench.py decode_main's legs over the trained LM: cache rows,
#: slots, requests (an 8-token shared prefix plus a 2-4 token tail each),
#: new tokens a request, the speculative window's draft length
DEC_MAXLEN = 128
DEC_SLOTS = 8
DEC_REQUESTS = 16    # cut from 32: the script's time limit
DEC_NEW = 48         # cut from 96: the script's time limit (phase 28)
DEC_SPEC_K = 2
DEC_SAMPLED = {"temperature": 0.8, "top_k": 50, "top_p": 0.95}
#: a greedy token may differ from the full forward's argmax only where
#: the forward's two probabilities are closer than this (a rounding tie)
DEC_ORACLE_TIE = 1e-5
#: each quantized leg's greedy streams against the float32 leg's: the
#: least share of the float32 tokens reproduced, each stream counted up
#: to its first difference (the serving tier's int8 gate,
#: MXTPU_SERVE_QUANT_MIN_AGREE's default)
DEC_QUANT_AGREE = 0.98
LM_CTX = "gpu"


def _lm_ctx():
    import mxnet_tpu_torch as mt
    return mt.gpu(0) if LM_CTX == "gpu" else mt.cpu()


def _lm_dev():
    return "cuda:0" if LM_CTX == "gpu" else "cpu"


def lm_symbol(layers=LM_LAYERS, **kw):
    import mxnet_tpu_torch as mt
    with mt.symbol.NameManager():
        return mt.models.transformer(vocab_size=LM_VOCAB, embed=LM_EMBED,
                                     num_heads=LM_HEADS, num_layers=layers,
                                     seq_len=LM_SEQ, **kw)


def lm_params(seed, layers=LM_LAYERS):
    """The LM's weights on the host from ``seed``: gains 1, shifts and
    biases 0, every matrix (the embeddings too) Xavier-uniform over its
    two dims."""
    sym = lm_symbol(layers)
    shapes, _, _ = sym.infer_shape(data=(1, LM_SEQ),
                                   softmax_label=(1, LM_SEQ))
    rng = np.random.default_rng(seed)
    out = {}
    for n, shp in zip(sym.list_arguments(), shapes):
        if n in ("data", "softmax_label"):
            continue
        if n.endswith("gamma"):
            out[n] = np.ones(shp, np.float32)
        elif n.endswith(("beta", "bias")):
            out[n] = np.zeros(shp, np.float32)
        else:
            a = np.sqrt(6.0 / (shp[0] + shp[1]))
            out[n] = rng.uniform(-a, a, shp).astype(np.float32)
    return out


def lm_tokens(seed, n=LM_BATCH * LM_BATCHES):
    """The synthetic next-token task: each row counts up from a random
    start (mod the vocabulary), the label is each token plus one."""
    rng = np.random.default_rng(seed + 17)
    x = (rng.integers(0, LM_VOCAB, (n, 1)) + np.arange(LM_SEQ)[None]) \
        % LM_VOCAB
    return x.astype(np.float32), ((x + 1) % LM_VOCAB).astype(np.float32)


def lm_fit(seed, params, k, layers=LM_LAYERS, epochs=LM_EPOCHS):
    """``Module(compute_dtype="bfloat16").fit`` over the task: returns the
    module, each epoch's perplexity and each epoch's seconds."""
    import mxnet_tpu_torch as mt
    x, y = lm_tokens(seed)
    it = mt.io.NDArrayIter(x, y, batch_size=LM_BATCH,
                           label_name="softmax_label")
    mod = mt.mod.Module(lm_symbol(layers), context=_lm_ctx(),
                        compute_dtype=LM_DTYPE)
    metric = mt.metric.Perplexity(ignore_label=None)
    ppl, marks = [], [time.perf_counter()]

    def epoch_end(*a):
        ppl.append(metric.get()[1])
        marks.append(time.perf_counter())
    mod.fit(it, eval_metric=metric, num_epoch=epochs,
            arg_params={n: mt.nd.array(v, ctx=mt.cpu())
                        for n, v in params.items()},
            optimizer="sgd", optimizer_params=dict(LM_OPT),
            steps_per_dispatch=k, dispatch_pipeline=1,
            epoch_end_callback=epoch_end)
    return mod, ppl, [b - a for a, b in zip(marks, marks[1:])]


def lm_decode_loop(params, layers=LM_LAYERS, **kw):
    from mxnet_tpu_torch import serving
    kw.setdefault("prefix_cache", False)
    return serving.DecodeLoop(params, num_layers=layers, num_heads=LM_HEADS,
                              max_len=DEC_MAXLEN, slots=DEC_SLOTS,
                              device=_lm_dev(), **kw)


def lm_profile(seed, card):
    """Run beside phase 6, before phase 8 (after which the profiler drops
    kernel records): one bf16 LM training step at bench.py lm_main's
    widths (the TrainStep that Module.fit's fused path drives), one
    float32 decode step and one speculative round (spec_k 2, a one-layer
    draft) at phase 17's decode widths, each profiled (device ms and
    kernel launches, the matrix products' share and the int64
    elementwise kernels' share) and timed back to back on CUDA events;
    the threefry uniforms of one decode step alone (``position_uniforms``
    over the slots; a speculative round computes them six times); and the
    attention core against scaled_dot_product_attention (cuDNN/flash,
    bf16, causal) on the step's shapes. Random weights from ``seed``.
    Returns {what: profile_step's numbers plus event_ms}."""
    import torch
    import torch.nn.functional as F
    from mxnet_tpu_torch.ops.attention import blockwise_attention
    from mxnet_tpu_torch.ops.nn import matmul_precision
    from mxnet_tpu_torch.serving.sampling import position_uniforms
    from mxnet_tpu_torch.train_step import TrainStep
    dev = torch.device(_lm_dev())
    out = {}
    step = TrainStep(lm_symbol(), optimizer="sgd", compute_dtype=LM_DTYPE,
                     device=dev, **LM_OPT)
    state = step.init({"data": (LM_BATCH, LM_SEQ)},
                      {"softmax_label": (LM_BATCH, LM_SEQ)}, seed=seed)
    for n, v in lm_params(seed).items():
        state["params"][n].copy_(torch.from_numpy(v))
    x, y = lm_tokens(seed, LM_BATCH)
    batch = {"data": torch.from_numpy(x).to(dev),
             "softmax_label": torch.from_numpy(y).to(dev)}
    shares = (("matrix products", ("gemm", "nvjet", "xmma", "cutlass")),
              ("int64 elementwise (threefry, positions, indices)",
               lambda k: "elementwise" in k and "long" in k))
    prof = profile_step(lambda: step.step(state, batch), card,
                        "one LM training step (%s, b=%d, seq %d, %dx%d, "
                        "%d heads)" % (LM_DTYPE, LM_BATCH, LM_SEQ,
                                       LM_LAYERS, LM_EMBED, LM_HEADS),
                        shares)
    out["train_step"] = dict(prof or {}, event_ms=cuda_time_ms(
        lambda: step.step(state, batch), 10))
    # the decode bodies, called on this thread over idle loops' state
    params = lm_params(seed)
    draft = lm_params(seed + 1, 1)
    rng = np.random.default_rng(seed)
    n = DEC_SLOTS
    slot = {"tokens": torch.from_numpy(rng.integers(0, LM_VOCAB, n)),
            "pos": torch.full((n,), DEC_MAXLEN // 2),
            "temp": torch.full((n,), DEC_SAMPLED["temperature"]),
            "top_k": torch.full((n,), DEC_SAMPLED["top_k"]),
            "top_p": torch.full((n,), DEC_SAMPLED["top_p"]),
            "fresh": torch.arange(n), "reseed": torch.zeros(n, dtype=bool)}
    s = {k: v.to(dev) for k, v in slot.items()}
    args = (s["temp"], s["top_k"], s["top_p"], s["fresh"], s["reseed"])
    plain = lm_decode_loop(params)
    spec = lm_decode_loop(params, spec_k=DEC_SPEC_K, draft_params=draft,
                          draft_num_layers=1)
    window = torch.stack([s["tokens"]] * (DEC_SPEC_K + 1), dim=1)

    def decode_step():
        plain._step_fn(plain._state, plain._params, s["tokens"], s["pos"],
                       *args)

    def spec_round():
        for j in range(DEC_SPEC_K + 1):
            spec._draft_fn(spec._draft_state, spec._draft_params,
                           s["tokens"], s["pos"] + j, *args)
        spec._verify_fn(spec._state, spec._params, window, s["pos"], *args)

    try:
        with torch.inference_mode(), matmul_precision(dev):
            for what, fn, label in (
                    ("decode_step", decode_step, "one float32 decode step "
                     "(%d slots, %d cache rows, sampled)"
                     % (DEC_SLOTS, DEC_MAXLEN + 1)),
                    ("spec_round", spec_round, "one speculative round "
                     "(%d one-layer draft passes, a %d-position verify)"
                     % (DEC_SPEC_K + 1, DEC_SPEC_K + 1))):
                prof = profile_step(fn, card, label, shares)
                out[what] = dict(prof or {}, event_ms=cuda_time_ms(fn, 10))
            seeds = s["fresh"] + 101

            def uniforms():
                position_uniforms(seeds, s["pos"])
            prof = profile_step(uniforms, card, "the threefry uniforms of "
                                "one decode step (%d slots)" % DEC_SLOTS,
                                ())
            out["uniforms"] = dict(prof or {},
                                   event_ms=cuda_time_ms(uniforms, 10))
    finally:
        plain.close()
        spec.close()
    # the attention core beside SDPA (the library call; not used)
    g = torch.Generator(device=dev).manual_seed(seed)
    q, k, v = (torch.randn(LM_BATCH, LM_HEADS, LM_SEQ,
                           LM_EMBED // LM_HEADS, device=dev, generator=g,
                           dtype=torch.bfloat16) for _ in range(3))
    core = blockwise_attention(q, k, v, causal=True)
    lib = F.scaled_dot_product_attention(q, k, v, is_causal=True)
    t_core = cuda_time_ms(lambda: blockwise_attention(q, k, v, causal=True),
                          20)
    t_lib = cuda_time_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=True), 20)
    err = float((core.float() - lib.float()).abs().max())
    log("lm profile: attention core (blockwise_attention, bf16, causal, "
        "%s) %.4f ms a call back to back, scaled_dot_product_attention "
        "%.4f ms; max |difference| %.3g [%s]"
        % (tuple(q.shape), t_core, t_lib, err, card))
    out["attention"] = {"core_ms": t_core, "sdpa_ms": t_lib,
                        "max_abs_diff": err}
    for what in ("train_step", "decode_step", "spec_round", "uniforms"):
        log("lm profile: %s: %s ms of device time in %s launches, %.3f ms "
            "back to back on CUDA events [%s]"
            % (what, "%.3f" % out[what]["total"] if "total" in out[what]
               else "no", out[what].get("launches", "?"),
               out[what]["event_ms"], card))
    return out


def _lm_host_params(mod):
    args, _ = mod.get_params()
    return {n: v.asnumpy() for n, v in args.items()}


def _stack_params(params, layers=LM_LAYERS):
    from mxnet_tpu_torch.ops.transformer_stack import STACK_INPUTS
    per = {"qkv_weight": "attn_qkv_weight", "qkv_bias": "attn_qkv_bias",
           "out_weight": "attn_out_weight", "out_bias": "attn_out_bias",
           "fc1_weight": "ffn_fc1_weight", "fc1_bias": "ffn_fc1_bias",
           "fc2_weight": "ffn_fc2_weight", "fc2_bias": "ffn_fc2_bias"}
    out = {k: v for k, v in params.items() if not k.startswith("layer")}
    for name in STACK_INPUTS[1:]:
        out["stack_" + name] = np.stack(
            [params["layer%d_%s" % (i, per.get(name, name))]
             for i in range(layers)])
    return out


def lm_forward(sym, params, x):
    """The symbol's float32 forward over token rows ``x`` (inference,
    TF32 off): the (rows x seq, vocab) probabilities on the host."""
    import mxnet_tpu_torch as mt
    import torch
    from mxnet_tpu_torch.ops.nn import matmul_precision
    ctx = _lm_ctx()
    ex = sym.simple_bind(ctx, grad_req="null", data=x.shape,
                         softmax_label=x.shape)
    ex.copy_params_from({n: mt.nd.array(v, ctx=ctx)
                         for n, v in params.items()})
    with matmul_precision(torch.device(_lm_dev())):
        ex.forward(is_train=False, data=mt.nd.array(x, ctx=ctx))
        return ex.outputs[0].asnumpy()


def lm_train_check(seed, card):
    """(a): returns the trained float32 parameters and a trained
    one-layer draft."""
    import torch
    params = lm_params(seed)
    nparams = sum(int(v.size) for v in params.values())
    log("lm (a) model: bench.py lm_main's LM (vocabulary %d, embed %d, %d "
        "heads, %d layers, seq %d, batch %d, %s compute, SGD lr %g "
        "momentum %g wd %g, gradient the mean over tokens): %d parameters; "
        "%d synthetic rows from --seed (next token = token + 1), %d "
        "batches an epoch"
        % (LM_VOCAB, LM_EMBED, LM_HEADS, LM_LAYERS, LM_SEQ, LM_BATCH,
           LM_DTYPE, LM_OPT["learning_rate"], LM_OPT["momentum"],
           LM_OPT["wd"], nparams, LM_BATCH * LM_BATCHES, LM_BATCHES))
    fits = {}
    tokens = LM_BATCH * LM_BATCHES * LM_SEQ
    for k in (1, LM_K):
        mod, ppl, secs = lm_fit(seed, params, k)
        fits[k] = (mod, ppl, secs)
        log("lm (a) Module.fit K=%d: perplexity by epoch %s; seconds by "
            "epoch %s; epoch %d: %d tokens, %.0f tokens/s, %.2f ms a step "
            "on the host clock [%s]"
            % (k, ["%.2f" % p for p in ppl], ["%.3f" % s for s in secs],
               LM_EPOCHS, tokens, tokens / secs[-1],
               1e3 * secs[-1] / LM_BATCHES, card))
        if not (np.all(np.isfinite(ppl)) and ppl[-1] < ppl[0]):
            raise SystemExit("lm (a): perplexity did not fall at K=%d: %r"
                             % (k, ppl))
        if mod._fused is None:
            raise SystemExit("lm (a): fit did not take the fused path")
    p1, p4 = _lm_host_params(fits[1][0]), _lm_host_params(fits[LM_K][0])
    bitwise = all(np.array_equal(p1[n], p4[n]) for n in p1)
    worst = max(float(np.linalg.norm(p4[n] - p1[n])
                      / max(np.linalg.norm(p1[n]), 1e-30)) for n in p1)
    log("lm (a) K=%d against K=1: parameters %s (worst relative norm of "
        "the difference %.3g)" % (LM_K, "bit for bit" if bitwise else
                                  "not bit for bit", worst))
    if not bitwise and worst > LM_K_RTOL:
        raise SystemExit("lm (a): K=%d and K=1 disagree" % LM_K)
    # a step's time on CUDA events, from a copy of the trained state
    mod = fits[1][0]
    ts = mod._fused
    st = _clone_tree(mod._fused_state)
    x, y = lm_tokens(seed, LM_BATCH)
    batch = {"data": torch.from_numpy(x).to(ts.device),
             "softmax_label": torch.from_numpy(y).to(ts.device)}
    ev = cuda_time_ms(lambda: ts.step(st, batch), 10)
    log("lm (a) a fused bf16 step back to back: %.3f ms on CUDA events "
        "(%.0f tokens/s) [%s]" % (ev, LM_BATCH * LM_SEQ / (ev / 1e3), card))
    # the stacked build against the per-layer build, float32
    xs, _ = lm_tokens(seed + 1, 4)
    per = lm_forward(lm_symbol(), p1, xs)
    stk = lm_forward(lm_symbol(stack_layers=True), _stack_params(p1), xs)
    err = float(np.abs(stk - per).max())
    scale = float(np.abs(per).max())
    log("lm (a) stack_layers=True against the per-layer build (trained "
        "weights stacked, float32, 4 rows): max |difference| %.3g of the "
        "largest value %.3g (limit %g of it)" % (err, scale, LM_STACK_RTOL))
    if not err <= LM_STACK_RTOL * scale:
        raise SystemExit("lm (a): the stacked build disagrees")
    draft_mod, dppl, _ = lm_fit(seed, lm_params(seed + 1, 1), LM_K,
                                layers=1)
    log("lm (a) the one-layer draft (the same task and fit, K=%d): "
        "perplexity by epoch %s" % (LM_K, ["%.2f" % p for p in dppl]))
    return p1, _lm_host_params(draft_mod)


def _dec_requests(seed):
    """bench.py decode_main's traffic: an 8-token shared prefix plus a
    2-4 token tail a request, seeds 101.."""
    rs = np.random.RandomState(seed + 2)
    shared = [int(t) for t in rs.randint(1, LM_VOCAB, 8)]
    tails = [[int(t) for t in rs.randint(1, LM_VOCAB, 2 + i % 3)]
             for i in range(DEC_REQUESTS)]
    return shared, [shared + t for t in tails], \
        [101 + i for i in range(DEC_REQUESTS)]


def dec_streams(loop, prompts, seeds, gen, plen=0, new=None):
    """Every request at once (``new`` new tokens each, a list or one
    count, DEC_NEW by default); the streams in request order."""
    new = new if isinstance(new, list) else [new or DEC_NEW] * len(prompts)
    futs = [loop.generate(p, n, seed=s, prefix_len=plen, **gen)
            for p, s, n in zip(prompts, seeds, new)]
    return [f.result(timeout=600.0) for f in futs]


def dec_run(loop, prompts, seeds, gen, plen=0):
    """One warmed run of every request (the warm run primes the prefix
    cache): tokens/s and ms a decode step on the host clock, and the
    streams."""
    dec_streams(loop, prompts, seeds, gen, plen)
    steps0 = loop.health.decode_steps
    t0 = time.perf_counter()
    outs = dec_streams(loop, prompts, seeds, gen, plen)
    dt = time.perf_counter() - t0
    steps = loop.health.decode_steps - steps0
    ntok = sum(len(o) for o in outs)
    return {"tokens_per_s": ntok / dt, "ms_per_step": 1e3 * dt / steps,
            "steps": steps, "tokens": ntok}, outs


def greedy_oracle_check(params, prompts, outs):
    """Every greedy token against the argmax of the full forward at its
    position, teacher-forced on the stream itself. Returns (mismatches,
    rounding ties)."""
    x = np.zeros((len(prompts), LM_SEQ), np.float32)
    for i, (p, o) in enumerate(zip(prompts, outs)):
        x[i, :len(p) + len(o)] = p + o
    probs = lm_forward(lm_symbol(), params, x).reshape(len(prompts),
                                                       LM_SEQ, LM_VOCAB)
    bad = ties = 0
    for i, (p, o) in enumerate(zip(prompts, outs)):
        for j, tok in enumerate(o):
            row = probs[i, len(p) + j - 1]
            top = int(np.argmax(row))
            if top != tok:
                if row[top] - row[tok] < DEC_ORACLE_TIE:
                    ties += 1
                else:
                    bad += 1
    return bad, ties


def stream_agreement(ref, got):
    """The share of ``ref``'s tokens that ``got`` reproduces, each stream
    counted up to its first difference."""
    same = 0
    for r, g in zip(ref, got):
        for a, b in zip(r, g):
            if a != b:
                break
            same += 1
    return same / max(1, sum(len(r) for r in ref))


def spec_edge_check(params, draft, prompts, seeds):
    """Speculative decoding to the end of the cache: one request a slot
    whose prompt plus new tokens fill ``max_len`` (the positional table's
    rows, LM_SEQ), spec_k 2 with a perfect draft (the target itself,
    which advances 3 positions a round and so starts a window at
    ``max_len`` - 2, reaching past the table) and with the one-layer
    draft, greedy and sampled, each against target-only decoding.
    Returns (problems, {leg: the last window start})."""
    prompts, seeds = prompts[:DEC_SLOTS], seeds[:DEC_SLOTS]
    new = [DEC_MAXLEN - len(p) for p in prompts]
    problems, starts = [], {}
    for name, gen in (("greedy", {}), ("sampled", DEC_SAMPLED)):
        loop = lm_decode_loop(params)
        target = dec_streams(loop, prompts, seeds, gen, new=new)
        loop.close()
        for dname, dparams, dlayers in (("perfect", params, LM_LAYERS),
                                        ("one-layer", draft, 1)):
            loop = lm_decode_loop(params, spec_k=DEC_SPEC_K,
                                  draft_params=dparams,
                                  draft_num_layers=dlayers)
            seen = []
            verify = loop._verify_fn

            def recording(state, p, tokens_w, pos0, *a, verify=verify,
                          seen=seen):
                seen.append(int(pos0.max()))
                return verify(state, p, tokens_w, pos0, *a)
            loop._verify_fn = recording
            try:
                spec = dec_streams(loop, prompts, seeds, gen, new=new)
            finally:
                loop.close()
            leg = "%s %s draft" % (name, dname)
            starts[leg] = max(seen)
            if spec != target:
                problems.append("speculative to max_len (%s) differs from "
                                "target-only" % leg)
            if [len(o) for o in spec] != new:
                problems.append("speculative to max_len (%s) ended short"
                                % leg)
    if starts["greedy perfect draft"] != DEC_MAXLEN - 2:
        problems.append("no speculative window reached past the table")
    return problems, starts


def lm_decode_check(seed, card, params, draft):
    """(b): the six legs over the trained weights."""
    import torch
    from mxnet_tpu_torch import faults, serving
    from mxnet_tpu_torch.serving.quantize import (check_quality,
                                                  quantize_array)
    shared, prompts, seeds = _dec_requests(seed)
    legs, problems = {}, []
    cold = lm_params(seed + 3)
    # greedy: a loop built on other weights, hot-reloaded to the trained
    loop = lm_decode_loop(cold)
    loop.update_params(params)
    reload_ok = all(torch.equal(loop._params[n].cpu(),
                                torch.from_numpy(v))
                    for n, v in params.items())
    legs["greedy"], greedy = dec_run(loop, prompts, seeds, {})
    bytes_f32 = loop.weight_bytes()
    loop.close()
    bad, ties = greedy_oracle_check(params, prompts, greedy)
    log("lm (b) greedy: %d of %d tokens differ from the full forward's "
        "argmax (%d more within %g of a tie); update_params landed the "
        "trained weights %s"
        % (bad, legs["greedy"]["tokens"], ties, DEC_ORACLE_TIE,
           "bit for bit" if reload_ok else "NOT bit for bit"))
    if bad:
        problems.append("greedy differs from the teacher-forced oracle")
    if not reload_ok:
        problems.append("update_params is not bitwise")
    loop = lm_decode_loop(params)
    legs["sampled"], sampled = dec_run(loop, prompts, seeds, DEC_SAMPLED)
    loop.close()
    agree = {}
    for mode in ("bf16", "int8"):
        loop = lm_decode_loop(cold, quantize=mode)
        loop.update_params(params)
        ok = True
        for n, v in params.items():
            want = quantize_array(torch.from_numpy(v), mode)
            got = loop._params[n]
            ok &= (all(torch.equal(got[i].cpu(), want[i]) for i in want)
                   if isinstance(want, dict)
                   else torch.equal(got.cpu(), want))
        legs[mode], _ = dec_run(loop, prompts, seeds, DEC_SAMPLED)
        legs[mode]["weight_bytes"] = loop.weight_bytes()
        agree[mode] = stream_agreement(
            greedy, dec_streams(loop, prompts, seeds, {}))
        legs[mode]["greedy_agreement"] = agree[mode]
        loop.close()
        if agree[mode] < DEC_QUANT_AGREE:
            problems.append("%s greedy streams agree with float32's on "
                            "%.4f of the tokens (floor %g)"
                            % (mode, agree[mode], DEC_QUANT_AGREE))
        if not ok:
            problems.append("update_params under %s is not bitwise" % mode)
    sym_json = lm_symbol().tojson()
    eng_params = {"arg:" + n: v for n, v in params.items()}
    ref = serving.ServingEngine(sym_json, eng_params, {"data": (LM_SEQ,)},
                                buckets=(4,), device=_lm_dev())
    q8 = serving.ServingEngine(sym_json, eng_params, {"data": (LM_SEQ,)},
                               buckets=(4,), device=_lm_dev(),
                               quantize="int8")
    probe = np.zeros((4, LM_SEQ), np.float32)
    probe[:, :8] = np.asarray([shared] * 4, np.float32)
    quality = q8.quality_report(ref, {"data": probe})
    check_quality(quality, who="phase 17 int8")
    legs["int8"]["top1_agreement"] = quality["top1_agreement"]
    loop = lm_decode_loop(params, prefix_cache=True)
    legs["prefix"], prefixed = dec_run(loop, prompts, seeds, DEC_SAMPLED,
                                       plen=len(shared))
    h = loop.health.report()
    legs["prefix"].update(hits=h["prefix_hits"],
                          prefills=h["prefix_prefills"])
    loop.close()
    if prefixed != sampled:
        problems.append("prefix streams differ from cold ones")
    loop = lm_decode_loop(params, spec_k=DEC_SPEC_K, draft_params=draft,
                          draft_num_layers=1)
    legs["spec_k%d" % DEC_SPEC_K], spec = dec_run(loop, prompts, seeds,
                                                  DEC_SAMPLED)
    h = loop.health.report()
    legs["spec_k%d" % DEC_SPEC_K].update(
        accept_rate=h["spec_accepted"] / max(1, h["spec_drafted"]),
        weight_bytes=loop.weight_bytes())
    loop.close()
    if spec != sampled:
        problems.append("speculative output differs from target-only")
    edge_problems, edge_starts = spec_edge_check(params, draft, prompts,
                                                 seeds)
    problems += edge_problems
    log("lm (b) speculative to max_len %d (%d requests, prompt plus new "
        "tokens = max_len): last window start by leg %s; %s"
        % (DEC_MAXLEN, DEC_SLOTS, json.dumps(edge_starts, sort_keys=True),
           "; ".join(edge_problems) or "every leg token-identical to "
           "target-only"))
    # serve.sample kills the loop: every sequence is shed
    loop = lm_decode_loop(params)
    try:
        faults.inject("serve.sample", nth=3, kind="raise")
        futs = [loop.generate(p, 8, seed=s, **DEC_SAMPLED)
                for p, s in zip(prompts[:3], seeds)]
        shed = 0
        for f in futs:
            try:
                f.result(timeout=60.0)
            except serving.ServingClosedError:
                shed += 1
    finally:
        faults.clear("serve.sample")
        loop.close()
    log("lm (b) serve.sample raised at the 3rd step: %d of 3 sequences "
        "shed with ServingClosedError" % shed)
    if shed != 3:
        problems.append("serve.sample did not shed every sequence")
    log("lm (b) weight bytes: f32 %d, bf16 %d, int8 %d (int8 top-1 "
        "agreement %.4f through a ServingEngine pair); draft+target %d"
        % (bytes_f32, legs["bf16"]["weight_bytes"],
           legs["int8"]["weight_bytes"], quality["top1_agreement"],
           legs["spec_k%d" % DEC_SPEC_K]["weight_bytes"]))
    log("lm (b) greedy streams against float32's, the share of its %d "
        "tokens reproduced up to each stream's first difference: bf16 "
        "%.4f, int8 %.4f (floor %g)"
        % (legs["greedy"]["tokens"], agree["bf16"], agree["int8"],
           DEC_QUANT_AGREE))
    for name, leg in legs.items():
        log("lm (b) %-8s %8.1f tokens/s, %.3f ms a decode step (%d steps, "
            "%d tokens)%s [%s]"
            % (name, leg["tokens_per_s"], leg["ms_per_step"], leg["steps"],
               leg["tokens"],
               "; accept rate %.4f" % leg["accept_rate"]
               if "accept_rate" in leg else "", card))
    if problems:
        raise SystemExit("lm (b): " + "; ".join(problems))
    return legs


def lm_phase(seed, card, profile):
    """Phase 17 (see the module docstring)."""
    from mxnet_tpu_torch.ops import matmul_stats, multibox_nms
    from mxnet_tpu_torch import rtc
    t_phase = time.perf_counter()
    multibox_nms.reset_launches()
    matmul_stats.reset_launches()
    rtc_before = (rtc.RTC_LAUNCHES, rtc.TRITON_LAUNCHES)
    params, draft = lm_train_check(seed, card)
    legs = lm_decode_check(seed, card, params, draft)
    launches = (multibox_nms.LAUNCHES, matmul_stats.LAUNCHES,
                rtc.RTC_LAUNCHES - rtc_before[0],
                rtc.TRITON_LAUNCHES - rtc_before[1])
    log("lm: B2, B1, B3 (Rtc, Triton) launches in this phase: %s (the LM "
        "path runs none of them)" % (launches,))
    if any(launches):
        raise SystemExit("lm: the LM path launched a kernel of B1-B3")
    log("lm: %s" % json.dumps({"profile": profile, "decode": legs},
                              sort_keys=True))
    log("lm: the phase took %.1f s" % (time.perf_counter() - t_phase))
    return params, draft


# ---------------------------------------------------------------------------
# model-parallel serving phase: ServingEngine and DecodeLoop over a 'model'
# mesh whose positions share the card
# ---------------------------------------------------------------------------

#: phase 21: positions of the 'model' mesh, all on MP_DEVICE (the machine
#: has one card)
MP_POSITIONS = 2
MP_DEVICE = "cuda:0"
#: (a): each sharded SSD head (cls_prob, loc_pred, anchors) against the
#: single-device engine's, largest |difference| over largest |value| (a
#: position's convolution has half the output channels, so cuDNN may take
#: other algorithms)
MP_SSD_TOL = 1e-5
#: (c): the least share of the single-device loop's tokens the sharded
#: loop picks again, teacher-forced
MP_LM_AGREE = 0.99
#: (a): timed requests a bucket and engine, in turns
MP_TIMED = 10
MP_HEADS = ["cls_prob", "multibox_loc_pred", "multibox_anchors"]


def _mp_rel(got, want):
    """Largest |difference| over largest |value| of two host arrays."""
    scale = max(float(np.abs(want).max()), 1e-30)
    return float(np.abs(got.astype(np.float64) - want).max()) / scale


def kept_matched(got, want, tol=1e-5):
    """Kept detections (class id >= 0) of ``want`` that ``got`` has too,
    in any row of the same image, with the same class and score and box
    within ``tol``: (matched, kept in ``want``, kept in ``got``)."""
    matched = 0
    for g, w in zip(got, want):
        g, w = g[g[:, 0] >= 0], w[w[:, 0] >= 0]
        if len(g) and len(w):
            close = ((g[None, :, 0] == w[:, None, 0])
                     & (np.abs(g[None, :, 1:] - w[:, None, 1:]).max(-1)
                        <= tol))
            matched += int(close.any(axis=1).sum())
    return (matched, int((want[..., 0] >= 0).sum()),
            int((got[..., 0] >= 0).sum()))


def _first_part(v):
    return v.parts[0] if hasattr(v, "parts") else v


def mp_dec_run(loop, prompts, seeds, gen, plen=0):
    """One timed run of every request (no warm run): tokens/s, ms a step
    and the streams."""
    steps0 = loop.health.decode_steps
    t0 = time.perf_counter()
    outs = dec_streams(loop, prompts, seeds, gen, plen)
    dt = time.perf_counter() - t0
    steps = loop.health.decode_steps - steps0
    ntok = sum(len(o) for o in outs)
    return {"tokens_per_s": ntok / dt, "ms_per_step": 1e3 * dt / steps,
            "steps": steps, "tokens": ntok}, outs


def teacher_forced(loop, prompts, refs, seeds, gen):
    """The share of ``refs``' tokens ``loop`` picks again when each
    reference stream is fed to it as its prompt: every position's token
    from the decode body, recorded as the loop teacher-forces it."""
    picks = {}
    step = loop._step_fn

    def recording(state, params, tokens, pos, *a):
        toks = step(state, params, tokens, pos, *a)
        p, t = _first_part(pos).cpu().numpy(), toks.cpu().numpy()
        for i, slot in enumerate(loop._slots):
            if slot is not None:
                picks[slot.fut.rid, int(p[i])] = int(t[i])
        return toks
    loop._step_fn = recording
    futs = [loop.generate(p + r[:-1], 1, seed=s, **gen)
            for p, r, s in zip(prompts, refs, seeds)]
    for f in futs:
        f.result(timeout=600.0)
    loop._step_fn = step
    same = sum(picks.get((f.rid, len(p) - 1 + j)) == tok
               for f, p, r in zip(futs, prompts, refs)
               for j, tok in enumerate(r))
    return same / max(1, sum(len(r) for r in refs))


def dec_step_launches(loop):
    """Device launches of one decode step of ``loop`` (closed first) at 8
    slots, a prompt's worth into the cache, by torch.profiler
    (:func:`step_launches`); None where two profiles never agree."""
    import torch
    from mxnet_tpu_torch.ops.nn import matmul_precision
    loop.close()
    n = loop.slots
    d = loop._dev({"tokens": np.arange(n) + 1, "pos": np.full(n, 20),
                   "temp": np.zeros(n), "top_k": np.zeros(n),
                   "top_p": np.ones(n), "fresh": np.arange(n) + 7,
                   "reseed": np.ones(n, np.bool_)})

    def one():
        with torch.inference_mode(), matmul_precision(loop.device):
            loop._step_fn(loop._state, loop._params, d["tokens"], d["pos"],
                          d["temp"], d["top_k"], d["top_p"], d["fresh"],
                          d["reseed"])
    return step_launches(one)


def mp_ssd(seed, card, files, pool, problems):
    """(a) and (b). Returns (B2 launches of the main path, the sharded
    and single engines)."""
    import torch
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch.ops import contrib, multibox_nms as mnms
    from mxnet_tpu_torch.parallel import mesh as pm
    from mxnet_tpu_torch.serving import ServingEngine
    from mxnet_tpu_torch.serving import quantize as tq

    def engine(positions=None, params=files[1], **kw):
        return ServingEngine(files[0], params, {"data": SSD_INPUT},
                             buckets=BUCKETS, device=MP_DEVICE,
                             contexts=positions, **kw)
    single, sharded = engine(), engine(MP_POSITIONS)
    heads1 = engine(output_names=MP_HEADS)
    heads = engine(MP_POSITIONS, output_names=MP_HEADS)
    net = mt.symbol.load(files[0])
    attrs = contrib._mbd_attrs([n for n in _nodes(net)
                                if n.name == "detection"][0].attrs)
    xs = {b: {"data": pool[:b]} for b in BUCKETS}
    # the main path: counts at 0 just before, read just after
    torch.cuda.synchronize()
    mnms.reset_launches()
    pm.reset_counters()
    d0 = sharded.health.batches
    got = {b: sharded.infer(x)[0] for b, x in xs.items()}
    torch.cuda.synchronize()
    launches, routes = mnms.LAUNCHES, dict(mnms.LAUNCHES_BY_ROUTE)
    disp = sharded.health.batches - d0
    gathers = dict(pm.COUNTERS)
    if launches != disp or routes != {"smem": disp, "l2": 0}:
        problems.append("(a) multibox_nms ran %d times (by route %s) for %d "
                        "sharded dispatches" % (launches, routes, disp))
    errs, worst, moved = {}, 0.0, {}
    for b, x in xs.items():
        hs = heads.infer(x)
        row = {name: _mp_rel(a, w)
               for name, a, w in zip(MP_HEADS, hs, heads1.infer(x))}
        worst = max([worst] + list(row.values()))
        want = single.infer(x)[0]
        row["detections"] = _mp_rel(got[b], want)
        moved[b] = kept_matched(got[b], want)
        errs[b] = row
        cls_prob, loc, anc = (torch.from_numpy(h).to(MP_DEVICE) for h in hs)
        with torch.inference_mode():
            plain = contrib.multibox_detection(
                cls_prob, loc, anc[:1], nms=mnms.nms_alive_reference,
                **attrs).cpu().numpy()
        if not np.array_equal(plain, got[b]):
            problems.append("(a) bucket %d: the sharded detections differ "
                            "from the plain NMS on the sharded heads" % b)
    log("mp (a) sharded SSD (%d positions on %s) against the single-device "
        "engine, largest |difference| over largest |value| by bucket and "
        "output: %s (tolerance %g on the heads); the single engine's kept "
        "detections found among the sharded engine's (same class, score and "
        "box within 1e-5), of the kept rows of each, by bucket: %s "
        "(MultiBoxDetection sorts the scores and suppresses greedily, so a "
        "rounding of the heads moves near-tied rows: the detections are "
        "held instead against MultiBoxDetection with the plain NMS on the "
        "sharded heads, bit for bit at every bucket: %s) [%s]"
        % (MP_POSITIONS, MP_DEVICE, json.dumps(errs, sort_keys=True),
           MP_SSD_TOL, moved,
           not any(p.startswith("(a) bucket") for p in problems), card))
    if worst > MP_SSD_TOL:
        problems.append("(a) sharded SSD heads %g off the single engine's "
                        "(over %g)" % (worst, MP_SSD_TOL))
    lat = {b: {"single": [], "sharded": []} for b in BUCKETS}
    for b, x in xs.items():
        single.infer(x)
        sharded.infer(x)
        for _ in range(MP_TIMED):
            for name, eng in (("single", single), ("sharded", sharded)):
                t = time.perf_counter()
                eng.infer(x)
                lat[b][name].append(time.perf_counter() - t)
    p50 = {b: {k: _pct(v, 50) for k, v in row.items()}
           for b, row in lat.items()}
    per_pos = [sharded.weight_bytes(r) for r in range(MP_POSITIONS)]
    log("mp (a) p50 ms by bucket, single against sharded, %d requests "
        "each in turns (host clock, copies included): %s; B2 launches %d "
        "for %d dispatches (%s); collectives %s, %.1f gathers a dispatch; "
        "parameter bytes a position %s of the whole %d (single engine %d) "
        "[%s]" % (MP_TIMED, json.dumps(p50, sort_keys=True), launches, disp,
                  routes, gathers, gathers["all_gather"] / max(1, disp),
                  per_pos, sharded.weight_bytes(), single.weight_bytes(),
                  card))
    arg = {k[4:]: v.data for k, v in
           mt.nd.load(files[1], ctx=mt.cpu()).items()}
    for mode in ("bf16", "int8"):
        eng = engine(MP_POSITIONS, quantize=mode)
        host = {k: tq.dequant_leaf(tq.quantize_array(v, mode))
                for k, v in arg.items()}
        deq = engine(MP_POSITIONS, params=host)
        equal = [np.array_equal(eng.infer({"data": pool[:n]})[0],
                                deq.infer({"data": pool[:n]})[0])
                 for n in (1, 5, 8, 32)]
        scales = {}
        for name, leaf in eng._state[0].items():
            if tq.is_quantized_leaf(leaf):
                q = [tuple(p.shape) for p in leaf["q"].parts]
                sc = [tuple(p.shape) for p in leaf["s"].parts]
                scales[name] = (q, sc)
                if [a[0] for a in q] != [a[0] for a in sc]:
                    problems.append("(b) %s's scale shards %s do not follow "
                                    "its payload's %s" % (name, sc, q))
        first = sorted(scales)[:2]
        log("mp (b) sharded %s: detections for 1, 5, 8, 32 images equal to "
            "a sharded f32 engine of the host-dequantized weights: %s; "
            "weight bytes %d, a position %s; %d int8 leaves, e.g. %s [%s]"
            % (mode, equal, eng.weight_bytes(),
               [eng.weight_bytes(r) for r in range(MP_POSITIONS)],
               len(scales), {n: scales[n] for n in first}, card))
        if not all(equal):
            problems.append("(b) sharded %s detections differ from the "
                            "host-dequantized f32 engine's" % mode)
        del eng, deq
    return launches, sharded, single, engine


def mp_lm(seed, card, params, draft, problems):
    """(c). Returns the legs' numbers."""
    from mxnet_tpu_torch.parallel import mesh as pm
    shared, prompts, seeds = _dec_requests(seed)
    legs, out = {}, {}
    for gen_name, gen in (("greedy", {}), ("sampled", DEC_SAMPLED)):
        loop = lm_decode_loop(params)
        legs["single " + gen_name], ref = mp_dec_run(loop, prompts, seeds,
                                                     gen)
        loop.close()
        loop = lm_decode_loop(params, contexts=MP_POSITIONS)
        pm.reset_counters()
        legs["sharded " + gen_name], got = mp_dec_run(loop, prompts, seeds,
                                                      gen)
        legs["sharded " + gen_name]["gathers_per_step"] = (
            pm.COUNTERS["all_gather"] / legs["sharded " + gen_name]["steps"])
        agree = teacher_forced(loop, prompts, ref, seeds, gen)
        shape = [tuple(p.shape) for p in loop._state["k"].parts]
        loop.close()
        exact = sum(a == b for a, b in zip(got, ref)) / len(ref)
        legs["sharded " + gen_name].update(streams_equal=exact,
                                           teacher_forced=agree)
        out[gen_name] = got
        log("mp (c) %s: %.4f of the %d streams equal to the single-device "
            "loop's; teacher-forced, the sharded loop picks %.4f of its %d "
            "tokens again (floor %g); K cache a position %s; %.2f gathers "
            "a step" % (gen_name, exact, len(ref), agree,
                        sum(len(r) for r in ref), MP_LM_AGREE, shape[0],
                        legs["sharded " + gen_name]["gathers_per_step"]))
        if agree < MP_LM_AGREE:
            problems.append("(c) %s teacher-forced agreement %.4f under %g"
                            % (gen_name, agree, MP_LM_AGREE))
    loop = lm_decode_loop(params, contexts=MP_POSITIONS, prefix_cache=True)
    legs["sharded prefix"], prefixed = mp_dec_run(
        loop, prompts, seeds, DEC_SAMPLED, plen=len(shared))
    h = loop.health.report()
    legs["sharded prefix"].update(hits=h["prefix_hits"],
                                  prefills=h["prefix_prefills"])
    loop.close()
    if prefixed != out["sampled"]:
        problems.append("(c) sharded prefix streams differ from the sharded "
                        "target-only loop's")
    loop = lm_decode_loop(params, contexts=MP_POSITIONS, spec_k=DEC_SPEC_K,
                          draft_params=draft, draft_num_layers=1)
    legs["sharded spec_k%d" % DEC_SPEC_K], spec = mp_dec_run(
        loop, prompts, seeds, DEC_SAMPLED)
    h = loop.health.report()
    legs["sharded spec_k%d" % DEC_SPEC_K].update(
        accept_rate=h["spec_accepted"] / max(1, h["spec_drafted"]))
    loop.close()
    if spec != out["sampled"]:
        problems.append("(c) sharded speculative streams differ from the "
                        "sharded target-only loop's")
    launches = {"single": dec_step_launches(lm_decode_loop(params)),
                "sharded": dec_step_launches(lm_decode_loop(
                    params, contexts=MP_POSITIONS))}
    log("mp (c) prefix and spec_k %d legs token for token with the sharded "
        "target-only loop: %s; device launches a decode step, single "
        "against sharded (torch.profiler): %s"
        % (DEC_SPEC_K, not any(p.startswith("(c) sharded") for p in
                                problems), launches))
    for name, leg in legs.items():
        log("mp (c) %-16s %8.1f tokens/s, %.3f ms a decode step (%d steps, "
            "%d tokens) [%s]" % (name, leg["tokens_per_s"],
                                  leg["ms_per_step"], leg["steps"],
                                  leg["tokens"], card))
    legs["launches_per_step"] = launches
    return legs


def mp_fleet(card, engine, single, sharded, pool, rng, problems):
    """(d). Returns B2's launches in the fleet run."""
    import torch
    from mxnet_tpu_torch.ops import multibox_nms as mnms
    from mxnet_tpu_torch.serving import Batcher, FleetRouter
    refs = {"single": tier_refs(single, pool)[0],
            "sharded": tier_refs(sharded, pool)[0]}
    sizes = rng.integers(1, 9, FLEET_REQUESTS)
    starts = [int(rng.integers(0, TIER_POOL - n + 1)) for n in sizes]
    classes = ["batch" if i % 3 == 2 else "interactive"
               for i in range(FLEET_REQUESTS)]
    freqs = [{"data": pool[s:s + n]} for s, n in zip(starts, sizes)]
    findex = {id(r): i for i, r in enumerate(freqs)}
    engines = [single, sharded]
    router = FleetRouter({"r0": Batcher(single), "r1": Batcher(sharded)})
    answers, done = {}, [0]
    progress = threading.Condition(threading.Lock())

    def serve(req):
        i = findex[id(req)]
        out = router.infer(req, priority=classes[i])[0]
        with progress:
            answers[i] = out
            done[0] += 1
            progress.notify_all()

    def join_factory():
        eng = engine(MP_POSITIONS)
        engines.append(eng)
        return Batcher(eng)
    events = []

    def control():
        for at, what in ((FLEET_REQUESTS // 3, "drain r1"),
                         (2 * FLEET_REQUESTS // 3, "join r2")):
            with progress:
                progress.wait_for(lambda: done[0] >= at, timeout=60.0)
            t = time.perf_counter()
            if what == "drain r1":
                router.drain("r1", timeout=60.0)
            else:
                router.join("r2", join_factory)
            events.append("%s after %d answers (%.3f s)"
                          % (what, done[0], time.perf_counter() - t))
    from mxnet_tpu_torch.autotune.harness import open_loop_run
    torch.cuda.synchronize()
    before = [e.health.batches for e in engines]
    mnms.reset_launches()
    ctl = threading.Thread(target=control)
    ctl.start()
    lat, errs, wall = open_loop_run(serve, lambda i: freqs[i], FLEET_QPS,
                                    FLEET_REQUESTS, nclients=TIER_CLIENTS)
    ctl.join(120.0)
    torch.cuda.synchronize()
    launches, routes = mnms.LAUNCHES, dict(mnms.LAUNCHES_BY_ROUTE)
    disp = sum(e.health.batches - b for e, b in zip(engines, before + [0]))
    expect = disp + len(BUCKETS)     # the joined engine's warm-up
    rep = router.report()
    router.close()
    devices = {n: r["model_devices"] for n, r in rep["replicas"].items()}
    by = {"single": 0, "sharded": 0, "both": 0}
    wrong = []
    for i, a in answers.items():
        rows = range(starts[i], starts[i] + sizes[i])
        hit = [all(a[k].tobytes() in refs[w][j] for k, j in enumerate(rows))
               for w in ("single", "sharded")]
        if all(hit):
            by["both"] += 1
        elif hit[0]:
            by["single"] += 1
        elif hit[1]:
            by["sharded"] += 1
        else:
            wrong.append(i)
    log("mp (d) fleet of a single-device (r0) and a sharded (r1) SSD "
        "replica, %d requests of 1-8 images at %.0f/s: %s; %d completed, "
        "%d failed, shed %d, errors %d, expired %d; answers equal to the "
        "single engine's only %d, the sharded engine's only %d, both %d, "
        "neither %d; p50 %.3f ms, p99 %.3f ms; model_devices by replica %s; "
        "multibox_nms launches %d (by route %s) for %d dispatches and %d "
        "warm-up launches of the joined engine [%s]"
        % (FLEET_REQUESTS, FLEET_QPS, events, len(lat), len(errs),
           rep["fleet"]["shed"], rep["fleet"]["errors"],
           rep["fleet"]["expired"], by["single"], by["sharded"], by["both"],
           len(wrong), _pct(lat, 50), _pct(lat, 99), devices, launches,
           routes, disp, len(BUCKETS), card))
    if (len(lat) != FLEET_REQUESTS or errs or wrong or len(events) != 2
            or rep["fleet"]["shed"] or rep["fleet"]["errors"]
            or rep["fleet"]["expired"]):
        problems.append("(d) fleet: %d of %d completed, errors %s, answers "
                        "of neither engine %s, events %s"
                        % (len(lat), FLEET_REQUESTS, errs[:3], wrong[:5],
                           events))
    if devices != {"r0": 1, "r1": MP_POSITIONS, "r2": MP_POSITIONS}:
        problems.append("(d) report()'s model_devices %s" % devices)
    if launches != expect or routes != {"smem": expect, "l2": 0}:
        problems.append("(d) multibox_nms ran %d times (by route %s) for %d "
                        "expected" % (launches, routes, expect))
    return launches


def mp_phase(seed, card, lm):
    """Phase 21 (see the module docstring). ``lm``: phase 17's trained LM
    weights and its one-layer draft. Returns B2's launches on the
    model-parallel path ((a)'s dispatches and (d)'s fleet run)."""
    problems = []
    t_phase = time.perf_counter()
    rng = np.random.default_rng(seed + 21)
    pool = rng.random((TIER_POOL,) + SSD_INPUT, dtype=np.float32)
    with no_tf32(), deterministic_cudnn(), \
            tempfile.TemporaryDirectory() as tmp:
        prefix = os.path.join(tmp, "ssd")
        ssd_checkpoint(prefix, seed)
        files = (prefix + "-symbol.json", prefix + "-0000.params")
        t = time.perf_counter()
        launches, sharded, single, engine = mp_ssd(seed, card, files, pool,
                                                   problems)
        t_ssd = time.perf_counter() - t
        t = time.perf_counter()
        legs = mp_lm(seed, card, lm[0], lm[1], problems)
        t_lm = time.perf_counter() - t
        t = time.perf_counter()
        launches += mp_fleet(card, engine, single, sharded, pool, rng,
                             problems)
        t_fleet = time.perf_counter() - t
    log("mp: %s" % json.dumps({"decode": legs}, sort_keys=True))
    log("mp: the phase took %.1f s ((a)+(b) %.1f, (c) %.1f, (d) %.1f)"
        % (time.perf_counter() - t_phase, t_ssd, t_lm, t_fleet))
    if problems:
        raise SystemExit("model-parallel phase failed: "
                         + "; ".join(problems))
    return launches


# ---------------------------------------------------------------------------
# mesh phase: data parallelism over a 'data' mesh of replicas on one card
# ---------------------------------------------------------------------------

#: phase 18: replicas of the 'data' mesh (all on MESH_DEVICE: the machine
#: has one card), steps a dispatch
MESH_REPLICAS = 2
MESH_DEVICE = "cuda:0"
MESH_K = 4
#: (a) float32 (TF32 off, deterministic cuDNN), each of MESH_K steps at lr
#: 0.1 run on the mesh from the one-device state before it: the moving
#: statistics (forward sums) within rtol |one device| + atol of the
#: one-device step's; the parameters' update within MESH_F32_UPDATE_RTOL
#: of its norm. The update is not held elementwise: on random labels one
#: f32 step of this model is itself some 1.7% (in norm; up to 13% of a
#: tensor's largest element) off its float64 value, on one device as on
#: the mesh (``_precision_study(64, 16)`` of tests/test_torch_multichip.py,
#: on the CPU), so the two f32 updates differ by as much.
#: Steps in a row amplify that (after 4 free-running steps on the card
#: the parameters 12% of their norm apart, the mean losses 0.13%)
MESH_F32_TOL = (1e-3, 1e-5)
MESH_F32_UPDATE_RTOL = 5e-2
#: (b) bf16 compute, each step from the one-device state before it: the
#: moving statistics within MESH_BF16_AUX_RTOL of the norm of their
#: one-device change (0.001571 on an H100; per-replica statistics
#: 0.01304), the parameters' update within MESH_BF16_UPDATE_RTOL of the
#: one-device update's norm (0.7669; per-replica statistics 1.327). On
#: random labels at initialisation one bf16 step's update is mostly
#: rounding: the mesh's and one device's differ by 77% in norm and by a
#: median 75% per tensor, so only a bound this wide holds it
MESH_BF16_AUX_RTOL = 5e-3
MESH_BF16_UPDATE_RTOL = 1.0
#: (d) the LM (phase 17's widths), bf16, MESH_K steps: the mesh's update of
#: each parameter within this fraction of the one-device update's norm
MESH_LM_RTOL = 5e-2


def _mesh_close(got, want, tol):
    """(worst |a - b| / (rtol |b| + atol) over the tensors of ``want``, the
    tensor it is in); infinite for a non-finite value."""
    import torch
    rtol, atol = tol
    worst, where = 0.0, None
    for n, b in want.items():
        a, b = got[n].float(), b.float()
        if not bool(torch.isfinite(a).all() and torch.isfinite(b).all()):
            return float("inf"), n
        r = float(((a - b).abs() / (rtol * b.abs() + atol)).max())
        if r > worst:
            worst, where = r, n
    return worst, where


def _replicas_identical(ts, state):
    """Whether every replica's params, aux, optimizer states and step equal
    replica 0's bit for bit."""
    import torch
    reps = ts.replica_states(state)

    def leaves(rep):
        out = list(rep["params"].values()) + list(rep["aux"].values())
        for v in rep["opt"].values():
            out += list(v) if isinstance(v, tuple) else [v]
        return [t for t in out if t is not None] + [rep["step"]]
    first = leaves(reps[0])
    return all(len(first) == len(leaves(r))
               and all(torch.equal(a, b) for a, b in zip(first, leaves(r)))
               for r in reps[1:])


def _timed_dispatch(ts, state, placed):
    """One ``run_steps`` dispatch: (device ms by CUDA events, host ms until
    the call returned, B1 launches, cross-replica sums), each a step."""
    import torch
    from mxnet_tpu_torch.ops import matmul_stats as ms
    from mxnet_tpu_torch.parallel import mesh as pm
    torch.cuda.synchronize()
    ms.reset_launches()
    pm.reset_counters()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    t = time.perf_counter()
    state, m = ts.run_steps(state, placed)
    host = (time.perf_counter() - t) * 1e3
    end.record()
    torch.cuda.synchronize()
    return (start.elapsed_time(end) / MESH_K, host / MESH_K,
            ms.LAUNCHES / MESH_K, pm.COUNTERS["all_reduce"] / MESH_K)


def mesh_phase(seed, card):
    """Phase 18 (see the module docstring). Returns the B1 launches of its
    main paths: ``{"tf32x3": (a)'s, "wgmma": (b)'s}``."""
    import pickle
    import torch
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch import convert, faults
    from mxnet_tpu_torch.ops import matmul_stats as ms, registry
    from mxnet_tpu_torch.parallel import mesh as pm
    from mxnet_tpu_torch.train_step import TrainStep
    t_phase = time.perf_counter()
    problems = []
    dev = torch.device(MESH_DEVICE)
    n_rep = MESH_REPLICAS
    mesh = pm.make_mesh({"data": n_rep}, [dev] * n_rep)
    bsz, img = RESNET_BATCH, RESNET_IMAGE
    dshape = (bsz, img, img, 3)
    os.environ["MXTPU_FUSE_CONV_BN"] = "1"
    with mt.symbol.NameManager():
        sym = mt.models.resnet(num_classes=RESNET_CLASSES, num_layers=50,
                               image_shape="3,%d,%d" % (img, img),
                               layout="NHWC")
    npairs = sum(fused_shapes(sym, dshape).values())
    opt = dict(optimizer="sgd", learning_rate=0.1, momentum=0.9, wd=1e-4)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 18)

    def superbatch():
        return {"data": torch.rand((MESH_K,) + dshape, generator=gen,
                                   device=dev),
                "softmax_label": torch.randint(
                    0, RESNET_CLASSES, (MESH_K, bsz), generator=gen,
                    device=dev).float()}

    def pair(compute_dtype):
        one = TrainStep(sym, device=dev, compute_dtype=compute_dtype, **opt)
        two = TrainStep(sym, mesh=mesh, compute_dtype=compute_dtype, **opt)
        st1 = one.init({"data": dshape}, {"softmax_label": (bsz,)},
                       seed=seed)
        return one, two, st1, two.replicate_state(clone_state(st1))

    def stepwise(one, two, st1, sb, steps=MESH_K):
        """The first ``steps`` steps of ``sb`` on one device, and each on
        the mesh from a copy of the one-device state before it (the error
        of one mesh step; steps in a row amplify each other's). Returns
        st1 after and a dict: ``worst``, ``where``, the worst excess of the
        moving statistics over MESH_F32_TOL and where; ``aux``, the worst
        |mesh - one| / |one's change| of the moving statistics; ``upd``,
        the worst |mesh update - one update| / |one update| over the
        parameters; ``losses``, the two mean losses a step."""
        out = dict(worst=0.0, where=None, aux=0.0, upd=0.0, losses=[])

        def dist(got, want, before):
            return sum(float(torch.sum((got[k].double() - want[k].double())
                                       ** 2)) for k in before) ** 0.5
        for i in range(steps):
            step_sb = {n: v[i:i + 1] for n, v in sb.items()}
            st2 = two.replicate_state(clone_state(st1))
            before = {k: {n: v.clone() for n, v in st1[k].items()}
                      for k in ("params", "aux")}
            st1, m1 = one.run_steps(st1, step_sb)
            st2, m2 = two.run_steps(st2, two.shard_superbatch(step_sb))
            out["losses"].append((m1.loss_avg, m2.loss_avg))
            w, n = _mesh_close(st2["aux"], st1["aux"], MESH_F32_TOL)
            if w > out["worst"]:
                out["worst"], out["where"] = w, "%s step %d" % (n, i)
            for key, got, want, base in (
                    ("aux", st2["aux"], st1["aux"], before["aux"]),
                    ("upd", st2["params"], st1["params"], before["params"])):
                out[key] = max(out[key], dist(got, want, base) / max(
                    dist(want, base, base), 1e-300))
        return st1, out

    def control(dtype, st0, sb):
        """The control: step 0 of ``sb`` on the mesh with BatchNorm's
        whole-batch rule taken away (each replica normalises by its own
        half: MXNet's per-device statistics), against one device from
        ``st0``. Returns stepwise's measures."""
        bn = registry.get("BatchNorm")
        saved, bn.mesh_fn = bn.mesh_fn, None
        try:
            one, two = (TrainStep(sym, device=dev, compute_dtype=dtype, **opt),
                        TrainStep(sym, mesh=mesh, compute_dtype=dtype, **opt))
            return stepwise(one, two, st0, sb, steps=1)[1]
        finally:
            bn.mesh_fn = saved

    def shard_b1(dtype, route):
        """B1 against its plain version on every (M, K, N) the fused pairs
        give one replica's shard (M = local batch x H x W): (worst errors,
        the shapes); raises unless every launch took ``route``."""
        shapes = sorted(fused_shapes(sym, (bsz // n_rep, img, img, 3)))
        worst = (0.0, 0.0, 0.0)
        before = dict(ms.LAUNCHES_BY_ROUTE)
        for m, k, nn in shapes:
            x = torch.randn((m, k), generator=gen, device=dev).to(dtype)
            w = (torch.randn((nn, k), generator=gen, device=dev)
                 / k ** 0.5).to(dtype)
            errs = b1_check(ms, x, w)
            worst = tuple(max(a, b) for a, b in zip(worst, errs))
            del x, w
        routes = b1_routes_since(ms, before)
        if routes[route] != 2 * len(shapes):
            raise SystemExit("mesh: B1 on the shard shapes took routes %s, "
                             "want %s" % (routes, route))
        return worst, shapes

    launches = {}
    # (a) float32: K steps on 2 replicas against one device
    with no_tf32(), deterministic_cudnn():
        one, two, st1, st2 = pair(None)
        sb = superbatch()
        placed = two.shard_superbatch(sb)
        torch.cuda.synchronize()
        ms.reset_launches()
        pm.reset_counters()
        st2, m2 = two.run_steps(st2, placed)
        torch.cuda.synchronize()
        routes = dict(ms.LAUNCHES_BY_ROUTE)
        colls = dict(pm.COUNTERS)
        launches["tf32x3"] = routes["tf32x3"]
        want = n_rep * npairs * MESH_K
        log("mesh (a): resnet-50 NHWC f32, global batch %d on a %d-replica "
            "'data' mesh (every replica on %s), %d steps: B1 launches by "
            "route %s (%d pairs x %d replicas x %d steps = %d), collectives "
            "%s [%s]" % (bsz, n_rep, dev, MESH_K, routes, npairs, n_rep,
                         MESH_K, want, colls, card))
        if routes["tf32x3"] != want or sum(routes.values()) != want:
            problems.append("f32 mesh: B1 launched %s, want %d on tf32x3"
                            % (routes, want))
        if colls["all_gather"]:
            problems.append("f32 mesh: %d ops ran on the gathered batch"
                            % colls["all_gather"])
        if not _replicas_identical(two, st2):
            problems.append("f32 mesh: replicas differ")
        st0 = clone_state(st1)
        st1, r = stepwise(one, two, st1, sb)
        log("mesh (a): each of the %d steps on the mesh from the one-device "
            "state before it: moving statistics worst |mesh - one| / (%g "
            "|one| + %g) %.4g (%s), |mesh - one| / |one's change| %.4g; "
            "parameters |mesh update - one update| / |one update| at most "
            "%.4g; mean losses (one, mesh) %s"
            % (MESH_K, MESH_F32_TOL[0], MESH_F32_TOL[1], r["worst"],
               r["where"], r["aux"], r["upd"], r["losses"]))
        if r["worst"] > 1.0:
            problems.append("f32 mesh: %s off the one-device step"
                            % r["where"])
        if r["upd"] > MESH_F32_UPDATE_RTOL:
            problems.append("f32 mesh: a step's update %.3g off one "
                            "device's" % r["upd"])
        c = control(None, st0, sb)
        log("mesh (a) control, per-replica statistics: moving statistics "
            "worst %.4g of the tolerance (%s), %.4g of their change; "
            "parameters' update %.4g off one device's (the checks above "
            "must refuse it)" % (c["worst"], c["where"], c["aux"], c["upd"]))
        if c["worst"] <= 1.0 and c["upd"] <= MESH_F32_UPDATE_RTOL:
            problems.append("f32 mesh: the checks pass per-replica "
                            "statistics")
        losses = r["losses"]
        del st0
        run = float(torch.sqrt(sum(torch.sum((st2["params"][n]
                                              - st1["params"][n]) ** 2)
                                   for n in st1["params"])))
        ref = float(torch.sqrt(sum(torch.sum(v ** 2)
                                   for v in st1["params"].values())))
        log("mesh (a): the %d-step dispatch, free-running: mean loss one "
            "device %.6f, mesh %.6f; |mesh - one| over the parameters %.4g "
            "of their norm (lr 0.1 on random labels amplifies each step's "
            "last-bit differences)" % (MESH_K, np.mean(
                [a for a, _ in losses]), m2.loss_avg, run / ref))
        del one, two, st1, st2, sb, placed
        torch.cuda.empty_cache()
        # B1 on every shard shape of the mesh path against its plain version
        for dtype, route in ((torch.float32, "tf32x3"),
                             (torch.bfloat16, "wgmma")):
            (b1_err, e1, e2), shapes = shard_b1(dtype, route)
            log("mesh (a): B1 %s on the %d (M, K, N) of one replica's shard "
                "%s, route %s, against its plain version: max |y - y_plain| "
                "%.3g, statistics %.3g, %.3g of their scales"
                % (str(dtype).replace("torch.", ""), len(shapes), shapes,
                   route, b1_err, e1, e2))

    # (b) bf16 compute: replicas, each step against one device, costs
    one, two, st1, st2 = pair("bfloat16")
    sb = superbatch()
    st2, _ = two.run_steps(st2, two.shard_superbatch(sb))
    if not _replicas_identical(two, st2):
        problems.append("bf16 mesh: replicas differ")
    st0 = clone_state(st1)
    st1, r = stepwise(one, two, st1, sb)
    log("mesh (b): resnet-50 NHWC bf16, each of %d steps on the mesh from "
        "the one-device state before it: moving statistics |mesh - one| / "
        "|one's change| at most %.4g (bound %g); parameters |mesh update - "
        "one update| / |one update| at most %.4g (bound %g); mean losses "
        "(one, mesh) %s" % (MESH_K, r["aux"], MESH_BF16_AUX_RTOL, r["upd"],
                            MESH_BF16_UPDATE_RTOL, r["losses"]))
    if r["aux"] > MESH_BF16_AUX_RTOL:
        problems.append("bf16 mesh: moving statistics %.3g off one "
                        "device's" % r["aux"])
    if r["upd"] > MESH_BF16_UPDATE_RTOL:
        problems.append("bf16 mesh: a step's update %.3g off one device's"
                        % r["upd"])
    c = control("bfloat16", st0, sb)
    log("mesh (b) control, per-replica statistics: moving statistics %.4g "
        "of their change; parameters' update %.4g off one device's (the "
        "checks above must refuse it)" % (c["aux"], c["upd"]))
    if c["aux"] <= MESH_BF16_AUX_RTOL and c["upd"] <= MESH_BF16_UPDATE_RTOL:
        problems.append("bf16 mesh: the checks pass per-replica statistics")
    del st0
    sb = superbatch()
    # the mesh walk on a one-replica mesh beside the plain step: what the
    # runner's MeshArray path costs the single-device step
    ts1 = TrainStep(sym, mesh=pm.make_mesh({"data": 1}, [dev]),
                    compute_dtype="bfloat16", **opt)
    costs = {"1": _timed_dispatch(one, st1, sb),
             "1 (one-replica mesh)": _timed_dispatch(
                 ts1, ts1.replicate_state(clone_state(st1)),
                 ts1.shard_superbatch(sb)),
             str(n_rep): _timed_dispatch(two, st2, two.shard_superbatch(sb))}
    del ts1
    launches["wgmma"] = int(costs[str(n_rep)][2] * MESH_K)
    for n, (dms, hms, b1n, red) in costs.items():
        log("mesh (b): %s replica(s): %.3f ms a step between CUDA events "
            "around a %d-step dispatch, %.3f ms of host time until the "
            "dispatch returned, %g B1 launches and %g cross-replica sums a "
            "step [%s]" % (n, dms, MESH_K, hms, b1n, red, card))
    if costs[str(n_rep)][2] != n_rep * npairs:
        problems.append("bf16 mesh: %g B1 launches a step, want %d"
                        % (costs[str(n_rep)][2], n_rep * npairs))

    # (c) the guard's one decision, and resume, on the mesh
    sb = superbatch()
    # a NaN in the last replica's half of step 1: every replica skips it
    sb["data"][1, bsz - 1, 0, 0, 0] = float("nan")
    steps_before = [int(r["step"]) for r in two.replica_states(st2)]
    faults.clear()
    st2, mg = two.run_steps(st2, two.shard_superbatch(sb), guard=True)
    steps_after = [int(r["step"]) for r in two.replica_states(st2)]
    finite = all(bool(torch.isfinite(v).all())
                 for v in st2["params"].values())
    log("mesh (c): guarded dispatch with a NaN in the last replica's half of "
        "step "
        "1: skipped %d, step counters %s -> %s, parameters finite %s, "
        "replicas identical %s" % (mg.skipped, steps_before, steps_after,
                                   finite, _replicas_identical(two, st2)))
    if not (mg.skipped == 1 and finite
            and steps_after == [s + MESH_K - 1 for s in steps_before]
            and _replicas_identical(two, st2)):
        problems.append("mesh guard: not one decision for every replica")
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "mesh_state.pkl")
        with open(path, "wb") as f:
            pickle.dump(convert.to_reference_state(st2), f)
        sba, sbb = superbatch(), superbatch()
        for b in (sba, sbb):
            st2, _ = two.run_steps(st2, two.shard_superbatch(b))
        fresh = TrainStep(sym, mesh=mesh, compute_dtype="bfloat16", **opt)
        with open(path, "rb") as f:
            st3 = fresh.replicate_state(convert.from_reference_state(
                pickle.load(f), dev))
        for b in (sba, sbb):
            st3, _ = fresh.run_steps(st3, fresh.shard_superbatch(b))
        same = all(torch.equal(a, b)
                   for r2, r3 in zip(two.replica_states(st2),
                                     fresh.replica_states(st3))
                   for key in ("params", "aux")
                   for a, b in zip(r2[key].values(), r3[key].values()))
        log("mesh (c): a checkpoint of the mesh state, resumed in a fresh "
            "TrainStep over 2 more dispatches: bit for bit %s" % same)
        if not same:
            problems.append("mesh resume: not bit for bit")
    del one, two, st1, st2, st3, fresh
    torch.cuda.empty_cache()

    # (d) the LM of phase 17 on the mesh against one device
    lsym = lm_symbol()
    host = lm_params(seed)
    x, y = lm_tokens(seed, MESH_K * LM_BATCH)
    lsb = {"data": torch.from_numpy(x.reshape(MESH_K, LM_BATCH, LM_SEQ)),
           "softmax_label": torch.from_numpy(
               y.reshape(MESH_K, LM_BATCH, LM_SEQ))}
    lopt = dict(optimizer="sgd", learning_rate=LM_OPT["learning_rate"],
                momentum=LM_OPT["momentum"], wd=LM_OPT["wd"],
                rescale_grad=LM_OPT["rescale_grad"], compute_dtype=LM_DTYPE)
    res, tok_s = {}, {}
    for n, kw in ((1, dict(device=dev)), (n_rep, dict(mesh=mesh))):
        ts = TrainStep(lsym, **kw, **lopt)
        st = ts.init({"data": (LM_BATCH, LM_SEQ)},
                     {"softmax_label": (LM_BATCH, LM_SEQ)})
        for k, v in host.items():
            st["params"][k].copy_(torch.from_numpy(v))
        st = ts.replicate_state(st)
        feed = {k: v.to(dev) for k, v in lsb.items()}
        feed = ts.shard_superbatch(feed) if n > 1 else feed
        pm.reset_counters()
        st, _ = ts.run_steps(st, feed)
        torch.cuda.synchronize()
        gathers = pm.COUNTERS["all_gather"]
        res[n] = st
        dms = _timed_dispatch(ts, clone_state(st) if n == 1 else
                              ts.replicate_state(clone_state(st)), feed)[0]
        tok_s[n] = LM_BATCH * LM_SEQ / (dms / 1e3)
        if gathers:
            problems.append("lm mesh: %d ops ran on the gathered batch"
                            % gathers)
    worst = 0.0
    for k, v in host.items():
        w0 = torch.from_numpy(v).to(dev)
        upd = float(torch.linalg.norm(res[1]["params"][k] - w0))
        diff = float(torch.linalg.norm(res[n_rep]["params"][k]
                                       - res[1]["params"][k]))
        worst = max(worst, diff / max(upd, 1e-30))
    log("mesh (d): LM (embed %d, %d layers, seq %d, batch %d, bf16) %d "
        "steps: worst |mesh - one| / |one's update| over the parameters "
        "%.4g; %.0f tokens/s on one device, %.0f on %d replicas (CUDA "
        "events around a %d-step dispatch) [%s]"
        % (LM_EMBED, LM_LAYERS, LM_SEQ, LM_BATCH, MESH_K, worst, tok_s[1],
           tok_s[n_rep], n_rep, MESH_K, card))
    if worst > MESH_LM_RTOL:
        problems.append("lm mesh: %.3g of the update off one device"
                        % worst)
    log("mesh: both replicas share %s, so these are the card's own costs "
        "of the replicated step, not a scaling figure; the phase took %.1f s"
        % (dev, time.perf_counter() - t_phase))
    if problems:
        raise SystemExit("mesh phase failed: " + "; ".join(problems))
    return launches


#: phase 19: the model, seq and pipe axes, every position on MESH_DEVICE.
#: (a) phase 17's LM over each mesh: its name, axes and kind ("ring":
#: seq_parallel="ring" with pos_embed_weight on P('seq', None), as bench.py
#: lm_main's rows; "pipe": stack_layers=True with the stacked weights on
#: P('pipe') and AXES_MICRO microbatches), each of AXES_K steps run on the
#: mesh from the one-device state before it
AXES_LM_MESHES = (("seq=2", {"seq": 2}, "ring"),
                  ("data=2,seq=2", {"data": 2, "seq": 2}, "ring"),
                  ("pipe=2", {"pipe": 2}, "pipe"))
AXES_K = 4
AXES_MICRO = 2
#: bf16 compute: each parameter's |mesh - one device| within this fraction
#: of the norm of its one-device update. A bf16 step's update differs by
#: its own rounding wherever sums run in another order: phase 18 measured
#: 0.03446 for the 'data' mesh's LM (its batch sums split in two); the
#: ring adds another order (the softmax statistics corrected across 2
#: shards in bf16) and the pipeline another (microbatches of 16 rows), so
#: the bound is twice that floor rounded up. A step that sums a replicated
#: weight's gradient over 'data' only is off by half its update or more:
#: the control step below must fail it
AXES_LM_RTOL = 1e-1
#: float32 (TF32 off): one step of the seq=2 mesh, the same measure, with
#: a float64 step on one device beside it for the arithmetic's own floor.
#: On the card (NVIDIA H100 80GB HBM3, 700 W) one device's f32 update lay
#: 3.80e-4 of its norm off the float64 update and the mesh's 1.037e-3
#: (the ring's two-pass softmax), the mesh 1.037e-3 off one device. The
#: same mesh step in bf16 compute, held against the f32 one-device update,
#: must fail the bound (its control); the step with TF32 matrix products
#: is printed beside it. The bound lies between the sound reading and
#: the control's
AXES_F32_RTOL = 1e-2
#: (b) example/model-parallel-lstm/lstm.py's defaults: sequence, layers,
#: hidden, embed, vocabulary, batch; Adam at MP_LSTM_LR, MP_LSTM_STEPS
#: steps, every group on a 'model' axis of MP_LSTM_POSITIONS positions
MP_LSTM = dict(seq=16, layers=4, hidden=128, embed=64, vocab=64, batch=32)
MP_LSTM_STEPS = 60
MP_LSTM_LR = 0.01
MP_LSTM_POSITIONS = 2
#: the example's --check bound (rtol, atol) over the span it checks: the
#: first MP_LSTM_SNAP losses, and the parameters after those steps (later,
#: Adam's normalisation turns the last-bit differences of near-zero
#: gradients into whole steps of size lr; the loss must halve over 60)
MP_LSTM_SNAP = 10
MP_LSTM_CHECK = (1e-4, 1e-4)


def mp_lstm_symbol(mt, seq_len, num_layers, num_hidden, num_embed,
                   vocab_size, batch_size):
    """example/model-parallel-lstm/lstm.py's build_symbol from the port's
    ``mt.rnn.LSTMCell`` and ``mt.AttrScope``: layer k in ctx_group
    'layer%d', the embedding in 'embed', the decoder in 'decode'.
    Returns (symbol, state names)."""
    sym = mt.sym
    with mt.symbol.NameManager():
        data = sym.Variable("data")
        label = sym.Variable("softmax_label")
        with mt.AttrScope(ctx_group="embed"):
            outputs = sym.Embedding(data, name="embed",
                                    input_dim=vocab_size,
                                    output_dim=num_embed)
        state_names = []
        for k in range(num_layers):
            with mt.AttrScope(ctx_group="layer%d" % k):
                cell = mt.rnn.LSTMCell(num_hidden, prefix="lstm%d_" % k)
                begin = cell.begin_state(shape=(batch_size, num_hidden))
                state_names += [s.name for s in begin]
                outputs, _ = cell.unroll(seq_len, inputs=outputs,
                                         begin_state=begin, layout="NTC",
                                         merge_outputs=True)
        with mt.AttrScope(ctx_group="decode"):
            flat = sym.Reshape(outputs, shape=(-1, num_hidden))
            pred = sym.FullyConnected(flat, name="pred",
                                      num_hidden=vocab_size)
            lab = sym.Reshape(label, shape=(-1,))
            out = sym.SoftmaxOutput(pred, lab, name="softmax")
    return out, state_names


def _update_ratio(got, new, old):
    """(worst |got - new| / |new - old| over the tensors, its name)."""
    import torch
    worst, where = 0.0, None
    for k, v in new.items():
        a = got[k].float()
        if not bool(torch.isfinite(a).all()):
            return float("inf"), k
        upd = float(torch.linalg.norm(v.float() - old[k].float()))
        r = float(torch.linalg.norm(a - v.float())) / max(upd, 1e-30)
        if r > worst:
            worst, where = r, k
    return worst, where


def _b123_launches():
    """B1's, B2's and B3's launch counts summed."""
    from mxnet_tpu_torch import rtc
    from mxnet_tpu_torch.ops import matmul_stats as ms, multibox_nms as mb
    return ms.LAUNCHES + mb.LAUNCHES + rtc.TRITON_LAUNCHES + rtc.RTC_LAUNCHES


def step_launches(fn, tries=4):
    """Device launches (kernels, copies and memsets) of one call of ``fn``
    by torch.profiler, as phase 17 counts a step's: profiled until two
    profiles in a row record the same counts (the profiler has been seen
    to drop records), at most ``tries`` times; None if they never
    agree."""
    fn()
    prev = None
    for _ in range(tries):
        kernels = profiled_kernels(fn, 1) or []
        counts = {e.key: e.count for e in kernels}
        if counts and counts == prev:
            return sum(counts.values())
        prev = counts
    return None


def _axes_dispatch(ts, state, feed, k):
    """One ``run_steps`` dispatch of ``k`` steps: (device ms by CUDA events,
    host ms until the call returned, collectives by kind, B1-B3 launches),
    each a step."""
    import torch
    from mxnet_tpu_torch.parallel import mesh as pm
    torch.cuda.synchronize()
    pm.reset_counters()
    b0 = _b123_launches()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    t = time.perf_counter()
    ts.run_steps(state, feed)
    host = (time.perf_counter() - t) * 1e3
    end.record()
    torch.cuda.synchronize()
    return (start.elapsed_time(end) / k, host / k,
            {c: v / k for c, v in pm.COUNTERS.items()},
            (_b123_launches() - b0) / k)


def _axes_lm(axes, kind, seed, dev, dtype, steps, f64=False,
             mesh_dtype="same", mesh_tf32=False):
    """Phase 19 (a) over one mesh: ``steps`` steps each from the
    one-device state before it. Returns (the worst update ratio, its
    parameter, the collectives of the first mesh step, and with
    ``steps == AXES_K`` the timed dispatches of one device and the mesh
    as ``_axes_dispatch`` gives them, each with the device launches of
    one step (:func:`step_launches`) appended; with ``f64`` instead the
    worst ratios of one device's and of the mesh's first step against a
    float64 step on one device). ``mesh_dtype`` (the mesh's compute
    dtype, ``dtype``'s by default) and ``mesh_tf32`` (its steps with
    TF32 matrix products) make the mesh's arithmetic coarser than one
    device's, for the float32 check's controls."""
    import torch
    from mxnet_tpu_torch.parallel import mesh as pm
    from mxnet_tpu_torch.train_step import TrainStep
    n = int(np.prod(list(axes.values())))
    mesh = pm.make_mesh(axes, [dev] * n)
    host = lm_params(seed)
    if kind == "ring":
        msym = lm_symbol(seq_parallel="ring", preserve_shape=True)
        osym = lm_symbol(preserve_shape=True)
        shard = {"pos_embed_weight": pm.P("seq", None)}
    else:
        msym = lm_symbol(stack_layers=True, num_microbatches=AXES_MICRO,
                         preserve_shape=True)
        osym = lm_symbol(stack_layers=True, preserve_shape=True)
        host = _stack_params(host)
        shard = {k: pm.P("pipe") for k in host if k.startswith("stack_")}
    x, y = lm_tokens(seed, steps * LM_BATCH)
    xs = torch.from_numpy(x.reshape(steps, LM_BATCH, LM_SEQ)).to(dev)
    ys = torch.from_numpy(y.reshape(steps, LM_BATCH, LM_SEQ)).to(dev)
    opt = dict(optimizer="sgd", learning_rate=LM_OPT["learning_rate"],
               momentum=LM_OPT["momentum"], wd=LM_OPT["wd"],
               rescale_grad=LM_OPT["rescale_grad"], compute_dtype=dtype)
    one = TrainStep(osym, device=dev, **opt)
    if mesh_dtype != "same":
        opt = dict(opt, compute_dtype=mesh_dtype)
    ts = TrainStep(msym, mesh=mesh, param_shardings=shard, **opt)
    st = one.init({"data": (LM_BATCH, LM_SEQ)},
                  {"softmax_label": (LM_BATCH, LM_SEQ)})
    for k, v in host.items():
        st["params"][k].copy_(torch.from_numpy(v))
    worst, where, colls, floor = 0.0, None, None, None
    for i in range(steps):
        batch = {"data": xs[i], "softmax_label": ys[i]}
        mst = ts.replicate_state(clone_state(st))
        pm.reset_counters()
        saved = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = saved or mesh_tf32
        try:
            ts.step(mst, batch)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = saved
        if colls is None:
            colls = dict(pm.COUNTERS)
        old = clone_state(st)["params"]
        if f64 and i == 0:
            ref = TrainStep(osym, device=dev, dtype=np.float64, **opt)
            st64 = ref.init({"data": (LM_BATCH, LM_SEQ)},
                            {"softmax_label": (LM_BATCH, LM_SEQ)})
            for k, v in st["params"].items():
                st64["params"][k].copy_(v.double())
            ref.step(st64, batch)
        one.step(st, batch)
        got = ts.whole_state(mst)["params"]
        r, w = _update_ratio(got, st["params"], old)
        if r > worst:
            worst, where = r, w
        if f64 and i == 0:
            floor = (_update_ratio(st["params"], st64["params"], old),
                     _update_ratio(got, st64["params"], old))
    if steps < AXES_K:
        return worst, where, colls, floor
    feed = {"data": xs, "softmax_label": ys}
    batch = {"data": xs[0], "softmax_label": ys[0]}
    timing = {}
    for tag, step, state, fd in (
            ("one", one, clone_state(st), feed),
            ("mesh", ts, ts.replicate_state(clone_state(st)),
             ts.shard_superbatch(feed))):
        _axes_dispatch(step, state, fd, steps)      # warm
        timing[tag] = _axes_dispatch(step, state, fd, steps) + (
            step_launches(lambda: step.step(state, batch)),)
    return worst, where, colls, timing


def axes_phase(seed, card):
    """Phase 19 (see the module docstring)."""
    import torch
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch import convert, rtc
    from mxnet_tpu_torch.ops import matmul_stats as ms, multibox_nms as mb
    from mxnet_tpu_torch.parallel import mesh as pm
    from mxnet_tpu_torch.train_step import TrainStep
    t_phase = time.perf_counter()
    problems = []
    dev = torch.device(MESH_DEVICE)
    ms.reset_launches()
    mb.reset_launches()
    rtc0 = rtc.TRITON_LAUNCHES + rtc.RTC_LAUNCHES

    # (a) the LM over seq=2, data=2,seq=2 and pipe=2
    for name, axes, kind in AXES_LM_MESHES:
        t = time.perf_counter()
        worst, where, colls, timing = _axes_lm(axes, kind, seed, dev,
                                               LM_DTYPE, AXES_K)
        (d1, h1, _, _, l1), (dn, hn, cn, bn, ln) = (timing["one"],
                                                    timing["mesh"])
        log("axes (a) %s LM (embed %d, %d layers, seq %d, batch %d, bf16) "
            "%d steps, each from the one-device state: worst |mesh - one| "
            "/ |one's update| %.4g (%s; bound %g); ms a step %.3f against "
            "%.3f on one device (CUDA events around a %d-step dispatch), "
            "host ms a step %.3f against %.3f; device launches a step %s "
            "against %s on one device (torch.profiler, one step); B1-B3 "
            "launches a step %g; collectives a step %s; %.1f s [%s]"
            % (name, LM_EMBED, LM_LAYERS, LM_SEQ, LM_BATCH, AXES_K, worst,
               where, AXES_LM_RTOL, dn, d1, AXES_K, hn, h1, ln, l1, bn,
               json.dumps({k: round(v, 2) for k, v in cn.items()}),
               time.perf_counter() - t, card))
        if bn:
            problems.append("axes %s: %g B1-B3 launches a step" % (name, bn))
        if worst > AXES_LM_RTOL:
            problems.append("axes %s: %.3g of the update off one device"
                            % (name, worst))
        if kind == "ring" and (cn["ppermute"] == 0 or cn["all_gather"]):
            problems.append("axes %s: ring rotations %g, gathers %g a step"
                            % (name, cn["ppermute"], cn["all_gather"]))
        if kind == "pipe" and cn["ppermute"] == 0:
            problems.append("axes %s: no pipeline hop" % name)
    # control: the replicated weights' gradients summed over 'data' only
    # (as a 'data' mesh alone would): one seq=2 step must fail the bound
    from mxnet_tpu_torch import train_step as _ts
    real = _ts.shard_grad_sums

    def data_only(grads, m, spec):
        out = list(grads)
        for grp in pm.axis_groups(m, pm.AXIS_DATA):
            summed = pm.all_reduce([grads[r] for r in grp],
                                   [m.replica_devices()[r] for r in grp])
            for r, g in zip(grp, summed):
                out[r] = g
        return out
    _ts.shard_grad_sums = data_only
    try:
        ctl, ctl_where, _, _ = _axes_lm({"seq": 2}, "ring", seed, dev,
                                        LM_DTYPE, 1)
    finally:
        _ts.shard_grad_sums = real
    log("axes (a) control, seq=2 with gradients summed over 'data' only: "
        "worst %.4g (%s), which must exceed the bound %g"
        % (ctl, ctl_where, AXES_LM_RTOL))
    if not ctl > AXES_LM_RTOL:
        problems.append("axes control: %.3g within the bound" % ctl)
    # the tighter float32 check: one step of the seq=2 mesh, TF32 off
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        worst, where, _, floor = _axes_lm({"seq": 2}, "ring", seed, dev,
                                          None, 1, f64=True)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved
    (f1, w1), (fm, wm) = floor
    log("axes (a) seq=2 LM float32 (TF32 off), one step from the same "
        "state: worst |mesh - one| / |one's update| %.4g (%s; bound %g); "
        "against a float64 step on one device: one device %.4g (%s), the "
        "mesh %.4g (%s)" % (worst, where, AXES_F32_RTOL, f1, w1, fm, wm))
    if worst > AXES_F32_RTOL:
        problems.append("axes seq=2 f32: %.3g of the update off one device"
                        % worst)
    # its controls: the same mesh step with coarser matrix products, each
    # against the f32 one-device update, must fail the bound
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        tf32, tf32_where, _, _ = _axes_lm({"seq": 2}, "ring", seed, dev,
                                          None, 1, mesh_tf32=True)
        bf16, bf16_where, _, _ = _axes_lm({"seq": 2}, "ring", seed, dev,
                                          None, 1, mesh_dtype=LM_DTYPE)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved
    log("axes (a) float32 controls, the seq=2 mesh step against the f32 "
        "one-device update: TF32 matrix products %.4g (%s), bf16 compute "
        "%.4g (%s), which must exceed the bound %g"
        % (tf32, tf32_where, bf16, bf16_where, AXES_F32_RTOL))
    if not bf16 > AXES_F32_RTOL:
        problems.append("axes f32 control: bf16 %.3g within the bound"
                        % bf16)
    torch.cuda.empty_cache()

    # (b) the model-parallel LSTM of example/model-parallel-lstm
    c = MP_LSTM
    sym, names = mp_lstm_symbol(mt, c["seq"], c["layers"], c["hidden"],
                                c["embed"], c["vocab"], c["batch"])
    rng = np.random.default_rng(seed)
    starts = rng.integers(1, c["vocab"] - 1, size=(c["batch"],))
    seq = (starts[:, None] + np.arange(c["seq"] + 1)) % (c["vocab"] - 1) + 1
    x = seq[:, :-1].astype(np.float32)
    y = seq[:, 1:].astype(np.float32)
    batch = {"data": torch.from_numpy(x).to(dev),
             "softmax_label": torch.from_numpy(y).to(dev)}
    batch.update({n: torch.zeros((c["batch"], c["hidden"]), device=dev)
                  for n in names})
    shapes = {"data": (c["batch"], c["seq"])}
    shapes.update({n: (c["batch"], c["hidden"]) for n in names})
    g2c = {"embed": "model", "decode": "model"}
    g2c.update({"layer%d" % k: "model" for k in range(c["layers"])})
    n_pos = MP_LSTM_POSITIONS
    mesh = pm.make_mesh({"model": n_pos}, [dev] * n_pos)
    yi = y.reshape(-1).astype(int)
    runs = {}
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        start = None
        for tag, m, g in (("one", None, None), ("mesh", mesh, g2c)):
            ts = TrainStep(sym, data_names=["data"] + names,
                           optimizer="adam", learning_rate=MP_LSTM_LR,
                           mesh=m, group2ctx=g,
                           device=None if m is not None else dev)
            if start is None:
                st = ts.init(shapes, {"softmax_label": (c["batch"],
                                                        c["seq"])}, seed=42)
                start = convert.to_reference_state(st)
            else:
                ts.init(shapes, {"softmax_label": (c["batch"], c["seq"])})
                st = ts.replicate_state(convert.from_reference_state(
                    start, dev))
            losses, snap = [], None
            pm.reset_counters()
            torch.cuda.synchronize()
            t = time.perf_counter()
            ev0 = torch.cuda.Event(enable_timing=True)
            ev1 = torch.cuda.Event(enable_timing=True)
            ev0.record()
            probs = []
            for i in range(MP_LSTM_STEPS):
                st, outs = ts.step(st, batch)
                probs.append(outs[0].detach().reshape(-1, c["vocab"])[
                    torch.arange(len(yi), device=dev),
                    torch.from_numpy(yi).to(dev)])
                if i + 1 == MP_LSTM_SNAP:
                    snap = {k: v.detach().clone() for k, v in
                            ts.whole_state(st)["params"].items()}
            ev1.record()
            torch.cuda.synchronize()
            host = (time.perf_counter() - t) * 1e3 / MP_LSTM_STEPS
            colls = {k: v / MP_LSTM_STEPS for k, v in pm.COUNTERS.items()}
            losses = [float(-torch.log(torch.clamp_min(p, 1e-8)).mean())
                      for p in probs]
            runs[tag] = (losses, snap, ev0.elapsed_time(ev1) / MP_LSTM_STEPS,
                         host, colls, ts, st)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved
    losses, snap, dms, hms, colls, ts, st = runs["mesh"]
    rl, rsnap, rdms, rhms = runs["one"][:4]
    rtol, atol = MP_LSTM_CHECK
    loss_err = max(abs(a - b) / (atol + rtol * abs(b))
                   for a, b in zip(losses[:MP_LSTM_SNAP], rl[:MP_LSTM_SNAP]))
    par_err, par_where = 0.0, None
    for k, v in rsnap.items():
        r = float(((snap[k] - v).abs() / (atol + rtol * v.abs())).max())
        if r > par_err:
            par_err, par_where = r, k
    shard = tuple(st["params"]["lstm0_i2h_weight"].shape)
    log("axes (b) model-parallel LSTM (seq %d, %d layers, hidden %d, "
        "embed %d, vocab %d, batch %d, Adam lr %g) over model=%d: nll %.4f "
        "-> %.4f in %d steps (one device %.4f -> %.4f); the first %d "
        "losses at %.3g and the parameters after them at %.3g (%s) of the "
        "bound rtol %g, atol %g; lstm0_i2h_weight shard %s; ms a step "
        "%.3f against %.3f on one device (CUDA events), host ms a step "
        "%.3f against %.3f; collectives a step %s [%s]"
        % (c["seq"], c["layers"], c["hidden"], c["embed"], c["vocab"],
           c["batch"], MP_LSTM_LR, n_pos, losses[0], losses[-1],
           MP_LSTM_STEPS, rl[0], rl[-1], MP_LSTM_SNAP, loss_err, par_err,
           par_where, rtol, atol, shard, dms, rdms, hms, rhms,
           json.dumps({k: round(v, 2) for k, v in colls.items()}), card))
    if not losses[-1] < 0.5 * losses[0]:
        problems.append("mp lstm: loss %.4f -> %.4f did not halve"
                        % (losses[0], losses[-1]))
    if loss_err > 1.0 or par_err > 1.0:
        problems.append("mp lstm: %.3g / %.3g of the check bound"
                        % (loss_err, par_err))
    if shard != (4 * c["hidden"] // n_pos, c["embed"]):
        problems.append("mp lstm: i2h weight not sharded: %s" % (shard,))
    launched = (ms.LAUNCHES, mb.LAUNCHES,
                rtc.TRITON_LAUNCHES + rtc.RTC_LAUNCHES - rtc0)
    if any(launched):
        problems.append("axes: B1-B3 launched %s times" % (launched,))
    log("axes: every position shares %s, so these are the card's own costs "
        "of the sharded step, not a scaling figure; the phase took %.1f s"
        % (dev, time.perf_counter() - t_phase))
    if problems:
        raise SystemExit("axes phase failed: " + "; ".join(problems))


# ---------------------------------------------------------------------------
# phase 20: the ops of ops/spatial.py and the rest of ops/nn.py and
# ops/contrib.py at their users' widths, and the three examples they serve
# ---------------------------------------------------------------------------

#: the ops of this phase: each must run in at least one case below
OPS_SLICE = (
    "log_softmax", "LeakyReLU", "InstanceNorm", "Deconvolution", "Crop",
    "Pad", "UpSampling", "LinearRegressionOutput",
    "LogisticRegressionOutput", "MAERegressionOutput", "SVMOutput",
    "IdentityAttachKLSparseReg", "CTCLoss", "fft", "ifft", "count_sketch",
    "quantize", "dequantize", "GridGenerator", "BilinearSampler",
    "SpatialTransformer", "ROIPooling", "Correlation")
#: tolerances, as the largest error over the CPU float64 result's largest
#: magnitude (outputs and gradients): elementwise ops and exact maxima keep
#: float32's rounding; sums of tens to thousands of terms (a convolution,
#: an instance's plane, 256 channels, a 512-point transform, a softmax over
#: 32000 classes) 1e-4; the CTC recursion over 300 steps in log space, where
#: each step's terms reach several hundred and float32 keeps about 3e-5 of
#: each, 1e-3 (a CPU float32 run measured 3.7e-5); the affine grids' loc
#: gradient 5e-3: per sample it sums 150528 products of cotangent and
#: bilinear slope, which cancel, and a grid point within a rounding of a
#: pixel edge takes the neighbouring cell's slope (a CPU float32 run
#: measured 7.9e-4; the CPU tests hold edge points against the JAX
#: package's float32 exactly)
OP_TOL_ELEMENTWISE = 1e-5
OP_TOL_SUM = 1e-4
OP_TOL_RECURSION = 1e-3
OP_TOL_GRID = 5e-3
#: ROIPooling's bound on its peak extra device memory at Fast R-CNN's size
ROI_PEAK_LIMIT = 2 * 1024 ** 3
#: channels of ROIPooling and samples of Correlation the CPU float64 run
#: takes (each output channel, and each sample, depends on its own inputs
#: only, so the card's result for them is held whole)
ROI_CPU_CHANNELS = 32
CORR_CPU_SAMPLES = 1


def _op(name, attrs, ins, train=True, gen=None):
    from mxnet_tpu_torch.ops import registry as treg
    outs, _ = treg.get(name).apply(
        treg.OpContext(is_train=train, rng=gen, device=ins[0].device),
        attrs, ins, [])
    return outs[0]


def _frac_away(rng, shape, lo, hi, margin=0.1):
    """Values in [lo, hi) whose fractional parts keep ``margin`` from the
    integers: sample points that both float32 and float64 place in the same
    pixel cell."""
    whole = rng.integers(lo, hi, shape)
    return (whole + rng.uniform(margin, 1 - margin, shape)).astype(np.float32)


def _smooth_images(rng, n, c, h, w):
    """Images of a few low-frequency waves, as smooth as a photograph."""
    y, x = np.meshgrid(np.linspace(0, 1, h), np.linspace(0, 1, w),
                       indexing="ij")
    out = np.zeros((n, c, h, w), np.float32)
    for _ in range(4):
        fy, fx, ph = rng.uniform(0.5, 4, (3, n, c, 1, 1))
        out += np.sin(2 * np.pi * (fy * y + fx * x) + 6 * ph).astype(
            np.float32)
    return out


def p20_cases(rng):
    """Each case at its users' width: name, the ops it runs, numpy inputs,
    the gradient inputs, ``fn(tensors, train, gen)``, the tolerance, and
    optional slices of the inputs and output the CPU float64 run takes."""
    n = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    cases = []

    def case(name, ops, ins, wrt, fn, tol, cpu_in=None, cpu_out=None):
        cases.append(dict(name=name, ops=ops, ins=ins, wrt=wrt, fn=fn,
                          tol=tol, cpu_in=cpu_in, cpu_out=cpu_out))

    # FCN-32s' head: the score map of a 500x500 image upsampled 32x, cropped
    case("Deconvolution+Crop (FCN-32s head)", ["Deconvolution", "Crop"],
         [n(1, 21, 22, 22), n(21, 21, 64, 64) * 0.05,
          np.zeros((1, 3, 500, 500), np.float32)], [0, 1],
         lambda t, tr, g: _op("Crop", dict(num_args=2, offset=(19, 19)), [
             _op("Deconvolution", dict(kernel=(64, 64), stride=(32, 32),
                                       num_filter=21, no_bias=True),
                 t[:2]), t[2]]), OP_TOL_SUM)
    # Fast R-CNN on VGG-16: conv5_3 of a 600x1000 image, 128 rois
    x1 = rng.uniform(0, 900, 128)
    y1 = rng.uniform(0, 520, 128)
    rois = np.stack([np.zeros(128), x1, y1,
                     np.minimum(x1 + rng.uniform(16, 500, 128), 999),
                     np.minimum(y1 + rng.uniform(16, 400, 128), 599)],
                    1).astype(np.float32)
    roi_attrs = dict(pooled_size=(7, 7), spatial_scale=0.0625)
    case("ROIPooling (Fast R-CNN, VGG-16)", ["ROIPooling"],
         [n(1, 512, 38, 63), rois], [0],
         lambda t, tr, g: _op("ROIPooling", roi_attrs, t), OP_TOL_ELEMENTWISE,
         cpu_in=[(slice(None), slice(0, ROI_CPU_CHANNELS)), None],
         cpu_out=(slice(None), slice(0, ROI_CPU_CHANNELS)))
    corr_attrs = dict(kernel_size=1, max_displacement=20, stride1=1,
                      stride2=2, pad_size=20)
    case("Correlation (FlowNetC)", ["Correlation"],
         [n(8, 256, 48, 64), n(8, 256, 48, 64)], [0, 1],
         lambda t, tr, g: _op("Correlation", corr_attrs, t), OP_TOL_SUM,
         cpu_in=[slice(0, CORR_CPU_SAMPLES)] * 2,
         cpu_out=slice(0, CORR_CPU_SAMPLES))
    # character-level speech: 300 frames, 28 characters and the blank
    lens = rng.integers(20, 101, 32)
    label = np.zeros((32, 100), np.float32)
    for i, ln in enumerate(lens):
        label[i, :ln] = rng.integers(1, 29, ln)
    case("CTCLoss (T 300, batch 32, alphabet 29)", ["CTCLoss"],
         [n(300, 32, 29), label], [0],
         lambda t, tr, g: _op("CTCLoss", {}, t), OP_TOL_RECURSION)
    imgs = _smooth_images(rng, 32, 3, 224, 224)
    loc = (np.tile(np.array([0.9, 0.05, 0.02, -0.05, 0.9, -0.03], np.float32),
                   (32, 1)) + 0.02 * n(32, 6)).astype(np.float32)
    case("SpatialTransformer (32x3x224x224)", ["SpatialTransformer"],
         [imgs, loc], [0, 1],
         lambda t, tr, g: _op("SpatialTransformer", dict(
             target_shape=(224, 224), transform_type="affine",
             sampler_type="bilinear"), t), OP_TOL_GRID)
    case("GridGenerator(affine)+BilinearSampler", ["GridGenerator",
                                                   "BilinearSampler"],
         [imgs, loc], [0, 1],
         lambda t, tr, g: _op("BilinearSampler", {}, [t[0], _op(
             "GridGenerator", dict(transform_type="affine",
                                   target_shape=(224, 224)), [t[1]])]),
         OP_TOL_GRID)
    gx = _frac_away(rng, (32, 224, 224), -20, 240)
    gy = _frac_away(rng, (32, 224, 224), -20, 240)
    grid = np.stack([gx * 2 / 223 - 1, gy * 2 / 223 - 1], 1).astype(
        np.float32)
    case("BilinearSampler (grid off pixel edges)", ["BilinearSampler"],
         [imgs, grid], [0, 1],
         lambda t, tr, g: _op("BilinearSampler", {}, t), OP_TOL_SUM)
    flow = np.stack([_frac_away(rng, (32, 224, 224), -8, 8),
                     _frac_away(rng, (32, 224, 224), -8, 8)], 1)
    case("GridGenerator(warp)+BilinearSampler", ["GridGenerator",
                                                 "BilinearSampler"],
         [imgs, flow], [0, 1],
         lambda t, tr, g: _op("BilinearSampler", {}, [t[0], _op(
             "GridGenerator", dict(transform_type="warp"), [t[1]])]),
         OP_TOL_SUM)
    # fast style transfer
    case("InstanceNorm (4x32x256x256)", ["InstanceNorm"],
         [n(4, 32, 256, 256) * 2 + 0.5, n(32), n(32)], [0, 1, 2],
         lambda t, tr, g: _op("InstanceNorm", dict(eps=1e-5), t), OP_TOL_SUM)
    for mode in ("reflect", "edge", "constant"):
        case("Pad %s (4x3x256x256 by 40)" % mode, ["Pad"],
             [n(4, 3, 256, 256)], [0],
             lambda t, tr, g, m=mode: _op("Pad", dict(
                 mode=m, pad_width=(0, 0, 0, 0, 40, 40, 40, 40)), t),
             OP_TOL_ELEMENTWISE)
    act = n(64, 128, 32, 32)
    for mode in ("leaky", "elu", "prelu", "rrelu"):
        ins = [act] + ([n(128) * 0.2] if mode == "prelu" else [])
        attrs = dict(act_type=mode, slope=0.2)
        case("LeakyReLU %s (64x128x32x32)" % mode, ["LeakyReLU"], ins,
             list(range(len(ins))),
             lambda t, tr, g, a=attrs: _op("LeakyReLU", a, t, tr, g),
             OP_TOL_ELEMENTWISE)
    case("UpSampling nearest x2, two inputs (64x128x32x32)", ["UpSampling"],
         [act, n(64, 128, 32, 32)], [0, 1],
         lambda t, tr, g: _op("UpSampling", dict(scale=2, num_args=2), t),
         OP_TOL_ELEMENTWISE)
    # compact bilinear pooling: a 14x14x512 map of 32 images, to 8192
    feats = n(6272, 512)
    case("fft (6272x512)", ["fft"], [feats], [0],
         lambda t, tr, g: _op("fft", {}, t), OP_TOL_SUM)
    case("ifft (6272x1024)", ["ifft"], [n(6272, 1024)], [0],
         lambda t, tr, g: _op("ifft", {}, t), OP_TOL_SUM)
    case("count_sketch (6272x512 to 8192)", ["count_sketch"],
         [feats, rng.integers(0, 8192, 512).astype(np.float32),
          rng.choice([-1.0, 1.0], 512).astype(np.float32)], [0],
         lambda t, tr, g: _op("count_sketch", dict(out_dim=8192), t),
         OP_TOL_SUM)
    case("log_softmax (32x32000)", ["log_softmax"], [n(32, 32000)], [0],
         lambda t, tr, g: _op("log_softmax", {}, t), OP_TOL_SUM)
    scores = n(128, 1000)
    cls = rng.integers(0, 1000, 128).astype(np.float32)
    for head, lab, attrs in (
            ("SVMOutput", cls, dict(margin=1.0)),
            ("SVMOutput", cls, dict(use_linear=True)),
            ("LinearRegressionOutput", n(128, 1000), {}),
            ("LogisticRegressionOutput",
             (rng.random((128, 1000)) > 0.5).astype(np.float32), {}),
            ("MAERegressionOutput", n(128, 1000), dict(grad_scale=0.5))):
        case("%s%s (128x1000)" % (head, " L1" if attrs.get("use_linear")
                                  else ""), [head], [scores, lab], [0],
             lambda t, tr, g, h=head, a=attrs: _op(h, a, t),
             OP_TOL_ELEMENTWISE)
    case("IdentityAttachKLSparseReg (128x1000)",
         ["IdentityAttachKLSparseReg"], [scores], [0],
         lambda t, tr, g: _op("IdentityAttachKLSparseReg", {}, t),
         OP_TOL_ELEMENTWISE)
    return cases


def p20_launches(fn):
    """Device launches (kernels, copies and memsets) of one call of ``fn``:
    the call captured once into a CUDA graph (never replayed), its nodes
    counted by type with libcuda's ``cuGraphGetNodes``. torch.profiler
    drops kernel records on the GPU machine (three of four an op by
    phase 20), so it cannot count them."""
    import ctypes
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        fn()
    cu = ctypes.CDLL("libcuda.so.1")
    raw = ctypes.c_void_p(graph.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    assert cu.cuGraphGetNodes(raw, None, ctypes.byref(n)) == 0
    if not n.value:
        # an identity whose gradient is its cotangent launches nothing
        return 0
    nodes = (ctypes.c_void_p * n.value)()
    assert cu.cuGraphGetNodes(raw, nodes, ctypes.byref(n)) == 0
    kind = ctypes.c_int()
    launches = 0
    for node in nodes:
        assert cu.cuGraphNodeGetType(ctypes.c_void_p(node),
                                     ctypes.byref(kind)) == 0
        # CU_GRAPH_NODE_TYPE_KERNEL, _MEMCPY, _MEMSET
        launches += kind.value in (0, 1, 2)
    del graph
    return launches


def _sl(x, s):
    return x if s is None else x[s]


def _rel_err(got, want):
    got = got.detach().double().cpu()
    want = want.detach().double().cpu()
    return float((got - want).abs().max() / want.abs().max().clamp_min(
        1e-30))


def p20_run(case, dev, dtype, seed, cot=None, slices=False):
    """One forward and backward of ``case`` on ``dev`` in ``dtype`` (its
    integer-valued inputs too): (output, gradients, the tensors)."""
    import torch
    ins = case["ins"]
    if slices and case["cpu_in"]:
        ins = [_sl(x, s) for x, s in zip(ins, case["cpu_in"])]
    ts = [torch.tensor(x, dtype=dtype, device=dev,
                       requires_grad=i in case["wrt"])
          for i, x in enumerate(ins)]
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    out = case["fn"](ts, True, gen)
    grads = []
    if case["wrt"] and cot is not None:
        grads = torch.autograd.grad(out, [ts[i] for i in case["wrt"]],
                                    cot.to(out.dtype))
    return out.detach(), [g.detach() for g in grads], ts


def p20_rrelu_check(case, dev, problems):
    """rrelu draws its slopes on the card: each in [lower, upper), the
    gradient equal to it, and the inference forward (the mean slope)
    against the CPU float64 run."""
    import torch
    x = torch.tensor(case["ins"][0], device=dev, requires_grad=True)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    out = _op("LeakyReLU", dict(act_type="rrelu"), [x], True, gen)
    (g,) = torch.autograd.grad(out, [x], torch.ones_like(out))
    neg = x.detach() < 0
    slope = out.detach()[neg] / x.detach()[neg]
    lo, hi = float(slope.min()), float(slope.max())
    grad_err = float((g[neg] - slope).abs().max())
    ok = 0.125 - 1e-6 <= lo and hi < 0.334 + 1e-6 and grad_err <= 1e-6 \
        and bool((g[~neg] == 1).all())
    inf = _op("LeakyReLU", dict(act_type="rrelu"), [x.detach()], False)
    ref = _op("LeakyReLU", dict(act_type="rrelu"),
              [torch.tensor(case["ins"][0], dtype=torch.float64)], False)
    err = _rel_err(inf, ref)
    log("ops: rrelu on the card: slopes in [%.6f, %.6f] of [0.125, 0.334), "
        "the gradient within %.3g of its slope; inference against the CPU "
        "float64 at %.3g" % (lo, hi, grad_err, err))
    if not ok or err > OP_TOL_ELEMENTWISE:
        problems.append("rrelu: slopes [%g, %g], gradient %g, inference %g"
                        % (lo, hi, grad_err, err))
    return err


def p20_quantize(rng, dev, reps, card, problems):
    """quantize and dequantize of a 1000x2048 weight: on the card against
    the CPU in float32 (exact: the same rounding, half to even)."""
    import torch
    w = rng.standard_normal((1000, 2048)).astype(np.float32)
    w[0, :8] = np.float32(-1.0) + np.arange(8, dtype=np.float32) * (
        np.float32(2.0) / 255) * np.float32(0.5)
    lo, hi = np.array([w.min()], np.float32), np.array([w.max()],
                                                       np.float32)
    rows = []
    for place in (dev, torch.device("cpu")):
        t = [torch.tensor(a, device=place) for a in (w, lo, hi)]
        q = _op("quantize", {}, t)
        deq = _op("dequantize", {}, [q, t[1], t[2]])
        rows.append((q.cpu(), deq.cpu(), q.device, deq.device))
    (qc, dc, qd, dd), (qh, dh, _, _) = rows
    diff = int((qc != qh).sum())
    derr = _rel_err(dc, dh)
    if qd.type != "cuda" or dd.type != "cuda" or qc.dtype != torch.uint8:
        problems.append("quantize: ran on %s/%s, %s" % (qd, dd, qc.dtype))
    if diff or derr > OP_TOL_ELEMENTWISE:
        problems.append("quantize: %d levels differ, dequantize %g"
                        % (diff, derr))
    t = [torch.tensor(a, device=dev) for a in (w, lo, hi)]
    ms = cuda_time_ms(lambda: _op("dequantize", {}, [
        _op("quantize", {}, t), t[1], t[2]]), reps, warmup=2)
    launches = p20_launches(lambda: _op("dequantize", {}, [
        _op("quantize", {}, t), t[1], t[2]]))
    log("ops: quantize+dequantize (1000x2048): %d of %d levels differ from "
        "the CPU's float32, dequantize at %.3g; %.4f ms a round trip (CUDA "
        "events), %s launches [%s]" % (diff, w.size, derr, ms, launches,
                                       card))
    return dict(name="quantize+dequantize (1000x2048)",
                ops=["quantize", "dequantize"], ms=ms, launches=launches,
                max_rel_err=max(float(diff), derr), tol=0.0,
                reference="cpu float32")


def ops_phase(seed, reps, card, dev="cuda:0"):
    """Phase 20 (a) (see the module docstring)."""
    import torch
    from mxnet_tpu_torch.ops import registry as treg
    problems = []
    dev = torch.device(dev)
    rng = np.random.default_rng(seed + 20)
    cases = p20_cases(rng)
    covered = {o for c in cases for o in c["ops"]} | {"quantize",
                                                      "dequantize"}
    assert covered == set(OPS_SLICE) and all(
        treg.exists(o) for o in OPS_SLICE), sorted(set(OPS_SLICE) - covered)
    rows = []
    with no_tf32():
        for case in cases:
            t0 = time.perf_counter()
            out, _, _ = p20_run(case, dev, torch.float32, seed)
            cot = torch.tensor(rng.standard_normal(tuple(out.shape)),
                               dtype=torch.float32, device=dev)
            # the card: output, gradients, peak memory, time, launches
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            out, grads, ts = p20_run(case, dev, torch.float32, seed, cot)
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated() - base
            placed = [t.device.type for t in [out] + list(grads)]
            if set(placed) != {dev.type}:
                problems.append("%s: results on %s" % (case["name"], placed))

            # rrelu draws from the card's default generator, which a
            # CUDA graph's capture can take
            gen = torch.cuda.default_generators[dev.index or 0] \
                if dev.type == "cuda" else None

            def step():
                o = case["fn"](ts, True, gen)
                if case["wrt"]:
                    torch.autograd.grad(o, [ts[i] for i in case["wrt"]],
                                        cot)
            ms = cuda_time_ms(step, max(2, reps // 4), warmup=1)
            fwd_ms = cuda_time_ms(lambda: case["fn"](ts, True, gen),
                                  max(2, reps // 4), warmup=1)
            launches = p20_launches(step)
            # the CPU in float64 from the same inputs
            if "rrelu" in case["name"]:
                err = p20_rrelu_check(case, dev, problems)
            else:
                ccot = _sl(cot, case["cpu_out"]).double().cpu()
                ref, rgrads, _ = p20_run(case, torch.device("cpu"),
                                         torch.float64, seed, ccot,
                                         slices=True)
                errs = [_rel_err(_sl(out, case["cpu_out"]), ref)]
                for i, g, r in zip(case["wrt"], grads, rgrads):
                    s = case["cpu_in"][i] if case["cpu_in"] else None
                    errs.append(_rel_err(_sl(g, s), r))
                err = max(errs)
                if not err <= case["tol"]:
                    problems.append("%s: %.3g over its tolerance %g (%s)"
                                    % (case["name"], err, case["tol"],
                                       ", ".join("%.3g" % e for e in errs)))
            shapes = "x".join(str(d) for d in out.shape)
            log("ops: %s -> %s: %.4f ms forward and backward, %.4f forward "
                "(CUDA events), %s launches, peak extra %.1f MiB; against "
                "the CPU float64%s at %.3g (tol %g); %.1f s [%s]"
                % (case["name"], shapes, ms, fwd_ms, launches,
                   peak / 2 ** 20, " on its slice" if case["cpu_in"] else "",
                   err, case["tol"], time.perf_counter() - t0, card))
            rows.append(dict(name=case["name"], ops=case["ops"], ms=ms,
                             fwd_ms=fwd_ms, launches=launches,
                             peak_mib=round(peak / 2 ** 20, 1),
                             max_rel_err=err, tol=case["tol"],
                             reference="cpu float64"))
            if case["ops"] == ["ROIPooling"] and peak >= ROI_PEAK_LIMIT:
                problems.append("ROIPooling: peak extra memory %.2f GiB"
                                % (peak / 2 ** 30))
            del out, grads, ts
        rows.append(p20_quantize(rng, dev, reps, card, problems))
    if problems:
        raise SystemExit("ops phase failed: " + "; ".join(problems))
    return rows


def example_mnist_autograd(mt, ctx):
    """example/autograd/mnist_autograd.py on ``ctx``: its data, MLP and
    loop; returns the last epoch's accuracy and the epochs' losses."""
    nd, ag = mt.nd, mt.autograd
    rng = np.random.default_rng(0)
    temps = rng.standard_normal((4, 32)).astype(np.float32) * 2
    X = np.concatenate([t + rng.standard_normal((128, 32)).astype(
        np.float32) for t in temps])
    Y = np.repeat(np.arange(4), 128)
    perm = rng.permutation(len(X))
    X, Y = X[perm], Y[perm].astype(np.int64)
    params = {
        "w1": nd.array(rng.standard_normal((32, 64)).astype(np.float32)
                       * 0.1, ctx=ctx),
        "b1": nd.zeros((64,), ctx=ctx),
        "w2": nd.array(rng.standard_normal((64, 4)).astype(np.float32)
                       * 0.1, ctx=ctx),
        "b2": nd.zeros((4,), ctx=ctx)}
    grads = {k: nd.zeros(v.shape, ctx=ctx) for k, v in params.items()}
    ag.mark_variables(list(params.values()), list(grads.values()))
    losses = []
    for _ in range(10):
        total, correct = 0.0, 0
        for i in range(0, len(X), 64):
            xb = nd.array(X[i:i + 64], ctx=ctx)
            yb = Y[i:i + 64]
            onehot = nd.array(np.eye(4, dtype=np.float32)[yb], ctx=ctx)
            with ag.train_section():
                h = nd.relu(nd.dot(xb, params["w1"]) + params["b1"])
                logits = nd.dot(h, params["w2"]) + params["b2"]
                loss = -nd.sum(nd.log_softmax(logits, axis=1) * onehot) \
                    / len(yb)
            ag.compute_gradient([loss])
            for k in params:
                params[k][:] = params[k].asnumpy() - 0.1 * grads[k].asnumpy()
            total += float(loss.asnumpy())
            correct += int((logits.asnumpy().argmax(1) == yb).sum())
        losses.append(total / (len(X) // 64))
    return correct / len(X), losses


def example_nce_lm(mt, ctx):
    """example/nce-loss/nce_lm.py's main on ``ctx``: returns its ranking
    accuracy (true successor against a random token)."""
    sym = mt.sym
    rng = np.random.RandomState(0)
    vocab, dim, k_noise, n = 50, 16, 8, 4096
    centers = rng.randint(0, vocab, n)
    cand = np.concatenate([((centers + 1) % vocab)[:, None],
                           rng.randint(0, vocab, (n, k_noise))], axis=1)
    labels = np.zeros((n, 1 + k_noise), np.float32)
    labels[:, 0] = 1.0
    it = mt.io.NDArrayIter({"data": centers.astype(np.float32),
                            "cand": cand.astype(np.float32)},
                           {"nce_label": labels}, batch_size=64,
                           shuffle=True)
    in_emb = sym.Embedding(sym.Variable("data"), input_dim=vocab,
                           output_dim=dim, name="in_emb")
    out_emb = sym.Embedding(sym.Variable("cand"), input_dim=vocab,
                            output_dim=dim, name="out_emb")
    scores = sym.sum(sym.broadcast_mul(
        out_emb, sym.Reshape(in_emb, shape=(-1, 1, dim))), axis=2)
    net = sym.LogisticRegressionOutput(data=scores,
                                       label=sym.Variable("nce_label"),
                                       name="nce")
    mod = mt.mod.Module(net, data_names=("data", "cand"),
                        label_names=("nce_label",), context=ctx)
    mod.fit(it, num_epoch=12, optimizer="adam",
            optimizer_params={"learning_rate": 0.02},
            initializer=mt.initializer.Normal(0.1))
    args, _ = mod.get_params()
    w_in = args["in_emb_weight"].asnumpy()
    w_out = args["out_emb_weight"].asnumpy()
    test_c = rng.randint(0, vocab, 512)
    pos = (test_c + 1) % vocab
    neg = (test_c + 1 + rng.randint(1, vocab - 1, 512)) % vocab
    return float(((w_in[test_c] * w_out[pos]).sum(1)
                  > (w_in[test_c] * w_out[neg]).sum(1)).mean())


def example_matrix_fact(mt, ctx):
    """example/recommenders/matrix_fact.py's main on ``ctx``: returns the
    holdout RMSE and the label spread."""
    sym = mt.sym
    rng = np.random.RandomState(0)
    n_users, n_items, k = 60, 40, 6
    U = rng.randn(n_users, k).astype(np.float32) * 0.8
    V = rng.randn(n_items, k).astype(np.float32) * 0.8
    users = rng.randint(0, n_users, 4000).astype(np.float32)
    items = rng.randint(0, n_items, 4000).astype(np.float32)
    ratings = ((U[users.astype(int)] * V[items.astype(int)]).sum(1)
               + rng.randn(4000).astype(np.float32) * 0.1)
    it = mt.io.NDArrayIter({"user": users[:3200], "item": items[:3200]},
                           {"score_label": ratings[:3200]}, batch_size=64,
                           shuffle=True)
    val = mt.io.NDArrayIter({"user": users[3200:], "item": items[3200:]},
                            {"score_label": ratings[3200:]}, batch_size=64)
    u = sym.Embedding(sym.Variable("user"), input_dim=n_users, output_dim=k,
                      name="user_emb")
    v = sym.Embedding(sym.Variable("item"), input_dim=n_items, output_dim=k,
                      name="item_emb")
    net = sym.LinearRegressionOutput(data=sym.sum(u * v, axis=1),
                                     label=sym.Variable("score_label"),
                                     name="lro")
    mod = mt.mod.Module(net, data_names=("user", "item"),
                        label_names=("score_label",), context=ctx)
    mod.fit(it, num_epoch=15, optimizer="adam",
            optimizer_params={"learning_rate": 0.02},
            initializer=mt.initializer.Normal(0.1), eval_metric="rmse")
    rmse = float(mod.score(val, mt.metric.RMSE())[0][1])
    return rmse, float(np.std(ratings[3200:]))


def examples_phase(seed, card):
    """Phase 20 (b) (see the module docstring)."""
    import mxnet_tpu_torch as mt
    mt.random.seed(seed)
    ctx = mt.gpu(0)
    problems = []
    t0 = time.perf_counter()
    acc, losses = example_mnist_autograd(mt, ctx)
    log("examples: mnist_autograd on %s: loss %.4f -> %.4f over 10 epochs, "
        "accuracy %.3f (must exceed 0.95); %.1f s [%s]"
        % (ctx, losses[0], losses[-1], acc, time.perf_counter() - t0, card))
    if not acc > 0.95:
        problems.append("mnist_autograd: accuracy %.3f" % acc)
    t0 = time.perf_counter()
    rank = example_nce_lm(mt, ctx)
    log("examples: nce_lm on %s: ranking accuracy %.3f (must be at least "
        "0.95); %.1f s [%s]" % (ctx, rank, time.perf_counter() - t0, card))
    if rank < 0.95:
        problems.append("nce_lm: ranking accuracy %.3f" % rank)
    t0 = time.perf_counter()
    rmse, base = example_matrix_fact(mt, ctx)
    log("examples: matrix_fact on %s: holdout RMSE %.4f against the label "
        "spread %.4f (must be below 0.35 of it, %.4f); %.1f s [%s]"
        % (ctx, rmse, base, 0.35 * base, time.perf_counter() - t0, card))
    if not rmse < 0.35 * base:
        problems.append("matrix_fact: RMSE %.4f, label spread %.4f"
                        % (rmse, base))
    if problems:
        raise SystemExit("examples phase failed: " + "; ".join(problems))
    return dict(mnist_autograd_accuracy=acc, nce_lm_ranking_accuracy=rank,
                matrix_fact_rmse=rmse, matrix_fact_label_std=base)


def slice_phase(seed, reps, card):
    """Phase 20: (a) the ops, then (b) the examples."""
    t0 = time.perf_counter()
    rows = ops_phase(seed, reps, card)
    ex = examples_phase(seed, card)
    log("ops and examples: the phase took %.1f s" % (time.perf_counter() - t0))
    return rows, ex


# ---------------------------------------------------------------------------
# phase 22: distributed training and chaos
# ---------------------------------------------------------------------------

#: (a): bench.py main()'s global batch of 128 over DIST_RANKS ranks, 8 steps
DIST_RANKS = 2
DIST_BATCH = RESNET_BATCH // DIST_RANKS
DIST_STEPS = 8
#: the card's context for the dist ranks ("gpu": cuda:0; a rehearsal on the
#: CPU sets "cpu")
DIST_CTX = "gpu"
#: (b) and (d): the committed chaos plans replayed on the card
DIST_PLANS = "tests/chaos_plans"
DIST_ELASTIC_PLAN = "dist_worker_die_slow_leader_s13.json"
DIST_CARD_PLANS = ("serve_composed_deaths_s1.json",
                   "train_torn_ckpt_midrun_raise_s7.json")
#: a replay that outlives this many seconds is a hang (a violation)
DIST_DEADLINE = 150.0
#: (c): dist_async's staleness window and the accuracy bar of
#: tests/dist_worker.py run_lenet
DIST_ASYNC_STALENESS = 4
DIST_ASYNC_ACC = 0.95
#: phase 6's one-device figures, for (a)'s global images/s
STEP_FIGURES = {}


def _dist_ctx(mt):
    return mt.gpu(0) if DIST_CTX == "gpu" else mt.cpu()


def dist_sync_child(out_dir, seed):
    """(a), one rank (MXTPU_RANK from the launcher): ResNet-50 NHWC bf16
    through Module.fit(kvstore=dist_sync) on this rank's shard, DIST_STEPS
    steps at k=1; writes its figures, its parameters' hash, step 1's local
    gradient vector and the hash of step 1's reduced vector."""
    import hashlib
    import torch
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch import kvstore_server, models
    from mxnet_tpu_torch.ops import matmul_stats as ms
    assert mt.tools_init_distributed(), "the launcher's environment is missing"
    rank = kvstore_server.plane()["rank"]
    os.environ["MXTPU_FUSE_CONV_BN"] = "1"
    img = RESNET_IMAGE
    dshape = (DIST_BATCH, img, img, 3)
    with mt.symbol.NameManager():
        sym = models.resnet(num_classes=RESNET_CLASSES, num_layers=50,
                            image_shape="3,%d,%d" % (img, img),
                            layout="NHWC")
    # this rank's shard of the synthetic data, from --seed
    rng = np.random.default_rng([seed, 22, rank])
    images = rng.standard_normal((DIST_STEPS * DIST_BATCH,) + dshape[1:],
                                 dtype=np.float32)
    labels = rng.integers(0, RESNET_CLASSES,
                          DIST_STEPS * DIST_BATCH).astype(np.float32)
    arg_params = xavier_params(sym, dshape, seed + rank)  # rank 0's wins
    kv = mt.kv.create("dist_sync")
    reduce_ = kv.grad_reduce
    first = {}

    def grad_reduce(vec):
        out = reduce_(vec)
        if not first:
            first.update(local=vec.copy(), reduced=out.copy())
        return out
    kv.grad_reduce = grad_reduce
    stamps = []

    def on_batch(p):
        stamps.append(time.perf_counter())
    mod = mt.mod.Module(sym, context=_dist_ctx(mt), compute_dtype="bfloat16")
    ms.reset_launches()
    t0 = time.perf_counter()
    mod.fit(mt.io.NDArrayIter(images, labels, batch_size=DIST_BATCH),
            num_epoch=1, kvstore=kv, optimizer="sgd",
            optimizer_params=MODULE_OPT, arg_params=arg_params,
            steps_per_dispatch=1, batch_end_callback=on_batch)
    if DIST_CTX == "gpu":
        torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    routes = dict(ms.LAUNCHES_BY_ROUTE)
    h = hashlib.sha256()
    arg, _ = mod.get_params()
    for n in sorted(arg):
        h.update(n.encode() + arg[n].asnumpy().tobytes())
    np.save(os.path.join(out_dir, "local%d.npy" % rank), first["local"])
    ex = dict(mod._fused.dist_exchange)
    steps = np.diff(stamps)           # steps 2..DIST_STEPS
    res = {"rank": rank, "routes": routes, "fit_s": fit_s,
           "steps": len(stamps), "step_ms": [1e3 * x for x in steps],
           "exchange": ex, "params_sha": h.hexdigest(),
           "reduced_sha": hashlib.sha256(
               first["reduced"].tobytes()).hexdigest(),
           "workers": kv.num_workers, "b1_per_step": sum(
               B1_STEP_SHAPES.values())}
    with open(os.path.join(out_dir, "rank%d.json" % rank), "w") as f:
        json.dump(res, f)
    return 0


def dist_async_child(out_dir, seed):
    """(c), one rank: the chaos dist scenario's MLP through
    Module.fit(kvstore=dist_async) at MXTPU_KV_STALENESS; writes the
    largest staleness lag a pull saw and the training accuracy."""
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch import kvstore_server
    assert mt.tools_init_distributed(), "the launcher's environment is missing"
    rank = kvstore_server.plane()["rank"]
    nproc = kvstore_server.plane()["size"]
    n_class, dim, n_per, bs = 4, 16, 96, 32
    rng = np.random.RandomState(7)          # the chaos scenario's data
    templates = rng.randn(n_class, dim).astype(np.float32) * 3
    y = (np.arange(n_class * n_per) % n_class).astype(np.float32)
    x = templates[y.astype(int)] + rng.randn(len(y), dim).astype(
        np.float32) * 0.5
    # every rank's shard holds every class (x[rank::2] of the scenario's
    # order would give each rank two of the four)
    order = np.random.RandomState(seed).permutation(len(y))
    x, y = x[order], y[order]
    data = mt.sym.Variable("data")
    h = mt.sym.FullyConnected(data, name="fc1", num_hidden=32)
    h = mt.sym.Activation(h, name="relu1", act_type="relu")
    h = mt.sym.FullyConnected(h, name="fc2", num_hidden=n_class)
    net = mt.sym.SoftmaxOutput(h, name="softmax")
    lags = []
    mod = mt.mod.Module(net, context=_dist_ctx(mt))
    mt.random.seed(seed)
    t0 = time.perf_counter()
    mod.fit(mt.io.NDArrayIter(x[rank::nproc], y[rank::nproc],
                              batch_size=bs),
            num_epoch=6, kvstore="dist_async",
            optimizer_params={"learning_rate": 0.1, "momentum": 0.9},
            initializer=mt.initializer.Xavier(),
            batch_end_callback=lambda p: lags.append(
                int(mod._kvstore.staleness_lag)))
    fit_s = time.perf_counter() - t0
    acc = dict(mod.score(mt.io.NDArrayIter(x, y, batch_size=bs), "acc"))
    res = {"rank": rank, "max_lag": max(lags), "steps": len(lags),
           "accuracy": acc["accuracy"], "fit_s": fit_s,
           "staleness": mod._kvstore.staleness}
    with open(os.path.join(out_dir, "rank%d.json" % rank), "w") as f:
        json.dump(res, f)
    return 0


def _launch_ranks(mode, n, out_dir, seed, env=None, timeout=300):
    """``n`` ranks of ``chip_smoke.py --MODE DIR`` through the port's
    launcher on a free port; raises with their output if any fails."""
    from mxnet_tpu_torch.chaos.runner import _free_port
    root = os.path.dirname(os.path.abspath(__file__))
    e = dict(os.environ)
    e["PYTHONPATH"] = os.pathsep.join(
        [root] + [p for p in e.get("PYTHONPATH", "").split(os.pathsep) if p])
    e.update(env or {})
    cmd = [sys.executable, "-m", "mxnet_tpu_torch.tools.launch", "-n", str(n),
           "--coord-port", str(_free_port()),
           "%s %s --%s %s --seed %d" % (sys.executable,
                                        os.path.abspath(__file__), mode,
                                        out_dir, seed)]
    t0 = time.perf_counter()
    r = subprocess.run(cmd, env=e, capture_output=True, text=True,
                       timeout=timeout, cwd=root)
    took = time.perf_counter() - t0
    if r.returncode != 0:
        raise SystemExit("dist: %s ranks failed (exit %d):\n%s\n%s"
                         % (mode, r.returncode, r.stdout[-4000:],
                            r.stderr[-6000:]))
    return [json.load(open(os.path.join(out_dir, "rank%d.json" % k)))
            for k in range(n)], took


def dist_phase(seed, card):
    """Phase 22 (see the module docstring). Returns B1's launches on the
    dist path (every rank's)."""
    import hashlib
    import torch
    from mxnet_tpu_torch import chaos
    t_phase = time.perf_counter()
    problems = []
    if DIST_CTX == "gpu":
        torch.cuda.empty_cache()       # the ranks share the card with us
    root = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory() as tmp:
        # (a) dist_sync: ResNet-50 over two ranks on cuda:0
        res, took = _launch_ranks("dist-sync-child", DIST_RANKS, tmp, seed,
                                  env={"MXTPU_FUSE_CONV_BN": "1"})
        per_step = res[0]["b1_per_step"]
        launches = 0
        for r in res:
            want = {"wgmma": per_step * DIST_STEPS, "wmma": 0, "tf32x3": 0,
                    "f32": 0}
            if DIST_CTX == "gpu" and r["routes"] != want:
                problems.append("rank %d: matmul_stats routes %s, expected "
                                "%s" % (r["rank"], r["routes"], want))
            launches += r["routes"]["wgmma"]
        if len({r["params_sha"] for r in res}) != 1:
            problems.append("the ranks' parameters differ: %s"
                            % [r["params_sha"][:12] for r in res])
        total = None
        for k in range(DIST_RANKS):     # the ring's member order
            v = np.load(os.path.join(tmp, "local%d.npy" % k))
            total = v.copy() if total is None else total + v
        want_sha = hashlib.sha256(total.tobytes()).hexdigest()
        same = all(r["reduced_sha"] == want_sha for r in res)
        if not same:
            problems.append("step 1's reduced vector is not the member-order "
                            "sum of the ranks' gradients")
        step_ms = float(np.median([m for r in res for m in r["step_ms"]]))
        ex = res[0]["exchange"]
        ex_ms = 1e3 * ex["seconds"] / max(ex["count"], 1)
        ex_bytes = ex["bytes"] / max(ex["count"], 1)
        ips = RESNET_BATCH * 1e3 / step_ms
        one = STEP_FIGURES.get("fused_ips")
        log("dist (a) ResNet-50 NHWC bf16, MXTPU_FUSE_CONV_BN=1, "
            "Module.fit(kvstore='dist_sync'), %d ranks x batch %d on %s, %d "
            "steps at k=1 (%.1f s, launch to exit): parameters %s across "
            "ranks; step 1's reduced vector %s the member-order sum of the "
            "ranks' gradients (%d floats); matmul_stats %s launches a rank "
            "(%d a step)"
            % (DIST_RANKS, DIST_BATCH, DIST_CTX, DIST_STEPS, took,
               "equal bit for bit" if len({r["params_sha"] for r in res}) == 1
               else "DIFFER", "equals bit for bit" if same else "DIFFERS FROM",
               total.size, [r["routes"]["wgmma"] for r in res], per_step))
        log("dist (a) %.3f ms a step (host clock, median of steps 2-%d over "
            "both ranks), exchange %.3f ms and %d bytes sent a step a rank "
            "(%d exchanges: D2H, encode, store writes, the peer's reads, "
            "the sum, H2D); %.1f global images/s against %s one-device "
            "images/s (phase 6's fused step): %.3fx [%s]"
            % (step_ms, DIST_STEPS, ex_ms, ex_bytes, ex["count"], ips,
               "%.1f" % one if one else "n/a",
               ips / one if one else float("nan"), card))
        for r in res:
            log("  rank %d: fit %.2f s, steps ms %s, exchange %s"
                % (r["rank"], r["fit_s"],
                   " ".join("%.1f" % m for m in r["step_ms"]),
                   r["exchange"]))

        # (b) elastic re-form: the committed plan through the port's runner
        os.environ["MXTPU_CHAOS_DEVICE"] = DIST_CTX
        plan = chaos.ChaosPlan.load(os.path.join(root, DIST_PLANS,
                                                 DIST_ELASTIC_PLAN))
        wd = os.path.join(tmp, "elastic")
        outcome = chaos.run_plan(plan, wd, deadline=DIST_DEADLINE)
        viols = chaos.check_scenario(plan, outcome)
        ranks = outcome["rank_results"]
        alive = {k: v for k, v in ranks.items() if v is not None}
        hashes = {v.get("final_hash") for v in alive.values()}
        reforms = sorted({v.get("reforms") for v in alive.values()})
        recovery = [v["generation_steps_s"]["1"][0]
                    - v["generation_steps_s"]["0"][1]
                    for v in alive.values()
                    if "1" in v.get("generation_steps_s", {})]
        log("dist (b) plan %s (%s): %.1f s, rc %s, survivors %s, hashes "
            "%s, reforms %s, invariants %s; kill to the survivors' first "
            "step of generation 1: %s s (the last step of generation 0 to "
            "the first of generation 1) [%s]"
            % (DIST_ELASTIC_PLAN, plan.describe(), outcome["wall_s"],
               outcome["rc"], sorted(alive),
               "equal" if len(hashes) == 1 else "DIFFER", reforms,
               [v.to_dict() for v in viols] or "all green",
               " ".join("%.3f" % x for x in recovery), card))
        if viols:
            problems.append("(b) invariants: %s" % [v.to_dict()
                                                   for v in viols])
        if len(hashes) != 1 or reforms != [1] or sorted(alive) != [0, 1] \
                or len(recovery) != 2:
            problems.append("(b) survivors %s, hashes %d, reforms %s"
                            % (sorted(alive), len(hashes), reforms))

        # (c) dist_async at MXTPU_KV_STALENESS=4, and (d) the serving and
        # training plans on the card, side by side: none of them is timed
        adir = os.path.join(tmp, "async")
        os.makedirs(adir)
        out = {}

        def run_async():
            out["c"] = _launch_ranks(
                "dist-async-child", DIST_RANKS, adir, seed,
                env={"MXTPU_KV_STALENESS": str(DIST_ASYNC_STALENESS)})

        def run_plan(name):
            plan = chaos.ChaosPlan.load(os.path.join(root, DIST_PLANS, name))
            outcome = chaos.run_plan(plan, os.path.join(tmp, name),
                                     deadline=DIST_DEADLINE)
            out[name] = (plan, outcome, chaos.check_scenario(plan, outcome))

        def guarded(fn, *a):
            try:
                fn(*a)
            except BaseException as e:      # reported below, never lost
                out.setdefault("errors", []).append(repr(e)[:4000])
        t0 = time.perf_counter()
        threads = [threading.Thread(target=guarded, args=(run_async,))] + [
            threading.Thread(target=guarded, args=(run_plan, name))
            for name in DIST_CARD_PLANS]
        for t in threads:
            t.start()
        for t in threads:
            t.join(DIST_DEADLINE + 60)
            if t.is_alive():
                raise SystemExit("dist (c)/(d): a run outlived its deadline")
        if out.get("errors"):
            raise SystemExit("dist (c)/(d) failed: %s" % out["errors"])
        ares, atook = out["c"]
        lag = max(r["max_lag"] for r in ares)
        acc = min(r["accuracy"] for r in ares)
        log("dist (c) dist_async, MXTPU_KV_STALENESS=%d, %d ranks on %s, the "
            "chaos scenario's MLP, 6 epochs (%.1f s): largest staleness lag "
            "%d (bound %d), training accuracy %s (bar %.2f), steps %s"
            % (DIST_ASYNC_STALENESS, DIST_RANKS, DIST_CTX, atook, lag,
               DIST_ASYNC_STALENESS, [round(r["accuracy"], 4) for r in ares],
               DIST_ASYNC_ACC, [r["steps"] for r in ares]))
        if lag > DIST_ASYNC_STALENESS or acc < DIST_ASYNC_ACC:
            problems.append("(c) lag %d, accuracy %.4f" % (lag, acc))
        for name in DIST_CARD_PLANS:
            plan, outcome, viols = out[name]
            res_d = outcome["result"] or {}
            log("dist (d) plan %s (%s) on %s: %.1f s, rc %s, outcome %s, "
                "fired %s, invariants %s"
                % (name, plan.describe(), DIST_CTX, outcome["wall_s"],
                   outcome["rc"], res_d.get("outcome"),
                   res_d.get("fault_fired"),
                   [v.to_dict() for v in viols] or "all green"))
            if viols:
                problems.append("(d) %s: %s" % (name, [v.to_dict()
                                                      for v in viols]))
        log("dist (c) and (d) side by side: %.1f s" % (time.perf_counter()
                                                     - t0))
    log("dist: the phase took %.1f s" % (time.perf_counter() - t_phase))
    if problems:
        raise SystemExit("dist phase failed: " + "; ".join(problems))
    return launches


# ---------------------------------------------------------------------------
# capi phase: the C ABI (libmxnet_tpu_torch.so) and its pure-C client
# ---------------------------------------------------------------------------

#: (a) bench.py main()'s ResNet-50, NHWC, float32, at this batch
CAPI_BATCH = 32
CAPI_LAYERS = 50
#: (b) the SSD (get_symbol() defaults) at this bucket
CAPI_SSD_BATCH = 8
#: host cost: calls timed each round, rounds in turns
CAPI_HOST_CALLS = 20
CAPI_HOST_ROUNDS = 4
#: the arrays card_client dumps, held bit for bit between the in-process
#: run and the child (both with cuDNN's deterministic algorithms)
CAPI_DUMPED = ("a_grads", "a_params", "b_det", "c_w", "c_mom")
CAPI_CHILD_TIMEOUT = 300


def capi_inputs(in_dir, seed, batch, image, classes, layers, ssd_batch,
                ssd_input, ssd_kw=None):
    """Write card_client's inputs from ``seed`` into ``in_dir`` (see
    ``mxnet_tpu_torch/csrc/capi/card_client.c``): a ResNet NHWC classifier
    with Xavier weights, zero moving means and unit moving variances, one
    batch of data and labels; an SSD inference symbol with random weights
    (``ssd_checkpoint``) and one batch of images. Returns the host arrays
    and symbols."""
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch import models
    os.makedirs(in_dir, exist_ok=True)
    dshape = (batch, image, image, 3)
    with mt.symbol.NameManager():
        net = models.resnet(num_classes=classes, num_layers=layers,
                            image_shape="3,%d,%d" % (image, image),
                            layout="NHWC")
    params = {n: v.asnumpy() for n, v in
              xavier_params(net, dshape, seed).items()}
    _, _, aux_shapes = net.infer_shape(data=dshape,
                                       softmax_label=(batch,))
    aux = {}
    for n, s in zip(net.list_auxiliary_states(), aux_shapes):
        aux[n] = (np.ones(s, np.float32) if n.endswith("moving_var")
                  else np.zeros(s, np.float32))
    rng = np.random.default_rng(seed + 23)
    data = rng.standard_normal(dshape, dtype=np.float32)
    label = rng.integers(0, classes, batch).astype(np.float32)
    snet = ssd_checkpoint(os.path.join(in_dir, "ssd"), seed, ssd_input,
                          **(ssd_kw or {}))[0]
    images = rng.random((ssd_batch,) + tuple(ssd_input), dtype=np.float32)
    files = {"resnet.json": net.tojson().encode(),
             "resnet_data.bin": data.tobytes(),
             "resnet_label.bin": label.tobytes(),
             "resnet_params.bin": b"".join(
                 params[n].tobytes() for n in net.list_arguments()
                 if n in params),
             "resnet_aux.bin": b"".join(
                 aux[n].tobytes() for n in net.list_auxiliary_states()),
             "ssd_data.bin": images.tobytes(),
             "meta.txt": ("resnet %d %d %d 3\nssd %d %d %d %d\n"
                          "sgd %r %r %r %r\n"
                          % ((batch, image, image, ssd_batch)
                             + tuple(ssd_input)
                             + (SGD["lr"], SGD["momentum"], SGD["wd"],
                                SGD["rescale_grad"]))).encode()}
    for name, blob in files.items():
        with open(os.path.join(in_dir, name), "wb") as f:
            f.write(blob)
    return {"sym": net, "params": params, "aux": aux, "data": data,
            "label": label, "ssd": snet, "ssd_images": images,
            "ssd_json": os.path.join(in_dir, "ssd-symbol.json"),
            "ssd_params": os.path.join(in_dir, "ssd-0000.params")}


def capi_results(out_dir):
    """card_client's results.txt: name -> (count, sum, sum of |x|)."""
    got = {}
    with open(os.path.join(out_dir, "results.txt")) as f:
        for line in f:
            name, n, s, a = line.split()
            got[name] = (int(n), float(s), float(a))
    return got


def capi_dumped(out_dir, name):
    return np.fromfile(os.path.join(out_dir, name + ".bin"), np.float32)


def capi_python_step(inputs, dev):
    """(a) through the port's Python API on ``dev``: bind, one training
    forward and backward, the update through a local KVStore whose updater
    runs nd.sgd_mom_update. Returns (loss, updated parameters in argument
    order, concatenated)."""
    import mxnet_tpu_torch as mt
    net, params = inputs["sym"], inputs["params"]
    ctx = mt.cpu() if dev == "cpu" else mt.gpu(0)
    names = [n for n in net.list_arguments() if n in params]
    args = {n: mt.nd.array(v, ctx=ctx) for n, v in params.items()}
    args["data"] = mt.nd.array(inputs["data"], ctx=ctx)
    args["softmax_label"] = mt.nd.array(inputs["label"], ctx=ctx)
    grads = {n: mt.nd.zeros(params[n].shape, ctx=ctx) for n in names}
    aux = {n: mt.nd.array(v, ctx=ctx) for n, v in inputs["aux"].items()}
    ex = net.bind(ctx, args, args_grad=grads, aux_states=aux)
    ex.forward(is_train=True)
    ex.backward()
    prob = ex.outputs[0].asnumpy().astype(np.float64)
    lab = inputs["label"].astype(np.int64)
    loss = -float(np.mean(np.log(np.maximum(
        prob[np.arange(len(lab)), lab], 1e-30))))
    moms = [mt.nd.zeros(params[n].shape, ctx=ctx) for n in names]

    def updater(key, recv, local):
        mt.nd.sgd_mom_update(local, recv, moms[key], out=[local, moms[key]],
                             **SGD)
    kv = mt.kv.create("local")
    kv._set_updater(updater)
    weights = [args[n] for n in names]
    keys = list(range(len(names)))
    kv.init(keys, weights)
    kv.push(keys, [grads[n] for n in names])
    kv.pull(keys, out=weights)
    return loss, np.concatenate([w.asnumpy().ravel() for w in weights])


def _abi_call(lib, fn_name, *args):
    import ctypes
    if getattr(lib, fn_name)(*args) != 0:
        raise SystemExit("capi: %s failed: %s" % (
            fn_name, ctypes.string_at(lib.MXGetLastError()).decode()))


def capi_host_costs(lib, inputs, card):
    """The ABI's host microseconds a call beside the Python API's, for
    MXNDArraySyncCopyFromCPU of (a)'s data batch and MXExecutorForward of
    its executor (inference), in turns; each call starts on an idle card
    and is timed to its return (the copy is synchronous, the forward
    returns once enqueued)."""
    import ctypes
    import torch
    from mxnet_tpu_torch import c_api
    lib.MXGetLastError.restype = ctypes.c_void_p
    net, params = inputs["sym"], inputs["params"]
    batch = np.ascontiguousarray(inputs["data"])
    st, hx = c_api.MXNDArrayCreate(batch.shape, 2, 0)
    handles = []
    for n in net.list_arguments():
        v = (batch if n == "data" else inputs["label"] if n ==
             "softmax_label" else params[n])
        handles.append(c_api.MXNDArrayCreateFromNumpy(v)[1])
    auxh = [c_api.MXNDArrayCreateFromNumpy(inputs["aux"][n])[1]
            for n in net.list_auxiliary_states()]
    sh = c_api.MXSymbolCreateFromJSON(net.tojson())[1]
    st, eh = c_api.MXExecutorBind(sh, 2, 0, handles, None, "null", auxh)
    if st != 0:
        raise SystemExit("capi: bind for the host costs: %s"
                         % c_api.MXGetLastError())
    arr, ex = c_api._get(hx), c_api._get(eh)
    ptr = batch.ctypes.data_as(ctypes.c_void_p)
    calls = {
        "MXNDArraySyncCopyFromCPU (ABI)": lambda: _abi_call(
            lib, "MXNDArraySyncCopyFromCPU", ctypes.c_uint64(hx), ptr,
            ctypes.c_size_t(batch.size)),
        "NDArray[:] = batch (Python)": lambda: arr.__setitem__(
            slice(None), batch),
        "MXExecutorForward (ABI)": lambda: _abi_call(
            lib, "MXExecutorForward", ctypes.c_uint64(eh), 0),
        "Executor.forward (Python)": lambda: ex.forward(is_train=False)}
    got = {name: [] for name in calls}
    for r in range(CAPI_HOST_ROUNDS):
        for name in (list(calls) if r % 2 == 0 else list(calls)[::-1]):
            calls[name]()
            for _ in range(CAPI_HOST_CALLS):
                torch.cuda.synchronize()
                t = time.perf_counter()
                calls[name]()
                got[name].append(time.perf_counter() - t)
    torch.cuda.synchronize()
    us = {name: 1e6 * float(np.median(v)) for name, v in got.items()}
    for name, v in us.items():
        log("capi host cost: %s %.1f us a call (median of %d) [%s]"
            % (name, v, CAPI_HOST_ROUNDS * CAPI_HOST_CALLS, card))
    c_api.MXExecutorFree(eh)
    for h in [hx, sh] + handles + auxh:
        c_api._free(h)
    return us


def capi_checks(inputs, out_in, res_in, seed, problems):
    """Phase 23's in-process results against the Python API on cuda:0 and
    each kernel against its plain version: (a) the loss and updated
    parameters, B1 at the step's shapes; (b) the detections against the
    Predictor and the plain NMS; (c) the Rtc update against
    nd.sgd_mom_update. Appends what is off to ``problems``; returns the
    three kernels' largest errors."""
    import torch
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch.ops import contrib, matmul_stats as ms
    from mxnet_tpu_torch.ops import multibox_nms as mnms
    dshape = inputs["data"].shape
    nparam = len(inputs["params"])
    # -- (a) against the Python API; B1 against its plain version
    t0 = time.perf_counter()
    with no_tf32():
        loss, want = capi_python_step(inputs, "cuda")
    got = capi_dumped(out_in, "a_params")
    abi_loss = res_in["a_loss"][1]
    rel, excess = max_excess({"w": torch.from_numpy(got)},
                             {"w": torch.from_numpy(want)})
    loss_off = abs(abi_loss - loss) / abs(loss)
    log("capi (a): loss through the ABI %.9f, Python API %.9f (rel "
        "%.3g, bound %g); updated parameters: largest relative "
        "difference %.3g, excess over rtol %g atol %g %.3g (%.2f s)"
        % (abi_loss, loss, loss_off, METRIC_CE_RTOL, rel, MODULE_RTOL,
           MODULE_ATOL, excess, time.perf_counter() - t0))
    if not (loss_off <= METRIC_CE_RTOL and excess <= 0):
        problems.append("capi (a): the ABI's step is off the Python "
                        "API's")
    x_rng = torch.Generator(device="cuda").manual_seed(seed)
    b1_err = 0.0
    for (m, k, n) in fused_shapes(inputs["sym"], dshape):
        x = torch.randn(m, k, device="cuda", generator=x_rng)
        w = torch.randn(n, k, device="cuda", generator=x_rng)
        err, _, _ = b1_check(ms, x, w, "tf32x3")
        b1_err = max(b1_err, err)
    log("capi (a): B1 tf32x3 against its plain version at the %d "
        "shapes of the step: max |y - y_plain| %.3g, within tolerance"
        % (len(fused_shapes(inputs["sym"], dshape)), b1_err))

    # -- (b) against the Python API's Predictor and the plain NMS
    det = capi_dumped(out_in, "b_det")
    shape = (CAPI_SSD_BATCH,) + tuple(SSD_INPUT)
    pred = mt.Predictor(inputs["ssd_json"], inputs["ssd_params"],
                        {"data": shape}, ctx=mt.gpu(0))
    pred.forward(data=inputs["ssd_images"])
    want = pred.get_output(0).asnumpy()
    heads = mt.Predictor(inputs["ssd_json"], inputs["ssd_params"],
                         {"data": shape}, ctx=mt.gpu(0),
                         output_names=["cls_prob", "multibox_loc_pred",
                                       "multibox_anchors"])
    heads.forward(data=inputs["ssd_images"])
    cls_prob, loc, anc = (heads.get_output(i).data for i in range(3))
    det_node = [n for n in _nodes(inputs["ssd"])
                if n.name == "detection"][0]
    with torch.inference_mode():
        plain = contrib.multibox_detection(
            cls_prob, loc, anc[:1], nms=mnms.nms_alive_reference,
            **contrib._mbd_attrs(det_node.attrs)).cpu().numpy()
    det = det.reshape(plain.shape)
    kept = int((det[:, :, 0] >= 0).sum())
    b2_err = float(np.abs(det - plain).max())
    log("capi (b): detections %s through the ABI, %d rows kept: equal "
        "to the Python API's Predictor %s, to the plain NMS on the same "
        "heads %s" % (det.shape, kept, np.array_equal(det, want),
                      np.array_equal(det, plain)))
    if not (np.array_equal(det, want) and np.array_equal(det, plain)
            and kept > 0):
        problems.append("capi (b): detections through the ABI differ")

    # -- (c) against nd.sgd_mom_update
    names = [n for n in inputs["sym"].list_arguments()
             if n in inputs["params"]]
    w0 = torch.from_numpy(np.concatenate(
        [inputs["params"][n].ravel() for n in names])).cuda()
    g = torch.from_numpy(capi_dumped(out_in, "a_grads")).cuda()
    w = torch.from_numpy(capi_dumped(out_in, "c_w")).cuda()
    m = torch.from_numpy(capi_dumped(out_in, "c_mom")).cuda()
    b3_excess, b3_err = update_excess(w, m, w0, g, torch.zeros_like(w0))
    log("capi (c): the Rtc update over %d arrays against "
        "nd.sgd_mom_update: max |diff| %.3g, excess over the bound %.3g"
        % (nparam, b3_err, b3_excess))
    if b3_excess > 0:
        problems.append("capi (c): the Rtc update exceeds its bound")
    del w0, g, w, m
    return b1_err, b2_err, b3_err


def capi_phase(seed, card):
    """Phase 23: the C ABI on the card. Builds libmxnet_tpu_torch.so and
    card_client from the checkout, runs the client's three paths in this
    process through ctypes (B1 through MXExecutorBind, B2 through
    MXPredCreate from two C threads, B3 through MXRtcPush) with the
    launches counted, holds each against the same work through the Python
    API and each kernel against its plain version, runs ``card_client
    gpu`` as a child process against the in-process run, and times the
    ABI's host cost a call."""
    import ctypes
    import sysconfig
    import torch
    from mxnet_tpu_torch import capi_build, rtc
    from mxnet_tpu_torch.ops import matmul_stats as ms
    from mxnet_tpu_torch.ops import multibox_nms as mnms
    t_phase = time.perf_counter()
    flags = capi_build.python_flags()
    with open("/proc/self/maps") as f:
        mapped = sorted({ln.split()[-1] for ln in f if "libpython" in ln})
    log("capi: python3-config %s: --ldflags --embed %s; Py_ENABLE_SHARED "
        "%s, LDLIBRARY %s in %s; libpython mapped in this process before "
        "the library loads: %s" % (
            capi_build._config_script(), " ".join(flags[1]),
            sysconfig.get_config_var("Py_ENABLE_SHARED"),
            sysconfig.get_config_var("LDLIBRARY"),
            sysconfig.get_config_var("LIBDIR"), mapped or "none"))
    t0 = time.perf_counter()
    built = capi_build.build()
    log("capi: built %s (library, card_client, libcard_client.so) in "
        "%.2f s" % (built["dir"], time.perf_counter() - t0))
    problems = []
    os.environ["MXTPU_FUSE_CONV_BN"] = "1"
    with tempfile.TemporaryDirectory() as tmp:
        in_dir = os.path.join(tmp, "in")
        t0 = time.perf_counter()
        inputs = capi_inputs(in_dir, seed, CAPI_BATCH, RESNET_IMAGE,
                             RESNET_CLASSES, CAPI_LAYERS, CAPI_SSD_BATCH,
                             SSD_INPUT)
        nparam = len(inputs["params"])
        dshape = inputs["data"].shape
        expected_b1 = sum(fused_shapes(inputs["sym"], dshape).values())
        log("capi: inputs from the seed in %.2f s: resnet-%d NHWC %s "
            "float32, %d parameter arrays (%d values), %d fused "
            "Conv1x1->BatchNorm pairs; SSD %s at bucket %d"
            % (time.perf_counter() - t0, CAPI_LAYERS, dshape, nparam,
               sum(v.size for v in inputs["params"].values()), expected_b1,
               SSD_INPUT, CAPI_SSD_BATCH))

        # -- in process: the client's code through ctypes, launches counted
        out_in = os.path.join(tmp, "inproc")
        os.makedirs(out_in)
        run = ctypes.CDLL(built["client_lib"]).card_client_run
        run.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_char_p)]
        run.restype = ctypes.c_int
        argv = [a.encode() for a in
                ("card_client", "gpu", in_dir, out_in, "dump")]
        argv_c = (ctypes.c_char_p * len(argv))(*argv)
        sys.stdout.flush()
        torch.cuda.synchronize()
        # the main path: counts at 0 just before, read just after
        ms.reset_launches()
        mnms.reset_launches()
        rtc.RTC_LAUNCHES = 0
        tf32x3 = ms.LAUNCHES_BY_ROUTE["tf32x3"]
        t0 = time.perf_counter()
        with deterministic_cudnn():
            rc = run(len(argv), argv_c)
            torch.cuda.synchronize()
        dt_in = time.perf_counter() - t0
        launches = {"B1": ms.LAUNCHES,
                    "B1 tf32x3": ms.LAUNCHES_BY_ROUTE["tf32x3"] - tf32x3,
                    "B2": mnms.LAUNCHES, "B3": rtc.RTC_LAUNCHES}
        sys.stdout.flush()
        if rc != 0:
            raise SystemExit("capi: card_client_run in process returned %d"
                             % rc)
        log("capi: in process, card_client_run(gpu) took %.2f s; launches "
            "B1 %d (tf32x3 %d, expected %d), B2 %d (expected 2), B3 %d "
            "(expected %d)" % (dt_in, launches["B1"], launches["B1 tf32x3"],
                               expected_b1, launches["B2"], launches["B3"],
                               nparam))
        if (launches["B1"] != expected_b1
                or launches["B1 tf32x3"] != expected_b1
                or launches["B2"] != 2 or launches["B3"] != nparam):
            problems.append("capi: launches through the ABI %s, expected "
                            "B1 %d on tf32x3, B2 2, B3 %d"
                            % (launches, expected_b1, nparam))
        res_in = capi_results(out_in)

        # -- the child process: the same client, its own interpreter, with
        # cuDNN's deterministic algorithms as in process
        out_child = os.path.join(tmp, "child")
        os.makedirs(out_child)
        t_child = time.perf_counter()
        child = subprocess.Popen(
            [built["client"], "gpu", in_dir, out_child, "dump"],
            env=capi_build.client_env(MXTPU_FUSE_CONV_BN="1",
                                      MXNET_ENFORCE_DETERMINISM="1"),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)

        # the checks run while the child starts up; it is stopped if
        # they fail
        try:
            b1_err, b2_err, b3_err = capi_checks(
                inputs, out_in, res_in, seed, problems)
        except BaseException:
            child.kill()
            child.communicate()
            raise

        # -- the child, started above, against the in-process run
        try:
            child_out, _ = child.communicate(timeout=CAPI_CHILD_TIMEOUT)
        except subprocess.TimeoutExpired:
            child.kill()
            child.communicate()
            raise SystemExit("capi: card_client gpu did not end within %d s"
                             % CAPI_CHILD_TIMEOUT)
        dt_child = time.perf_counter() - t_child
        for line in child_out.splitlines()[-8:]:
            log("capi child: %s" % line)
        if child.returncode != 0 or "CARD CLIENT PASS (gpu)" not in child_out:
            raise SystemExit("capi: card_client gpu exited %d"
                             % child.returncode)
        res_child = capi_results(out_child)
        log("capi: card_client gpu as a child process took %.2f s "
            "(interpreter start, imports, CUDA and NVRTC included; started "
            "before this process's checks and run beside them)" % dt_child)
        for name, (n, s, a) in res_in.items():
            got = res_child.get(name)
            log("capi: %-8s in process n=%d sum %.17g |sum| %.17g; child %s"
                % (name, n, s, a, "equal" if got == (n, s, a) else
                   "%r: OFF" % (got,)))
            if got != (n, s, a):
                problems.append("capi: the child's %s sums differ from the "
                                "in-process run's" % name)
        for name in CAPI_DUMPED:
            x, y = capi_dumped(out_in, name), capi_dumped(out_child, name)
            same = x.shape == y.shape and np.array_equal(x, y)
            off = (float(np.abs(x - y).max()) / max(float(np.abs(x).max()),
                                                    1e-30)
                   if x.shape == y.shape else float("inf"))
            log("capi: %-8s %d values: the child's %s (largest difference "
                "%.3g of the largest |value|)"
                % (name, x.size, "equal bit for bit" if same else "DIFFER",
                   off))
            if not same:
                problems.append("capi: the child's %s differs from the "
                                "in-process run's" % name)

        host = capi_host_costs(ctypes.CDLL(built["library"]), inputs, card)
    if problems:
        raise SystemExit("\n".join(problems))
    log("capi phase: %.1f s [%s]" % (time.perf_counter() - t_phase, card))
    return {"launches": launches, "b1_err": b1_err, "b2_err": b2_err,
            "b3_err": b3_err, "host_us": host, "in_process_s": dt_in,
            "child_s": dt_child}


# ---------------------------------------------------------------------------
# phase 24: the tuner and the memory analyzer on the card
# ---------------------------------------------------------------------------

#: (a) the static peak of the ResNet-50 step against the allocator's
#: measured peak of one real step: within this fraction of the latter
MEMCHECK_BAND = 0.25
#: (a) the batch whose step cannot fit the card
MEMCHECK_BIG_BATCH = 1024
#: (c) the sweeps: (label, tune() arguments)
MEMCHECK_SWEEPS = (
    ("img_per_sec mlp", dict(model="mlp", objective="img_per_sec",
                             budget=4)),
    ("serve_p99 mlp", dict(model="mlp", objective="serve_p99", budget=3,
                           nreq=100)),
    ("decode_tokens_per_sec lm", dict(model="lm",
                                      objective="decode_tokens_per_sec",
                                      budget=2)))


def _unmoved_peak(fn):
    """``(fn(), bytes the allocator's peak rose above the memory allocated
    when fn started)``: 0 when fn allocated nothing on the card."""
    import torch
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.max_memory_allocated()
    out = fn()
    torch.cuda.synchronize()
    return out, torch.cuda.max_memory_allocated() - before


def largest_allocs(fn, n=3):
    """Run ``fn()`` under the caching allocator's history and return the
    ``n`` largest allocations it made: ``(bytes, frames)``, the frames
    those of its C++ and Python stack that name cuDNN, cuBLAS, a
    workspace or a convolution (else the first two)."""
    import torch
    torch.cuda.memory._record_memory_history(max_entries=200000)
    try:
        fn()
        torch.cuda.synchronize()
        snap = torch.cuda.memory._snapshot()
    finally:
        torch.cuda.memory._record_memory_history(enabled=None)
    dev = torch.cuda.current_device()
    allocs = [e for e in snap["device_traces"][dev] if e["action"] == "alloc"]
    out = []
    for e in sorted(allocs, key=lambda e: -e["size"])[:n]:
        names = [f.get("name", "") for f in e.get("frames", [])]
        keep = [x for x in names if re.search(
            "cudnn|cublas|[Ww]orkspace|conv", x)] or names[:2]
        out.append((e["size"], keep[:2]))
    return out


def memcheck_resnet(seed, card, problems):
    """(a): the ResNet-50 step priced shape-only against one real step,
    and the b=1024 step flagged. Returns B1's launches in the real step."""
    import torch
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch import memcheck as mc, models
    from mxnet_tpu_torch.ops import matmul_stats as ms
    from mxnet_tpu_torch.tracecheck import train_step_programs
    from mxnet_tpu_torch.train_step import TrainStep
    os.environ["MXTPU_FUSE_CONV_BN"] = "1"
    bsz, img = RESNET_BATCH, RESNET_IMAGE
    with mt.symbol.NameManager():
        sym = models.resnet(num_classes=RESNET_CLASSES, num_layers=50,
                            image_shape="3,%d,%d" % (img, img),
                            layout="NHWC")
    ts = TrainStep(sym, optimizer="sgd", learning_rate=0.1, momentum=0.9,
                   wd=1e-4, compute_dtype="bfloat16")
    expected = sum(B1_STEP_SHAPES.values())

    def priced(batch):
        def run():
            (name, fn, args), = train_step_programs(
                ts, {"data": (batch, img, img, 3)},
                {"softmax_label": (batch,)}, k=1, guard=False,
                name="resnet50-nhwc-bf16-b%d" % batch)[:1]
            ms.reset_launches()
            t0 = time.perf_counter()
            rep = mc.analyze(fn, args, donate_argnums=(0,), name=name)
            return rep, time.perf_counter() - t0
        (rep, dt), moved = _unmoved_peak(run)
        log("memcheck (a) static %s in %.2f s: B1 shape-only %d times, %d "
            "launches; the allocator's peak moved %d bytes [%s]"
            % (rep.format(), dt, ms.SHAPE_ONLY_CALLS, ms.LAUNCHES, moved,
               card))
        for line in rep.breakdown(top=6):
            log("memcheck (a)   " + line)
        if ms.SHAPE_ONLY_CALLS != expected or ms.LAUNCHES or moved:
            problems.append("memcheck (a) b=%d: %d shape-only calls "
                            "(expected %d), %d launches, peak moved %d "
                            "bytes" % (batch, ms.SHAPE_ONLY_CALLS, expected,
                                       ms.LAUNCHES, moved))
        return rep

    # the first fake CUDA tensor a process makes from a real one runs
    # FakeTensor's CUDA-context check, a 4-byte tensor on the card: done
    # here, outside the windows that must not move the allocator's peak
    with mc.fake_mode() as mode:
        mode.from_tensor(torch.zeros(1, device=ts.device))
    static = priced(bsz)
    # one real step from a fresh state: the allocator's peak above what
    # was allocated before its state, batch and step
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    dev = ts.device
    state = ts.init({"data": (bsz, img, img, 3)}, {"softmax_label": (bsz,)},
                    seed=seed)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 24)
    batch = {"data": torch.randn((bsz, img, img, 3), generator=gen,
                                 device=dev),
             "softmax_label": torch.randint(
                 0, RESNET_CLASSES, (bsz,), generator=gen,
                 device=dev).float()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ms.reset_launches()
    state, outs = ts.step(state, batch)
    torch.cuda.synchronize()
    measured = torch.cuda.max_memory_allocated() - base
    launches, routes = ms.LAUNCHES, dict(ms.LAUNCHES_BY_ROUTE)
    ratio = static.peak_bytes / measured
    log("memcheck (a) b=%d: static peak %d bytes (%.3f GiB), measured %d "
        "bytes (%.3f GiB, torch.cuda.max_memory_allocated over one real "
        "step, above the %d bytes allocated before it): static/measured "
        "%.4f (band 1 +- %.2f); B1 %d launches by route %s [%s]"
        % (bsz, static.peak_bytes, static.peak_bytes / 2 ** 30, measured,
           measured / 2 ** 30, base, ratio, MEMCHECK_BAND, launches, routes,
           card))
    if abs(ratio - 1.0) > MEMCHECK_BAND:
        problems.append("memcheck (a): static peak %d is %.4f of the "
                        "measured %d (band %.2f)"
                        % (static.peak_bytes, ratio, measured,
                           MEMCHECK_BAND))
    if launches != expected or routes["wgmma"] != expected:
        problems.append("memcheck (a): the real step launched B1 %d times "
                        "(%s), expected %d on wgmma"
                        % (launches, routes, expected))
    del state, outs, batch
    torch.cuda.empty_cache()
    big = priced(MEMCHECK_BIG_BATCH)
    budget = mc.budget_bytes(dev)
    lints = sorted({f.lint for f in mc.lint_report(big, budget=budget)})
    log("memcheck (a) b=%d: static peak %.3f GiB against the card's %.3f "
        "GiB: lints %s [%s]" % (MEMCHECK_BIG_BATCH,
                                big.peak_bytes / 2 ** 30,
                                budget / 2 ** 30, lints, card))
    if "hbm-budget" not in lints:
        problems.append("memcheck (a): the b=%d step is not flagged "
                        "hbm-budget" % MEMCHECK_BIG_BATCH)
    return launches


def memcheck_ssd(seed, card, problems):
    """(b): the SSD engine's memory_report against each bucket's measured
    peak. Returns B2's launches (the warm-up and one forward a bucket)."""
    import torch
    from mxnet_tpu_torch.ops import multibox_nms as mnms
    from mxnet_tpu_torch.serving import ServingEngine
    with tempfile.TemporaryDirectory() as tmp:
        prefix = os.path.join(tmp, "ssd")
        ssd_checkpoint(prefix, seed)
        mnms.reset_launches()
        eng = ServingEngine(prefix + "-symbol.json", prefix + "-0000.params",
                            {"data": SSD_INPUT}, buckets=BUCKETS)
    load_launches = mnms.LAUNCHES
    t0 = time.perf_counter()
    reports, moved = _unmoved_peak(eng.memory_report)
    dt = time.perf_counter() - t0
    if (mnms.SHAPE_ONLY_CALLS != len(BUCKETS)
            or mnms.LAUNCHES != load_launches or moved):
        problems.append("memcheck (b): memory_report took the shape-only "
                        "route %d times (expected %d), launched %d, moved "
                        "the peak %d bytes"
                        % (mnms.SHAPE_ONLY_CALLS, len(BUCKETS),
                           mnms.LAUNCHES - load_launches, moved))
    log("memcheck (b) ssd memory_report of %d buckets in %.2f s, B2 "
        "shape-only %d times [%s]"
        % (len(BUCKETS), dt, mnms.SHAPE_ONLY_CALLS, card))
    rng = np.random.default_rng(seed + 24)
    weights = eng.weight_bytes()
    for b in BUCKETS:
        x = rng.random((b,) + SSD_INPUT, dtype=np.float32)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        biggest = largest_allocs(lambda: eng.infer({"data": x}))
        measured = torch.cuda.max_memory_allocated() - base + weights
        rep = reports[b]
        ratio = rep.peak_bytes / measured
        log("memcheck (b) %s; measured %d bytes (the forward's allocator "
            "peak above what was allocated before it, plus the %d bytes of "
            "weights): static %d, static/measured %.4f (band 1 +- %.2f) "
            "[%s]" % (rep.format(), measured, weights, rep.peak_bytes,
                      ratio, MEMCHECK_BAND, card))
        if abs(ratio - 1.0) > MEMCHECK_BAND or rep.unpriced_workspaces:
            problems.append("memcheck (b) bucket %d: static peak %d is %.4f "
                            "of the measured %d (band %.2f), %d convolution "
                            "workspaces not priced"
                            % (b, rep.peak_bytes, ratio, measured,
                               MEMCHECK_BAND, rep.unpriced_workspaces))
        for size, frames in biggest:
            log("memcheck (b)   the forward's allocation of %d bytes: %s"
                % (size, " < ".join(f[:120] for f in frames)))
        log("memcheck (b)   the dry run's largest: %s"
            % "; ".join("%d %s %s" % (t["bytes"], t["opcode"], t["op_path"])
                        for t in rep.top_buffers[:3]))
    return mnms.LAUNCHES


def memcheck_sweeps(card, problems):
    """(c): three sweeps on the card, then one whose every candidate is
    pruned with the allocator's peak unmoved."""
    from mxnet_tpu_torch import autotune
    for label, kw in MEMCHECK_SWEEPS:
        t0 = time.perf_counter()
        r = autotune.tune(**kw)
        best = r["best"]
        log("memcheck (c) %s: %d trials %s, default %s, best %s score %s "
            "%s, speedup_vs_default %s, %.1f s [%s]"
            % (label, len(r["trials"]), r["counts"],
               r["default"] and r["default"]["score"],
               best and best["knobs"], best and best["score"], r["unit"],
               r.get("speedup_vs_default"), time.perf_counter() - t0, card))
        if best is None:
            problems.append("memcheck (c): the %s sweep ended without a "
                            "best (%s)" % (label, r["counts"]))
    os.environ["MXTPU_AUTOTUNE_BUDGET"] = "4K"
    try:
        r, moved = _unmoved_peak(lambda: autotune.tune(
            model="mlp", objective="img_per_sec", budget=4))
    finally:
        del os.environ["MXTPU_AUTOTUNE_BUDGET"]
    log("memcheck (c) img_per_sec mlp under MXTPU_AUTOTUNE_BUDGET=4K: %s, "
        "best %s, the allocator's peak moved %d bytes; first: %s [%s]"
        % (r["counts"], r["best"], moved,
           (r["trials"][0]["detail"] or "").split("\n")[0], card))
    if (r["best"] is not None or r["counts"]["pruned"] != len(r["trials"])
            or moved):
        problems.append("memcheck (c): the 4K sweep ran a candidate (%s) "
                        "or moved the peak %d bytes" % (r["counts"], moved))


def memcheck_phase(seed, card):
    """Phase 24 (last): the tuner and the memory analyzer on the card.
    Returns ``{"B1": n, "B2": n}``, the kernels' real launches."""
    t_phase = time.perf_counter()
    problems = []
    b1 = memcheck_resnet(seed, card, problems)
    b2 = memcheck_ssd(seed, card, problems)
    memcheck_sweeps(card, problems)
    log("memcheck phase: %.1f s [%s]" % (time.perf_counter() - t_phase,
                                         card))
    if problems:
        raise SystemExit("\n".join(problems))
    return {"B1": b1, "B2": b2}


# ---------------------------------------------------------------------------
# phase 25: tracecheck's registry, the retrace watch and the check methods
# ---------------------------------------------------------------------------

#: (b) dispatches a turn, in turns off, warn, warn, off: the mlp, ResNet-50
TRACECHECK_TURN = {"mlp": 50, "resnet": 10}
#: (b) the mlp's batch, and the hook's back-to-back calls a turn
TRACECHECK_MLP_BATCH = 32
TRACECHECK_HOOK_CALLS = 2000
#: (b) the hook's budget: microseconds a dispatch on the mlp, and its share
#: of the ResNet-50 step's host time
TRACECHECK_MLP_US = 50.0
TRACECHECK_RESNET_SHARE = 0.01
#: (c) the SSD engine's buckets, and the LSTM batches of the bucketed fit
TRACECHECK_BUCKETS = (8, 32)
TRACECHECK_LSTM_BATCHES = 12
#: (d) the zoo CLI's time limit, seconds
TRACECHECK_CLI_TIMEOUT = 600


def _resnet_step(seed):
    """(a)'s ResNet-50 TrainStep (phase 24 (a)'s configuration), a fresh
    state from ``seed`` and one batch made on the card."""
    import torch
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch import models
    from mxnet_tpu_torch.train_step import TrainStep
    os.environ["MXTPU_FUSE_CONV_BN"] = "1"
    bsz, img = RESNET_BATCH, RESNET_IMAGE
    with mt.symbol.NameManager():
        sym = models.resnet(num_classes=RESNET_CLASSES, num_layers=50,
                            image_shape="3,%d,%d" % (img, img),
                            layout="NHWC")
    ts = TrainStep(sym, optimizer="sgd", learning_rate=0.1, momentum=0.9,
                   wd=1e-4, compute_dtype="bfloat16")
    state = ts.init({"data": (bsz, img, img, 3)}, {"softmax_label": (bsz,)},
                    seed=seed)
    gen = torch.Generator(device=ts.device)
    gen.manual_seed(seed + 25)
    batch = {"data": torch.randn((bsz, img, img, 3), generator=gen,
                                 device=ts.device),
             "softmax_label": torch.randint(
                 0, RESNET_CLASSES, (bsz,), generator=gen,
                 device=ts.device).float()}
    return ts, state, batch


def tracecheck_resnet(ts, state, batch, card, problems):
    """(a): step and run_steps (K=2), guarded and unguarded, register four
    programs that audit clean; a float32 -> float16 flip of ``data`` is
    one retrace event, and under ``error`` a RetraceError whose result
    carries the advanced state."""
    import torch
    from mxnet_tpu_torch import engine, tracecheck as tc
    n0 = tc.retrace_count()
    sb = {k: torch.stack([v, v]) for k, v in batch.items()}
    state, _ = ts.step(state, batch)
    state, _, _ = ts.step(state, batch, guard=True)
    state, m = ts.run_steps(state, sb)
    m.fetch()
    state, m = ts.run_steps(state, sb, guard=True)
    m.fetch()
    name = ts._watcher.name
    names = sorted(r.name[len(name) + 1:] for r in tc.registered_programs()
                   if r.name.startswith(name + "/"))
    bs = RESNET_BATCH
    want = sorted(["step[bs=%d]" % bs, "guard-step[bs=%d]" % bs,
                   "scan[bs=%d,k=2]" % bs, "guard-scan[bs=%d,k=2]" % bs])
    t0 = time.perf_counter()
    findings = tc.check_registered(match=name + "/")
    dt = time.perf_counter() - t0
    bad = tc.unsuppressed(findings)
    log("tracecheck (a) %s: %d programs %s, check_registered %.2f s, %d "
        "findings (%d unsuppressed) [%s]"
        % (name, len(names), names, dt, len(findings), len(bad), card))
    for f in findings:
        log("tracecheck (a)   " + f.format())
    if names != want or bad:
        problems.append("tracecheck (a): programs %s (expected %s), %d "
                        "unsuppressed findings" % (names, want, len(bad)))
    half = dict(batch, data=batch["data"].half())
    state, _ = ts.step(state, half)
    events = tc.RETRACE_EVENTS[n0:]
    log("tracecheck (a) the float16 flip: %d event(s) %s"
        % (len(events), [tuple(e) for e in events]))
    if (len(events) != 1 or not events[0].site.endswith(
            "/step[bs=%d]" % bs)
            or not any("['data']" in d and "float32 -> float16" in d
                       for d in events[0].diff)):
        problems.append("tracecheck (a): the flip recorded %s" % (events,))
    engine.set_tracecheck("error")
    try:
        step0 = int(state["step"])
        ts.step(state, half, guard=True)
        problems.append("tracecheck (a): the flip under error did not raise")
    except tc.RetraceError as e:
        got = int(e.result[0]["step"])
        log("tracecheck (a) under error: RetraceError at %s, the result's "
            "step %d after %d" % (tc.RETRACE_EVENTS[-1].site, got, step0))
        if got != step0 + 1:
            problems.append("tracecheck (a): the result's step is %d, not "
                            "%d" % (got, step0 + 1))
    finally:
        engine.set_tracecheck(None)
    return state


def _hook_cost(ts, state, batch, n, calls=TRACECHECK_HOOK_CALLS):
    """The host cost of ``ts``'s tracecheck hook, in turns with
    ``MXTPU_TRACECHECK`` off, warn, warn, off: each turn's ``n`` dispatches'
    host seconds (``ts.step``), and the seconds a call of the hook takes
    on the same arguments, over ``calls`` back-to-back calls (no clock read
    between them). Returns ``{mode: (dispatch seconds, [hook seconds a
    call, one a turn])}``."""
    import torch
    args = (state, ts.shard_batch(batch))
    bs = next(iter(args[1].values())).shape[0]
    out = {"off": ([], []), "warn": ([], [])}
    try:
        for mode in ("off", "warn", "warn", "off"):
            os.environ["MXTPU_TRACECHECK"] = mode
            torch.cuda.synchronize()
            for _ in range(n):
                t = time.perf_counter()
                ts.step(state, batch)
                out[mode][0].append(time.perf_counter() - t)
            torch.cuda.synchronize()
            t = time.perf_counter()
            for _ in range(calls):
                ts._tc_after("step", bs, args, None)
            out[mode][1].append((time.perf_counter() - t) / calls)
    finally:
        del os.environ["MXTPU_TRACECHECK"]
    return out


def tracecheck_host_cost(seed, ts, state, batch, card, problems):
    """(b): the hook's host cost a dispatch, off against warn in turns, on
    the zoo's mlp at batch 32 and on (a)'s ResNet-50 step."""
    import torch
    from mxnet_tpu_torch import models
    from mxnet_tpu_torch.tracecheck import ZOO
    from mxnet_tpu_torch.train_step import TrainStep
    mb = TRACECHECK_MLP_BATCH
    mlp = TrainStep(models.get_symbol("mlp", **ZOO["mlp"]["kwargs"]),
                    optimizer="sgd", learning_rate=0.1)
    mst = mlp.init({"data": (mb, 64)}, {"softmax_label": (mb,)}, seed=seed)
    gen = torch.Generator(device=mlp.device)
    gen.manual_seed(seed + 26)
    mbatch = {"data": torch.randn((mb, 64), generator=gen,
                                  device=mlp.device),
              "softmax_label": torch.randint(0, 4, (mb,), generator=gen,
                                             device=mlp.device).float()}
    figures = {}
    for label, t, st, b in (("mlp", mlp, mst, mbatch),
                            ("resnet", ts, state, batch)):
        t.step(st, b)
        cost = _hook_cost(t, st, b, TRACECHECK_TURN[label])
        med = {m: (1e6 * float(np.median(c[0])), 1e6 * float(np.median(c[1])))
               for m, c in cost.items()}
        figures[label] = med
        log("tracecheck (b) %s: host us a dispatch off %.1f, warn %.1f "
            "(medians of %d each); the hook %.2f us a call off, %.2f warn "
            "(%d calls a turn, medians of 2 turns) [%s]"
            % (label, med["off"][0], med["warn"][0], len(cost["off"][0]),
               med["off"][1], med["warn"][1], TRACECHECK_HOOK_CALLS, card))
    hook_mlp = figures["mlp"]["warn"][1]
    share = figures["resnet"]["warn"][1] / figures["resnet"]["off"][0]
    log("tracecheck (b) the hook: %.2f us a dispatch on the mlp (budget "
        "%.0f), %.4f%% of the ResNet-50 step's host time (budget %.0f%%) "
        "[%s]" % (hook_mlp, TRACECHECK_MLP_US, 100 * share,
                  100 * TRACECHECK_RESNET_SHARE, card))
    if hook_mlp > TRACECHECK_MLP_US or share >= TRACECHECK_RESNET_SHARE:
        problems.append("tracecheck (b): the hook costs %.2f us on the mlp, "
                        "%.4f of the ResNet-50 step" % (hook_mlp, share))
    return figures


def tracecheck_serving(seed, card, problems):
    """(c): the SSD engine's check(memory=True) beside each bucket's real
    forward, the LM's DecodeLoop and the LSTM's BucketingModule. Returns
    B2's launches."""
    import torch
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch.ops import multibox_nms as mnms
    from mxnet_tpu_torch.serving import ServingEngine
    n0 = mnms.LAUNCHES
    with tempfile.TemporaryDirectory() as tmp:
        prefix = os.path.join(tmp, "ssd")
        ssd_checkpoint(prefix, seed)
        eng = ServingEngine(prefix + "-symbol.json", prefix + "-0000.params",
                            {"data": SSD_INPUT}, buckets=TRACECHECK_BUCKETS)
    t0 = time.perf_counter()
    findings = eng.check(memory=True)
    dt = time.perf_counter() - t0
    lints = sorted({f.lint for f in findings})
    log("tracecheck (c) %s check(memory=True) in %.2f s: %d findings %s [%s]"
        % (eng.name, dt, len(findings), lints, card))
    for f in findings:
        log("tracecheck (c)   " + f.format().split("\n")[0])
    if "hbm-budget" in lints:
        problems.append("tracecheck (c): the SSD engine is flagged "
                        "hbm-budget")
    reports = eng.memory_report()
    rng = np.random.default_rng(seed + 25)
    for b in TRACECHECK_BUCKETS:
        x = rng.random((b,) + SSD_INPUT, dtype=np.float32)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        eng.infer({"data": x})
        torch.cuda.synchronize()
        measured = torch.cuda.max_memory_allocated() - base \
            + eng.weight_bytes()
        ratio = reports[b].peak_bytes / measured
        log("tracecheck (c) bucket %d: static %d, measured %d, %.4f (band "
            "1 +- %.2f) [%s]" % (b, reports[b].peak_bytes, measured, ratio,
                                 MEMCHECK_BAND, card))
        if abs(ratio - 1.0) > MEMCHECK_BAND:
            problems.append("tracecheck (c) bucket %d: static/measured "
                            "%.4f" % (b, ratio))
    launches = mnms.LAUNCHES - n0
    del eng
    loop = lm_decode_loop(lm_params(seed), prefix_cache=True)
    try:
        t0 = time.perf_counter()
        findings = loop.check(memory=True)
        log("tracecheck (c) %s check(memory=True) over %d programs in %.2f "
            "s: %d findings [%s]" % (loop.name, len(loop.memory_report()),
                                     time.perf_counter() - t0,
                                     len(findings), card))
        for f in findings:
            log("tracecheck (c)   " + f.format().split("\n")[0])
    finally:
        loop.close()
    it = lstm_iter(seed, lstm_sentences(seed),
                   max_batches=TRACECHECK_LSTM_BATCHES)
    mod = lstm_module(it)
    mod.fit(it, num_epoch=1, arg_params=lstm_params(seed),
            optimizer="adam", optimizer_params={"learning_rate": LSTM_LR},
            eval_metric=mt.metric.Perplexity(ignore_label=0))
    t0 = time.perf_counter()
    findings = mod.check(memory=True)
    log("tracecheck (c) BucketingModule over buckets %s: check(memory=True) "
        "in %.2f s, %d findings [%s]"
        % (sorted(mod._bucket_fused), time.perf_counter() - t0,
           len(findings), card))
    for f in findings:
        log("tracecheck (c)   " + f.format().split("\n")[0])
    return launches


def tracecheck_cli_start():
    """(d): start the zoo CLI on the card in a child process, which runs
    beside (a)-(c); returns it and its start time."""
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=root)
    return subprocess.Popen(
        [sys.executable, "-m", "mxnet_tpu_torch.tracecheck", "--zoo",
         "--json", "--device", "cuda:0"], cwd=root, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True), time.perf_counter()


def tracecheck_cli(started, card, problems):
    """(d): the zoo CLI's exit, programs, findings and seconds."""
    proc, t0 = started
    try:
        out, err = proc.communicate(timeout=TRACECHECK_CLI_TIMEOUT)
    except subprocess.TimeoutExpired:
        proc.kill()
        out, err = proc.communicate()
    dt = time.perf_counter() - t0
    try:
        data = json.loads(out)
    except ValueError:
        data = None
    if proc.returncode or data is None:
        problems.append("tracecheck (d): the zoo CLI exited %s\n%s"
                        % (proc.returncode, err[-3000:]))
        return
    log("tracecheck (d) python -m mxnet_tpu_torch.tracecheck --zoo --json "
        "--device cuda:0: exit %d, %d programs, %d findings (%d suppressed) "
        "in %.1f s [%s]" % (proc.returncode, data["programs"], data["total"],
                            data["suppressed"], dt, card))
    for f in data["findings"]:
        log("tracecheck (d)   [%s] %s: %s (%s)"
            % (f["lint"], f["program"], f["message"].split("\n")[0],
               f["provenance"]))


def tracecheck_phase(seed, card):
    """Phase 25 (last): tracecheck's program registry, the retrace watch
    and the analyzers' check methods on the card. Returns ``{"B1": n,
    "B2": n}``, the kernels' launches in the phase."""
    from mxnet_tpu_torch.ops import matmul_stats as ms
    from mxnet_tpu_torch.ops import multibox_nms as mnms
    t_phase = time.perf_counter()
    problems = []
    cli = tracecheck_cli_start()
    ms.reset_launches()
    mnms.reset_launches()
    ts, state, batch = _resnet_step(seed)
    state = tracecheck_resnet(ts, state, batch, card, problems)
    tracecheck_host_cost(seed, ts, state, batch, card, problems)
    b1 = ms.LAUNCHES
    routes = dict(ms.LAUNCHES_BY_ROUTE)
    del ts, state, batch
    if routes.get("wgmma", 0) != b1 or b1 % sum(B1_STEP_SHAPES.values()):
        problems.append("tracecheck: B1 launched %d times by route %s"
                        % (b1, routes))
    b2 = tracecheck_serving(seed, card, problems)
    tracecheck_cli(cli, card, problems)
    log("tracecheck phase: B1 %d launches (%s), B2 %d; %.1f s [%s]"
        % (b1, routes, b2, time.perf_counter() - t_phase, card))
    if problems:
        raise SystemExit("\n".join(problems))
    return {"B1": b1, "B2": b2}


# ---------------------------------------------------------------------------
# phase 26: flopcheck, the roofline analyzer
# ---------------------------------------------------------------------------

#: (a) real steps timed on CUDA events, after FLOPCHECK_WARMUP
FLOPCHECK_STEPS = 10
FLOPCHECK_WARMUP = 3
#: (a) B1's summed predicted time against its 33 launches priced by the
#: shared formula, relative
FLOPCHECK_REL = 1e-9
#: (b) the SSD engine's buckets, and the bucket program's timed calls
FLOPCHECK_BUCKETS = (8, 32)
FLOPCHECK_FORWARDS = 10
#: (e) the zoo CLI's time limit, seconds
FLOPCHECK_CLI_TIMEOUT = 600


def _b1_shapes(rep):
    """``{(M, K, N): launches}`` of a report's B1 entries."""
    got = {}
    for k in rep.kernels:
        if k.opcode == "matmul_stats":
            ((m, kk), _), ((n, _), _) = k.inputs
            got[(m, kk, n)] = got.get((m, kk, n), 0) + k.multiplier
    return got


def flopcheck_resnet(seed, card, problems):
    """(a): the ResNet-50 bf16 step's four programs priced, then real
    steps timed. Returns B1's launches."""
    import torch
    from mxnet_tpu_torch import flopcheck as fc
    from mxnet_tpu_torch.ops import matmul_stats as ms
    ts, state, batch = _resnet_step(seed)
    bsz, img = RESNET_BATCH, RESNET_IMAGE
    name = "resnet50-nhwc-bf16-b%d" % bsz
    t0 = time.perf_counter()
    findings, reports = fc.check_train_step(
        ts, {"data": (bsz, img, img, 3)}, {"softmax_label": (bsz,)}, k=2,
        guard=True, name=name)
    dt = time.perf_counter() - t0
    for pname, rep in sorted(reports.items()):
        log("flopcheck (a) %s: %d kernels a dispatch, predicted %.4f ms, "
            "MFU %.4f, top hotspot %s [%s]"
            % (pname, rep.kernel_count, rep.predicted_step_ms,
               rep.predicted_mfu, rep.top_hotspot, card))
        for line in rep.breakdown(top=3):
            log("flopcheck (a)   " + line)
    log("flopcheck (a) check_train_step: %d programs in %.2f s, %d findings "
        "(%d unsuppressed) [%s]" % (len(reports), dt, len(findings),
                                    len(fc.unsuppressed(findings)), card))
    for f in findings:
        log("flopcheck (a)   " + f.format().split("\n")[0])
    rep = reports[name + "/step"]
    b1 = [k for k in rep.kernels if k.opcode == "matmul_stats"]
    got = sum(k.total_seconds for k in b1)
    want = sum(count * ms.bound_seconds(m, k, n, "bf16")[0]
               for (m, k, n), count in B1_STEP_SHAPES.items())
    log("flopcheck (a) the step's B1: %d entries, multiplier %d, predicted "
        "%.6f ms against %.6f ms for its %d launches priced by "
        "ops/matmul_stats.bound_seconds (relative %.3g) [%s]"
        % (len(b1), sum(k.multiplier for k in b1), 1e3 * got, 1e3 * want,
           sum(B1_STEP_SHAPES.values()), abs(got - want) / want, card))
    if _b1_shapes(rep) != B1_STEP_SHAPES \
            or abs(got - want) > FLOPCHECK_REL * want:
        problems.append("flopcheck (a): B1 entries %s, predicted %.9g s "
                        "against %.9g" % (_b1_shapes(rep), got, want))
    ms.reset_launches()
    measured = cuda_time_ms(lambda: ts.step(state, batch), FLOPCHECK_STEPS,
                            warmup=FLOPCHECK_WARMUP)
    launches = ms.LAUNCHES
    pred = rep.predicted_step_ms
    log("flopcheck (a) %s: predicted %.4f ms, measured %.4f ms a step (%d "
        "steps on CUDA events after %d warm-ups): predicted/measured %.4f; "
        "predicted MFU %.4f, measured %.4f; B1 %d launches by route %s "
        "[%s]" % (name, pred, measured, FLOPCHECK_STEPS, FLOPCHECK_WARMUP,
                  pred / measured, rep.predicted_mfu,
                  rep.flops_per_dispatch / (1e-3 * measured
                                            * rep.peak_flops_per_s),
                  launches, dict(ms.LAUNCHES_BY_ROUTE), card))
    steps = FLOPCHECK_STEPS + FLOPCHECK_WARMUP
    if pred > measured:
        problems.append("flopcheck (a): predicted %.4f ms above the "
                        "measured %.4f" % (pred, measured))
    if launches != steps * sum(B1_STEP_SHAPES.values()):
        problems.append("flopcheck (a): B1 launched %d times in %d steps"
                        % (launches, steps))
    return launches


def flopcheck_serving(seed, card, problems):
    """(b): the SSD engine's bucket programs priced from tracecheck's
    registry beside each one's measured forward. Returns B2's launches
    (the engine's warm-up and the timed forwards)."""
    import torch
    from mxnet_tpu_torch import flopcheck as fc, tracecheck as tc
    from mxnet_tpu_torch.ops import multibox_nms as mnms
    from mxnet_tpu_torch.serving import ServingEngine
    n0 = mnms.LAUNCHES
    with tempfile.TemporaryDirectory() as tmp:
        prefix = os.path.join(tmp, "ssd")
        ssd_checkpoint(prefix, seed)
        eng = ServingEngine(prefix + "-symbol.json", prefix + "-0000.params",
                            {"data": SSD_INPUT}, buckets=FLOPCHECK_BUCKETS)
    recs = {r.name: r for r in tc.registered_programs()
            if r.name.startswith(eng.name + "/bucket[")}
    params, aux = eng._state
    gen = torch.Generator(device=eng.device)
    gen.manual_seed(seed + 26)
    for b in FLOPCHECK_BUCKETS:
        rec = recs["%s/bucket[b=%d]" % (eng.name, b)]
        t0 = time.perf_counter()
        rep = fc.analyze(rec.fn_ref(), rec.arg_structs, name=rec.name)
        dt = time.perf_counter() - t0
        b2 = [k for k in rep.kernels if k.opcode == "multibox_nms"]
        x = torch.rand((b,) + SSD_INPUT, generator=gen, device=eng.device)
        measured = cuda_time_ms(
            lambda: eng._device_forward(params, aux, {"data": x}),
            FLOPCHECK_FORWARDS)
        pred = rep.predicted_step_ms
        log("flopcheck (b) %s: %d kernels, predicted %.4f ms, measured "
            "%.4f ms a forward (CUDA events): predicted/measured %.4f, "
            "MFU %.4f, top hotspot %s; priced in %.2f s [%s]"
            % (rec.name, rep.kernel_count, pred, measured, pred / measured,
               rep.predicted_mfu, rep.top_hotspot, dt, card))
        for line in rep.breakdown(top=3):
            log("flopcheck (b)   " + line)
        if len(b2) != 1 or b2[0].multiplier != 1:
            problems.append("flopcheck (b) bucket %d: B2 entries %s"
                            % (b, b2))
            continue
        (bb, k), _ = b2[0].inputs[1]
        want = mnms.bound_seconds(bb, k)[0]
        log("flopcheck (b) bucket %d: B2 at B=%d, k=%d priced %.6f ms, "
            "ops/multibox_nms.bound_seconds %.6f ms [%s]"
            % (b, bb, k, 1e3 * b2[0].seconds, 1e3 * want, card))
        if abs(b2[0].seconds - want) > FLOPCHECK_REL * want:
            problems.append("flopcheck (b) bucket %d: B2 priced %.9g s, "
                            "its formula %.9g" % (b, b2[0].seconds, want))
        if b == FLOPCHECK_BUCKETS[-1] and pred > measured:
            problems.append("flopcheck (b) bucket %d: predicted %.4f ms "
                            "above the measured %.4f" % (b, pred, measured))
    launches = mnms.LAUNCHES - n0
    del eng, params, aux
    return launches


def flopcheck_lm(seed, card, problems):
    """(c): phase 17's LM bf16 training step: its hot spots, and its
    predicted against its measured time."""
    import torch
    from mxnet_tpu_torch import autotune, flopcheck as fc
    from mxnet_tpu_torch.tracecheck import train_step_programs
    from mxnet_tpu_torch.train_step import TrainStep
    dev = torch.device(_lm_dev())
    step = TrainStep(lm_symbol(), optimizer="sgd", compute_dtype=LM_DTYPE,
                     device=dev, **LM_OPT)
    shapes = ({"data": (LM_BATCH, LM_SEQ)},
              {"softmax_label": (LM_BATCH, LM_SEQ)})
    (pname, fn, args), = train_step_programs(step, *shapes, k=1,
                                             guard=False, name="lm")[:1]
    hot = autotune.hotspot_report(fn, args, name=pname, top=10)
    rep = fc.analyze(fn, args, name=pname)
    state = step.init(*shapes, seed=seed)
    for n, v in lm_params(seed).items():
        state["params"][n].copy_(torch.from_numpy(v))
    x, y = lm_tokens(seed, LM_BATCH)
    batch = {"data": torch.from_numpy(x).to(dev),
             "softmax_label": torch.from_numpy(y).to(dev)}
    measured = cuda_time_ms(lambda: step.step(state, batch), 10)
    log("flopcheck (c) %s (%s, b=%d, seq %d, %dx%d): %d kernels, predicted "
        "%.4f ms, measured %.4f ms a step (CUDA events): predicted/"
        "measured %.4f, MFU %.4f [%s]"
        % (pname, LM_DTYPE, LM_BATCH, LM_SEQ, LM_LAYERS, LM_EMBED,
           rep.kernel_count, rep.predicted_step_ms, measured,
           rep.predicted_step_ms / measured, rep.predicted_mfu, card))
    log("flopcheck (c) autotune.hotspot_report(top=10), memory-bound:")
    for e in hot:
        log("flopcheck (c)   %5.1f%% %8.2f us x%d %s %s @ %s"
            % (100 * e["step_time_frac"], e["predicted_us"],
               e["multiplier"], e["opcode"], e["op_path"],
               e["provenance"]))
    if not hot:
        problems.append("flopcheck (c): the LM step has no hot spot")


def flopcheck_hook(seed, card, problems):
    """(d): the audit hook on fresh zoo mlp TrainSteps under warn, error
    (MXTPU_FLOPCHECK_TINY_COUNT=1) and off."""
    import torch
    from mxnet_tpu_torch import engine, flopcheck as fc
    from mxnet_tpu_torch.base import MXNetError
    from mxnet_tpu_torch.tracecheck import zoo_train_step
    calls, runs = [], []
    audit, check = fc.maybe_audit_dispatch, fc.check_program

    def timed_audit(name, *a, **kw):
        t = time.perf_counter()
        rep = audit(name, *a, **kw)
        calls.append((name, time.perf_counter() - t, rep is not None))
        return rep

    def counted_check(*a, **kw):
        runs.append(kw.get("name"))
        return check(*a, **kw)

    def mlp():
        ts, data, label = zoo_train_step("mlp", device="cuda:0")
        state = ts.init(data, label, seed=seed)
        gen = torch.Generator(device=ts.device)
        gen.manual_seed(seed + 26)
        batch = {"data": torch.randn(data["data"], generator=gen,
                                     device=ts.device),
                 "softmax_label": torch.randint(
                     0, 4, label["softmax_label"], generator=gen,
                     device=ts.device).float()}
        return ts, state, batch, {k: torch.stack([v, v])
                                  for k, v in batch.items()}

    def dispatch_all(ts, state, batch, sb):
        ts.step(state, batch)
        ts.step(state, batch, guard=True)
        ts.run_steps(state, sb)[1].fetch()
        ts.run_steps(state, sb, guard=True)[1].fetch()

    fc.maybe_audit_dispatch, fc.check_program = timed_audit, counted_check
    try:
        engine.set_flopcheck("warn")
        args = mlp()
        dispatch_all(*args)
        dispatch_all(*args)
        audited = [(n, dt) for n, dt, ran in calls if ran]
        log("flopcheck (d) warn: 8 dispatches over four keys, %d audits: "
            "%s [%s]" % (len(audited), ", ".join("%s %.3f s" % a
                                                 for a in audited), card))
        if len(audited) != 4 or len({n for n, _ in audited}) != 4:
            problems.append("flopcheck (d): warn audited %s" % audited)
        os.environ["MXTPU_FLOPCHECK_TINY_COUNT"] = "1"
        engine.set_flopcheck("error")
        ts, state, batch, _ = mlp()
        try:
            ts.step(state, batch)
            problems.append("flopcheck (d): the first dispatch under error "
                            "did not raise")
        except MXNetError as e:
            log("flopcheck (d) error: the first dispatch raised %s [%s]"
                % (str(e).split("\n")[0], card))
        engine.set_flopcheck("off")
        del runs[:]
        dispatch_all(*mlp())
        log("flopcheck (d) off: %d dry runs over four dispatch keys [%s]"
            % (len(runs), card))
        if runs:
            problems.append("flopcheck (d): off ran %d dry runs" % len(runs))
    finally:
        fc.maybe_audit_dispatch, fc.check_program = audit, check
        engine.set_flopcheck(None)
        os.environ.pop("MXTPU_FLOPCHECK_TINY_COUNT", None)


def flopcheck_cli_start():
    """(e): start the zoo CLI on the card in a child process, which runs
    beside (a)-(d); returns it and its start time."""
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=root)
    return subprocess.Popen(
        [sys.executable, "-m", "mxnet_tpu_torch.flopcheck", "--zoo",
         "--json", "--hotspots", "5", "--device", "cuda:0"], cwd=root,
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True), time.perf_counter()


def flopcheck_cli(started, card, problems):
    """(e): the zoo CLI's exit, programs, findings and seconds."""
    proc, t0 = started
    try:
        out, err = proc.communicate(timeout=FLOPCHECK_CLI_TIMEOUT)
    except subprocess.TimeoutExpired:
        proc.kill()
        out, err = proc.communicate()
    dt = time.perf_counter() - t0
    try:
        data = json.loads(out)
    except ValueError:
        data = None
    if proc.returncode or data is None:
        problems.append("flopcheck (e): the zoo CLI exited %s\n%s%s"
                        % (proc.returncode, out[-2000:], err[-3000:]))
        return
    progs = data["programs"]
    log("flopcheck (e) python -m mxnet_tpu_torch.flopcheck --zoo --json "
        "--hotspots 5 --device cuda:0: exit %d, %d programs, %d findings "
        "(%d suppressed), dry runs %.1f s, %.1f s in all [%s]"
        % (proc.returncode, len(progs), len(data["findings"]),
           data["suppressed"], data["dry_run_seconds"], dt, card))
    for f in data["findings"]:
        log("flopcheck (e)   [%s] %s%s: %s (%s)"
            % (f["lint"], f["program"],
               " [suppressed]" if f["suppressed"] else "",
               f["message"].split("\n")[0][:160], f["provenance"]))
    for pname in sorted(progs):
        if pname.endswith("/step"):
            r = progs[pname]
            log("flopcheck (e)   %s: %d kernels, predicted %.4f ms, MFU "
                "%s, top %s" % (pname, r["kernel_count"],
                                r["predicted_step_ms"], r["predicted_mfu"],
                                r["top_hotspot"]))


def flopcheck_phase(seed, card):
    """Phase 26 (last): flopcheck, the roofline analyzer, on the card.
    Returns ``{"B1": n, "B2": n}``, the kernels' launches in the phase."""
    t_phase = time.perf_counter()
    problems = []
    cli = flopcheck_cli_start()
    b1 = flopcheck_resnet(seed, card, problems)
    b2 = flopcheck_serving(seed, card, problems)
    flopcheck_lm(seed, card, problems)
    flopcheck_hook(seed, card, problems)
    flopcheck_cli(cli, card, problems)
    log("flopcheck phase: B1 %d launches, B2 %d; %.1f s [%s]"
        % (b1, b2, time.perf_counter() - t_phase, card))
    if problems:
        raise SystemExit("\n".join(problems))
    return {"B1": b1, "B2": b2}


# ---------------------------------------------------------------------------
# phase 27: commscheck, the communication analyzer
# ---------------------------------------------------------------------------

#: (a) the f32 gradients of ResNet-50 (1000 classes), one position's: the
#: bytes a rank sent a step through the TCPStore in phase 22
COMMSCHECK_GRAD_BYTES = 102228128
#: (b) the sharded engine's buckets (phase 21's)
COMMSCHECK_BUCKETS = BUCKETS
#: (b) the findings each sharded serving program may carry, by lint, with
#: the reason: the engine gathers each convolution's output slices whole
#: on every position (column-parallel, then a gather), which passes 1 MiB
#: at 300x300; the placement rule splits the LM's 1-D LayerNorm gamma and
#: beta along the model axis and the loop gathers them whole each token
COMMSCHECK_EXPECTED = {"ServingEngine": {"replicated-large"},
                       "DecodeLoop": {"resharding-copy"}}
#: (d) the sharded set's expected findings by tool. commscheck's: the
#: flat-head transformer step gathers its label argument along 'seq'
#: before its Reshape (where GSPMD gathers the Reshape's output), and
#: ``comms-bound`` on any of the four: the gate's programs are tiny (a
#: position computes microseconds at the H100's bf16 peak) while their
#: gradients keep every parameter's bytes. flopcheck's: ``tiny-dispatch``
#: (the eager port launches every op on its own, eight positions' worth on
#: one card: tracecheck.ZOO's reason)
COMMSCHECK_SHARDED_EXPECTED = {
    "commscheck": lambda f: f["lint"] == "comms-bound" or (
        f["lint"], f["program"]) == ("resharding-copy",
                                     "dp4xsp2/transformer-ring/step"),
    "flopcheck": lambda f: f["lint"] == "tiny-dispatch"}
#: (d) the children's time limit, seconds
COMMSCHECK_CLI_TIMEOUT = 600
#: ``parallel.mesh.COUNTERS``' keys as the inventory's kinds
COUNTER_KINDS = {"all_reduce": "all-reduce", "all_gather": "all-gather",
                 "broadcast": "collective-broadcast",
                 "ppermute": "collective-permute",
                 "all_to_all": "all-to-all"}


def _forward_kinds(rep):
    """A CommsReport's forward collectives by kind (the transposes the
    backward runs are not counted in COUNTERS)."""
    out = {}
    for e in rep.entries:
        if not e.transpose:
            out[e.kind] = out.get(e.kind, 0) + e.multiplier
    return out


def _counted():
    from mxnet_tpu_torch.parallel import mesh as pm
    return {COUNTER_KINDS[k]: v for k, v in pm.COUNTERS.items() if v}


def commscheck_resnet(seed, card, problems):
    """(a). Returns B1's launches."""
    import torch
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch import commscheck as cc, models
    from mxnet_tpu_torch.ops import matmul_stats as ms
    from mxnet_tpu_torch.parallel import mesh as pm
    from mxnet_tpu_torch.train_step import TrainStep
    os.environ["MXTPU_FUSE_CONV_BN"] = "1"
    bsz, img = RESNET_BATCH, RESNET_IMAGE
    with mt.symbol.NameManager():
        sym = models.resnet(num_classes=RESNET_CLASSES, num_layers=50,
                            image_shape="3,%d,%d" % (img, img),
                            layout="NHWC")
    mesh = pm.make_mesh({"data": MESH_REPLICAS},
                        [MESH_DEVICE] * MESH_REPLICAS)
    ts = TrainStep(sym, mesh=mesh, optimizer="sgd", learning_rate=0.1,
                   momentum=0.9, wd=1e-4, compute_dtype="bfloat16")
    shapes = ({"data": (bsz, img, img, 3)}, {"softmax_label": (bsz,)})
    name = "dp%d-resnet50-nhwc-bf16-b%d" % (MESH_REPLICAS, bsz)
    t0 = time.perf_counter()
    findings, reports = cc.check_train_step(ts, *shapes, k=1, guard=False,
                                            name=name)
    dt = time.perf_counter() - t0
    rep = reports[name + "/step"]
    log("commscheck (a) %s: %d collectives a dispatch (%s), %d B payload, "
        "%d B on the wire, comm_seconds %.6g, compute_seconds %.6g (%.6g "
        "FLOP a position, peak %.4g FLOP/s, link %.4g B/s), predicted "
        "efficiency %.6f; check_train_step(k=1) %d programs in %.2f s, %d "
        "findings (%d unsuppressed) [%s]"
        % (rep.program, rep.collective_count, rep.counts_by_kind(),
           rep.collective_bytes, rep.wire_bytes, rep.comm_seconds,
           rep.compute_seconds, rep.flops, rep.peak_flops_per_s,
           rep.link_bytes_per_s, rep.predicted_efficiency, len(reports),
           dt, len(findings), len(cc.unsuppressed(findings)), card))
    for line in rep.breakdown(top=4):
        log("commscheck (a)   " + line)
    for f in findings:
        log("commscheck (a)   " + f.format().split("\n")[0])
    if cc.unsuppressed(findings) or rep.hlo_unavailable:
        problems.append("commscheck (a): %d unsuppressed findings, dry run "
                        "failed: %s" % (len(cc.unsuppressed(findings)),
                                        rep.hlo_unavailable))
    grads = [e for e in rep.entries
             if (e.op_path or "").startswith("gradient/")]
    got = sum(e.bytes for e in grads)
    log("commscheck (a) the gradient all-reduces: %d entries (%s), %d B "
        "against phase 22's %d B a rank [%s]"
        % (len(grads), sorted({(e.kind, e.axes, e.group_size)
                               for e in grads}), got, COMMSCHECK_GRAD_BYTES,
           card))
    if got != COMMSCHECK_GRAD_BYTES:
        named = ["%s %d B" % (e.op_path, e.bytes) for e in grads]
        problems.append("commscheck (a): gradient all-reduces %d B, not %d "
                        "(%+d): %s" % (got, COMMSCHECK_GRAD_BYTES,
                                       got - COMMSCHECK_GRAD_BYTES, named))
    state = ts.init(*shapes, seed=seed)
    gen = torch.Generator(device=MESH_DEVICE)
    gen.manual_seed(seed + 27)
    batch = {"data": torch.randn((bsz, img, img, 3), generator=gen,
                                 device=MESH_DEVICE),
             "softmax_label": torch.randint(
                 0, RESNET_CLASSES, (bsz,), generator=gen,
                 device=MESH_DEVICE).float()}
    torch.cuda.synchronize()
    # the main path: counts at 0 just before, read just after
    pm.reset_counters()
    ms.reset_launches()
    ts.step(state, batch)
    torch.cuda.synchronize()
    b1, counted = ms.LAUNCHES, _counted()
    log("commscheck (a) one real dispatch: COUNTERS %s, the inventory's "
        "forward collectives %s; B1 %d launches by route %s [%s]"
        % (counted, _forward_kinds(rep), b1, dict(ms.LAUNCHES_BY_ROUTE),
           card))
    if counted != _forward_kinds(rep):
        problems.append("commscheck (a): COUNTERS %s, inventory %s"
                        % (counted, _forward_kinds(rep)))
    if b1 != MESH_REPLICAS * sum(B1_STEP_SHAPES.values()):
        problems.append("commscheck (a): B1 launched %d times a step" % b1)
    del ts, state, batch
    return b1


def _unexpected(findings, lints):
    """The unsuppressed findings whose lint is not in ``lints``."""
    return [f for f in findings if not f.suppressed and f.lint not in lints]


def commscheck_serving(seed, card, problems):
    """(b). Returns B2's launches (the engine's warm-up and one dispatch a
    bucket)."""
    import torch
    from mxnet_tpu_torch.ops import multibox_nms as mnms
    from mxnet_tpu_torch.serving import Batcher, FleetRouter, ServingEngine
    from mxnet_tpu_torch.parallel import mesh as pm
    n0 = mnms.LAUNCHES
    with tempfile.TemporaryDirectory() as tmp:
        prefix = os.path.join(tmp, "ssd")
        ssd_checkpoint(prefix, seed)
        eng = ServingEngine(prefix + "-symbol.json", prefix + "-0000.params",
                            {"data": SSD_INPUT}, buckets=COMMSCHECK_BUCKETS,
                            device=MP_DEVICE, contexts=MP_POSITIONS)
    t0 = time.perf_counter()
    reps = eng.comms_report()
    dt = time.perf_counter() - t0
    rng = np.random.default_rng(seed + 27)
    for b in COMMSCHECK_BUCKETS:
        rep = reps["%s/bucket[b=%d]" % (eng.name, b)]
        x = {"data": rng.random((b,) + SSD_INPUT, dtype=np.float32)}
        torch.cuda.synchronize()
        pm.reset_counters()
        launched = mnms.LAUNCHES
        eng.infer(x)
        torch.cuda.synchronize()
        counted, b2 = _counted(), mnms.LAUNCHES - launched
        log("commscheck (b) %s: %d collectives (%s), %d B payload, "
            "comm_seconds %.6g, predicted efficiency %.6f; a real dispatch "
            "counted %s, B2 %d [%s]"
            % (rep.program, rep.collective_count, rep.counts_by_kind(),
               rep.collective_bytes, rep.comm_seconds,
               rep.predicted_efficiency, counted, b2, card))
        if counted != _forward_kinds(rep) or b2 != 1 or rep.hlo_unavailable:
            problems.append("commscheck (b) bucket %d: COUNTERS %s, "
                            "inventory %s, B2 %d" % (
                                b, counted, _forward_kinds(rep), b2))
    log("commscheck (b) the engine's comms_report: %d buckets in %.2f s [%s]"
        % (len(reps), dt, card))
    findings = eng.check(comms=True)
    router = FleetRouter({"sharded": Batcher(eng)})
    try:
        fleet = router.check(comms=True)
    finally:
        router.close()
    lm = lm_decode_loop(lm_params(seed), contexts=MP_POSITIONS)
    try:
        lreps = lm.comms_report()
        lfindings = lm.check(comms=True)
    finally:
        lm.close()
    for rep in lreps.values():
        log("commscheck (b) %s: %d collectives a token (%s), %d B payload, "
            "comm_seconds %.6g, predicted efficiency %.6f [%s]"
            % (rep.program, rep.collective_count, rep.counts_by_kind(),
               rep.collective_bytes, rep.comm_seconds,
               rep.predicted_efficiency, card))
    for who, fs in (("ServingEngine", findings), ("FleetRouter", fleet),
                    ("DecodeLoop", lfindings)):
        lints = COMMSCHECK_EXPECTED["DecodeLoop" if who == "DecodeLoop"
                                    else "ServingEngine"]
        by = {}
        for f in fs:
            by.setdefault(f.lint, []).append(f.op_path)
        log("commscheck (b) %s.check(comms=True): %d findings %s; "
            "expected kinds %s [%s]"
            % (who, len(fs), {k: sorted(v) for k, v in by.items()},
               sorted(lints), card))
        bad = _unexpected(fs, lints)
        if bad:
            problems.append("commscheck (b) %s: %s" % (
                who, [f.format().split("\n")[0] for f in bad]))
    launches = mnms.LAUNCHES - n0
    del eng
    return launches


def commscheck_hook(seed, card, problems):
    """(c): the audit hook on a 'data' mesh under warn, error and off."""
    import torch
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch import commscheck as cc, engine
    from mxnet_tpu_torch.base import MXNetError
    from mxnet_tpu_torch.parallel import mesh as pm
    from mxnet_tpu_torch.train_step import TrainStep
    runs = []
    check = cc.check_program

    def counted_check(*a, **kw):
        runs.append(kw.get("name"))
        return check(*a, **kw)

    def step(seeded=False):
        data = mt.sym.Variable("data")
        h = mt.sym.FullyConnected(data, num_hidden=64, name="fc1")
        if seeded:
            s = mt.sym.sum(h, axis=0, keepdims=True, name="batch_sum")
            h = mt.sym.broadcast_add(h, s, name="add_sum")
        h = mt.sym.FullyConnected(h, num_hidden=4, name="fc2")
        ts = TrainStep(mt.sym.SoftmaxOutput(h, name="softmax"),
                       optimizer="sgd", learning_rate=0.1,
                       mesh=pm.make_mesh({"data": MESH_REPLICAS},
                                         [MESH_DEVICE] * MESH_REPLICAS))
        state = ts.init({"data": (32, 16)}, {"softmax_label": (32,)},
                        seed=seed)
        gen = torch.Generator(device=MESH_DEVICE)
        gen.manual_seed(seed + 27)
        sb = {"data": torch.randn((2, 32, 16), generator=gen,
                                  device=MESH_DEVICE),
              "softmax_label": torch.randint(0, 4, (2, 32), generator=gen,
                                             device=MESH_DEVICE).float()}
        return ts, state, sb

    cc.check_program = counted_check
    try:
        engine.set_commscheck("warn")
        ts, state, sb = step()
        t = time.perf_counter()
        ts.run_steps(state, sb)[1].fetch()
        first = time.perf_counter() - t
        audited = list(runs)
        ts.run_steps(state, sb)[1].fetch()
        log("commscheck (c) warn: the first dispatch audited %s (%.3f s "
            "with the dispatch), the second %d more [%s]"
            % (audited, first, len(runs) - len(audited), card))
        if len(audited) != 1 or len(runs) != 1:
            problems.append("commscheck (c): warn ran %s" % runs)
        engine.set_commscheck("error")
        ts, state, sb = step(seeded=True)
        try:
            ts.run_steps(state, sb)
            problems.append("commscheck (c): the first dispatch of the "
                            "seeded gather under error did not raise")
        except MXNetError as e:
            msg = str(e)
            log("commscheck (c) error: the first dispatch raised: %s [%s]"
                % (" | ".join(msg.split("\n")[:3]), card))
            if "[gather-in-loop]" not in msg or "batch_sum" not in msg:
                problems.append("commscheck (c): error raised %r" % msg[:300])
        engine.set_commscheck("off")
        del runs[:]
        ts, state, sb = step()
        ts.run_steps(state, sb)[1].fetch()
        log("commscheck (c) off: %d dry runs [%s]" % (len(runs), card))
        if runs:
            problems.append("commscheck (c): off ran %d dry runs"
                            % len(runs))
    finally:
        cc.check_program = check
        engine.set_commscheck(None)


def commscheck_cli_start():
    """(d): start the commscheck and flopcheck sharded CLIs on the card in
    children, which run beside (a)-(c); returns them and their start
    time."""
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=root)
    return [subprocess.Popen(
        [sys.executable, "-m", "mxnet_tpu_torch.%s" % tool, "--sharded",
         "--device", "cuda:0", "--json"], cwd=root, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for tool in ("commscheck", "flopcheck")], time.perf_counter()


def commscheck_cli(started, card, problems):
    """(d): each sharded program's comm_seconds from both CLIs, and their
    findings."""
    procs, t0 = started
    for tool, proc in zip(("commscheck", "flopcheck"), procs):
        try:
            out, err = proc.communicate(timeout=COMMSCHECK_CLI_TIMEOUT)
        except subprocess.TimeoutExpired:
            proc.kill()
            out, err = proc.communicate()
        dt = time.perf_counter() - t0
        try:
            data = json.loads(out)
        except ValueError:
            problems.append("commscheck (d): %s --sharded exited %s\n%s%s"
                            % (tool, proc.returncode, out[-2000:],
                               err[-3000:]))
            continue
        bad = {(f["lint"], f["program"]) for f in data["findings"]
               if not f["suppressed"]}
        odd = sorted((f["lint"], f["program"]) for f in data["findings"]
                     if not f["suppressed"]
                     and not COMMSCHECK_SHARDED_EXPECTED[tool](f))
        log("commscheck (d) python -m mxnet_tpu_torch.%s --sharded --device "
            "cuda:0 --json: exit %d, %d programs, %d findings (%s), %.1f s "
            "[%s]" % (tool, proc.returncode, len(data["programs"]),
                      len(data["findings"]), sorted(bad), dt, card))
        for pname, r in sorted(data["programs"].items()):
            secs = (data["comm_seconds"][pname] if tool == "commscheck"
                    else r["comm_seconds"])
            log("commscheck (d)   %s: comm_seconds %.6g%s"
                % (pname, secs, (", %d collectives, predicted efficiency %s"
                                 % (r["collective_count"],
                                    r["predicted_efficiency"])
                                 if tool == "commscheck" else
                                 ", predicted step %.4f ms"
                                 % r["predicted_step_ms"])))
            if not secs > 0:
                problems.append("commscheck (d): %s %s comm_seconds %r"
                                % (tool, pname, secs))
        if len(data["programs"]) != 4 or data["baseline_failures"] or odd:
            problems.append("commscheck (d): %s: %d programs, unexpected "
                            "findings %s, failures %s"
                            % (tool, len(data["programs"]), odd,
                               data["baseline_failures"]))


def commscheck_phase(seed, card):
    """Phase 27 (last): commscheck, the communication analyzer, on the
    card. Returns ``{"B1": n, "B2": n}``, the kernels' launches in the
    phase."""
    t_phase = time.perf_counter()
    problems = []
    cli = commscheck_cli_start()
    b1 = commscheck_resnet(seed, card, problems)
    b2 = commscheck_serving(seed, card, problems)
    commscheck_hook(seed, card, problems)
    commscheck_cli(cli, card, problems)
    log("commscheck phase: B1 %d launches, B2 %d; %.1f s [%s]"
        % (b1, b2, time.perf_counter() - t_phase, card))
    if problems:
        raise SystemExit("\n".join(problems))
    return {"B1": b1, "B2": b2}


# ---------------------------------------------------------------------------
# phase 28: ImageRecordIter on the card (nvJPEG and the image_augment kernel)
# ---------------------------------------------------------------------------

#: example/image-classification/train_imagenet.py:99-154 and 171-178:
#: ResNet-50, 1000 classes, 3x224x224, batch 128, ImageRecordIter(resize
#: 256, random crop and mirror, shuffle) with the example's mean and std,
#: SGD lr 0.1 momentum 0.9 wd 1e-4, Xavier(gaussian, in, 2)
IMNET_LAYERS = 50
IMNET_CLASSES = 1000
IMNET_SHAPE = (3, 224, 224)
IMNET_BATCH = 128
IMNET_RESIZE = 256
IMNET_MEAN = (123.68, 116.78, 103.94)
IMNET_STD = (58.395, 57.12, 57.375)
IMNET_OPT = (("learning_rate", 0.1), ("momentum", 0.9), ("wd", 1e-4))
#: phase 15 (c)'s fastest step: bf16 compute, 4 steps a dispatch
IMNET_K = 4
IMNET_WORKERS = 4
#: warm-up and timed epochs of each fit
IMNET_EPOCHS = (1, 2)
#: the records (1024): 896 baseline 4:2:0 at 500x375 or 375x500, 64 at
#: 1024x768 (libjpeg's DCT scale 1/2 at resize 256), 32 progressive, 32
#: grayscale, quality 90
IMNET_IMAGES = 1024
IMNET_QUALITY = 90
#: (c) nvJPEG's pixels against Pillow's decode of the same bytes, by group:
#: (mean |difference| at most, largest |difference| at most, share of
#: values more than 2 levels apart at most). The IDCT and the chroma
#: upsampling differ between the decoders; the denom-2 group compares the
#: kernel's box average of nvJPEG's full-size decode with libjpeg's scaled
#: IDCT. The dev runs' figures (NVIDIA H100 80GB HBM3, 700.00 W; 256
#: images on the hybrid route, 16 at denom 2; the phase_depths run):
#: hybrid mean 1.288, largest 19, share 0.1294; denom 2 mean 0.517,
#: largest 4, share 0.00058. The hardware route's bounds are the hybrid's:
#: its backend did not initialise on that machine (nvjpegCreateEx status
#: 7), so it is not measured.
NVJPEG_BOUNDS = {"hardware": (2.0, 40, 0.25), "hybrid": (2.0, 40, 0.25),
                 "denom2": (1.5, 16, 0.05)}


def _imnet_kind(i):
    """Record ``i``'s kind and size (w, h)."""
    if i % 32 == 0:
        return "progressive", (500, 375)
    if i % 32 == 1:
        return "gray", (375, 500)
    if i % 16 == 2:
        return "large", (1024, 768)
    return "baseline", ((500, 375) if (i // 3) % 2 else (375, 500))


def smooth_field(rng, w, h):
    """A uint8 HWC image: a random field on a 40-pixel grid, bilinearly
    smoothed, with uniform noise of +-17 levels (10 levels' deviation)."""
    from PIL import Image
    coarse = rng.integers(20, 236, (h // 40 + 2, w // 40 + 2, 3),
                          dtype=np.uint8)
    field = np.asarray(Image.fromarray(coarse).resize((w, h),
                                                      Image.BILINEAR),
                       np.int16)
    noise = rng.integers(-17, 18, (h, w, 3), dtype=np.int16)
    return np.clip(field + noise, 0, 255).astype(np.uint8)


def _imnet_image(seed, i):
    """Image ``i`` of the records (:func:`smooth_field`), its label
    ``i % 1000`` and its save options."""
    kind, (w, h) = _imnet_kind(i)
    img = smooth_field(np.random.default_rng([seed, 28, i]), w, h)
    opts = {"subsampling": 2}                     # 4:2:0
    if kind == "progressive":
        opts["progressive"] = True
    if kind == "gray":
        img = img.mean(axis=2).astype(np.uint8)
        opts = {}
    return img, float(i % IMNET_CLASSES), opts


def _imnet_iter(rec, seed, workers, **kw):
    """train_imagenet.py's training iterator, on the card."""
    import mxnet_tpu_torch as mt
    args = dict(path_imgrec=rec, data_shape=IMNET_SHAPE,
                batch_size=IMNET_BATCH, shuffle=True, rand_crop=True,
                rand_mirror=True, resize=IMNET_RESIZE,
                mean_r=IMNET_MEAN[0], mean_g=IMNET_MEAN[1],
                mean_b=IMNET_MEAN[2], std_r=IMNET_STD[0],
                std_g=IMNET_STD[1], std_b=IMNET_STD[2],
                num_workers=workers, seed=seed)
    args.update(kw)
    return mt.image.ImageRecordIter(**args)


def _read_bufs(rec, keys):
    from mxnet_tpu_torch import recordio
    r = recordio.MXIndexedRecordIO(os.path.splitext(rec)[0] + ".idx", rec,
                                   "r")
    try:
        return [recordio.unpack(r.read_idx(k))[1] for k in keys]
    finally:
        r.close()


def _composite(pixels, desc, m, s):
    """What PyTorch's library calls do in the kernel's place, image by
    image: F.interpolate (bilinear) for the resize-short and the second
    resize, the crop, torch.flip and the normalisation."""
    import torch
    import torch.nn.functional as F
    from mxnet_tpu_torch.ops import image_augment as ia
    oh, ow = IMNET_SHAPE[1:]
    out = torch.empty((len(desc), 3, oh, ow), device=pixels.device)
    mt_ = torch.as_tensor(m, device=pixels.device).view(3, 1, 1)
    st = torch.as_tensor(s, device=pixels.device).view(3, 1, 1)
    for i, r in enumerate(desc):
        W, H = int(r[ia.D_W]), int(r[ia.D_H])
        off = int(r[ia.D_OFFSET])
        img = pixels[off:off + 3 * W * H].view(1, H, W, 3).permute(
            0, 3, 1, 2).float()
        img = F.interpolate(img, size=(int(r[ia.D_NH]), int(r[ia.D_NW])),
                            mode="bilinear", align_corners=False)
        x0, y0 = int(r[ia.D_X0]), int(r[ia.D_Y0])
        cw, ch = int(r[ia.D_CW]), int(r[ia.D_CH])
        img = img[:, :, y0:y0 + ch, x0:x0 + cw]
        if (cw, ch) != (ow, oh):
            img = F.interpolate(img, size=(oh, ow), mode="bilinear",
                                align_corners=False)
        if r[ia.D_MIRROR]:
            img = torch.flip(img, dims=(3,))
        out[i] = (img[0] - mt_) * st
    return out


#: (b)'s extra descriptor mix for image_augment, (image sizes (w, h),
#: resize, output (h, w)): the script's own, after the kinds of case in
#: tests/test_torch_image_decode_card.py: libjpeg's 1/8 cap with a 3.1x
#: resize-short shrink (listed windows) and at a small resize, crops
#: smaller than a 227x227 output (the second resize), odd pitches and
#: images one pixel wide or high
D1_EXTRA = (
    (((1200, 1000), (1000, 1300), (170, 130)), 40, (40, 36)),
    (((170, 130),) * 3 + ((48, 40), (33, 95)), 10, (9, 10)),
    (((48, 40), (37, 61), (90, 83), (170, 130), (1, 7), (7, 1)), 0,
     (227, 227)),
    (((48, 40), (37, 61), (90, 83), (170, 130)), 100, (227, 227)),
)


def exact_diff(got, want):
    """max |got - want|: 0.0 only where the two are equal, inf where
    either holds a NaN the other does not (max() skips a NaN)."""
    import torch
    if got.shape == want.shape and torch.equal(got, want):
        return 0.0
    if got.shape != want.shape:
        return float("inf")
    d = (got - want).abs()
    return float("inf") if bool(torch.isnan(d).any()) else float(d.max())


def d1_extra_mix(seed, m, s):
    """image_augment against its plain version on :data:`D1_EXTRA`'s
    descriptors (random pixels from ``seed``, packed after 5 bytes so no
    row starts aligned, the last image flush with the buffer's end):
    ``(max |difference|, images, tiles with listed windows)``, the last
    counted by the kernel."""
    import torch
    from mxnet_tpu_torch.ops import image_augment as ia
    dev = torch.device("cuda", 0)
    worst, images = 0.0, 0
    listed = torch.zeros(1, dtype=torch.int32, device=dev)
    for k, (sizes, resize, (oh, ow)) in enumerate(D1_EXTRA):
        rng = np.random.default_rng([seed, 28, 2, k])
        desc = ia.plan([w for w, _ in sizes], [h for _, h in sizes], resize,
                       (oh, ow), True, True, seed + k)
        host, off = [np.zeros(5, np.uint8)], 0
        for i, (w, h) in enumerate(sizes):
            host.append(rng.integers(0, 256, 3 * w * h, dtype=np.uint8))
            desc[i, ia.D_OFFSET], desc[i, ia.D_PITCH] = off, 3 * w
            off += 3 * w * h
        pixels = torch.from_numpy(np.concatenate(host)).to(dev)[5:]
        d = torch.from_numpy(desc).to(dev)
        got = ia._launch(pixels, d, oh, ow, torch.as_tensor(m),
                         torch.as_tensor(s), listed=listed)
        want = ia.image_augment_reference(pixels, d, oh, ow,
                                          torch.as_tensor(m),
                                          torch.as_tensor(s))
        torch.cuda.synchronize()
        worst = max(worst, exact_diff(got, want))
        images += len(sizes)
    return worst, images, int(listed)


def imnet_kernel(rec, seed, reps, card, problems):
    """(b) the kernel against its plain version on two batches' decoded
    pixels, geometry against the Python draws on Pillow's header sizes;
    times; nvJPEG's decode time by route. (c) nvJPEG against Pillow."""
    import io as _bio
    import torch
    from PIL import Image
    from mxnet_tpu_torch import jpeg_decode
    from mxnet_tpu_torch.image import _pure_batch_seed
    from mxnet_tpu_torch.ops import image_augment as ia
    dev = torch.device("cuda", 0)
    oh, ow = IMNET_SHAPE[1:]
    m, s = ia.normalization(IMNET_MEAN, IMNET_STD, True, True)
    dec = jpeg_decode.acquire(dev)
    worst, geo_diffs, routes_seen = 0.0, 0, {"hardware": 0, "hybrid": 0}
    kept = None
    diffs = {k: [] for k in NVJPEG_BOUNDS}
    try:
        for b in range(2):
            keys = list(range(b * IMNET_BATCH, (b + 1) * IMNET_BATCH))
            bufs = _read_bufs(rec, keys)
            w, h, routes, st = dec.info(bufs)
            if np.count_nonzero(st):
                problems.append("nvJPEG rejected %d headers of batch %d"
                                % (np.count_nonzero(st), b))
                return None
            pil = [Image.open(_bio.BytesIO(x)).size for x in bufs]
            bseed = _pure_batch_seed(seed, 0, b)
            desc = ia.plan(w, h, IMNET_RESIZE, (oh, ow), True, True, bseed)
            want_desc = ia.plan([p[0] for p in pil], [p[1] for p in pil],
                                IMNET_RESIZE, (oh, ow), True, True, bseed)
            geo_diffs += int(np.sum(np.any(desc != want_desc, axis=1)))
            pixels, offs, st = dec.decode(bufs, w, h, routes)
            dec.finish()
            if np.count_nonzero(st):
                problems.append("nvJPEG failed %d images of batch %d"
                                % (np.count_nonzero(st), b))
                return None
            desc[:, ia.D_OFFSET] = offs
            desc[:, ia.D_PITCH] = 3 * w.astype(np.int64)
            d = torch.from_numpy(desc).to(dev)
            got = ia.image_augment(pixels, d, oh, ow, m, s)
            want = ia.image_augment_reference(
                pixels, d, oh, ow, torch.as_tensor(m), torch.as_tensor(s))
            torch.cuda.synchronize()
            worst = max(worst, exact_diff(got, want))
            for k, name in enumerate(jpeg_decode.ROUTES):
                routes_seen[name] += int(np.sum(routes == k))
            # (c): every image of the two batches against Pillow's decode,
            # by route, and the denom-2 ones' box average against libjpeg's
            # scaled decode
            host = pixels.cpu().numpy()
            for i, x in enumerate(bufs):
                W, H = int(w[i]), int(h[i])
                nv = host[offs[i]:offs[i] + 3 * W * H].reshape(H, W, 3)
                ref = np.asarray(Image.open(_bio.BytesIO(x)).convert("RGB"))
                diffs[jpeg_decode.ROUTES[routes[i]]].append(
                    np.abs(nv.astype(np.int16) - ref).ravel())
                if desc[i, ia.D_DENOM] == 2:
                    w1, h1 = int(desc[i, ia.D_W1]), int(desc[i, ia.D_H1])
                    box = ia._box_average(torch.from_numpy(nv), 2, w1,
                                          h1).numpy()
                    im = Image.open(_bio.BytesIO(x))
                    im.draft("RGB", (w1, h1))
                    sc = np.asarray(im.convert("RGB"))
                    if sc.shape != box.shape:
                        problems.append("Pillow's 1/2 decode is %s, the box "
                                        "average %s" % (sc.shape, box.shape))
                        continue
                    diffs["denom2"].append(
                        np.abs(box.astype(np.int16) - sc).ravel())
            if b == 0:
                kept = (pixels, d, desc, bufs, w, h, routes)
        pixels, d, desc, bufs, w, h, routes = kept
        ms = cuda_time_ms(lambda: ia._launch(pixels, d, oh, ow,
                                             torch.as_tensor(m),
                                             torch.as_tensor(s)), reps)
        plain_ms = cuda_time_ms(lambda: ia.image_augment_reference(
            pixels, d, oh, ow, torch.as_tensor(m), torch.as_tensor(s)), 2,
            warmup=1)
        comp_ms = cuda_time_ms(lambda: _composite(pixels, desc, m, s), 3,
                               warmup=1)
        bound_s, bound_by = ia.bound_seconds(desc, oh, ow)
        nbytes = ia.launch_bytes(desc, oh, ow)
        t0 = time.perf_counter()
        extra_worst, extra_images, extra_listed = d1_extra_mix(seed, m, s)
        extra_s = time.perf_counter() - t0

        # nvJPEG's decode time a image by route on batch 0's records (host
        # clock around the call and a wait on the decoder's stream)
        def t_decode(idx, route):
            sub = [bufs[i] for i in idx]
            best = None
            for _ in range(3):
                t0 = time.perf_counter()
                _, _, st = dec.decode(sub, w[idx], h[idx],
                                      np.full(len(idx), route, np.int32))
                dec.finish()
                dt = time.perf_counter() - t0
                best = dt if best is None else min(best, dt)
                if np.count_nonzero(st):
                    problems.append("nvJPEG failed on the %s route" % route)
            return 1e3 * best / max(len(idx), 1)
        hw = np.flatnonzero(routes == 0)
        hy = np.flatnonzero(routes == 1)
        dec_ms = {"hardware": t_decode(hw, 0) if len(hw) else None,
                  "hybrid": t_decode(hy, 1) if len(hy) else None,
                  "hardware_images_through_hybrid":
                      t_decode(hw, 1) if len(hw) else None,
                  "images": {"hardware": int(len(hw)),
                             "hybrid": int(len(hy))}}
    finally:
        jpeg_decode.release(dec)
    hwstat = jpeg_decode.hardware_status()
    log("imagenet (b) image_augment against its plain version on the "
        "decoded pixels of 2 batches of %d (%s by route): max |difference| "
        "%.3g; descriptors from nvJPEG's header sizes against the Python "
        "draws on Pillow's header sizes: %d images differ"
        % (IMNET_BATCH, routes_seen, worst, geo_diffs))
    log("imagenet (b) image_augment at b=%d 3x%dx%d: %.4f ms a launch "
        "(CUDA events, %d launches back to back), plain version %.2f ms, "
        "F.interpolate + flip + normalize image by image %.2f ms; bound "
        "%.4f ms (%s: %d B, the float32 batch written and the source "
        "pixels the taps read, at 3.35 TB/s), %.4f of it reached [%s]"
        % (IMNET_BATCH, oh, ow, ms, reps, plain_ms, comp_ms, 1e3 * bound_s,
           bound_by, nbytes, 1e3 * bound_s / ms, card))
    log("imagenet (b) image_augment against its plain version on the extra "
        "descriptor mix (denom 8 with a 3.1x shrink, denom 8 at resize 10, "
        "crops under a 227x227 output, odd pitches, 1-pixel edges): %d "
        "images, %d tiles with listed windows (the kernel's count), max "
        "|difference| %.3g, %.2f s" % (extra_images, extra_listed, extra_worst, extra_s))
    log("imagenet (b) nvJPEG decode ms a image by route: %s; hardware "
        "backend status %s [%s]" % (json.dumps(dec_ms), hwstat, card))
    stats = {}
    for k, parts in diffs.items():
        if not parts:
            stats[k] = None
            continue
        a = np.concatenate(parts)
        stats[k] = {"images": len(parts), "mean": float(a.mean()),
                    "max": int(a.max()), "over2": float(np.mean(a > 2))}
        lim = NVJPEG_BOUNDS[k]
        if (stats[k]["mean"] > lim[0] or stats[k]["max"] > lim[1]
                or stats[k]["over2"] > lim[2]):
            problems.append("nvJPEG against Pillow (%s): %s past %s"
                            % (k, stats[k], lim))
    log("imagenet (c) nvJPEG against Pillow on the same bytes (mean and "
        "largest |difference|, share of values more than 2 levels apart), "
        "by route, and the denom-2 images' box average against libjpeg's "
        "1/2 decode: %s; bounds %s" % (json.dumps(stats),
                                       json.dumps(NVJPEG_BOUNDS)))
    if worst != 0.0:
        problems.append("image_augment differs from its plain version by "
                        "%g" % worst)
    if extra_worst != 0.0 or not extra_listed:
        problems.append("image_augment on the extra descriptor mix: max "
                        "|difference| %g, %d tiles with listed windows"
                        % (extra_worst, extra_listed))
    if geo_diffs:
        problems.append("%d images' geometry differs from the Python draws "
                        "on Pillow's sizes" % geo_diffs)
    return {"name": "image_augment", "route": "cuda",
            "source": "mxnet_tpu_torch/csrc/image_augment.cu",
            "replaces": "src/io/image_decode.cc:131",
            "replaces_note": "no TPU kernel: ProcessOne, the host C++ "
                             "stage after libjpeg",
            "redesigned": "32x32 output tiles, taps once a tile, windows "
                          "staged in shared memory",
            "max_abs_err": max(worst, extra_worst), "ms": ms,
            "ms_source": "cuda_events",
            "plain_ms": plain_ms, "bound_ms": 1e3 * bound_s,
            "bound_by": bound_by, "bound_share": 1e3 * bound_s / ms,
            "library_ms": None,
            "extra_mix": {"images": extra_images,
                          "listed_tiles": extra_listed,
                          "max_abs_err": extra_worst},
            "composite_ms": comp_ms, "nvjpeg_ms_per_image": dec_ms,
            "nvjpeg_vs_pillow": stats}


def _imnet_fit(mt, sym, it, seed, epochs):
    """Module(compute_dtype="bfloat16").fit over ``it`` at K=IMNET_K with
    the example's optimizer and initializer; returns (epoch end times,
    samples in the last epoch's metric, parameters finite)."""
    import torch
    ends = []
    metric = mt.metric.Accuracy()

    def on_epoch(*_):
        torch.cuda.synchronize()
        ends.append(time.perf_counter())
    mt.random.seed(seed)
    mod = mt.mod.Module(sym, context=mt.gpu(0), compute_dtype="bfloat16")
    torch.cuda.synchronize()
    ends.append(time.perf_counter())
    mod.fit(it, num_epoch=epochs, eval_metric=metric, optimizer="sgd",
            optimizer_params=IMNET_OPT,
            initializer=mt.initializer.Xavier(
                rnd_type="gaussian", factor_type="in", magnitude=2),
            steps_per_dispatch=IMNET_K, epoch_end_callback=on_epoch)
    finite = all(bool(torch.isfinite(v.data).all())
                 for v in mod.get_params()[0].values())
    return ends, metric.num_inst, finite


def imnet_fit(rec, seed, card, problems):
    """(d) decode alone, the fit from the records against a
    device-resident NDArrayIter, PipelineStats, launches by route; (e)
    the first superbatches against a 1-worker pass, set_epoch resume."""
    import torch
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch import data as tdata, jpeg_decode, models
    from mxnet_tpu_torch.ops import image_augment as ia
    warm, timed = IMNET_EPOCHS
    nb = IMNET_IMAGES // IMNET_BATCH
    n = nb * IMNET_BATCH
    sym = models.resnet(num_layers=IMNET_LAYERS, num_classes=IMNET_CLASSES,
                        image_shape=",".join(map(str, IMNET_SHAPE)))

    it = _imnet_iter(rec, seed, IMNET_WORKERS)
    t0 = time.perf_counter()
    nbatch = _drain(it)
    torch.cuda.synchronize()
    alone_ips = nbatch * IMNET_BATCH / (time.perf_counter() - t0)
    it.close()

    landed = []
    real_next = tdata.DevicePrefetcher.next

    def recording(self):
        sb = real_next(self)
        if len(landed) < 2:
            landed.append([a.data.clone() for a in sb.data + sb.label])
        return sb
    it = _imnet_iter(rec, seed, IMNET_WORKERS)
    tdata.DevicePrefetcher.next = recording
    # the main path: counts at 0 just before, read just after
    jpeg_decode.reset_launches()
    ia.reset_launches()
    try:
        ends, count, finite = _imnet_fit(mt, sym, it, seed, warm + timed)
    finally:
        tdata.DevicePrefetcher.next = real_next
    launches = ia.LAUNCHES
    by_route = dict(jpeg_decode.LAUNCHES_BY_ROUTE)
    images = dict(jpeg_decode.IMAGES_BY_ROUTE)
    stats, health = it.data_stats.report(), it.data_health.report()
    it.close()
    real_ips = timed * n / (ends[-1] - ends[warm])

    ref = _imnet_iter(rec, seed, 1)
    want = []
    for _ in range(2):
        parts = [ref.next_host() for _ in range(IMNET_K)]
        want.append([torch.stack([p.data[0] for p in parts]),
                     torch.stack([p.label[0] for p in parts])])
    ref.close()
    same = len(landed) == 2 and all(
        a.device.type == "cuda" and b.device.type == "cuda"
        and torch.equal(a, b)
        for got, exp in zip(landed, want) for a, b in zip(got, exp))

    # set_epoch: a resumed launch positioned on epoch 1 against the
    # uninterrupted run's epoch 1
    full = _imnet_iter(rec, seed, IMNET_WORKERS)
    _drain(full)
    full.reset()
    epoch1 = [full.next_host().data[0].clone() for _ in range(nb)]
    full.close()
    resumed = _imnet_iter(rec, seed, IMNET_WORKERS)
    resumed.next_host()
    resumed.set_epoch(1)
    resume_same = all(torch.equal(resumed.next_host().data[0], e)
                      for e in epoch1)
    resumed.close()
    del epoch1, landed, want

    dev = torch.device("cuda", 0)
    gen = torch.Generator(dev).manual_seed(seed)
    x = torch.randn((n,) + IMNET_SHAPE, generator=gen, device=dev)
    y = torch.randint(0, IMNET_CLASSES, (n,), generator=gen, device=dev)
    synth = mt.io.NDArrayIter(mt.nd.NDArray(x), mt.nd.NDArray(y.float()),
                              batch_size=IMNET_BATCH)
    sends, _, _ = _imnet_fit(mt, sym, synth, seed, warm + timed)
    del x, y, synth
    synth_ips = timed * n / (sends[-1] - sends[warm])
    log("imagenet (d) %d workers decoding one epoch on the card with no "
        "training beside them: %.1f images/s [%s]"
        % (IMNET_WORKERS, alone_ips, card))
    log("imagenet (d) ResNet-50 NCHW bf16 b=%d k=%d, 1000 classes, from %d "
        "JPEG records through ImageRecordIter(num_workers=%d) on the card: "
        "%.1f images/s over %d timed epochs (host clock, each epoch ended "
        "by a synchronize; warm-up epoch %.2f s); over a device-resident "
        "NDArrayIter of the same shapes %.1f images/s; real/synthetic "
        "%.3f; %d samples in the last epoch's metric, parameters finite "
        "%s [%s]" % (IMNET_BATCH, IMNET_K, n, IMNET_WORKERS, real_ips, timed,
                     ends[warm] - ends[0], synth_ips, real_ips / synth_ips,
                     count, finite, card))
    log("imagenet (d) PipelineStats %s; DataHealth %s" % (stats, health))
    log("imagenet (d) the fit's launches: image_augment %d (%d batches), "
        "nvJPEG calls by route %s, images by route %s"
        % (launches, (warm + timed) * nb, by_route, images))
    log("imagenet (e) the first 2 superbatches that reached the card equal "
        "a 1-worker pass bit for bit: %s; set_epoch(1) after a batch of "
        "epoch 0 equals the uninterrupted epoch 1 bit for bit: %s"
        % (same, resume_same))
    if launches != (warm + timed) * nb:
        problems.append("image_augment launched %d times in the fit, not "
                        "%d" % (launches, (warm + timed) * nb))
    if sum(images.values()) != (warm + timed) * n:
        problems.append("nvJPEG decoded %s images in the fit" % images)
    if not same or not resume_same:
        problems.append("card batches differ across worker counts (%s) or "
                        "on resume (%s)" % (same, resume_same))
    if not finite or count != n:
        problems.append("ResNet-50 from JPEG on the card: finite %s, %d "
                        "samples" % (finite, count))
    return {"launches": launches, "launches_by_route": by_route,
            "real_ips": real_ips, "synthetic_ips": synth_ips,
            "decode_alone_ips": alone_ips,
            "stall_frac": stats.get("stall_frac")}


def imnet_threads(rec, card, problems):
    """(e) four threads, each on its own decoder, decode two batches of the
    records again and again beside a busy card (a matmul loop on another
    stream); every decode must equal one thread's decode on an idle card
    bit for bit (nvjpegDecode's state must not be reused while the card
    still reads it: csrc/jpeg_decode.cu)."""
    import torch
    from mxnet_tpu_torch import jpeg_decode
    dev = torch.device("cuda", 0)
    batches = [_read_bufs(rec, range(k * 64, (k + 1) * 64)) for k in (0, 1)]

    def decode(dec, bufs):
        # the images alone: the buffer's alignment gaps are not written
        w, h, r, _ = dec.info(bufs)
        px, offs, st = dec.decode(bufs, w, h, r)
        dec.finish()
        return torch.cat([px[o:o + 3 * int(a) * int(b)]
                          for o, a, b in zip(offs, w, h)]), \
            int(np.count_nonzero(st))
    dec = jpeg_decode.acquire(dev)
    try:
        ref = [decode(dec, b)[0] for b in batches]
    finally:
        jpeg_decode.release(dec)
    stop = threading.Event()

    def load():
        a = torch.randn(8192, 8192, device=dev)
        s = torch.cuda.Stream()
        with torch.cuda.stream(s):
            while not stop.is_set():
                for _ in range(4):
                    a = (a @ a).clamp_(-1, 1)
                s.synchronize()
    bad, lock = [0, 0], threading.Lock()

    def work(t):
        for it in range(4):
            k = (t + it) % 2
            dec = jpeg_decode.acquire(dev)
            try:
                px, failed = decode(dec, batches[k])
            finally:
                jpeg_decode.release(dec)
            with lock:
                bad[0] += int(not torch.equal(px, ref[k]))
                bad[1] += failed
    t0 = time.perf_counter()
    loader = threading.Thread(target=load)
    loader.start()
    workers = [threading.Thread(target=work, args=(t,)) for t in range(4)]
    for w in workers:
        w.start()
    for w in workers:
        w.join()
    stop.set()
    loader.join()
    log("imagenet (e) 4 threads x 4 decodes of a 64-image batch beside a "
        "busy card: %d of 16 differ from one thread's decode, %d images "
        "failed (%.1f s) [%s]" % (bad[0], bad[1], time.perf_counter() - t0,
                                  card))
    if bad != [0, 0]:
        problems.append("concurrent decodes beside a busy card differ (%d) "
                        "or fail (%d)" % tuple(bad))


def imnet_faults(rec, seed, tmp, problems):
    """(f) a truncated record raises the corrupt-image error on the card
    route; the io.record_read retry drill counts as on the host route."""
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch import faults, recordio
    bufs = _read_bufs(rec, range(8))
    bad = os.path.join(tmp, "corrupt.rec")
    w = recordio.MXIndexedRecordIO(os.path.join(tmp, "corrupt.idx"), bad,
                                   "w")
    for i, x in enumerate(bufs):
        w.write_idx(i, recordio.pack(recordio.IRHeader(0, 0.0, i, 0),
                                     x[:100] if i == 3 else x))
    w.close()
    err = None
    it = _imnet_iter(bad, seed, 0, batch_size=8, shuffle=False)
    try:
        it.next()
    except mt.MXNetError as e:
        err = str(e)
    it.close()
    log("imagenet (f) a record cut to its first 100 bytes (inside the "
        "header): next() raised %r" % err)
    if err is None or "1 corrupt image(s) in batch" not in err:
        problems.append("the truncated record raised %r" % err)

    def first(nw):
        it = _imnet_iter(rec, seed, nw, data_shape=(3, 64, 64),
                         batch_size=16, resize=72)
        try:
            return [it.next_host().data[0].cpu().numpy() for _ in range(4)]
        finally:
            it.close()
    clean = first(2)
    mt.io.DATA_HEALTH.reset()
    faults.clear()
    faults.inject("io.record_read", nth=3, kind="transient", times=2)
    got = first(2)
    faults.clear()
    retries = mt.io.DATA_HEALTH.report()["retries"]
    same = all(np.array_equal(a, b) for a, b in zip(got, clean))
    log("imagenet (f) drill io.record_read@3=transient*2 on the card route: "
        "DATA_HEALTH.retries %d, the 4 batches equal the clean pass's %s"
        % (retries, same))
    if retries != 2 or not same:
        problems.append("card io.record_read drill: retries %d, same %s"
                        % (retries, same))


def imagenet_phase(seed, reps, card):
    """Phase 28 (see the module docstring): the image_augment kernel's
    line for the kernels JSON."""
    import tempfile as _tempfile
    from mxnet_tpu_torch import native_build
    t_phase = time.perf_counter()
    problems = []
    p = native_build.probe()
    log("imagenet: nvjpeg.h %s; libnvjpeg %s" % (p["nvjpeg_h"],
                                                 p["libnvjpeg"]))
    with _tempfile.TemporaryDirectory() as tmp:
        rec = os.path.join(tmp, "imagenet.rec")
        t0 = time.perf_counter()
        nbytes = write_records(rec, IMNET_IMAGES,
                               lambda i: _imnet_image(seed, i),
                               IMNET_QUALITY)
        kinds = {}
        for i in range(IMNET_IMAGES):
            kinds[_imnet_kind(i)[0]] = kinds.get(_imnet_kind(i)[0], 0) + 1
        log("imagenet (a) records: %d JPEGs %s (quality %d, labels i %% "
            "1000), %.1f MB, written in %.2f s"
            % (IMNET_IMAGES, kinds, IMNET_QUALITY, nbytes / 1e6,
               time.perf_counter() - t0))
        parts = {"(a)": time.perf_counter() - t0}
        t0 = time.perf_counter()
        line = imnet_kernel(rec, seed, reps, card, problems)
        parts["(b)+(c)"] = time.perf_counter() - t0
        if line is not None:
            t0 = time.perf_counter()
            fit = imnet_fit(rec, seed, card, problems)
            parts["(d)+(e)"] = time.perf_counter() - t0
            line.update(launches=fit["launches"],
                        nvjpeg_launches_by_route=fit["launches_by_route"],
                        real_ips=fit["real_ips"],
                        synthetic_ips=fit["synthetic_ips"],
                        decode_alone_ips=fit["decode_alone_ips"],
                        stall_frac=fit["stall_frac"])
            t0 = time.perf_counter()
            imnet_threads(rec, card, problems)
            imnet_faults(rec, seed, tmp, problems)
            parts["(e) threads, (f)"] = time.perf_counter() - t0
    log("imagenet: the phase took %.1f s (%s)" % (
        time.perf_counter() - t_phase,
        ", ".join("%s %.1f" % kv for kv in parts.items())))
    if problems:
        raise SystemExit("imagenet phase failed: " + "; ".join(problems))
    return line


def _nodes(sym):
    from mxnet_tpu_torch.symbol import _topo
    return _topo(sym._out_nodes())


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reps", type=int, default=20,
                    help="timed repetitions per measurement")
    ap.add_argument("--lstm-profile-child", metavar="DIR",
                    help=argparse.SUPPRESS)
    ap.add_argument("--dist-sync-child", metavar="DIR",
                    help=argparse.SUPPRESS)
    ap.add_argument("--dist-async-child", metavar="DIR",
                    help=argparse.SUPPRESS)
    args = ap.parse_args()
    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import mxnet_tpu_torch  # noqa: F401  (fails outside a checkout)
    if args.lstm_profile_child:
        # phase 16 (e) runs this in a fresh process
        return lstm_profile_child(args.lstm_profile_child, args.seed)
    if args.dist_sync_child:
        # phase 22 (a) runs this once a rank, through the port's launcher
        return dist_sync_child(args.dist_sync_child, args.seed)
    if args.dist_async_child:
        return dist_async_child(args.dist_async_child, args.seed)
    from mxnet_tpu_torch import cuda_build
    from mxnet_tpu_torch.ops import nn as _nn

    card = gpu_name_and_power()
    log("device: %s | torch %s, CUDA %s" % (card, torch.__version__,
                                           torch.version.cuda))
    log("float32 convolutions: ServingEngine and TrainStep run them with "
        "TF32 %s (PyTorch's default cudnn.allow_tf32 here is %s)"
        % ("on" if _nn.CONV_TF32 else "off",
           torch.backends.cudnn.allow_tf32))

    t0 = time.perf_counter()
    cuda_build.build(["multibox_nms", "matmul_stats", "rtc_launch",
                      "image_augment", "jpeg_decode"])
    log("build: %.2f s" % (time.perf_counter() - t0))
    for name, text in cuda_build.BUILD_LOG.items():
        for line in text.splitlines():
            log("  nvcc %s: %s" % (name, line))

    seconds = {}

    def timed(fn, *a):
        """``fn(*a)``, its seconds kept under its name."""
        t = time.perf_counter()
        out = fn(*a)
        seconds[fn.__name__] = round(time.perf_counter() - t, 1)
        return out

    rng = np.random.default_rng(args.seed)
    nms = timed(kernel_phase, rng, max(20, 10 * args.reps), card)
    b1 = timed(b1_phase, args.seed, args.reps, card)
    serve_launches = timed(serve_phase, args.seed, args.reps, card)
    b1["launches"], step_profiles = timed(train_phase, args.seed, card)
    ssd_profile = timed(ssd_train_profile, args.seed, card)
    lm_prof = timed(lm_profile, args.seed, card)
    rtc_err, rtc_host = timed(rtc_phase, args.seed, args.reps, card)
    launches, upd_err, upd, event, bound = timed(bind_phase, args.seed, 3,
                                                 card)
    upd_source = "cuda_events" if upd is event else "profiler"
    timed(imperative_phase, args.seed, card)
    b1_f32 = timed(module_phase, args.seed, card)
    timed(resnet_serve_phase, args.seed, args.reps, card)
    with tempfile.TemporaryDirectory() as tmp:
        ssd_train = timed(ssd_train_phase, args.seed, card, ssd_profile,
                          os.path.join(tmp, "ssd_fit"))
        tier_launches = timed(serving_tier_phase, args.seed, card,
                              ssd_train["checkpoint"])
    api_launches = timed(training_api_phase, args.seed, card, step_profiles)
    data = timed(data_phase, args.seed, card)
    timed(rnn_phase, args.seed, card)
    lm_trained = timed(lm_phase, args.seed, card, lm_prof)
    mesh_launches = timed(mesh_phase, args.seed, card)
    timed(axes_phase, args.seed, card)
    mp_launches = timed(mp_phase, args.seed, card, lm_trained)
    op_rows, examples = timed(slice_phase, args.seed, args.reps, card)
    dist_launches = timed(dist_phase, args.seed, card)
    capi_run = timed(capi_phase, args.seed, card)
    capi = capi_run["launches"]
    mem = timed(memcheck_phase, args.seed, card)
    tc25 = timed(tracecheck_phase, args.seed, card)
    fc26 = timed(flopcheck_phase, args.seed, card)
    cc27 = timed(commscheck_phase, args.seed, card)
    d1 = timed(imagenet_phase, args.seed, args.reps, card)
    log("seconds by phase (%.1f s in all from the build) %s [%s]"
        % (time.perf_counter() - t0, json.dumps(seconds), card))
    # B1 runs on three main paths: the train phase, the training API and
    # the bf16 mesh; its float32 route on the module phase and the f32 mesh
    b1.update(launches=(b1["launches"] + api_launches + mesh_launches["wgmma"]
                        + dist_launches + mem["B1"] + tc25["B1"]
                        + fc26["B1"] + cc27["B1"]),
              launches_train=b1["launches"],
              launches_training_api=api_launches,
              launches_mesh=mesh_launches["wgmma"],
              launches_dist=dist_launches,
              launches_memcheck=mem["B1"],
              launches_tracecheck=tc25["B1"],
              launches_flopcheck=fc26["B1"],
              launches_commscheck=cc27["B1"])
    b1["launches_capi"] = 0
    b1_f32.update(launches=(b1_f32["launches"] + mesh_launches["tf32x3"]
                            + capi["B1"]),
                  launches_module=b1_f32["launches"],
                  launches_mesh=mesh_launches["tf32x3"],
                  launches_capi=capi["B1"], launches_memcheck=0,
                  launches_tracecheck=0, launches_flopcheck=0,
                  launches_commscheck=0,
                  max_abs_err=max(b1_f32["max_abs_err"],
                                  capi_run["b1_err"]))
    # B2 runs on six main paths: serving (phase 5), training (phase 12),
    # the serving tier (phase 13), training from JPEG records (phase 15),
    # model-parallel serving (phase 21) and the C ABI (phase 23); B1's
    # float32 route and B3's Rtc run through the C ABI too
    nms.update(launches=(serve_launches + ssd_train["launches"]
                         + tier_launches + data["launches"] + mp_launches
                         + capi["B2"] + mem["B2"] + tc25["B2"]
                         + fc26["B2"] + cc27["B2"]),
               launches_capi=capi["B2"],
               launches_memcheck=mem["B2"],
               launches_tracecheck=tc25["B2"],
               launches_flopcheck=fc26["B2"],
               launches_commscheck=cc27["B2"],
               max_abs_err=max(nms["max_abs_err"], capi_run["b2_err"]),
               launches_serve=serve_launches,
               launches_train=ssd_train["launches"],
               launches_serving_tier=tier_launches,
               launches_data=data["launches"],
               launches_model_parallel=mp_launches,
               train_ms=ssd_train["in_step_ms"],
               train_ms_source="profiler")
    b3 = []
    for route, wrapper, call in (("cuda", "Rtc", "Rtc.push"),
                                 ("triton", "TritonKernel",
                                  "TritonKernel.__call__")):
        b3.append({"name": "rtc_%s" % route, "route": route,
                   "source": "mxnet_tpu_torch/rtc.py",
                   "replaces": "mxnet_tpu/rtc.py:83",
                   "launches": launches[route] + (
                       capi["B3"] if route == "cuda" else 0),
                   "launches_capi": capi["B3"] if route == "cuda" else 0,
                   "launches_memcheck": 0, "launches_tracecheck": 0,
                   "launches_flopcheck": 0, "launches_commscheck": 0,
                   "max_abs_err": max(rtc_err[route], upd_err[route],
                                      capi_run["b3_err"] if route == "cuda"
                                      else 0.0),
                   "ms": upd[wrapper], "ms_source": upd_source,
                   "plain_ms": upd["plain nd.sgd_mom_update"],
                   "bound_ms": bound, "bound_by": "bytes",
                   "library_ms": upd.get("torch._fused_sgd_"),
                   "event_ms": event[wrapper], "host_us": rtc_host[call]})
    b3[0]["graph_ms"] = event["Rtc captured, graph.replay()"]

    log(card)
    log(json.dumps({"ops": op_rows, "examples": examples}))
    log(json.dumps({"kernels": [nms, b1, b1_f32] + b3 + [d1]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
