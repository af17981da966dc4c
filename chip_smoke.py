#!/usr/bin/env python3
"""Chip smoke of the PyTorch/CUDA port (``znicz_tpu_torch``): the
quickest proof that the port builds, serves and trains on an NVIDIA GPU.

    python3 chip_smoke.py          # from the root of a checkout; one GPU

Phases, each printing one JSON line (any failure raises and the script
exits non-zero without the final ``ok`` line):

0. **build** — every kernel source under ``znicz_tpu_torch/csrc`` built
   by ``nvcc``, one process each, all started together.
1. **kernel** — the serving path's paged-decode kernels (the split
   kernel and its combine) against their plain PyTorch version on the
   card at the path's shapes, in all four instantiations (bf16 and f32,
   head dim 64 and 128), at the serving mix of lengths, lengths on and
   beside split boundaries and every slot at length 1, bit-identical
   across launches, the band rejecting a control (one split of the
   longest slot read from the wrong pages); each instantiation, the
   plain version and one PyTorch library call timed with the split
   count; the bound computed from this run's inputs.
1b. **flash** — the same for the flash-attention forward and backward
   kernels (norm-relative error of each 64-row tile, bf16 and f32, head
   dim 64 and 128, causal and not, t 2048, 1984, 1000 and 17 and the
   training shape), bit-identical across two launches; each band must
   reject a control run that reads one K/V tile as zeros.  At the
   training shape each kernel's achieved TFLOP/s beside SDPA's, the
   backward's two kernels timed apart (``torch.profiler``) and each
   wrapper's host µs a call; the same times at head dim 128.
1c. **gemm** — the FC kernels (``gemm_fc``, ``act_backward``) against
   their plain versions in f32 with TF32 off: bench_fc's two forward and
   four backward products, AlexNet's six FC products at batch 128, two
   ragged shapes in every operand layout, every fused activation; the
   band must reject a control with one slice of K zeroed (the middle
   split-K slice where the plan splits, else the last k tile); split
   launches bit-identical; the tile and split-K plan from gemm.cu (the
   card's occupancy) held against kernels/gemm.py gemm_plan; the twelve
   products timed at full width, each with its tile and slices, and the
   headline in all four operand layouts; registers and resident blocks
   of every instantiation; ``act_backward`` with and without the bias
   gradient at every activation, on and off its vector path: err_v
   against its plain twin, grad_b against the twin's sums in the
   kernel's order (a band rejecting a control with the last row
   dropped), both bit-identical across launches; at AlexNet's
   strict-ReLU shapes (fc7 and fc6 at batch 128) its one launch timed
   beside a torch column sum of err_v alone, ``aten.threshold_backward``
   with and without a column sum (the library's pair) and an empty
   kernel launched over the same grid and clusters from the same library
   (the launch floor); one ``fc_backward`` profiled: act_backward first
   and once, then only the GEMM's kernels.  The parent's two-launch
   pair is timed by ``act_compare`` on the parent's tree.
1d. **optim** — the SGD (f32 and bf16 velocity) and AdamW update kernels
   against their plain versions on bench_fc's six leaves, each band
   rejecting a control with bs = 1; one six-leaf step timed against the
   plain version and torch.optim's fused optimizers.
2. **train** — bench.py bench_transformer's step at full width (6
   layers, d 512, 8 heads, ff 2048, vocab 32000; batch 8, t 2048, 16 CE
   chunks, bf16 over f32 masters) from a seed through
   ``make_train_step``, each step a CUDA graph replay after the first
   (eager) and the second (captured): two warm and 12 timed steps with
   the flash launch counters set to 0 just before and read just after;
   the loss must be finite and fall.  Then two profiled steps and the
   host's time to issue one, and the same for the step's eager body
   (``step.eager``, on a copy of the params) beside them.
3. **train_parity** — 3 steps at 2 layers, batch 2, t 256: the card in
   f32 against the CPU, bf16 against f32; the f32 loss band must reject
   the same steps with TF32 on.
4. **serve** — the trained weights exported once through ``export_lm``
   and that package served in-process (8 slots, max_len 2048, page 16,
   bf16): 12 concurrent greedy requests through HTTP, the launch counter
   set to 0 just before and read just after.
4b. **speculative** — the same package served with ``--speculative
   --spec-k 4 --draft-layers 1``: (a) the 12 requests again, each stream
   held token for token against serve's (a mismatch passes only as a
   bf16 tie, re-decoded), paged_decode launches exactly k + 1 draft
   steps and a 6-layer verify a speculative round and 6 a plain one,
   both page ledgers closed, ``/meta`` speculative; (b) the batcher
   with and without the draft in f32 (TF32 off) and a control with the
   verify frontier one row later that the identity gate must reject;
   (c) one verify of 5 rows against 5 decode steps on identical arenas
   in bf16 and f32, within the parity bands, its control outside them,
   and the verify's kernel call at B·Q 40 timed beside the step's at B
   8.
5. **profile** — a steady decode step with all 8 slots live, timed
   without and with ``torch.profiler`` (busy time, the kernel's share,
   the idle share).
6. **parity** — teacher-forced decode through the paged decoder (kernel
   attention) and the contiguous decoder (plain attention), f32 and bf16.
7. **handoff** — the package's weights in a paged decoder in f32, each
   step's logits held against ``make_logits_fn``.
7b. **char_lm** — ``models/char_lm.py`` at bench_transformer's block
   widths over the synthesized corpus (vocab 14, seq_len 2048, batch 8):
   (a) two epochs through ``run(load, main)`` as the CLI drives it
   (``-o root.char_lm.*``, ``lm_export``), every train and eval
   minibatch but the first of each a CUDA graph replay, the flash
   counters exact, the train loss falling, the second epoch's ms and
   idle share; (b) the graphed step bit-identical to its eager body
   over 4 steps, both timed and profiled, the flash kernels a replay
   runs matching the counters; (c) each remat policy's losses against
   no remat, with peak memory; (d) the MoE step (4 experts, top-2, aux
   and z-loss) timed at full width, and at 2 layers, d 64 card (f32)
   against the CPU with a TF32 control; (e) the exported package served
   by ``generate --serve`` in f32, each greedy stream equal to
   ``make_logits_fn``'s argmax, paged_decode launched.
8. **mnist_eager** — ``models/mnist_fc.py build_eager`` at bench_fc's
   widths (784-4096-4096-10, batch 1024) through ``Workflow.run`` on
   ``TorchDevice()``, the FC kernels' counters set to 0 just before and
   read just after; ms per train minibatch.
9. **mnist_fused** — bench_fc's configuration through ``build_fused``,
   every step a CUDA graph replay but each body's first:
   ``train_steps`` calls of K minibatches (one warm, timed ones, one
   profiled), 3 epochs through ``Workflow.run`` profiled after their
   first minibatches, then AdamW; the update kernels' counters set to 0
   just before and read just after (exact through replays), each
   graph's replays counted, and in a profiled window of replays the SGD
   and AdamW kernels the card ran equal to what the counters added
   (``replayed_launches``); step ms, host issue µs, samples/s, MFU, peak
   memory, busy ms and idle share on both paths.
10. **mnist_parity** — the MNIST FC sample at its defaults in f32, the
   card against the CPU, eager and fused; the fused loss band must reject
   the same run with TF32 on.
11. **conv** — the conv kernels (``conv2d_fwd``, ``conv2d_input_grad``,
   ``conv2d_weight_grad``) against their plain versions in f32 with TF32
   off, as the norm-relative error of each 64-row tile: the reference's
   four geometries and AlexNet's five layers at batch 128 (conv1's
   stride-4 input gradient included), bit-identical across launches,
   each band rejecting its control (a skipped k tile, a dropped tap, a
   dropped split-K slice); each kernel, its plain version and cuDNN
   (channels_last, TF32 off) timed at the five layers, each weight
   gradient with its tile, slices, blocks and resident blocks an SM and
   cuDNN's kernels by name, each f32 forward with its tile and cuDNN's
   kernels; the weight gradient's schedule and the f32 forward's tile
   from conv.cu (the card's occupancy) held against kernels/conv.py's
   twins, with every forward instantiation's registers and resident
   blocks.  Then the bf16
   forward (bf16 operands, f32 sums, one rounding) the same way at the
   reference sweep's shape and the five layers, within one bf16 ulp on
   the tile norm, its control rejected, timed beside cuDNN in bf16.
12. **alexnet_eager** — ``models/alexnet.py build(fused=False)`` at its
   defaults (227 px, batch 128, 1000 classes, dropout 0.5) on
   ``TorchDevice()`` for 2 epochs of 3 train + 1 validation minibatches,
   the conv and FC counters set to 0 just before and read just after;
   ms per train minibatch, samples/s, peak memory, and one train
   minibatch profiled (the conv and FC kernels' device ms, the idle
   share).
13. **alexnet_parity** — AlexNet's geometry at test size in f32, the card
   against the CPU with the same dropout masks: identical n_err
   histories, weights within a band the same run with TF32 on must fail.
13a. **deconv** — ``deconv2d`` and ``deconv2d_backward`` against their
   plain versions in f32 at ``models/autoencoder.py build_deep``'s two
   deconv layers (batch 64: (64,16,16,128) -> (64,32,32,64) and
   (64,32,32,64) -> (64,64,64,3)), bit-identical across launches, each
   band rejecting its control; timed beside ``F.conv_transpose2d`` and
   the transposed conv's ``aten.convolution_backward`` (TF32 off).
13b. **ae_eager** — ``build_deep(fused=False)`` at its defaults (64x64x3,
   n_kernels (64, 128), batch 64, 256 samples) for 2 epochs on
   ``TorchDevice()``, the conv and deconv counters set to 0 just before
   and read just after (exact counts a minibatch); ms per train
   minibatch, samples/s, peak memory; a second run from the same seed,
   profiled (idle share), must end bit-identical.
13c. **ae_parity** — ``build`` and a shrunk ``build_deep`` eager, and
   ``build`` fused, in f32, the card against the CPU; the fused band must
   reject TF32, and the eager path must not move under it.
13d. **ae_fused** — bench_deconv_ae's configuration (``build_deep``
   fused, batch 64, K = 64 staged batches, bf16 over f32 masters) through
   ``train_steps`` and 3 epochs of ``Workflow.run``, graph replays and
   the profiled SGD launches as in mnist_fused: samples/s, MFU, peak
   memory, busy ms and idle share.  It runs cuDNN under autograd and
   the SGD update kernel, not the hand-written conv kernels (as the
   reference's fused step runs XLA's convs).
14. **stochastic_pool** — the stochastic-pool kernel against its plain
   version bit for bit through ``bits=`` (y, taps, offsets; MNIST conv's
   and AlexNet's pool shapes, odd sizes with clipped borders, windows of
   zero mass, both variants) and through ``seed=``; the winners'
   frequencies over one window repeated 16 M times within a chi-square
   band that a run with 16-bit uniforms must fail; the kernel, the plain
   version and the bound at MNIST conv's two pools and AlexNet's pool1.
15. **mnist_conv_stochastic** — ``models/mnist_conv.py``'s layers with
   both pools stochastic, eager on ``TorchDevice()`` (batch 100, 2000
   train and 500 validation samples, 2 epochs), the stochastic-pool,
   conv and FC counters set to 0 just before and read just after:
   exactly 2 stochastic-pool launches a minibatch; ms per train
   minibatch; then the card against the CPU at test size with the same
   bits (a TF32 control).
16. **kohonen** — ``som_step`` against its plain version at
   bench_kohonen's and the reference sweep's shapes (a bs - 1 control)
   and on integer data past them (ten chunks; three chunks with h a
   chunk at a time; 3 and 7 neurons; W off shared memory): identical
   winners, bits identical across launches, the card's plan equal to
   ``som_plan`` over a sweep, at least one cluster resident; timed with a spin kernel ahead, the profiler's
   kernel time by name, exactly one kernel a step; bench_kohonen's run
   (scan mode, 3 epochs after a warm one, exact launches); the demo's
   defaults per minibatch until the decision stops it; the card against
   the CPU on the demo (identical winners).
17. **lrn_dropout** — the LRN kernels against their plain versions at
   AlexNet's two norm layers (a cut-window control), both directions
   bit-identical there on the quad path and on the element path (c 5, an
   unaligned x), each direction's plan equal to ``lrn_plan`` over a
   sweep, each layer timed against its bound and the forward against
   ``F.local_response_norm``; the dropout kernel against its plain
   version at one seed bit for bit in f32 and bf16 (fc6's input and 64 M
   elements on the vector path, and the element path), its plan against
   ``dropout_plan``, its drop rate on 64 M elements, the kernel timed
   beside ``aten.native_dropout`` and its byte bound.
17a. **alexnet_fused** — ``models/alexnet.py build()`` at its defaults
   (fused, 227 px, batch 128, 1000 classes, dropout 0.5, bf16 over f32
   masters, the data set pinned on the card) through ``train_steps`` (K
   staged batches; one warm call, timed ones by CUDA events, one
   profiled), every step a graph replay but each body's first, the LRN
   and SGD counters set to 0 just before and read just after (exactly 2
   LRN forwards and 2 backwards and one update a leaf a step, replays
   included, and the SGD and both LRN kernels the card ran in a profiled
   window of replays equal to what the counters added); step ms,
   samples/s, MFU, peak memory, idle share; then 3 epochs through
   ``Workflow.run`` profiled in the last, the counts and each graph's
   replays again exact.
17b. **graph_parity** — the graphed fused step against its unrolled
   body (``_train_step``) on a twin from the same seed, 8 steps, every
   learning rate halved before the fifth: bit-identical metrics and
   params (weights, velocities, moments, step counts) for MNIST FC at
   bench_fc's widths with bf16 velocity, with AdamW, the 67-px AlexNet
   with dropout 0.5 and MNIST conv with both pools stochastic (the
   step's generator drawn in replays; cuDNN deterministic on both for
   the conv nets); then ``accumulate_steps``,
   ``ema_decay`` and ``scan_epoch`` once each on the card against the
   CPU in f32.
17c. **fused_conv_parity** — the fused conv shape in f32, the card
   against the CPU for the test-size AlexNet (dropout 0) and MNIST conv
   with stochastic pools (the same numpy uniforms on both sides, through
   a device tensor a wrapper refills before each train minibatch, so the
   card's steps are graph replays, counted): the same n_err, weights
   within a band that the same runs with TF32 on must fail; MNIST conv
   and CIFAR conv fused at their own widths (batch 100) for an epoch
   each; the fused max-pool backward at AlexNet's pool1 bit-identical
   across two runs (f32 and bf16) and equal to the CPU's in f32.
17d. **input_pipeline** — the input layer: host-fed AlexNet
   (``alexnet.layers()`` through ``StandardWorkflow(fused=True)``, 227
   px, batch 128, ``dataset_on_device_max_bytes`` 0: 79.1 MB a minibatch
   from the host) synchronously and at pipeline depth 2, index-fed
   MNIST FC at bench_fc's widths and CIFAR conv on its own pickle files,
   each sync against depth 2 (ms a minibatch, the profiled epoch's busy
   ms and idle share, the stall table, the HtoD copies by stream), and
   ``native.gather_rows`` against numpy at AlexNet's minibatch; gates:
   histories and weights bit-identical to the sync runs, depth + 2
   pinned ring slots serving every batch, the staged copies on a stream
   the step does not run on, the same graphs and replays (no capture in
   the steady state), the worker dead after run and stop, the gather
   bit-identical.
17e. **image_files** — the image-file loaders (``loader/image.py``,
   decoding with PIL as the reference does): (a) ``alexnet.build()`` at
   full width (227-px crops of 256-px decodes with mirrors, 1000
   classes, batch 128, dropout 0.5), fused, ``file_image`` with
   ``augment`` over a synthesized tree of 256 128-px PNGs (each decode
   resizes to 256 px), one class pass of 2 train minibatches
   synchronously and at pipeline depth 2, each profiled (ms a minibatch, busy ms, idle share, the loader's serve
   ms), with the decode ms an image (``_decode`` through PIL) and the
   synthesis seconds; gates: histories and weights bit-identical, the
   first served minibatch of both routes byte-equal to a CPU loader's
   of the same seed, exact LRN and SGD launches and graph replays; (b)
   ``image_ae.build()`` at its defaults eager (exact conv2d_fwd,
   input-gradient, weight-gradient, deconv2d and deconv2d_backward
   launches) and fused, (c) ``yale_faces.build()`` at its defaults
   fused (exact SGD launches) and eager (exact gemm_fc and act_backward
   launches), 2 epochs each, every run on the card in
   f32 against the CPU: the image AE's MSE within rtol 1e-5 and weights
   within 4e-6, Yale's n_err equal and weights within 2e-6.
17f. **snapshot_resume** — snapshots, the workflow CLI and the
   supervisor: ``python -m znicz_tpu_torch wf.py`` trains
   ``alexnet.build()`` at full width (227 px, batch 128, 1000 classes,
   dropout 0.5; 256 samples, no validation) to epoch 1 with the
   snapshotter on, a second process resumes that snapshot with ``-w`` to
   epoch 2, and its history, a digest of every param and momentum leaf
   and of the step's generator state equal the uninterrupted run's
   here, its counters showing the SGD and LRN kernels launched (the
   snapshot's size, write and restore seconds printed); CIFAR conv on
   its pickle files at depth 2 crashed at a seeded epoch and resumed by
   ``run_supervised``, bit-identical to the synchronous run with no
   worker left; MNIST FC at bench_fc's width with one hidden layer
   (784-4096-10), AdamW and EMA, snapshotted, restored into a fresh
   workflow (the launcher's ``resume``) and continued
   bit-identically (one AdamW launch a step); the same, and the 67-px
   AlexNet with dropout, restored into a step that has already
   captured its graphs: bit-identical, no stale replay.
17g. **data_parallel** — the fused step data-parallel on a one-rank
   NCCL world (one H100: NCCL across GPUs is not exercised here): (c)
   ``sgd_update_`` and one ``adam_update_multi_`` on AlexNet's 16 leaves
   cut as ranks 0 and n - 1 of n = 2 and 4 hold them (views at the
   ranks' offsets, a 250-element slice among them), bit for bit against
   the plain versions and against one launch on the whole leaves; (a)
   ``alexnet.build()`` at its defaults fused for 3 train minibatches
   through ``Workflow.run`` with no group, then joined through
   ``launcher.multihost`` replicated, ``shard_update`` and
   ``shard_params``: each bit-identical to the run with no group
   (weights, momenta, the generator, the history), the SGD, LRN and
   collective counters set to 0 just before and read just after (exact),
   the replays counted; ms a step of 3 timed ``train_steps`` calls of 4
   staged batches, peak memory, and one replay profiled for its NCCL and
   copy activities; (b) MNIST FC at bench_fc's widths with AdamW, int8
   collectives with error feedback and bf16 ones, 4 steps on the card
   (f32) on the world against the CPU with no group (its runs in a
   process of their own, overlapping (a)), within the MNIST FC bands,
   the loss band rejecting the card's run with TF32 on.  The group is
   destroyed at the phase's end.
17h. **lm_axes** — the transformer's ``(data, seq, model)`` mesh: (a)
   ``ring_flash_attention`` over a stand-in seq axis that plays rank r
   of n on one card over the whole K and V (rotation s hands over block
   (r - s - 1) mod n), every rank's output and the q, k, v gradients
   against one whole-sequence flash launch at the training step's
   attention (b·h 64, t 2048, dh 64, bf16), n = 2 and 4, causal and not,
   within a tile band that rejects rank 0 merging its future block; the
   flash launches exactly Σ(r+1) under causal, n² without; ms of both;
   (b) the train phase's step with no group, then joined through
   ``launcher.multihost`` as a one-rank NCCL world on ``make_mesh({"data":
   1, "seq": 1, "model": 1})``: replicated and ``head_sharded`` (16 CE
   chunks) bit-identical to the step with no group and the same options
   over 3 graphed steps, ``shard_update`` and ``shard_params``
   bit-identical to the grouped replicated step, the int8 codec's losses
   within a band of the replicated's; collectives a step, replays, flash
   launches, ms a step, peak memory, one replay's NCCL activities.  The
   group is destroyed at the phase's end.
17i. **serve_forward** — the forward-serving plane: AlexNet at its own
   configuration (227 px, 1000 classes) initialized on the card,
   exported once and loaded as an ``ExportedForward`` in eval's type
   (bf16); the engine's warmup captures buckets 1, 2, 4 and 8 into CUDA
   graphs; each bucket's replay bit-identical to its eager body, exactly
   two ``lrn_forward`` launches a forward (replays counted); the card
   against the CPU's f32 forward within a band that rejects the CPU run
   with LRN skipped; served over HTTP to concurrent clients with no
   capture after warmup; then MNIST FC's widths exported and served by
   ``python -m znicz_tpu_torch serve --smoke-test`` on cuda (its own
   process) and with ``--native`` (the C++ runtime, built beside the
   AlexNet work, held against the torch forward).
17j. **pipe_expert** — the pipeline step and the expert axis at the
   char LM's MoE block widths (d 512, ff 2048, 4 experts; 8
   microbatches of 1024 rows): (a) ``parallel/pipeline.py``'s GPipe
   ticks with 2 and 4 stages played one after another on the card
   (each stage's rotation hands over what the stage before it sent),
   bit-identical to the stages applied one after another in f32 and
   bf16, a stage fed one tick late rejected, tick counts and ms; then,
   joined through ``launcher.multihost`` as a one-rank NCCL world on
   ``make_mesh({"data": 1, "pipe": 1, "expert": 1})``: (b)
   ``make_pipeline_step`` for 20 steps bit-identical to the step with
   no group, bf16 within the reference's band of f32 with the params
   f32, the loss below 0.8x its first; collectives a step, replays, ms
   a step, peak memory; (c) ``moe_ffn_dispatch`` over the expert line
   at 16384 tokens, top-1 and top-2: at lossless capacity its values
   and gradients against ``moe_ffn`` (a misrouted slot rejected), at
   capacity 1.0 its dropped pairs against the host's count, and one
   call captured in a CUDA graph, the replay bit-identical to the eager
   call with NCCL's all-to-all in it; (d) the train phase's step for 2
   steps, saved through ``parallel/checkpoint.py``, restored into the
   ``shard_params`` layout and run 2 more: losses and params
   bit-identical to 4 uninterrupted steps, the flash launches counted
   exactly; MB written, seconds to write and to restore.  The group is
   destroyed at the phase's end.
17k. **zoo** — the rest of the zoo: (a) Wine (fused and eager),
   Approximator (regression, and nearest-target fused and eager),
   SpamFilter, TvChannels (fused, and eager through its Cutter: the
   conv forward, weight- and input-gradient kernels) and the CD-1 RBM
   at their build() defaults, f32, TF32 off, on the card and on the CPU
   from one seed: gemm_fc, act_backward, conv and SGD launches exact
   against the counts read from each run's units, n_err histories
   identical, MSE histories and weights within bands that reject the
   same run with TF32 on (the eager Approximator, with no TF32-capable
   call, must not move under TF32), the RBM's h2v product (gemm_fc on
   the transposed view of the shared weights, no copy) against its
   plain twin; ms a minibatch of each; (b) fused Wine with a
   per-minibatch LearningRateAdjust and an NNRollback forced mid-run
   after the step's leaves were poisoned: card against the CPU, the
   restore bit-equal in the same tensors, no graph recaptured; (c)
   online training fed through ``InteractiveLoader.feed``, exported,
   served in f32 by ``PredictionServer`` to ``predict_remote`` against
   the CPU forward; (d) ``python -m znicz_tpu_torch
   znicz_tpu_torch/models/wine.py`` with no ``-d``, on the card, in its
   own process beside (a)'s CPU runs.
17z. **operations** — the operational planes, f32 with TF32 off, the
   launch counters set to 0 before each part: (a) fused AlexNet (227
   px, batch 128) with ``anatomy=True``: per step the ``grad`` and
   ``update`` ms, the phase sum within 10 % of the step wall, the step's
   ms beside the one-replay step's, the weights bit-identical to the
   same steps replayed normally, LRN (2 + 2) and SGD (16) launches a
   step exact, the ``znicz_anatomy_mfu`` gauge against 989 TFLOP/s; (b)
   the LM step at ``train``'s width in its anatomy mode against the
   plain ``make_train_step`` (losses within the reference's rtol 2e-4,
   6 + 6 flash launches a step, per-phase ms, MFU); (c) ``python -m
   znicz_tpu_torch --profile DIR`` on an eager MNIST FC workflow with no
   ``-d``, and on the fused one: the traces name the gemm_fc and
   act_backward kernels (eager) and the SGD kernel (fused) as many times
   as their counters count, and ``compare_traces`` of each against
   itself is all zeros; (d) ``HealthGuard(mode="skip")`` on
   fused MNIST FC at full width with a NaN at ``step.loss``: one trip,
   the certified weights restored into the same tensors, no graph
   recaptured, the next replays training from them; (e) ``python -m
   znicz_tpu_torch elastic --workers 1`` over the drill workflow on the
   card, the worker SIGKILLed at the seeded hit and resumed, its
   history bit-identical to an uninterrupted one-worker run, ``flight``
   printing the restart's artifact, the worker's metrics export
   parseable and rank-tagged.
17zz. **fleet_learn** — the serving fleet and the learn plane, its
   subprocess parts started side by side: (a) packages A and B (the
   serve phase's LM from two seeds) behind a ``FleetRouter`` over two
   spawned ``generate --serve`` workers in bf16 (8 slots each), four
   client threads streaming greedy requests, ``POST /rollout`` of B once
   four have completed and a seeded SIGKILL at ``generate.step`` on the
   second worker inside the rollout: every stream one terminal event,
   the router's ledger closed, every worker on B's sha256, its decode
   steps moved and its count of first-run shapes the warmup's, the
   rollout's seconds; (b) a ``GenerateServer`` in this process on a
   ``PagedKVDecoder`` adopted into a pool (``WorkerPool.adopt``) behind a
   router: four prompts routed one at a time, ``paged_decode`` launches
   exactly 6 a decode step, the streams equal to its batcher's direct
   greedy decode of the same prompts; (c) the learn loop at
   bench_transformer's block widths over the char corpus's vocabulary:
   two workers appending to the feedback spool, the trainer
   (``learn/trainer_workflow.py``) under ``run_elastic`` with
   ``--profile``, the adoption bridge: one publish adopted fleet-wide,
   the ledger closed, no request lost, the trace's flash forward and
   backward kernels exactly 6 + 6 a train minibatch its spool implies,
   the publish-to-adoption latency; (d) ``python -m znicz_tpu_torch
   fleet <A> --smoke-test --workers 1 --port 0`` on the card exits 0.
17zzz. **services** — the last modules of the reference, each part run
   before the first failure is raised: (a) ``--optimize``'s core
   (``utils/genetics.py optimize``) over an lr ``Tune`` on bench_fc's
   model as a fused StandardWorkflow (784-4096-4096-10, batch 1024, 4
   train minibatches and 1 valid one, one epoch), 4 individuals, 2
   generations: the population route, SGD launches exactly 6 a replayed
   step, one capture of the train body and one of the eval body for the
   whole population, every individual's fitness equal bit for bit to its
   sequential replay on the same step, an lr-0 individual scoring the
   untrained step's error; the evaluator's seconds a generation beside
   the sequential route's (one generation of full runs) on the same
   workflow; Wine's hidden width, a structural ``Tune``, routed
   sequentially; (b) ``--ensemble-train 3`` through the CLI over eager
   Wine on the card, gemm_fc and act_backward launched exactly as the
   members' minibatches imply, each member's history and its weights
   at the held epoch against the same CLI on the CPU in the zoo's band,
   which the card's TF32 run must fail; the fused Wine committee's
   errors (``Ensemble.test_classification``); (c) serve_forward's
   AlexNet package (exported here when the phase runs alone) through
   ``forge upload``, ``list`` and ``fetch``, served from the registry by
   ``forge_fetch`` on the card, ``lrn_forward`` launched twice a
   forward, its rows bit-identical to the package loaded directly, a
   corrupted copy of the registry refused with exit 2; (d) fused Wine
   through the CLI with ``--publish markdown`` and ``--manhole=PATH``:
   inside the run a manhole session reads the live epoch and a
   ``WebStatus`` lists the workflow on ``/status.json`` and serves its
   other endpoints; the report names the card, the socket is removed.
18. **kernel_hw** — ``utils/kernel_hw.run_parity("cuda")``, all fourteen
   families of the reference ``ok``; the LRN, dropout and bf16 conv
   forward counters set to 0 just before and read just after (the only
   path to the last two).

``python3 chip_smoke.py --phase NAME ...`` runs only the named phases
(kernel, flash, gemm, optim, mnist_fused, stochastic_pool,
pool_backward, conv, alexnet_eager, deconv, kohonen, lrn_dropout,
ae_fused, alexnet_fused, graph_parity, fused_conv_parity,
input_pipeline, image_files, snapshot_resume, data_parallel, lm_axes,
serve_forward, pipe_expert, zoo, operations, fleet_learn, services,
speculative, char_lm, train, or three
that only measure and run on older trees of the port too: **waves**, the
weight gradient at AlexNet's and build_deep's shapes with split_k's
slices, one fewer and one more, through the C entry; **fused_compare**,
the dropout kernel at 64 M elements beside ``aten.native_dropout`` and
the three fused paths through ``train_steps`` and ``Workflow.run``;
**act_compare**, the tree's route to err_v and grad_b at AlexNet's fc7
and fc6 — one launch, or act_backward and a torch column sum on a tree
before it — beside the library's pair and the empty launch) after the
build, for iterating on one kernel family.  To hold a change against
its parent on one card, copy this file into a checkout of the parent
and run ``--phase fused_compare`` (or ``act_compare``) there and here
in one call: parent, change, change, parent.

Every line carries ``at_s``, the seconds since the smoke started.  Then
a ``{"kernels": [...]}`` line for all eighteen kernels, the card's name
and power limit as ``nvidia-smi`` reports them, and, last, the ``{"ok":
true, ...}`` line.  Exits non-zero without a usable CUDA device.
"""

from __future__ import annotations

import collections
import contextlib
import gc
import io
import json
import os
import re
import shutil
import socket
import signal
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import torch

from znicz_tpu_torch import launcher
from znicz_tpu_torch.core import prng as tprng
from znicz_tpu_torch.core.backends import TorchDevice, resolve_compute_dtype
from znicz_tpu_torch.core.config import root
from znicz_tpu_torch.kernels import build as kbuild
from znicz_tpu_torch.kernels import conv as kconv
from znicz_tpu_torch.kernels import counter_rng
from znicz_tpu_torch.kernels import decode as kdecode
from znicz_tpu_torch.kernels import dropout as kdrop
from znicz_tpu_torch.kernels import flash_attention as kflash
from znicz_tpu_torch.kernels import gemm as kgemm
from znicz_tpu_torch.kernels import kohonen as ksom
from znicz_tpu_torch.kernels import lrn as klrn
from znicz_tpu_torch.kernels import optim as koptim
from znicz_tpu_torch.kernels import pooling as kpool
from znicz_tpu_torch.loader.base import TRAIN
from znicz_tpu_torch.models import alexnet as talexnet
from znicz_tpu_torch.models import approximator as tapprox
from znicz_tpu_torch.models import autoencoder as tautoencoder
from znicz_tpu_torch.models import kohonen as tkohonen
from znicz_tpu_torch.models import mnist_conv as tmnist_conv
from znicz_tpu_torch.models import mnist_fc as tmnist
from znicz_tpu_torch.models import rbm as trbm
from znicz_tpu_torch.models import spam as tspam
from znicz_tpu_torch.models import tv_channels as ttv
from znicz_tpu_torch.models import wine as twine
from znicz_tpu_torch.ops import activations
from znicz_tpu_torch.ops import deconv as tdeconv_ops
from znicz_tpu_torch.ops import kohonen as tk_ops
from znicz_tpu_torch.ops import pooling as tpool_ops
from znicz_tpu_torch.observe import federation as tfederation
from znicz_tpu_torch.observe import registry as tregistry
from znicz_tpu_torch.observe.anatomy import TRAIN_PHASES
from znicz_tpu_torch.observe.trace import TRACER
from znicz_tpu_torch.parallel import mesh as tmesh
from znicz_tpu_torch.parallel import zero as tzero
from znicz_tpu_torch.parallel.transformer import (init_params,
                                                  make_logits_fn,
                                                  make_train_step,
                                                  param_shapes,
                                                  params_from_numpy,
                                                  params_to_numpy)
from znicz_tpu_torch.serve.continuous import ContinuousBatcher
from znicz_tpu_torch.serve.kvcache import KVDecoder
from znicz_tpu_torch.serve.paged import PagedKVDecoder, truncate_draft
from znicz_tpu_torch.serve.server import (build_generate_parser,
                                          start_generate_server)
from znicz_tpu_torch.resilience import faults as tfaults
from znicz_tpu_torch.standard_workflow import StandardWorkflow
from znicz_tpu_torch.units import deconv as tdeconv_unit
from znicz_tpu_torch.units import dropout as tdropout
from znicz_tpu_torch.units import pooling as tpooling
from znicz_tpu_torch.units.all2all import All2All, All2AllSoftmax
from znicz_tpu_torch.units.conv import Conv
from znicz_tpu_torch.units.gd import GradientDescent
from znicz_tpu_torch.units.gd_conv import GradientDescentConv
from znicz_tpu_torch.units.lr_adjust import ExpPolicy, LearningRateAdjust
from znicz_tpu_torch.units.nn_rollback import NNRollback
from znicz_tpu_torch.units.rbm import Binarization, WeightsUpdater
from znicz_tpu_torch.utils.export import export_lm, load_lm
from znicz_tpu_torch.utils import profiling as tprofiling
from znicz_tpu_torch.utils.kernel_hw import run_parity

SEED = 20261016
#: every tensor, decoder and the server run here (stated explicitly)
DEVICE = "cuda"
#: the largest transformer the repo configures (bench.py
#: bench_transformer): layers, d, heads, ff, vocab
N_LAYERS, D, HEADS, FF, VOCAB = 6, 512, 8, 2048, 32000
SLOTS, MAX_LEN, PAGE = 8, 2048, 16
PROMPT_LENS = (17, 64, 130, 255, 511, 700, 1024, 1500, 33, 300, 900, 1200)
MAX_TOKENS = 32
#: steady decode steps timed (and then profiled) in phase profile
PROFILE_STEPS = 20
#: the parity subset: prompt lengths and teacher-forced decode steps
PARITY_LENS, PARITY_STEPS = (17, 511, 1024), 16
#: speculative phase: draft tokens a round and the draft's depth (the
#: target's first layers); (b)'s in-process f32 run: its requests (the
#: serve phase's first prompts) and new tokens each; its own clock's
#: budget in seconds
SPEC_K, DRAFT_LAYERS = 4, 1
SPEC_F32_REQUESTS, SPEC_F32_TOKENS = 4, 16
SPEC_BUDGET_S = 12.0

#: H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, f32 non-tensor and
#: bf16 dense tensor-core flop/s
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
BF16_FLOPS = 989e12

#: kernel vs plain on identical inputs: both compute in f32 from the
#: same (bf16-exact) operands and differ only in summation order, ~1e-7
#: at these shapes — 2e-5 is the reference's own kernel band
KERNEL_ATOL = 2e-5
#: whole-model logits, kernel attention vs plain attention, f32: the
#: attention sums reorder (~1e-7 per layer) and the difference carries
#: through 6 layers — the CPU parity band of the port's tests
PARITY_ATOL_F32 = 1e-4
#: the same in bf16: the plain path rounds softmax probabilities to bf16
#: before the value product and the kernel does not, so activations
#: differ by bf16 roundings (~0.4 %) that compound over 6 layers on
#: logits of order 1; a wrong page or mask moves logits by order 1
PARITY_ATOL_BF16 = 0.25

#: flash phase: the check matrix runs at b·h 16 (b 2, h 8), at the full
#: t, at 1984 (a multiple of 64 but not of the bf16 kernels' 128-row
#: tiles), at 1000 (no multiple of 64) and at 17 (shorter than one
#: tile), then at the training shape (b·h 64, t 2048, dh 64, bf16,
#: causal)
FLASH_CHECK_BH, FLASH_TS = 16, (2048, 1984, 1000, 17)
#: rows per tile of the error metric: the f32 kernels' q and k tile
#: height, half the bf16 kernels' 128-row tiles
FLASH_ERR_TILE = 64
#: flash kernel vs plain, as the largest norm-relative error of any
#: 64-row tile of any head, ||kernel - plain|| / ||plain||, per output
#: (a tile's norm sums 64 rows, so no near-zero row blows it up, and one
#: wrong tile cannot hide behind the large early rows of a causal head).
#: lse is f32 in both dtypes, from the same operands and the unrounded
#: p: summation order only.  f32 o and grads: summation order only.
#: bf16 o and grads: p and ds round to bf16 at the online running max
#: in the kernel and at the whole-row max in the plain version, and the
#: outputs are bf16.  Each band sits above the sound readings and well
#: below a kernel that reads one K/V tile as zeros (the control below),
#: which the smoke requires the band to reject
FLASH_TOL = {torch.bfloat16: {"o": 1e-2, "lse": 1e-6, "dq": 1e-2,
                              "dk": 1e-2, "dv": 1e-2},
             torch.float32: {"o": 1e-5, "lse": 1e-6, "dq": 1e-5,
                             "dk": 1e-5, "dv": 1e-5}}
#: the training step of bench.py bench_transformer: batch, time, CE
#: chunks, learning rate (plain SGD at 0.05 diverges at this width, on
#: the CPU path as on the card; at 1e-3 the random-init loss of ~13
#: falls by ~0.3 a step)
TRAIN_B, TRAIN_T, TRAIN_CHUNKS, TRAIN_LR = 8, 2048, 16, 1e-3
#: timed steps after one warm step
TRAIN_STEPS = 12
#: train_parity: depth, batch, time and CE chunks of the reduced run
PARITY_LAYERS, PARITY_B, PARITY_T, PARITY_CHUNKS = 2, 2, 256, 4
#: card (f32 kernels, TF32 off) vs CPU (plain versions), both full f32:
#: they differ in summation order only (cuBLAS vs the CPU's GEMM
#: blocking, the kernels' tiles vs whole-row softmax), by about one
#: f32 ulp: ~1e-7 relative on losses of ~11 and ~6e-8 on the params
#: after 3 steps of lr 1e-3.  The loss band (~6 ulps) must reject the
#: same three steps run with TF32 on (the control below, ~20 ulps): a
#: run that silently left full f32 does not pass
TRAIN_LOSS_RTOL, TRAIN_PARAM_ATOL = 5e-7, 1e-6
#: bf16 compute vs f32 on the card: the reference's own band
#: (tests/test_transformer_spmd.py::test_bf16_step_tracks_f32)
TRAIN_BF16_RTOL = 2e-2
#: handoff: prompt and decoded tokens; decoder logits (prefill in plain
#: attention, decode through paged_decode, f32) vs the training forward
#: (flash forward kernel, f32) over 6 layers differ in summation order,
#: ~1e-5 on logits of order 1; a wrong row or layer moves them by order 1
HANDOFF_PROMPT, HANDOFF_TOKENS, HANDOFF_ATOL = 100, 8, 1e-3


#: the smoke's start, for each line's "at_s": the seconds since it, so
#: consecutive lines give each phase's wall time
T_START = time.perf_counter()


def emit(doc: dict) -> None:
    print(json.dumps({**doc, "at_s": time.perf_counter() - T_START}),
          flush=True)


def fail(msg: str) -> None:
    raise RuntimeError(f"chip_smoke: {msg}")


#: spin cycles queued ahead of a timed call by ``time_cuda_ms(...,
#: lead=True)``: ~100 µs at the H100's clock, longer than a wrapper's
#: host time, so the device is still busy when the call's launches
#: arrive and the events time the device, not the host's issue
LEAD_CYCLES = 200_000


def time_cuda_ms(fn, iters: int = 20, warmup: int = 3,
                 lead: bool = False) -> float:
    """Median device time of ``fn`` in ms, CUDA events around each
    call, with L2 flushed before each (the serving path meets each
    layer's arena cold: six layers of K/V exceed the 50 MB L2).  With
    ``lead``, a spin kernel of LEAD_CYCLES runs between the flush and the
    start event, for calls of a few µs of device work whose host issue
    could otherwise outlast the flush and land on the clock."""
    flush = torch.empty(64 << 20, dtype=torch.int32, device=DEVICE)
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        flush.zero_()
        if lead:
            torch.cuda._sleep(LEAD_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        times.append((start, end))
    torch.cuda.synchronize()
    return float(np.median([s.elapsed_time(e) for s, e in times]))


def host_us(fn, calls: int = 100) -> float:
    """Median host time of one call of ``fn`` in µs, the calls issued
    back to back with no sync between them: a wrapper's checks, argument
    set-up and launch, not its device time (the queue stays far from
    full at ``calls`` launches)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(calls):
        start = time.perf_counter()
        fn()
        times.append(time.perf_counter() - start)
    torch.cuda.synchronize()
    return float(np.median(times)) * 1e6


#: untimed fills, and untimed calls of the profiled function, that open
#: each profiled window: the tracer drops some of a window's first device
#: activities late in a long process (alexnet_eager's finding), at times
#: the first launch of each kernel it meets (one launch of ten lost in
#: every window of a process)
PROFILE_LEAD_IN, PROFILE_LEAD_CALLS = 4, 2
#: the spin kernel (``torch.cuda._sleep``) that marks where a profiled
#: window's counted calls begin: its name, its cycles (~25 µs at the
#: H100's clock) and the least device µs that tells it from the short
#: spin (OPEN_CYCLES) that opens the window to take the tracer's loss
MARK_KERNEL, MARK_CYCLES, MARK_MIN_US, OPEN_CYCLES = \
    "spin_kernel", 50_000, 10.0, 1_000


def profiled_after_mark(fn, calls: int, lead=None):
    """One torch.profiler window: a short spin kernel, PROFILE_LEAD_IN
    fills and PROFILE_LEAD_CALLS calls of ``lead`` (default ``fn``)
    that take the tracer's losses, then a long spin kernel as the mark,
    then ``calls`` calls of ``fn``, each device-synchronised on both
    sides.  Returns the device activities that started after the mark
    as ``(name, device µs)`` pairs, or None where the window lost the
    mark (it is told from the short spin by its length)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    lead = fn if lead is None else lead
    flush = torch.empty(64 << 20, dtype=torch.int32, device=DEVICE)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(OPEN_CYCLES)
        for _ in range(PROFILE_LEAD_IN):
            flush.zero_()
        for _ in range(PROFILE_LEAD_CALLS):
            flush.zero_()
            lead()
        torch.cuda.synchronize()
        torch.cuda._sleep(MARK_CYCLES)
        torch.cuda.synchronize()
        for _ in range(calls):
            flush.zero_()
            fn()
        torch.cuda.synchronize()
    device = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    marks = [e for e in device if MARK_KERNEL in e.name and
             e.time_range.elapsed_us() >= MARK_MIN_US]
    if len(marks) != 1:
        return None
    mark_end = marks[0].time_range.end
    return [(e.name, e.time_range.elapsed_us()) for e in device
            if e.time_range.start >= mark_end]


def kernel_ms_by_name(fn, tag: str, iters: int = 10,
                      windows: int = 5) -> dict:
    """Device ms per call of each kernel whose name starts with ``tag``
    (``name<template args>``, or a plain kernel's ``name``) that ``fn``
    launches, from ``torch.profiler`` over ``iters`` calls with L2
    flushed before each, as :func:`time_cuda_ms` flushes it: only the
    calls after :func:`profiled_after_mark`'s mark count, so the
    tracer's losses at the window's start fall on untimed calls.  Each
    such kernel launches once a call, so the window must record exactly
    ``iters`` launches of it after the mark: else it is profiled again,
    up to ``windows`` windows, and then the smoke fails; no time is
    taken from a window that lost launches."""
    counts = None
    for _ in range(windows):
        acts = profiled_after_mark(fn, iters)
        out, counts = {}, {}
        for key, us in acts or ():
            name = re.search(rf"\b({tag}\w*(?:<[^>]*>)?)", key)
            if name and us > 0:
                n = name.group(1)
                out[n] = out.get(n, 0.0) + us / 1e3 / iters
                counts[n] = counts.get(n, 0) + 1
        if out and all(c == iters for c in counts.values()):
            return out
        print(f"kernel_ms_by_name({tag}): a window recorded "
              f"{'no mark' if acts is None else counts} launches of "
              f"{iters} calls; profiling again", file=sys.stderr)
    fail(f"kernel_ms_by_name({tag}): {windows} windows, none recorded "
         f"exactly {iters} launches of each kernel (last: {counts})")


def device_profile(prof, wall_ms: float, steps: int, top: int = 10,
                   sums=()) -> dict:
    """A profiled window of ``steps`` steps in ``wall_ms`` of host time:
    the device's busy ms (every CUDA activity's self time, the kernels of
    graph replays included), its idle share, busy ms and device ops a
    step, the ``top`` activities by time, and the ms a step of the
    activities whose names hold each string of ``sums``."""
    device = [e for e in prof.key_averages()
              if str(e.device_type).endswith("CUDA")
              and e.self_device_time_total > 0]
    busy_ms = sum(e.self_device_time_total for e in device) / 1e3
    ranked = sorted(device, key=lambda e: -e.self_device_time_total)
    return {"steps": steps, "wall_ms": wall_ms,
            "device_busy_ms": busy_ms,
            "device_idle_share": 1 - busy_ms / wall_ms,
            "busy_ms_per_step": busy_ms / steps,
            "ops_per_step": sum(e.count for e in device) / steps,
            "top_device": [{"name": e.key[:80], "count": e.count,
                            "ms_per_step":
                                e.self_device_time_total / 1e3 / steps}
                           for e in ranked[:top]],
            "ms_per_step_of": {
                key: sum(e.self_device_time_total for e in device
                         if key in e.key) / 1e3 / steps for key in sums}}


#: single-step train_steps calls after timed_train_steps's, each from an
#: idle card, for the host's issue time of a step
ONE_STEP_CALLS = 3


def timed_train_steps(step, xs, ys, ms, reps: int, sums=()) -> dict:
    """``reps`` ``train_steps`` calls of the K staged minibatches, CUDA
    events around each call and the host clock around its issue (no
    sync inside): each call's device ms and host ms (a step's share of
    it, unless a call of many steps fills the launch queue and the host
    waits on the card), and its metric sums; then one call under
    torch.profiler (the device's busy time and idle share, the ms of
    the kernels named by ``sums``); then ONE_STEP_CALLS one-step calls,
    each after a sync, whose median host time is the issue cost of a
    step from an idle card."""
    from torch.profiler import ProfilerActivity, profile

    k = int(xs.shape[0])
    events = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        t0 = time.perf_counter()
        metrics = step.train_steps(xs, ys, ms)
        host = time.perf_counter() - t0
        end.record()
        events.append((start, end, host, metrics))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step.train_steps(xs, ys, ms)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # the host's cost to issue one step into an idle queue (a K-step
    # call can fill the launch queue, and then the host waits on the card)
    issue = []
    for _ in range(ONE_STEP_CALLS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step.train_steps(xs[:1], ys[:1], ms[:1])
        issue.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    call_ms = [s.elapsed_time(e) for s, e, _, _ in events]
    return {"call_ms": call_ms,
            "call_host_ms": [h * 1e3 for _, _, h, _ in events],
            "step_ms": float(np.median(call_ms)) / k,
            "host_issue_us_per_step": float(np.median(issue)) * 1e6,
            "call_host_us_per_step": float(np.median(
                [h for _, _, h, _ in events])) / k * 1e6,
            "metrics": [m for _, _, _, m in events],
            "profile": device_profile(prof, wall_ms, k, sums=sums)}


def workflow_run_profiled(w, warm: int, timed: int,
                          streams: bool = False) -> dict:
    """One ``w.run()`` (Repeater -> Loader -> FusedStep -> Decision),
    each minibatch's class recorded as the step runs it: after ``warm``
    minibatches (the first eager step and the capture of each graph come
    before), a sync and ``timed`` minibatches on the host clock alone
    (their ms a minibatch and the step's own host µs a minibatch), then
    a sync and torch.profiler from there to the run's end (the device's
    busy time and idle share; the tracer stretches the host's side), and
    with ``streams`` the window's device activities by stream
    (:func:`stream_table`)."""
    from torch.profiler import ProfilerActivity, profile

    step = w.step
    orig = step.run
    prof = profile(activities=[ProfilerActivity.CUDA])
    classes, host_s, marks = [], [], []

    def run():
        if len(classes) in (warm, warm + timed):
            torch.cuda.synchronize()
            marks.append(time.perf_counter())
            if len(marks) == 2:
                prof.start()
        classes.append(int(w.loader.minibatch_class))
        t0 = time.perf_counter()
        orig()
        if len(marks) == 1:
            host_s.append(time.perf_counter() - t0)

    step.run = run
    t0 = time.perf_counter()
    try:
        w.run()
        torch.cuda.synchronize()
    finally:
        del step.run
    end = time.perf_counter()
    if len(marks) != 2 or len(classes) == warm + timed:
        fail(f"the run had {len(classes)} minibatches, not more than "
             f"{warm} + {timed}")
    prof.stop()
    wall_ms = (end - marks[1]) * 1e3
    n = len(classes) - warm - timed
    return {"classes": classes, "run_s": end - t0,
            "timed_minibatches": timed,
            "ms_per_minibatch": (marks[1] - marks[0]) * 1e3 / timed,
            "step_host_us": float(np.median(host_s)) * 1e6,
            "profiled_minibatches": n,
            "profile": device_profile(prof, wall_ms, n),
            **({"streams": stream_table(prof)} if streams else {})}


def replays_of(step) -> dict:
    """The replays of the step's graphs, summed by body (0: a body that
    ran once, eagerly, and was never captured)."""
    out = {}
    for key, g in step._graphs.items():
        out[key[0]] = out.get(key[0], 0) + (0 if g is None else g.replays)
    return out


#: the kernel counters a captured step's graphs replay: (module,
#: counter, the name its kernels start with in the profiler; the flash
#: backward's dq kernel, one of its two kernels a launch)
REPLAYED_KERNELS = {
    "flash_fwd": (kflash, "fwd_launches", "flash_fwd_"),
    "flash_bwd": (kflash, "bwd_launches", "flash_bwd_dq"),
    "sgd_update": (koptim, "sgd_launches", "sgd_kernel"),
    "adam_update": (koptim, "adam_launches", "adam_multi_kernel"),
    "lrn_forward": (klrn, "fwd_launches", "lrn_fwd"),
    "lrn_backward": (klrn, "bwd_launches", "lrn_bwd")}


def replayed_launches(fn, names, windows: int = 5) -> dict:
    """``fn`` (replays of captured fused steps) under torch.profiler: for
    each counter of ``names`` (REPLAYED_KERNELS) what one call of ``fn``
    added to it (``counted``: a replay adds its capture's launches, it
    runs no wrapper) against the kernels of that name the card ran in it
    (``ran``).  :func:`profiled_after_mark`'s window, one call after
    the mark: the calls before it take the tracer's losses.  A window
    whose counts differ is profiled again, up to ``windows``; then the
    smoke fails.  ``calls`` is how many times ``fn`` ran in all."""
    rows, calls = None, 0
    for _ in range(windows):
        before = {}

        def lead():
            lead.n += 1
            fn()
            if lead.n == PROFILE_LEAD_CALLS:
                before.update({n: getattr(*REPLAYED_KERNELS[n][:2])
                               for n in names})
        lead.n = 0
        acts = profiled_after_mark(fn, 1, lead)
        calls += PROFILE_LEAD_CALLS + 1
        rows = {n: {"counted": getattr(*REPLAYED_KERNELS[n][:2]) -
                    before[n],
                    "ran": None if acts is None else sum(
                        1 for key, us in acts if us > 0 and
                        re.search(rf"\b{REPLAYED_KERNELS[n][2]}", key))}
                for n in names}
        if all(r["counted"] == r["ran"] for r in rows.values()):
            return {"calls": calls, **rows}
        print(f"replayed_launches: a window counted {rows}; profiling "
              f"again", file=sys.stderr)
    fail(f"replayed launches: {windows} windows, in none did the card run "
         f"what the counters counted (last: {rows})")


def decode_inputs(rng, dtype, head_dim, lengths, batch=SLOTS, heads=HEADS,
                  page=PAGE, max_len=MAX_LEN):
    """Random q and an arena layer with every slot's pages scattered
    over a shuffled page table (page 0 reserved, padding -> 0)."""
    p_view = -(-max_len // page)
    n_pages = batch * p_view + 1
    q = torch.tensor(rng.normal(size=(batch, heads, head_dim)),
                     dtype=dtype, device=DEVICE)
    k = torch.tensor(rng.normal(size=(n_pages, page, heads, head_dim)),
                     dtype=dtype, device=DEVICE)
    v = torch.tensor(rng.normal(size=(n_pages, page, heads, head_dim)),
                     dtype=dtype, device=DEVICE)
    perm = rng.permutation(np.arange(1, n_pages))
    pt = np.zeros((batch, p_view), np.int32)
    for b, n_rows in enumerate(lengths):
        n = -(-n_rows // page)
        pt[b, :n] = perm[b * p_view:b * p_view + n]
    return (q, k, v, torch.tensor(pt, device=DEVICE),
            torch.tensor(lengths, dtype=torch.int32, device=DEVICE))


def sdpa_on_view(q, k, v, pt, lengths):
    """The library yardstick: gather the page view once (untimed), then
    one scaled_dot_product_attention call with the length mask."""
    B, H, Dh = q.shape
    t_view = pt.shape[1] * k.shape[1]
    kc = k[pt.long()].reshape(B, t_view, H, Dh).transpose(1, 2).contiguous()
    vc = v[pt.long()].reshape(B, t_view, H, Dh).transpose(1, 2).contiguous()
    live = (torch.arange(t_view, device=DEVICE)[None, :]
            < lengths.long()[:, None])[:, None, None, :]
    q4 = q[:, :, None, :]
    return lambda: torch.nn.functional.scaled_dot_product_attention(
        q4, kc, vc, attn_mask=live)


#: kernel phase: slot lengths beside the serving mix (which phase_kernel
#: draws): every length on a split boundary of the widest view (64 rows
#: a split at B 8, page 16, P 128: decode_split), or one row past or
#: short of one, and every slot at length 1 (one live split a slot)
DECODE_EDGE_LENGTHS = {"split_boundaries": [64, 128, 192, 2048, 1024, 63,
                                            65, 1],
                       "all_one": [1] * SLOTS}


#: kernel phase, past one block's 32 heads: this many heads (two head
#: blocks a split and slot), bf16, at the serving view and mix of lengths
WIDE_HEADS = 64


def _decode_case(q, k, v, pt, ln) -> dict:
    """The kernel at one input against its plain version, two launches
    bit for bit, the launch counted once a call."""
    before = kdecode.launches
    o = kdecode.paged_decode(q, k, v, pt, ln)
    o2 = kdecode.paged_decode(q, k, v, pt, ln)
    if kdecode.launches != before + 2:
        fail("paged_decode did not count its launches")
    ref = kdecode.paged_decode_plain(q, k, v, pt, ln)
    torch.cuda.synchronize()
    if not torch.isfinite(o).all():
        fail(f"non-finite kernel output ({q.dtype}, {q.shape[-1]})")
    return {"max_abs_err": float((o - ref).abs().max()),
            "deterministic": bool(torch.equal(o, o2)), "_out": o}


def phase_kernel() -> dict:
    """The paged-decode kernel (split kernel and combine) against its
    plain version in all four instantiations at the serving view (B 8, H
    8, page 16, P 128) and the serving mix of lengths, at the edge
    lengths of DECODE_EDGE_LENGTHS, bit-identical across launches; the
    band must reject a control (the plain output with one split's pages
    of the longest slot pointed at another page).  Each instantiation
    timed beside its plain version, SDPA on the gathered view and the
    bound from this run's inputs, with its split count, all three with a
    spin kernel ahead of the start event (``lead``: a 20 µs call must not
    be timed as its wrapper's host issue); its two kernels apart
    (``torch.profiler``), and the call at every slot of length 1 (the
    fixed cost) and of the whole view.  Then WIDE_HEADS heads at head_dim
    64 and 128 in bf16, against the plain version with the same control
    and timed beside the bound (on a tree whose kernel stops at 32
    heads this case is recorded as not run)."""
    rng = np.random.default_rng(SEED)
    lengths = rng.permutation([1, 17, 300, 700, 1024, 1500, 2000, 2048])
    lengths = [int(n) for n in lengths]
    checks, timed_rows = [], []
    timed = None
    for dtype in (torch.bfloat16, torch.float32):
        for head_dim in kdecode.HEAD_DIMS:
            args = decode_inputs(rng, dtype, head_dim, lengths)
            q, k, v, pt, ln = args
            pps, splits = kdecode.decode_split(SLOTS, pt.shape[1], PAGE)
            case = _decode_case(*args)
            # the control: split 1 of the longest slot read from the
            # pages of its split 0
            longest = int(ln.argmax())
            pt_bad = pt.clone()
            pt_bad[longest, pps:2 * pps] = pt[longest, :pps]
            control = float((case.pop("_out") - kdecode.paged_decode_plain(
                q, k, v, pt_bad, ln)).abs().max())
            row = {"dtype": str(dtype).split(".")[-1], "head_dim": head_dim,
                   "lengths": "serving mix", "pages_per_split": pps,
                   "splits": splits, "control_max_abs_err": control,
                   **case}
            checks.append(row)
            for name, edge in DECODE_EDGE_LENGTHS.items():
                e_args = (q, k, v, pt, torch.tensor(edge, dtype=torch.int32,
                                                    device=DEVICE))
                e_case = _decode_case(*e_args)
                e_case.pop("_out")
                checks.append({"dtype": row["dtype"], "head_dim": head_dim,
                               "lengths": name, "pages_per_split": pps,
                               "splits": splits, **e_case})
            for c in checks[-3:]:
                if not c["max_abs_err"] <= KERNEL_ATOL:
                    fail(f"kernel vs plain over {KERNEL_ATOL} ({c})")
                if not c["deterministic"]:
                    fail(f"kernel output differs between two identical "
                         f"runs ({c})")
            if not control > KERNEL_ATOL:
                fail(f"the decode band passes its control ({row})")
            nbytes = kdecode.bound_bytes(q, k, pt, ln)
            flops = 4 * int(ln.long().sum()) * HEADS * head_dim
            bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
            ops_ms = flops / F32_FLOPS * 1e3
            t = {"dtype": row["dtype"], "head_dim": head_dim,
                 "pages_per_split": pps, "splits": splits,
                 "blocks": splits * SLOTS,
                 "ms": time_cuda_ms(lambda: kdecode.paged_decode(*args),
                                    lead=True),
                 "plain_ms": time_cuda_ms(
                     lambda: kdecode.paged_decode_plain(*args), lead=True),
                 "library_ms": time_cuda_ms(sdpa_on_view(*args),
                                            lead=True),
                 "bound_ms": max(bytes_ms, ops_ms),
                 "bound_by": "bytes" if bytes_ms >= ops_ms
                 else "operations", "bound_bytes": nbytes}
            t["kernels_ms"] = kernel_ms_by_name(
                lambda: kdecode.paged_decode(*args), "paged_decode_kernel")
            # the fixed cost (every slot at length 1) and the full view
            for name, edge in (("all_one", [1] * SLOTS),
                               ("all_full", [MAX_LEN] * SLOTS)):
                e_args = (q, k, v, pt, torch.tensor(
                    edge, dtype=torch.int32, device=DEVICE))
                t[f"ms_{name}"] = time_cuda_ms(
                    lambda: kdecode.paged_decode(*e_args), lead=True)
                t[f"kernels_ms_{name}"] = kernel_ms_by_name(
                    lambda: kdecode.paged_decode(*e_args),
                    "paged_decode_kernel")
            timed_rows.append(t)
            if dtype == torch.bfloat16 and head_dim == D // HEADS:
                timed = t
            del args, q, k, v, pt, ln
    wide = _wide_heads_cases(rng, lengths)
    # the serving shapes: bf16, head_dim 64, the widest page view
    return {"phase": "kernel", "ptxas": ptxas_usage("paged_decode"),
            "checks": checks, "atol": KERNEL_ATOL, "lengths": lengths,
            "wide_heads": wide,
            "shape": {"B": SLOTS, "H": HEADS, "Dh": D // HEADS,
                      "page": PAGE, "P": -(-MAX_LEN // PAGE),
                      "dtype": "bfloat16"},
            "timed": timed_rows,
            **{key: timed[key] for key in ("ms", "plain_ms", "library_ms",
                                           "bound_ms", "bound_by",
                                           "bound_bytes", "splits")},
            "max_abs_err": max(c["max_abs_err"] for c in checks)}


def _wide_heads_cases(rng, lengths) -> list:
    """The decode kernel at WIDE_HEADS heads, bf16, head_dim 64 and 128:
    within KERNEL_ATOL of the plain version, bit-identical across two
    launches, the band rejecting the split control; timed beside its
    bound and the plain version."""
    if not hasattr(kdecode, "HEADS_PER_BLOCK"):
        return [{"heads": WIDE_HEADS, "run": False,
                 "note": "this tree's kernel takes at most 32 heads"}]
    rows = []
    for head_dim in kdecode.HEAD_DIMS:
        args = decode_inputs(rng, torch.bfloat16, head_dim, lengths,
                             heads=WIDE_HEADS)
        q, k, v, pt, ln = args
        pps, splits = kdecode.decode_split(SLOTS, pt.shape[1], PAGE,
                                           WIDE_HEADS)
        case = _decode_case(*args)
        longest = int(ln.argmax())
        pt_bad = pt.clone()
        pt_bad[longest, pps:2 * pps] = pt[longest, :pps]
        control = float((case.pop("_out") - kdecode.paged_decode_plain(
            q, k, v, pt_bad, ln)).abs().max())
        nbytes = kdecode.bound_bytes(q, k, pt, ln)
        row = {"heads": WIDE_HEADS, "head_dim": head_dim,
               "dtype": "bfloat16", "pages_per_split": pps,
               "splits": splits,
               "blocks": splits * SLOTS * kdecode.head_blocks(WIDE_HEADS),
               "control_max_abs_err": control, **case,
               "ms": time_cuda_ms(lambda: kdecode.paged_decode(*args),
                                  lead=True),
               "plain_ms": time_cuda_ms(
                   lambda: kdecode.paged_decode_plain(*args), lead=True),
               "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
               "bound_by": "bytes"}
        rows.append(row)
        if not (row["max_abs_err"] <= KERNEL_ATOL and row["deterministic"]):
            fail(f"decode at {WIDE_HEADS} heads vs plain: {row}")
        if not control > KERNEL_ATOL:
            fail(f"the decode band passes its control at {WIDE_HEADS} "
                 f"heads ({row})")
        del args, q, k, v, pt, ln
    return rows


def _kernel_key(mangled: str) -> str:
    """``name<args>`` of a mangled kernel template: the first
    ``<length><name>`` that starts lower case and is followed by ``I``;
    each argument is a literal ``L<type><n>E`` (-> n), a named type
    ``<length><name>`` or a one-letter builtin type (``f`` = float)."""
    for i, ch in enumerate(mangled):
        if not ch.isdigit():
            continue
        j = i
        while j < len(mangled) and mangled[j].isdigit():
            j += 1
        n = int(mangled[i:j])
        name = mangled[j:j + n]
        if not (name[:1].islower() and mangled[j + n:j + n + 1] == "I"):
            continue
        args, k = [], j + n + 1
        while k < len(mangled) and mangled[k] != "E":
            if mangled[k] == "L":
                end = mangled.index("E", k)
                args.append(mangled[k + 2:end])
                k = end + 1
            elif mangled[k].isdigit():
                d = k
                while mangled[d].isdigit():
                    d += 1
                args.append(mangled[d:d + int(mangled[k:d])])
                k = d + int(mangled[k:d])
            else:
                args.append(mangled[k])
                k += 1
        return f"{name}<{','.join(args)}>"
    for i, ch in enumerate(mangled):    # a plain kernel: <length><name>E
        if ch.isdigit():
            j = i
            while j < len(mangled) and mangled[j].isdigit():
                j += 1
            name = mangled[j:j + int(mangled[i:j])]
            if name.endswith("_kernel") and name[:1].islower() and \
                    mangled[j + len(name):j + len(name) + 1] == "E":
                return name
    return mangled


def ptxas_usage(name: str) -> dict:
    """Registers and spill bytes per kernel from ptxas's build log, keyed
    by the kernel's name and template arguments (``flash_fwd_bf16<64>``,
    ``gemm_f32_kernel<128,128,1,0>``, ``sgd_kernel<__nv_bfloat16,4>``,
    ``reduce_splits_kernel``)."""
    usage, current = {}, None
    for line in kbuild.build_log(name).splitlines():
        entry = re.search(r"Compiling entry function '(\S+)'", line)
        if entry:
            current = _kernel_key(entry.group(1))
            usage[current] = {}
        elif current and "spill stores" in line:
            nums = [int(n) for n in re.findall(r"(\d+) bytes spill", line)]
            usage[current].update(spill_stores=nums[0], spill_loads=nums[1])
        elif current and "registers" in line:
            usage[current]["registers"] = int(
                re.search(r"Used (\d+) registers", line).group(1))
    return usage


def with_blocks(usage: dict, name: str, blocks_of) -> dict:
    """ptxas's usage with each instantiation of kernel ``name`` given its
    resident blocks an SM on the card: ``blocks_of(template args)``."""
    for key, entry in usage.items():
        if key.startswith(name + "<"):
            args = [int(a) for a in key[len(name) + 1:-1].split(",")]
            entry["blocks_per_sm"] = blocks_of(*args)
    return usage


def _flash_inputs(rng, bh, t, dh, dtype):
    return [torch.tensor(rng.normal(size=(bh, t, dh)), dtype=dtype,
                         device=DEVICE) for _ in range(4)]


def _delta(do, o, dlse):
    """Δ = rowsum(do ⊙ o) minus the lse cotangent, as the autograd
    function folds it."""
    return (do.float() * o.float()).sum(-1, keepdim=True) - dlse


def _flash_run(q, k, v, do, dlse, causal):
    """Forward then backward through the kernels."""
    o, lse = kflash.flash_attention_fwd(q, k, v, causal)
    return (o, lse) + kflash.flash_attention_bwd(
        q, k, v, do, lse, _delta(do, o, dlse), causal)


def _flash_plain(q, k, v, do, dlse, causal):
    o, lse = kflash.flash_attention_fwd_plain(q, k, v, causal)
    return (o, lse) + kflash.flash_attention_bwd_plain(
        q, k, v, do, lse, _delta(do, o, dlse), causal)


def tile_rel_err(a, b, rows: int = FLASH_ERR_TILE) -> float:
    """The largest ||a - b|| / ||b|| over ``rows``-row tiles of dim 1 of
    ``(bh, t, x)`` tensors, each head's tiles apart (a ragged last tile
    is zero-padded in both, which changes neither norm)."""
    bh, t = a.shape[:2]
    pad = -t % rows
    a, b = (torch.nn.functional.pad(x.float().reshape(bh, t, -1),
                                    (0, 0, 0, pad)).reshape(bh, -1, rows *
                                                            x[0, 0].numel())
            for x in (a, b))
    num = (a - b).norm(dim=-1)
    den = b.norm(dim=-1)
    return float((num / den.clamp_min(torch.finfo(torch.float32).tiny))
                 .max())


#: the training shape, a case of the check matrix: b·h, t, dh, dtype,
#: causal
FLASH_TRAIN_CASE = (TRAIN_B * HEADS, TRAIN_T, D // HEADS, torch.bfloat16,
                    True)
FLASH_OUTPUTS = ("o", "lse", "dq", "dk", "dv")


def _flash_check(rng, bh, t, dh, dtype, causal) -> tuple:
    """One case: the kernels against the plain versions (random do, a
    nonzero lse cotangent), two launches bit for bit, and the control —
    the kernels run with the last K/V tile read as zeros, which every
    output's band must reject.  Returns the report and the inputs."""
    case = (f"{str(dtype).split('.')[-1]}, b·h {bh}, t {t}, dh {dh}, "
            f"causal {causal}")
    q, k, v, do = _flash_inputs(rng, bh, t, dh, dtype)
    dlse = torch.tensor(rng.normal(size=(bh, t, 1)), dtype=torch.float32,
                        device=DEVICE)
    got = _flash_run(q, k, v, do, dlse, causal)
    again = _flash_run(q, k, v, do, dlse, causal)
    want = _flash_plain(q, k, v, do, dlse, causal)
    last = (t - 1) // FLASH_ERR_TILE * FLASH_ERR_TILE
    kz, vz = k.clone(), v.clone()
    kz[:, last:] = 0
    vz[:, last:] = 0
    wrong = _flash_run(q, kz, vz, do, dlse, causal)
    torch.cuda.synchronize()
    tol = FLASH_TOL[dtype]
    rel, control = {}, {}
    for name, a, b, w in zip(FLASH_OUTPUTS, got, want, wrong):
        if not torch.isfinite(a).all():
            fail(f"non-finite flash {name} ({case})")
        rel[name] = tile_rel_err(a, b)
        control[name] = tile_rel_err(w, b)
    same = all(torch.equal(a, b) for a, b in zip(got, again))
    report = {"dtype": str(dtype).split(".")[-1], "bh": bh, "head_dim": dh,
              "causal": causal, "t": t, "rel_err": rel,
              "control_rel_err": control, "deterministic": same,
              "max_abs_err_by": {
                  n: float((a.float() - b.float()).abs().max())
                  for n, a, b in zip(FLASH_OUTPUTS, got, want)}}
    if not all(rel[n] <= tol[n] for n in FLASH_OUTPUTS):    # NaN fails
        fail(f"flash kernel vs plain {rel} > {tol} ({case})")
    if not all(control[n] > tol[n] for n in FLASH_OUTPUTS):
        fail(f"a band passes the zeroed-tile control {control} vs {tol} "
             f"({case})")
    if not same:
        fail(f"flash kernel output differs between two identical runs "
             f"({case})")
    return report, (q, k, v, do, dlse)


def phase_flash() -> dict:
    rng = np.random.default_rng(SEED + 4)
    checks = []
    for dtype in (torch.bfloat16, torch.float32):
        for dh in kflash.HEAD_DIMS:
            for causal in (True, False):
                for t in FLASH_TS:
                    checks.append(_flash_check(rng, FLASH_CHECK_BH, t, dh,
                                               dtype, causal)[0])
    train_check, (q, k, v, do, dlse) = _flash_check(rng, *FLASH_TRAIN_CASE)
    checks.append(train_check)
    o, lse = kflash.flash_attention_fwd(q, k, v, True)
    delta = _delta(do, o, dlse)
    shape4 = (TRAIN_B, HEADS, TRAIN_T, D // HEADS)
    q4, k4, v4 = (x.view(shape4).detach().requires_grad_() for x in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    o4 = sdpa(q4, k4, v4, is_causal=True)
    do4 = do.view(shape4)
    timed = {
        "fwd": {"ms": time_cuda_ms(
                    lambda: kflash.flash_attention_fwd(q, k, v, True)),
                "plain_ms": time_cuda_ms(
                    lambda: kflash.flash_attention_fwd_plain(q, k, v, True)),
                "library_ms": time_cuda_ms(
                    lambda: sdpa(q4, k4, v4, is_causal=True)),
                "max_abs_err": max(train_check["max_abs_err_by"][n]
                                   for n in ("o", "lse")),
                **kflash.bound(q, True)},
        "bwd": {"ms": time_cuda_ms(lambda: kflash.flash_attention_bwd(
                    q, k, v, do, lse, delta, True)),
                "plain_ms": time_cuda_ms(
                    lambda: kflash.flash_attention_bwd_plain(
                        q, k, v, do, lse, delta, True)),
                "library_ms": time_cuda_ms(lambda: torch.autograd.grad(
                    o4, (q4, k4, v4), do4, retain_graph=True)),
                "max_abs_err": max(train_check["max_abs_err_by"][n]
                                   for n in ("dq", "dk", "dv")),
                # the backward's two kernels (dk/dv, then dq) apart
                "kernel_ms": kernel_ms_by_name(
                    lambda: kflash.flash_attention_bwd(
                        q, k, v, do, lse, delta, True), "flash_bwd_"),
                **kflash.bound(q, True, backward=True)},
    }
    for entry in timed.values():    # achieved rates: live-pair flops / ms
        entry["tflops"] = entry["flops"] / entry["ms"] / 1e9
        entry["library_tflops"] = entry["flops"] / entry["library_ms"] / 1e9
    timed["fwd"]["host_us"] = host_us(
        lambda: kflash.flash_attention_fwd(q, k, v, True))
    timed["bwd"]["host_us"] = host_us(
        lambda: kflash.flash_attention_bwd(q, k, v, do, lse, delta, True))
    # head dim 128 at the training shape's b·h and t: times only (the
    # check matrix above holds its bands)
    q, k, v, do = _flash_inputs(rng, TRAIN_B * HEADS, TRAIN_T, 128,
                                torch.bfloat16)
    o, lse = kflash.flash_attention_fwd(q, k, v, True)
    delta = _delta(do, o, torch.zeros_like(lse))
    q4, k4, v4 = (x.view(TRAIN_B, HEADS, TRAIN_T, 128).detach()
                  .requires_grad_() for x in (q, k, v))
    o4 = sdpa(q4, k4, v4, is_causal=True)
    do4 = do.view(o4.shape)
    timed["dh128"] = {
        "fwd_ms": time_cuda_ms(
            lambda: kflash.flash_attention_fwd(q, k, v, True)),
        "bwd_ms": time_cuda_ms(lambda: kflash.flash_attention_bwd(
            q, k, v, do, lse, delta, True)),
        "bwd_kernel_ms": kernel_ms_by_name(lambda: kflash.flash_attention_bwd(
            q, k, v, do, lse, delta, True), "flash_bwd_"),
        "library_fwd_ms": time_cuda_ms(
            lambda: sdpa(q4, k4, v4, is_causal=True)),
        "library_bwd_ms": time_cuda_ms(lambda: torch.autograd.grad(
            o4, (q4, k4, v4), do4, retain_graph=True))}
    return {"phase": "flash",
            "ptxas": ptxas_usage("flash_attention"),
            "tol": {str(k).split(".")[-1]: v for k, v in FLASH_TOL.items()},
            "checks": checks,
            "shape": {"bh": TRAIN_B * HEADS, "t": TRAIN_T, "dh": D // HEADS,
                      "dtype": "bfloat16", "causal": True},
            **timed}


#: bench.py bench_fc's MNIST FC model at full width: batch, inputs,
#: hidden layers, classes
FC_BATCH, FC_IN, FC_LAYERS, FC_CLASSES = 1024, 784, (4096, 4096), 10
#: AlexNet's two all2all_str layers at its batch (alexnet.py): name,
#: inputs, outputs; their forward and backward products run on gemm_fc
ALEX_FC = (("fc6", 9216, 4096), ("fc7", 4096, 4096))
#: gemm_fc vs plain (f32, TF32 off), as the largest norm-relative error
#: of any 64-row tile (the flash phase's metric): both sum the same f32
#: products, cuBLAS sometimes in another order (1.3e-6 at worst, 0 where
#: it sums as the kernel does), and the activations add ~1 ulp.  The
#: band must reject the control, the same call with one slice of the
#: contraction zeroed in both operands: the middle split-K slice where
#: the plan splits K (~sqrt(1/S) of a tile), else the last k tile
#: (K_TILE deep: ~sqrt(32/K), 0.09 at K 4096) — what a kernel that
#: dropped that slice or skipped its last k tile would return
GEMM_TOL = 1e-5
#: act_backward vs plain: the same elementwise f32 formula; exp may
#: differ by an ulp
ACT_TOL = 1e-6
#: the update kernels vs plain: the same f32 operations in the same
#: order with round-to-nearest intrinsics (no FMA contraction), so
#: bit-identical is expected; the band on each f32 output, as the
#: norm-relative error of the whole leaf, leaves room for an ulp.  A bf16
#: velocity must be within one bf16 ulp.  The control feeds bs = 1 in
#: place of 1024, which every band must reject
OPTIM_TOL, OPTIM_BF16_ULPS = 1e-6, 1
#: the update phase's hyperparameters: bench_fc's momentum, a decay and
#: an L1 mix so that every term of the formula is exercised
OPTIM_HYPER = {"lr": 0.05, "wd": 1e-3, "l1": 0.3, "mom": 0.9}
ADAM_HYPER = {"lr": 1e-3, "wd": 1e-2, "b1": 0.9, "b2": 0.999,
              "eps": 1e-8}


def fc_leaf_shapes() -> list:
    """bench_fc's six parameter leaves: (w, b) of each All2All."""
    dims = (FC_IN,) + FC_LAYERS + (FC_CLASSES,)
    shapes = []
    for n_in, n_out in zip(dims, dims[1:]):
        shapes += [(n_in, n_out), (n_out,)]
    return shapes


def _dev(a, dtype=torch.float32):
    return torch.tensor(np.asarray(a), dtype=dtype, device=DEVICE)


def _gemm_operands(rng, m, k, n, trans_a, trans_b):
    """a (m, k) and b (k, n), each stored contiguous or as the transpose
    of a contiguous matrix; entries of unit size after the product."""
    a = _dev(rng.normal(size=(k, m) if trans_a else (m, k)))
    b = _dev(rng.normal(size=(n, k) if trans_b else (k, n)) / np.sqrt(k))
    return (a.t() if trans_a else a), (b.t() if trans_b else b)


def gemm_plan_of(m, n, k) -> dict:
    """gemm_fc's tile and split-K slices for an (m, k) x (k, n) product
    (``kernels/gemm.py gemm_plan``; a tree before the split-K gemm ran
    every product unsplit on 128 x 128 tiles)."""
    plan = getattr(kgemm, "gemm_plan", None)
    if plan is None:
        return {"tile": [128, 128], "splits": 1, "per": k}
    return plan(m, n, k)


def _gemm_control(a, b):
    """Copies of a and b (same layouts) with one slice of the contraction
    zeroed: the middle split-K slice where the plan splits K, else the
    kernel's last k tile -> (copies, the zeroed k range)."""
    m, k = a.shape
    plan = gemm_plan_of(m, b.shape[1], k)
    if plan["splits"] > 1:
        mid = plan["splits"] // 2
        lo, hi = mid * plan["per"], min(k, (mid + 1) * plan["per"])
    else:
        lo, hi = (k - 1) // kgemm.K_TILE * kgemm.K_TILE, k
    ac = a.t().clone().t() if not a.is_contiguous() else a.clone()
    bc = b.t().clone().t() if not b.is_contiguous() else b.clone()
    ac[:, lo:hi] = 0
    bc[lo:hi, :] = 0
    return (ac, bc), [lo, hi]


def _gemm_check(rng, name, m, k, n, trans_a, trans_b, bias, act) -> dict:
    a, b = _gemm_operands(rng, m, k, n, trans_a, trans_b)
    bv = _dev(rng.normal(size=n) * 0.1) if bias else None
    got = kgemm.gemm_fc(a, b, bv, act)
    again = kgemm.gemm_fc(a, b, bv, act)
    want = kgemm.fc_forward_plain(a, b, bv, act)
    zeroed, k_range = _gemm_control(a, b)
    wrong = kgemm.gemm_fc(*zeroed, bv, act)
    torch.cuda.synchronize()
    rel = tile_rel_err(got[None], want[None])
    control = tile_rel_err(wrong[None], want[None])
    plan = gemm_plan_of(m, n, k)
    report = {"case": name, "m": m, "k": k, "n": n, "trans_a": trans_a,
              "trans_b": trans_b, "bias": bias, "activation": act,
              "tile": plan["tile"], "splits": plan["splits"],
              "rel_err": rel, "control_rel_err": control,
              "control_zeroed_k": k_range,
              "max_abs_err": float((got - want).abs().max()),
              "deterministic": bool(torch.equal(got, again))}
    if not torch.isfinite(got).all():
        fail(f"non-finite gemm_fc output ({report})")
    if not rel <= GEMM_TOL:                                 # NaN fails
        fail(f"gemm_fc vs plain {rel} > {GEMM_TOL} ({report})")
    if not control > GEMM_TOL:
        fail(f"the gemm band passes its control ({report})")
    if not report["deterministic"]:
        fail(f"gemm_fc differs between two identical launches ({report})")
    return report


def _act_check(rng, m, n, act) -> tuple:
    y = _dev(activations.forward(
        np, act, rng.normal(size=(m, n)).astype(np.float32)))
    err = _dev(rng.normal(size=(m, n)))
    got = kgemm.act_backward(y, err, act)
    again = kgemm.act_backward(y, err, act)
    want = kgemm.act_backward_plain(y, err, act)
    torch.cuda.synchronize()
    rel = tile_rel_err(got[None], want[None])
    report = {"m": m, "n": n, "activation": act, "rel_err": rel,
              "max_abs_err": float((got - want).abs().max()),
              "deterministic": bool(torch.equal(got, again))}
    if not rel <= ACT_TOL or not report["deterministic"]:
        fail(f"act_backward vs plain: {report} (band {ACT_TOL})")
    return report, (y, err)


#: act_backward's grad_b vs its plain twin, norm-relative: the twin adds
#: the kernel's err_v in the kernel's order with the same f32 roundings,
#: so bit-identical is expected; the band leaves room for an ulp.  It
#: must reject the control, the twin's sums without the last row (what a
#: kernel that dropped the last lane's tail would return)
GRADB_TOL = 1e-6


def _act_bias_check(rng, name, m, n, act) -> tuple:
    """act_backward with grad_b at (m, n) against its plain twin: err_v
    within ACT_TOL (bit-identical at strict ReLU, where the derivative is
    0 or 1), grad_b within GRADB_TOL and its control outside it, both
    bit-identical across two launches -> (report, (y, err, err_v))."""
    y = _dev(np.maximum(rng.normal(size=(m, n)), 0) if act ==
             activations.STRICT_RELU else activations.forward(
                 np, act, rng.normal(size=(m, n)).astype(np.float32)))
    err = _dev(rng.normal(size=(m, n)))
    got = kgemm.act_backward(y, err, act, bias_grad=True)
    again = kgemm.act_backward(y, err, act, bias_grad=True)
    want = kgemm.act_bias_backward_plain(y, err, act)
    vec = 4 if n % 4 == 0 else 1
    plan = kgemm.act_bias_plan(m, n, vec)
    control = kgemm.column_sum_in_plan_order(
        torch.cat([want[0][:-1], torch.zeros_like(want[0][-1:])]), vec)
    torch.cuda.synchronize()

    def rel(a):
        return float((a - want[1]).norm() / want[1].norm())

    check = {"layer": name, "m": m, "n": n, "activation": act,
             "plan": plan, "err_v_rel": tile_rel_err(got[0][None],
                                                     want[0][None]),
             "err_v_identical": bool(torch.equal(got[0], want[0])),
             "grad_b_rel": rel(got[1]), "control_rel": rel(control),
             "grad_b_identical_to_twin": bool(torch.equal(got[1], want[1])),
             "deterministic": bool(torch.equal(got[0], again[0]) and
                                   torch.equal(got[1], again[1])),
             "max_abs_err": max(float((got[0] - want[0]).abs().max()),
                                float((got[1] - want[1]).abs().max()))}
    exact = act != activations.STRICT_RELU or check["err_v_identical"]
    if not (exact and check["err_v_rel"] <= ACT_TOL and
            check["deterministic"] and check["grad_b_rel"] <= GRADB_TOL):
        fail(f"act_backward with grad_b vs plain: {check} (bands "
             f"{ACT_TOL}, {GRADB_TOL})")
    if not check["control_rel"] > GRADB_TOL:
        fail(f"the grad_b band passes its control ({check})")
    return check, (y, err, got[0])


def _act_bias_row(rng, name, m, n, act) -> dict:
    """:func:`_act_bias_check` at a path's shape, then timed beside a
    torch column sum of err_v alone, the library's pair and the empty
    launch over the same grid."""
    check, (y, err, err_v) = _act_bias_check(rng, name, m, n, act)

    def library():
        torch.ops.aten.threshold_backward(err, y, 0.0).sum(dim=0)

    lib = torch.ops.aten.threshold_backward(err, y, 0.0)
    return {"layer": name, "m": m, "n": n, "check": check,
            "ms": time_cuda_ms(lambda: kgemm.act_backward(
                y, err, act, bias_grad=True)),
            "plain_ms": time_cuda_ms(
                lambda: kgemm.act_bias_backward_plain(y, err, act)),
            "sum_ms": time_cuda_ms(lambda: err_v.sum(dim=0)),
            "library_ms": time_cuda_ms(library),
            "library_act_ms": time_cuda_ms(
                lambda: torch.ops.aten.threshold_backward(err, y, 0.0)),
            # the launch floor: an empty kernel over the same grid and
            # clusters from the same library, timed the same way
            "empty_launch_ms": time_cuda_ms(lambda: kgemm.empty_launch(y)),
            "library_max_abs_err": float((lib - err_v).abs().max()),
            **kgemm.act_backward_bound(y, act, bias_grad=True)}


#: the kernels an fc_backward may launch on the card: act_backward, the
#: GEMM and the GEMM's split-K sum
FC_BACKWARD_KERNELS = ("act_backward_f32_kernel", "gemm_f32_kernel",
                       "gemm_reduce_kernel")


def _fc_backward_kernels(rng) -> dict:
    """One fc_backward at AlexNet's fc7 (batch 128, strict ReLU) under
    the profiler: its first kernel is act_backward, launched once, and
    every other kernel is the GEMM's (no PyTorch reduction after it)."""
    _, n_in, n_out = ALEX_FC[1]
    x = _dev(rng.normal(size=(ALEX_BATCH, n_in)))
    w = _dev(rng.normal(size=(n_in, n_out)) / np.sqrt(n_in))
    y = _dev(np.maximum(rng.normal(size=(ALEX_BATCH, n_out)), 0))
    e = _dev(rng.normal(size=(ALEX_BATCH, n_out)))
    relu = activations.STRICT_RELU
    names = None
    for _ in range(5):
        acts = profiled_after_mark(
            lambda: kgemm.fc_backward(x, y, w, e, relu), 1)
        if acts is not None:
            names = [name for name, _ in acts if "flush" not in name and
                     "zero" not in name.lower() and "fill" not in
                     name.lower()]
            if names and FC_BACKWARD_KERNELS[0] in names[0]:
                break
    report = {"kernels": [n[:60] for n in names or []]}
    if not names or FC_BACKWARD_KERNELS[0] not in names[0] or \
            sum(FC_BACKWARD_KERNELS[0] in n for n in names) != 1 or \
            not all(any(k in n for k in FC_BACKWARD_KERNELS)
                    for n in names):
        fail(f"fc_backward's kernels on the card: {report}")
    return report


def alexnet_fc_products() -> list:
    """AlexNet's six FC products of a train minibatch at batch 128, as
    gemm_check cases: each layer's forward (bias, strict ReLU), err_v.W^T
    (the stored (in, out) weights read transposed) and x^T.err_v (the
    stored (batch, in) input read transposed)."""
    out = []
    for name, n_in, n_out in ALEX_FC:
        out += [(f"alexnet {name} forward", ALEX_BATCH, n_in, n_out, False,
                 False, True, activations.STRICT_RELU),
                (f"alexnet {name} err_v.W^T", ALEX_BATCH, n_out, n_in,
                 False, True, False, "linear"),
                (f"alexnet {name} x^T.err_v", n_in, ALEX_BATCH, n_out, True,
                 False, False, "linear")]
    return out


def _gemm_plans() -> dict:
    """gemm_fc's plan from csrc/gemm.cu (the card's own residency)
    against kernels/gemm.py's twin over bench_fc's and AlexNet's products
    and a sweep of shapes: the two must agree on every one.  A tree
    before the split-K gemm has neither and reports None."""
    if not hasattr(kgemm, "gemm_plan_on_card"):
        return None
    shapes = [(m, n, k) for m in (1, 7, 64, 128, 129, 784, 1024, 4096,
                                  9216)
              for n in (3, 10, 96, 784, 1000, 4096, 9216)
              for k in (5, 128, 784, 1024, 4096, 9216)]
    for m, n, k in shapes:
        card, twin = kgemm.gemm_plan_on_card(m, n, k), kgemm.gemm_plan(m, n,
                                                                        k)
        if card != twin:
            fail(f"gemm_fc's plan at {(m, n, k)}: gemm.cu {card}, "
                 f"kernels/gemm.py {twin}")
    card = kgemm.gemm_residency_on_card()
    table = {f"{bm}x{bn}": r for (bm, bn), r in kgemm.GEMM_TILES.items()}
    if card != table:
        fail(f"gemm_fc's residency on the card {card} differs from "
             f"kernels/gemm.py GEMM_TILES {table}")
    return {"shapes_checked": len(shapes), "blocks_per_sm": card,
            "blocks_per_sm_by_layout": kgemm.gemm_residency_on_card(True)}


def phase_gemm() -> dict:
    """The FC kernels against their plain versions on the card, f32 with
    TF32 off: bench_fc's two forward products and the backward's four
    (with their transposes), AlexNet's six FC products at batch 128, two
    ragged shapes in every layout, every fused activation at one shape;
    each band rejecting its control (a dropped split-K slice or a skipped
    last k tile); the card's tile and split choices against their Python
    twins; then the twelve products timed at full width, each with its
    tile and slices."""
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(SEED + 8)
    (h0, h1), tanh = FC_LAYERS, "tanh"
    full = [("fc0 forward", FC_BATCH, FC_IN, h0, False, False, True, tanh),
            ("fc1 forward", FC_BATCH, h0, h1, False, False, True, tanh),
            ("fc1 err_v.W^T", FC_BATCH, h1, h0, False, True, False,
             "linear"),
            ("fc0 err_v.W^T", FC_BATCH, h0, FC_IN, False, True, False,
             "linear"),
            ("fc1 x^T.err_v", h0, FC_BATCH, h1, True, False, False,
             "linear"),
            ("fc0 x^T.err_v", FC_IN, FC_BATCH, h0, True, False, False,
             "linear")] + alexnet_fc_products()
    plans = _gemm_plans()
    checks = [_gemm_check(rng, *case) for case in full]
    for m, k, n in ((7, 13, 3), (129, 200, 257)):
        for ta in (False, True):
            for tb in (False, True):
                checks.append(_gemm_check(rng, "ragged", m, k, n, ta, tb,
                                          not (ta or tb), tanh))
    for act in kgemm.FUSED_ACTIVATIONS:
        checks.append(_gemm_check(rng, "activation", 129, 200, 257, False,
                                  False, True, act))
    split_cases = [f"{c['case']} {c['m']}x{c['k']}x{c['n']} /{c['splits']}"
                   for c in checks if c["splits"] > 1]
    if plans is not None and not split_cases:
        fail("no gemm check split K: the split path went unchecked")
    act_checks = [_act_check(rng, 7, 13, act)[0]
                  for act in kgemm.FUSED_ACTIVATIONS[1:]]
    act_checks += [_act_check(rng, FC_BATCH, h1, act)[0]
                   for act in kgemm.FUSED_ACTIVATIONS[1:]]
    # grad_b in the same launch: every activation on the vector path and
    # off it (13 columns), a ragged row count, bench_fc's hidden layer
    act_checks += [_act_bias_check(rng, "bias", m, n, act)[0]
                   for m, n in ((7, 13), (129, 256), (FC_BATCH, h1))
                   for act in kgemm.FUSED_ACTIVATIONS[1:]]
    # timings at full width: bench_fc's six products of one train step
    # (fc1 forward, the widest layer's, is the headline) and AlexNet's six
    timed = []
    for name, m, k, n, ta, tb, bias, act in full:
        a, b = _gemm_operands(rng, m, k, n, ta, tb)
        bv = _dev(rng.normal(size=n) * 0.1) if bias else None

        def library(a=a, b=b, bv=bv, act=act):
            v = torch.addmm(bv, a, b) if bv is not None else \
                torch.mm(a, b)
            return activations.forward(torch, act, v)

        plan = gemm_plan_of(m, n, k)
        timed.append({"case": name, "m": m, "k": k, "n": n,
                      "tile": plan["tile"], "splits": plan["splits"],
                      "ms": time_cuda_ms(
                          lambda: kgemm.gemm_fc(a, b, bv, act)),
                      "plain_ms": time_cuda_ms(
                          lambda: kgemm.fc_forward_plain(a, b, bv, act)),
                      "library_ms": time_cuda_ms(library),
                      **kgemm.bound(a, b, bv, act)})
    # the headline's product in each operand layout: how much the
    # register-staged (k-contiguous) operands cost against cp.async
    layouts = {}
    for ta in (False, True):
        for tb in (False, True):
            a, b = _gemm_operands(rng, FC_BATCH, h0, h1, ta, tb)
            layouts[f"{'A^T' if ta else 'A'}.{'B^T' if tb else 'B'}"] = {
                "ms": time_cuda_ms(lambda: kgemm.gemm_fc(a, b)),
                "library_ms": time_cuda_ms(lambda: torch.mm(a, b))}
    del a, b
    act_report, (y, err) = _act_check(rng, FC_BATCH, h1, tanh)
    act_timed = {"m": FC_BATCH, "n": h1, "activation": tanh,
                 "ms": time_cuda_ms(lambda: kgemm.act_backward(
                     y, err, tanh, bias_grad=True)),
                 "plain_ms": time_cuda_ms(
                     lambda: kgemm.act_bias_backward_plain(y, err, tanh)),
                 "library_ms": None,
                 "library_note": "no single PyTorch call computes "
                                 "err * act'(y) from y at tanh",
                 "max_abs_err": max(c["max_abs_err"] for c in act_checks),
                 **kgemm.act_backward_bound(y, tanh, bias_grad=True)}
    # AlexNet eager's launches: fc7's and fc6's strict-ReLU backward at
    # batch 128, err_v and grad_b from one launch; the library computes
    # the same pair as aten.threshold_backward(err, y, 0) (err where y >
    # 0, else 0) and a column sum
    relu = activations.STRICT_RELU
    rows = [_act_bias_row(rng, name, ALEX_BATCH, n_out, relu)
            for name, _, n_out in reversed(ALEX_FC)]
    act_checks += [r.pop("check") for r in rows]
    act_alexnet = {**_summed(rows, max(c["max_abs_err"]
                                       for c in act_checks)),
                   **{key: sum(r[key] for r in rows) for key in (
                       "empty_launch_ms", "sum_ms",
                       "library_act_ms")},
                   "activation": relu, "layers": rows,
                   "library": "aten.threshold_backward(err, y, 0) + "
                              "sum(dim=0)",
                   "plan": kgemm.act_bias_plan(ALEX_BATCH, 4096),
                   "fc_backward_kernels": _fc_backward_kernels(rng)}
    usage = ptxas_usage("gemm")
    if plans is not None:
        by = plans["blocks_per_sm_by_layout"]
        with_blocks(usage, "gemm_f32_kernel",
                    lambda bm, bn, a_kc, b_kc:
                    by[f"{bm}x{bn}/{1 - a_kc},{b_kc}"])
    return {"phase": "gemm", "ptxas": usage, "plans": plans,
            "tol": {"gemm": GEMM_TOL, "act_backward": ACT_TOL,
                    "grad_b": GRADB_TOL},
            "checks": checks, "split_cases": split_cases,
            "act_checks": act_checks,
            "gemm_timed": timed, "gemm_layouts": layouts, "gemm": {
                **timed[1], "max_abs_err": max(c["max_abs_err"]
                                               for c in checks)},
            "act_backward": act_timed, "act_backward_alexnet": act_alexnet}


def phase_act_compare() -> dict:
    """Measures only, and runs on a parent tree too: at AlexNet's fc7
    and fc6 strict-ReLU backward (batch 128) this tree's route to err_v
    and grad_b — one launch where act_backward takes ``bias_grad``, else
    act_backward followed by a torch column sum — beside act_backward
    called without ``bias_grad`` (on a tree with the one launch, that
    same launch), the library's pair and the empty launch, each
    event-timed as phase gemm times them."""
    rng = np.random.default_rng(SEED + 8)
    relu = activations.STRICT_RELU
    fused = hasattr(kgemm, "act_bias_plan")
    rows = []
    for name, _, n_out in reversed(ALEX_FC):
        y = _dev(np.maximum(rng.normal(size=(ALEX_BATCH, n_out)), 0))
        err = _dev(rng.normal(size=(ALEX_BATCH, n_out)))
        if fused:
            def route(y=y, err=err):
                kgemm.act_backward(y, err, relu, bias_grad=True)

            def empty(y=y):
                kgemm.empty_launch(y)
        else:
            def route(y=y, err=err):
                kgemm.act_backward(y, err, relu).sum(dim=0)

            def empty(y=y):
                kgemm.empty_launch(y.numel(), y.device)

        def library(y=y, err=err):
            torch.ops.aten.threshold_backward(err, y, 0.0).sum(dim=0)

        if not rows:
            # untimed: the process's first timings meet the card's idle
            # clocks (a first row measured 1.2-1.5x its repeat)
            time_cuda_ms(route)
        rows.append({"layer": name, "m": ALEX_BATCH, "n": n_out,
                     "ms": time_cuda_ms(route),
                     "act_ms": time_cuda_ms(
                         lambda y=y, err=err: kgemm.act_backward(y, err,
                                                                 relu)),
                     "library_ms": time_cuda_ms(library),
                     "empty_launch_ms": time_cuda_ms(empty)})
    return {"phase": "act_compare", "route": "act_backward with grad_b, "
            "one launch" if fused else "act_backward + sum(dim=0)",
            "layers": rows,
            **{key: sum(r[key] for r in rows) for key in (
                "ms", "act_ms", "library_ms", "empty_launch_ms")}}


def _optim_state(rng, shapes, vel_dtype=None):
    """Seeded w, grad (summed over a batch of 1024) and optimizer state
    on the card for each leaf."""
    leaves = []
    for shape in shapes:
        leaf = {"w": _dev(rng.normal(size=shape) * 0.05),
                "g": _dev(rng.normal(size=shape) * 32.0)}
        if vel_dtype is not None:
            leaf["vel"] = _dev(rng.normal(size=shape) * 0.01, vel_dtype)
        else:
            leaf["m"] = _dev(rng.normal(size=shape) * 0.1)
            leaf["v"] = _dev(np.abs(rng.normal(size=shape)) * 0.01)
        leaves.append(leaf)
    return leaves


def _clone(leaves):
    return [{k: v.clone() for k, v in leaf.items()} for leaf in leaves]


def _scalars(values: dict) -> dict:
    return {k: _dev(np.float32(v)) for k, v in values.items()}


def _rel(a, b) -> float:
    return float((a.float() - b.float()).norm() /
                 b.float().norm().clamp_min(torch.finfo(torch.float32).tiny))


def _max_abs(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def _bf16_ulps(a, b) -> int:
    """Largest distance in bf16 units in the last place (same signs)."""
    return int((a.view(torch.int16).int() - b.view(torch.int16).int())
               .abs().max())


def _sgd_compare(leaves, hs, bs, vel_dtype, control_bs) -> dict:
    """Kernel (at ``control_bs`` when given) vs plain at ``bs``, leaf by
    leaf, each leaf with its own (lr, wd, l1, mom) from ``hs``: the worst
    f32 relative error of w (and of an f32 vel), the worst bf16 ulp
    distance of a bf16 vel, and whether bit-identical."""
    ker, ref = _clone(leaves), _clone(leaves)
    kbs = bs if control_bs is None else _dev(np.float32(control_bs))
    for kl, rl, h in zip(ker, ref, hs):
        koptim.sgd_update_(kl["w"], kl["g"], kl["vel"], *h, kbs)
        koptim.sgd_update_plain(rl["w"], rl["g"], rl["vel"], *h, bs)
    torch.cuda.synchronize()
    out = {"w_rel": max(_rel(k["w"], r["w"]) for k, r in zip(ker, ref)),
           "max_abs_err": max(_max_abs(k[n], r[n]) for k, r in
                              zip(ker, ref) for n in ("w", "vel")),
           "exact": all(torch.equal(k[n], r[n]) for k, r in zip(ker, ref)
                        for n in ("w", "vel"))}
    if vel_dtype == torch.bfloat16:
        out["vel_ulps"] = max(_bf16_ulps(k["vel"], r["vel"])
                              for k, r in zip(ker, ref))
    else:
        out["vel_rel"] = max(_rel(k["vel"], r["vel"])
                             for k, r in zip(ker, ref))
    return out


def _sgd_within(r: dict) -> bool:
    return r["w_rel"] <= OPTIM_TOL and (
        r["vel_ulps"] <= OPTIM_BF16_ULPS if "vel_ulps" in r
        else r["vel_rel"] <= OPTIM_TOL)


def _sgd_rejects(r: dict) -> bool:
    return r["w_rel"] > OPTIM_TOL and (
        r["vel_ulps"] > OPTIM_BF16_ULPS if "vel_ulps" in r
        else r["vel_rel"] > OPTIM_TOL)


def _sgd_checked(leaves, hs, bs, vel_dtype) -> dict:
    """:func:`_sgd_compare` and its bs = 1 control; fails unless the
    sound update is within the bands and the control outside them."""
    r = {"sound": _sgd_compare(leaves, hs, bs, vel_dtype, None),
         "control": _sgd_compare(leaves, hs, bs, vel_dtype, 1)}
    if not _sgd_within(r["sound"]):
        fail(f"sgd_update_ vs plain outside the band: {r}")
    if not _sgd_rejects(r["control"]):
        fail(f"the sgd bands pass the bs = 1 control: {r}")
    return r


def _adam_compare(leaves, h, bs, control_bs) -> dict:
    ker, ref = _clone(leaves), _clone(leaves)
    kbs = bs if control_bs is None else _dev(np.float32(control_bs))
    for kl, rl in zip(ker, ref):
        koptim.adam_update_(kl["w"], kl["g"], kl["m"], kl["v"], h["lr"],
                            h["wd"], h["b1"], h["b2"], h["eps"], h["c1"],
                            h["c2"], kbs)
        koptim.adam_update_plain(rl["w"], rl["g"], rl["m"], rl["v"],
                                 h["lr"], h["wd"], h["b1"], h["b2"],
                                 h["eps"], h["c1"], h["c2"], bs)
    torch.cuda.synchronize()
    out = {f"{n}_rel": max(_rel(k[n], r[n]) for k, r in zip(ker, ref))
           for n in ("w", "m", "v")}
    out["max_abs_err"] = max(_max_abs(k[n], r[n]) for k, r in
                             zip(ker, ref) for n in ("w", "m", "v"))
    out["exact"] = all(torch.equal(k[n], r[n]) for k, r in zip(ker, ref)
                       for n in ("w", "m", "v"))
    return out


def _adam_leaf_hyper(h) -> list:
    """Per-leaf (lr, wd, c1, c2) on the card for bench_fc's six leaves,
    as the fused step passes them: lr and wd differ between w and b,
    and each layer has its own step count (t = 3, 4, 5)."""
    out = []
    for i in range(6):
        t = _dev(np.float32(3 + i // 2))
        scale = 1.0 if i % 2 == 0 else 2.0
        out.append((h["lr"] * scale, h["wd"] * (2 - scale),
                    1.0 - h["b1"] ** t, 1.0 - h["b2"] ** t))
    return out


def _adam_multi_compare(leaves, h, bs) -> dict:
    """One adam_update_multi_ call over the six leaves with per-leaf
    scalars against six one-leaf adam_update_ launches and the plain
    version leaf by leaf: bit for bit, one launch counted."""
    per_leaf = _adam_leaf_hyper(h)
    multi, single, plain = _clone(leaves), _clone(leaves), _clone(leaves)
    before = koptim.adam_launches
    koptim.adam_update_multi_(
        [(lf["w"], lf["g"], lf["m"], lf["v"], *hl)
         for lf, hl in zip(multi, per_leaf)], h["b1"], h["b2"], h["eps"], bs)
    launches = koptim.adam_launches - before
    for sl, pl, (lr, wd, c1, c2) in zip(single, plain, per_leaf):
        koptim.adam_update_(sl["w"], sl["g"], sl["m"], sl["v"], lr, wd,
                            h["b1"], h["b2"], h["eps"], c1, c2, bs)
        koptim.adam_update_plain(pl["w"], pl["g"], pl["m"], pl["v"], lr, wd,
                                 h["b1"], h["b2"], h["eps"], c1, c2, bs)
    torch.cuda.synchronize()

    def same(a, b):
        return all(torch.equal(x[n], y[n]) for x, y in zip(a, b)
                   for n in ("w", "m", "v"))
    return {"launches": launches, "identical_to_one_leaf": same(multi, single),
            "identical_to_plain": same(multi, plain)}


def _adam_grids(shapes) -> dict:
    """The AdamW grid from optim.cu on this card (its occupancy
    calculator's residency) against ``kernels/optim.py adam_grid`` at
    bench_fc's leaves and at launches of a few vectors or scalars."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    vecs, tails, _, _ = koptim.adam_spaces(
        [(int(np.prod(s)), True) for s in shapes])
    cases = [(vecs, tails), (1000, 3), (0, 3), (1, 0), (10 ** 7, 0),
             (0, 300000), (5, 2 ** 20)]
    rows = []
    for v, t in cases:
        card = koptim.adam_grid_on_card(v, t)
        rows.append({"vecs": v, "tails": t, **card,
                     "twin": koptim.adam_grid(v, t, card["blocks_per_sm"],
                                              sms)})
    if any(r["blocks"] != r["twin"] for r in rows):
        fail(f"optim.cu's AdamW grid differs from adam_grid: {rows}")
    return {"sms": sms, "blocks_per_sm": rows[0]["blocks_per_sm"],
            "bench_fc": rows[0], "plans_equal": len(rows)}


def phase_optim() -> dict:
    """The update kernels against their plain versions on bench_fc's six
    leaves (SGD with f32 and bf16 velocity, AdamW), each with the bs = 1
    control, and AdamW's one launch over the six leaves against six
    one-leaf launches and the plain version, bit for bit, its grid
    against its Python twin; then one step over the six leaves timed
    against the plain version and torch.optim's fused optimizers (AdamW
    one call), the kernels and the library with a spin kernel ahead of
    the start event (``lead``: six wrapper calls can take as long on the
    host as the step on the device).  On a tree without the multi-leaf
    entry (a parent's) AdamW's step is its six launches."""
    rng = np.random.default_rng(SEED + 9)
    shapes = fc_leaf_shapes()
    bs = _dev(np.float32(FC_BATCH))
    h = _scalars(OPTIM_HYPER)
    out = {"phase": "optim",
           "ptxas": ptxas_usage("optim"), "leaves": shapes,
           "tol": {"f32_rel": OPTIM_TOL, "bf16_ulps": OPTIM_BF16_ULPS},
           "hyper": {**OPTIM_HYPER, "bs": FC_BATCH}, "control_bs": 1}
    sgd_state = {}
    for vel_dtype in (torch.float32, torch.bfloat16):
        name = f"sgd_vel_{str(vel_dtype).split('.')[-1]}"
        leaves = _optim_state(rng, shapes, vel_dtype)
        out[name] = _sgd_checked(
            leaves, [(h["lr"], h["wd"], h["l1"], h["mom"])] * len(leaves),
            bs, vel_dtype)
        sgd_state[vel_dtype] = leaves
    ah = _scalars(ADAM_HYPER)
    t_step = _dev(np.float32(3.0))            # the step count after 2
    ah["c1"] = 1.0 - ah["b1"] ** t_step       # on the device, as the step
    ah["c2"] = 1.0 - ah["b2"] ** t_step
    adam_leaves = _optim_state(rng, shapes)
    sound = _adam_compare(adam_leaves, ah, bs, None)
    control = _adam_compare(adam_leaves, ah, bs, 1)
    out["adam"] = {"sound": sound, "control": control}
    if not all(sound[f"{n}_rel"] <= OPTIM_TOL for n in ("w", "m", "v")):
        fail(f"adam_update_ vs plain outside the band: {out['adam']}")
    if not all(control[f"{n}_rel"] > OPTIM_TOL for n in ("w", "m", "v")):
        fail(f"the adam bands pass the bs = 1 control: {out['adam']}")
    multi = getattr(koptim, "adam_update_multi_", None)
    if multi is not None:
        out["adam"]["multi"] = _adam_multi_compare(adam_leaves, ah, bs)
        if out["adam"]["multi"] != {"launches": 1,
                                    "identical_to_one_leaf": True,
                                    "identical_to_plain": True}:
            fail(f"adam_update_multi_ over six leaves: {out['adam']}")
        out["adam_grid"] = _adam_grids(shapes)

    # one step = six launches, timed on the bf16-velocity state (bench_fc)
    # and the AdamW state; the library yardsticks update clones of the
    # same leaves with the grads divided by bs
    def sgd_step(fn, leaves):
        def run():
            for leaf in leaves:
                fn(leaf["w"], leaf["g"], leaf["vel"], h["lr"], h["wd"],
                   h["l1"], h["mom"], bs)
        return run

    def adam_step(fn, leaves):
        def run():
            for leaf in leaves:
                fn(leaf["w"], leaf["g"], leaf["m"], leaf["v"], ah["lr"],
                   ah["wd"], ah["b1"], ah["b2"], ah["eps"], ah["c1"],
                   ah["c2"], bs)
        return run

    def adam_multi_step(leaves):
        batch = [(leaf["w"], leaf["g"], leaf["m"], leaf["v"], ah["lr"],
                  ah["wd"], ah["c1"], ah["c2"]) for leaf in leaves]
        return lambda: multi(batch, ah["b1"], ah["b2"], ah["eps"], bs)

    def library(opt_cls, leaves, **kw):
        params = []
        for leaf in leaves:
            p = leaf["w"].clone().requires_grad_()
            p.grad = leaf["g"] / FC_BATCH
            params.append(p)
        opt = opt_cls(params, fused=True, **kw)
        return opt.step

    timed = {}
    for name, vel_dtype in (("sgd_vel_bfloat16", torch.bfloat16),
                            ("sgd_vel_float32", torch.float32)):
        leaves = sgd_state[vel_dtype]
        timed[name] = {
            "ms": time_cuda_ms(sgd_step(koptim.sgd_update_, leaves),
                               lead=True),
            "plain_ms": time_cuda_ms(sgd_step(koptim.sgd_update_plain,
                                              leaves)),
            "library_ms": time_cuda_ms(library(
                torch.optim.SGD, leaves, lr=OPTIM_HYPER["lr"],
                momentum=OPTIM_HYPER["mom"],
                weight_decay=OPTIM_HYPER["wd"]), lead=True),
            "library_note": "torch.optim.SGD(momentum, fused=True), f32 "
                            "state: the same update up to folding lr "
                            "into the momentum, without the L1 mix and "
                            "without bf16 state",
            **koptim.sgd_bound(shapes, vel_dtype)}
    timed["adam"] = {
        "ms": time_cuda_ms(adam_step(koptim.adam_update_, adam_leaves)
                           if multi is None
                           else adam_multi_step(adam_leaves), lead=True),
        "launches_a_step": 6 if multi is None else 1,
        "plain_ms": time_cuda_ms(adam_step(koptim.adam_update_plain,
                                           adam_leaves)),
        "library_ms": time_cuda_ms(library(
            torch.optim.AdamW, adam_leaves, lr=ADAM_HYPER["lr"],
            betas=(ADAM_HYPER["b1"], ADAM_HYPER["b2"]),
            eps=ADAM_HYPER["eps"], weight_decay=ADAM_HYPER["wd"]),
            lead=True),
        "library_note": "torch.optim.AdamW(fused=True) on the grads "
                        "divided by bs: the same function",
        **koptim.adam_bound(shapes)}
    out["timed"] = timed
    return out


#: mnist_eager: epochs at full width (bench_fc's layers, batch 1024; 4
#: train and 1 validation minibatches an epoch)
EAGER_EPOCHS, EAGER_TRAIN, EAGER_VALID = 2, 4096, 1024
#: mnist_fused: minibatches per train_steps call and timed calls after a
#: warm one (bench.py _throughput's protocol: K rolled copies of one
#: seeded batch staged on the device); AdamW steps after
FUSED_K, FUSED_REPS, ADAM_K = 16, 3, 4
#: then MF_EPOCHS epochs of MF_TRAIN_MB minibatches through Workflow.run:
#: the first epoch warm (the train body's eager step and its capture),
#: the next two timed on the host clock, the last profiled
MF_EPOCHS, MF_TRAIN_MB, MF_WARM, MF_TIMED = 4, 4, 4, 8
#: matmul weights of bench_fc's model (784-4096-4096-10): the N of
#: MFU = 6 N samples/s / peak, as utils/flops.py counts an All2All
FC_MATMUL_WEIGHTS = 784 * 4096 + 4096 * 4096 + 4096 * 10
#: mnist_parity: the build_* defaults (layers (64,)) in f32, the card
#: (TF32 off) against the port on the CPU.  Both sum the same f32
#: products in another order (the kernels', cuBLAS's and the CPU's GEMM
#: blocking): weights 8.9e-8 apart after 2 epochs, the fused train
#: losses 1.7e-6 relative (the second epoch's sum is 0.47, so its
#: rounding shows).  The bands sit 6x and 11x above those readings; the
#: loss band must reject the same fused run with TF32 on (10 mantissa
#: bits: 3.0e-4 on the losses, 7.6e-5 on the weights).  Readings from
#: the chip runs of PERF.md
MNIST_PARITY_EPOCHS = 2
MNIST_PARITY_LOSS_RTOL, MNIST_PARITY_WEIGHT_ATOL = 1e-5, 1e-6


def _per_minibatch_marks(w):
    """Wrap the loader's run so each served minibatch stamps the host
    clock after a device sync, with its class — the per-minibatch times
    of an eager run (the evaluator syncs every minibatch anyway)."""
    marks, orig = [], w.loader.run

    def run():
        torch.cuda.synchronize()
        marks.append((time.perf_counter(), None))
        orig()
        marks[-1] = (marks[-1][0], int(w.loader.minibatch_class))

    w.loader.run = run
    return marks


def phase_mnist_eager() -> dict:
    """build_eager at full width on TorchDevice() through Workflow.run:
    every All2AllTanh/GDTanh minibatch on gemm_fc and act_backward, the
    launch counters set to 0 just before the run and read just after."""
    tprng.seed_all(SEED)
    w = tmnist.build_eager(max_epochs=EAGER_EPOCHS, layers=FC_LAYERS,
                           minibatch_size=FC_BATCH, n_train=EAGER_TRAIN,
                           n_valid=EAGER_VALID)
    t0 = time.perf_counter()
    w.initialize(device=TorchDevice())
    init_s = time.perf_counter() - t0
    marks = _per_minibatch_marks(w)
    kgemm.gemm_launches = kgemm.act_launches = 0     # 0 just before ...
    t0 = time.perf_counter()
    w.run()
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    gemm_n, act_n = kgemm.gemm_launches, kgemm.act_launches  # ... after
    marks.append((time.perf_counter(), None))
    per_epoch = len(marks[:-1]) // EAGER_EPOCHS
    last_epoch = [(b[0] - a[0]) * 1e3 for a, b in
                  zip(marks[-per_epoch - 1:-1], marks[-per_epoch:])]
    classes = [c for _, c in marks[-per_epoch - 1:-1]]
    train_ms = [t for t, c in zip(last_epoch, classes) if c == 2]
    hist = w.decision.metrics_history
    n_train_mb = EAGER_EPOCHS * EAGER_TRAIN // FC_BATCH
    n_eval_mb = EAGER_EPOCHS * EAGER_VALID // FC_BATCH
    out = {"phase": "mnist_eager", "layers": list(FC_LAYERS),
           "minibatch": FC_BATCH, "epochs": EAGER_EPOCHS,
           "n_train": EAGER_TRAIN, "n_valid": EAGER_VALID,
           "init_s": init_s, "wall_s": wall_s, "history": hist,
           "gemm_fc_launches": gemm_n, "act_backward_launches": act_n,
           "train_minibatches": n_train_mb, "eval_minibatches": n_eval_mb,
           "train_minibatch_ms": float(np.median(train_ms)),
           "train_minibatch_ms_all": train_ms,
           "samples_per_s": FC_BATCH / (float(np.median(train_ms)) / 1e3),
           "timing": "host clock between device-synced loader serves, "
                     "last epoch's train minibatches, median"}
    if not (len(hist) == EAGER_EPOCHS and bool(w.decision.complete)):
        fail(f"eager run did not finish its epochs: {hist}")
    if not hist[-1]["metric_validation"] <= hist[0]["metric_validation"]:
        fail(f"validation n_err rose: {hist}")
    if gemm_n < 6 * n_train_mb + 2 * n_eval_mb or act_n < 2 * n_train_mb:
        fail(f"gemm_fc launched {gemm_n} / act_backward {act_n} times for "
             f"{n_train_mb} train + {n_eval_mb} eval minibatches")
    return out


def _staged_batches(rng, k: int):
    """bench.py _throughput's inputs: one seeded batch and its K rolled
    copies, staged on the card."""
    x = torch.tensor(rng.normal(size=(FC_BATCH, FC_IN)).reshape(
        FC_BATCH, 28, 28), dtype=torch.float32, device=DEVICE)
    y = torch.tensor(rng.integers(0, FC_CLASSES, FC_BATCH), device=DEVICE,
                     dtype=torch.int32)
    idx = torch.tensor((np.arange(FC_BATCH)[None, :] -
                        np.arange(k)[:, None]) % FC_BATCH, device=DEVICE)
    return x[idx], y[idx], torch.ones((k, FC_BATCH), dtype=torch.bool,
                                      device=DEVICE)


def _fused_workflow(max_epochs=1, n_train=2 * FC_BATCH, **kw):
    tprng.seed_all(SEED)
    w = tmnist.build_fused(max_epochs=max_epochs, layers=FC_LAYERS,
                           minibatch_size=FC_BATCH, n_train=n_train,
                           n_valid=0, **kw)
    w.initialize(device=TorchDevice())
    return w


def phase_mnist_fused() -> dict:
    """bench_fc's configuration (bench.py:303-313) through build_fused on
    the card, every step a graph replay but each body's first: K-step
    train_steps calls (one warm, FUSED_REPS timed with CUDA events, one
    profiled), then MF_EPOCHS epochs through Workflow.run (warm, timed,
    profiled: workflow_run_profiled); then AdamW for a few steps, one update
    launch a step.  The update kernels' counters are set to 0 just
    before each path and read just after: exact, replays included."""
    w = _fused_workflow(max_epochs=MF_EPOCHS, n_train=MF_TRAIN_MB * FC_BATCH,
                        optimizer_config={"state_dtype": "bfloat16"})
    step = w.step
    xs, ys, ms = _staged_batches(np.random.default_rng(SEED + 10), FUSED_K)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    koptim.sgd_launches = 0                          # 0 just before ...
    losses = [float(step.train_steps(xs, ys, ms)["loss"]) / (FC_BATCH *
                                                             FUSED_K)]
    timed = timed_train_steps(step, xs, ys, ms, FUSED_REPS)
    losses += [float(m["loss"]) / (FC_BATCH * FUSED_K)
               for m in timed.pop("metrics")]
    peak = torch.cuda.max_memory_allocated()
    # MF_EPOCHS epochs through the graph: Repeater -> Loader -> FusedStep
    # -> Decision, the dataset pinned on the device (index-fed)
    run = workflow_run_profiled(w, MF_WARM, MF_TIMED)
    sgd_n = koptim.sgd_launches                      # ... read just after
    # the warm, timed and profiled calls, then the epochs' minibatches
    staged = FUSED_K * (2 + FUSED_REPS) + ONE_STEP_CALLS
    steps = staged + MF_EPOCHS * MF_TRAIN_MB
    replays = replays_of(step)
    want_replays = {"steps": staged - 1,
                    "train": MF_EPOCHS * MF_TRAIN_MB - 1}
    hist = w.decision.metrics_history
    sps = FC_BATCH / (timed["step_ms"] / 1e3)
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        fail(f"fused loss not finite and falling: {losses}")
    if sgd_n != 6 * steps:
        fail(f"sgd_update_ launched {sgd_n} times over {steps} steps of "
             f"6 leaves")
    if replays != want_replays:
        fail(f"mnist fused graph replays {replays}, want {want_replays}")
    if not (len(hist) == MF_EPOCHS and bool(w.decision.complete) and
            step._dataset_dev is not None):
        fail(f"the fused epochs through Workflow.run did not finish: {hist}")
    # AdamW, the same configuration with f32 moments
    wa = _fused_workflow(optimizer="adam")
    koptim.adam_launches = 0                         # 0 just before ...
    m = wa.step.train_steps(xs[:ADAM_K], ys[:ADAM_K], ms[:ADAM_K])
    adam_loss = float(m["loss"]) / (FC_BATCH * ADAM_K)
    adam_n = koptim.adam_launches                    # ... read just after
    if not np.isfinite(adam_loss) or adam_n != ADAM_K or \
            replays_of(wa.step) != {"steps": ADAM_K - 1}:
        fail(f"adam: loss {adam_loss}, {adam_n} launches over {ADAM_K} "
             f"steps, replays {replays_of(wa.step)}")
    # what the replays ran, by the profiler, against the counters
    profiled = {
        "sgd": replayed_launches(lambda: step.train_steps(xs, ys, ms),
                                 ("sgd_update",)),
        "adam": replayed_launches(
            lambda: wa.step.train_steps(xs[:ADAM_K], ys[:ADAM_K],
                                        ms[:ADAM_K]), ("adam_update",))}
    return {"phase": "mnist_fused",
            "config": {"layers": list(FC_LAYERS), "batch": FC_BATCH,
                       "optimizer": "sgd", "momentum": 0.9, "lr": 0.05,
                       "state_dtype": "bfloat16", "compute": "bfloat16",
                       "K": FUSED_K, "timed_calls": FUSED_REPS,
                       "epochs": MF_EPOCHS, "train_minibatches": MF_TRAIN_MB},
            "losses_per_sample": losses, **timed,
            "samples_per_s": sps,
            "mfu": 6.0 * FC_MATMUL_WEIGHTS * sps / BF16_FLOPS,
            "peak_mem_bytes": peak, "sgd_update_launches": sgd_n,
            "steps": steps, "graph_replays": replays,
            "workflow_run": {**run, "history": hist},
            "adam": {"steps": ADAM_K, "loss_per_sample": adam_loss,
                     "adam_update_launches": adam_n},
            "replayed_launches_profiled": profiled}


def _parity_run(kind, device, allow_tf32=False):
    """A build_* default run (layers (64,)) from one seed on ``device``
    in f32 -> (n_err history, per-epoch train loss sums, weights)."""
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = allow_tf32
    try:
        tprng.seed_all(SEED)
        w = getattr(tmnist, f"build_{kind}")(max_epochs=MNIST_PARITY_EPOCHS)
        w.initialize(device=TorchDevice(device, precision="float32"))
        losses = []
        if kind == "fused":
            logged = w.decision.on_epoch_logged

            def on_epoch_logged():
                losses.append(float(w.step.loss))
                logged()

            w.decision.on_epoch_logged = on_epoch_logged
        w.run()
        if kind == "fused":
            w.step.sync_to_units()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    return (w.decision.metrics_history, losses,
            [a for f in w.forwards for a in (f.weights.map_read(),
                                             f.bias.map_read())])


def phase_mnist_parity() -> dict:
    """The MNIST FC slice at the build_* defaults in f32: the card (the
    kernels; TF32 off) against the port on the CPU (the plain versions),
    eager and fused; the fused loss band must reject TF32."""
    out = {"phase": "mnist_parity", "epochs": MNIST_PARITY_EPOCHS,
           "bands": {"loss_rel": MNIST_PARITY_LOSS_RTOL,
                     "weight_atol": MNIST_PARITY_WEIGHT_ATOL}}
    runs = {}
    for kind in ("eager", "fused"):
        card, cpu = _parity_run(kind, DEVICE), _parity_run(kind, "cpu")
        runs[kind] = (card, cpu)
        out[kind] = {
            "history_card": card[0], "history_cpu": cpu[0],
            "weight_max_abs": max(float(np.abs(a - b).max())
                                  for a, b in zip(card[2], cpu[2]))}
        if kind == "fused":
            out[kind]["loss_rel"] = max(abs(a - b) / abs(b) for a, b in
                                        zip(card[1], cpu[1]))
            out[kind]["losses_card"], out[kind]["losses_cpu"] = card[1], \
                cpu[1]
    tf32 = _parity_run("fused", DEVICE, allow_tf32=True)
    cpu_losses = runs["fused"][1][1]
    out["tf32_control"] = {
        "losses": tf32[1],
        "loss_rel": max(abs(a - b) / abs(b) for a, b in zip(tf32[1],
                                                            cpu_losses)),
        "weight_max_abs": max(float(np.abs(a - b).max())
                              for a, b in zip(tf32[2], runs["fused"][1][2]))}
    for kind in ("eager", "fused"):
        r = out[kind]
        if r["history_card"] != r["history_cpu"]:
            fail(f"{kind} n_err history card {r['history_card']} != cpu "
                 f"{r['history_cpu']}")
        if not r["weight_max_abs"] <= MNIST_PARITY_WEIGHT_ATOL:
            fail(f"{kind} weights card vs cpu: {out}")
    if not out["fused"]["loss_rel"] <= MNIST_PARITY_LOSS_RTOL:
        fail(f"fused losses card vs cpu: {out}")
    if not out["tf32_control"]["loss_rel"] > MNIST_PARITY_LOSS_RTOL:
        fail(f"the fused loss band passes the TF32 control: {out}")
    return out


#: conv phase: AlexNet's five conv layers at its batch (alexnet.py): name,
#: input side, cin, cout, kernel, stride, pad
ALEX_BATCH = 128
ALEX_CONVS = (("conv1", 227, 3, 96, 11, 4, 0), ("conv2", 27, 96, 256, 5, 1, 2),
              ("conv3", 13, 256, 384, 3, 1, 1),
              ("conv4", 13, 384, 384, 3, 1, 1),
              ("conv5", 13, 384, 256, 3, 1, 1))
#: the reference's conv test geometries (tests/test_pallas_kernels.py:
#: 126-132) at batch 3: h, w, cin, cout, k, sliding, padding
CONV_GEOMS = ((8, 8, 3, 16, 3, (1, 1), (0, 0, 0, 0)),
              (9, 7, 4, 8, 3, (2, 2), (1, 1, 1, 1)),
              (12, 12, 2, 8, 5, (2, 2), (2, 1, 0, 2)),
              (6, 6, 8, 32, 1, (1, 1), (0, 0, 0, 0)))
#: the conv kernels vs their plain versions (f32, TF32 off), as the
#: largest norm-relative error of any 64-row tile (rows: output pixels of
#: y and of the input gradient, (iy, ix, ci) rows of gw).  Both sum the
#: same f32 products in other orders.  y and the input gradient sum K <=
#: 3456 products a value: sequential f32 rounding, u·sqrt(K/2), is ~3e-6
#: at worst, so 1e-5.  gw and gb sum n·oh·ow products (387,200 for
#: conv1): a sequential sum of that length rounds to ~u·sqrt(K/2) = 2.6e-5
#: of its value, so their band is the reference's own 1e-4
#: (tests/test_pallas_kernels.py:448-453).  Each band must reject its
#: control: the forward with its last k tile skipped (the weights' last 8
#: rows zeroed: ~sqrt(8/K), >= 0.048 at K 3456), the input gradient with
#: one tap dropped (the centre tap's weights zeroed), the weight gradient
#: with one split-K slice dropped (that slice's rows of e zeroed: ~sqrt(1/
#: S) of the sum)
CONV_TOL = {"fwd": 1e-5, "input_grad": 1e-5, "weight_grad": 1e-4}


#: the bf16 conv forward vs its plain version, both from the same bf16
#: operands with f32 sums, the bias added in f32 and one rounding: they
#: sum in other orders, so a value whose f32 sum lies near a bf16
#: rounding boundary can round to the neighbouring bf16 value, one ulp
#: (<= 2^-8 of it) away: 0.01-0.2 % of the values at AlexNet's layers on
#: the H100, a global norm-relative error of 2e-5 to 1.3e-4.  The band
#: is one bf16 ulp on the 64-row-tile norm, 2^-8: a tile every value of
#: which moved by one ulp reads at most that.  It must reject the control
#: that skips the wgmma kernel's last k tile (the weights' last <= 64
#: rows zeroed, kconv.BF16_K_TILE: ~sqrt(64/K) or more; all of them
#: where K <= 64)
CONV_BF16_TOL = 2.0 ** -8
#: the reference sweep's conv_fwd_bf16 shape (utils/pallas_hw.py:129-142):
#: x (8, 16, 16, 64), w (3, 3, 64, 128), k3 s1 p1
CONV_BF16_SWEEP = (8, 16, 16, 64, 128, 3, (1, 1), (1, 1, 1, 1))


def _bf16_conv_check(name, x, wt, b, sliding, padding) -> dict:
    """The bf16 forward at one geometry against its plain version, two
    launches bit for bit, and the band's control (the last 64-deep k
    tile skipped)."""
    geom = (sliding, padding)
    ky, kx, cin, cout = wt.shape
    got = kconv.conv2d_fwd(x, wt, b, *geom)
    again = kconv.conv2d_fwd(x, wt, b, *geom)
    want = kconv.conv2d_fwd_plain(x, wt, b, *geom)
    k_all = ky * kx * cin
    w_skip = wt.clone()
    last = (k_all - 1) // kconv.BF16_K_TILE * kconv.BF16_K_TILE
    w_skip.view(k_all, cout)[last:] = 0
    wrong = kconv.conv2d_fwd(x, w_skip, b, *geom)
    torch.cuda.synchronize()
    out = {"case": name, "n": x.shape[0], "h": x.shape[1], "cin": cin,
           "cout": cout, "k": ky, "sliding": list(sliding),
           "tile": [kconv.BF16_TILE_M, kconv.fwd_bf16_tile(cout)],
           "padding": list(padding), "dtype": str(got.dtype),
           "rel_err": tile_rel_err(_rows(got, cout), _rows(want, cout)),
           "control_rel_err": tile_rel_err(_rows(wrong, cout),
                                           _rows(want, cout)),
           "max_abs_err": _max_abs(got, want),
           "values_differing": float((got != want).float().mean()),
           "deterministic": bool(torch.equal(got, again))}
    if got.dtype != torch.bfloat16 or not bool(
            torch.isfinite(got.float()).all()):
        fail(f"bf16 conv forward output not finite bf16 ({out})")
    if not out["rel_err"] <= CONV_BF16_TOL:
        fail(f"bf16 conv forward vs plain over its band ({out})")
    if not out["control_rel_err"] > CONV_BF16_TOL:
        fail(f"the bf16 conv forward band passes its control ({out})")
    if not out["deterministic"]:
        fail(f"bf16 conv forward differs between two launches ({out})")
    return out


def _conv_inputs(rng, n, h, w, cin, cout, k, sliding, padding):
    """Seeded x, HWIO w (fan-in scaled), b, and a cotangent e of the
    output's shape, on the card."""
    x = _dev(rng.normal(size=(n, h, w, cin)))
    wt = _dev(rng.normal(size=(k, k, cin, cout)) / np.sqrt(k * k * cin))
    b = _dev(rng.normal(size=cout) * 0.1)
    ky, kx, sy, sx, pt, pb, pl, pr = kconv.geometry(wt.shape, sliding,
                                                    padding)
    oh = kconv.out_size(h, ky, sy, pt, pb)
    ow = kconv.out_size(w, kx, sx, pl, pr)
    e = _dev(rng.normal(size=(n, oh, ow, cout)))
    return x, wt, b, e


def _rows(t, width):
    return t.reshape(1, -1, width)


def _conv_check(name, inputs, sliding, padding) -> dict:
    """The three kernels at one geometry, on ``inputs`` = (x, w, b, e) of
    ``_conv_inputs``, against their plain versions, two launches bit for
    bit, and each band's control."""
    x, wt, b, e = inputs
    n, h, w, cin = x.shape
    k, cout = wt.shape[0], wt.shape[3]
    geom = (sliding, padding)
    ky, kx, sy, sx, pt, pb, pl, pr = kconv.geometry(wt.shape, *geom)
    got = {"fwd": (kconv.conv2d_fwd(x, wt, b, *geom),),
           "input_grad": (kconv.conv2d_input_grad(e, wt, *geom, (h, w)),),
           "weight_grad": kconv.conv2d_weight_grad(x, e, wt.shape, *geom)}
    again = {"fwd": (kconv.conv2d_fwd(x, wt, b, *geom),),
             "input_grad": (kconv.conv2d_input_grad(e, wt, *geom, (h, w)),),
             "weight_grad": kconv.conv2d_weight_grad(x, e, wt.shape, *geom)}
    want = {"fwd": (kconv.conv2d_fwd_plain(x, wt, b, *geom),),
            "input_grad": (kconv.conv2d_input_grad_plain(e, wt, *geom,
                                                         (h, w)),),
            "weight_grad": kconv.conv2d_weight_grad_plain(x, e, wt.shape,
                                                          *geom)}
    # the controls: what a kernel that skipped its last k tile, dropped
    # the centre tap or dropped one split-K slice would return
    k_all = ky * kx * cin
    w_skip = wt.clone()
    w_skip.view(k_all, cout)[(k_all - 1) // kconv.K_TILE * kconv.K_TILE:] = 0
    w_tap = wt.clone()
    w_tap[ky // 2, kx // 2] = 0
    splits, per = kconv.split_k(k_all + 1, cout, e.numel() // cout)
    e_cut = e.clone()
    e_cut.view(-1, cout)[splits // 2 * per:(splits // 2 + 1) * per] = 0
    wrong = {"fwd": (kconv.conv2d_fwd(x, w_skip, b, *geom),),
             "input_grad": (kconv.conv2d_input_grad(e, w_tap, *geom,
                                                    (h, w)),),
             "weight_grad": kconv.conv2d_weight_grad(x, e_cut, wt.shape,
                                                     *geom)}
    torch.cuda.synchronize()
    report = {"case": name, "n": n, "h": h, "w": w, "cin": cin,
              "cout": cout, "k": k, "sliding": list(sliding),
              "padding": list(padding), "splits": splits, "per": per}
    for kind in CONV_TOL:
        outs = list(zip(got[kind], want[kind], wrong[kind], again[kind]))
        width = [o[1].shape[-1] for o in outs]
        rel = max(tile_rel_err(_rows(a, c), _rows(p, c))
                  for (a, p, _, _), c in zip(outs, width))
        control = min(tile_rel_err(_rows(z, c), _rows(p, c))
                      for (_, p, z, _), c in zip(outs, width))
        same = all(torch.equal(a, r) for a, _, _, r in outs)
        finite = all(bool(torch.isfinite(a).all()) for a, _, _, _ in outs)
        report[kind] = {"rel_err": rel, "control_rel_err": control,
                        "deterministic": same,
                        "max_abs_err": max(float((a - p).abs().max())
                                           for a, p, _, _ in outs)}
        if not finite:
            fail(f"non-finite conv {kind} output ({report})")
        if not rel <= CONV_TOL[kind]:                       # NaN fails
            fail(f"conv {kind} vs plain {rel} > {CONV_TOL[kind]} "
                 f"({report})")
        if not control > CONV_TOL[kind]:
            fail(f"the conv {kind} band passes its control ({report})")
        if not same:
            fail(f"conv {kind} differs between two identical launches "
                 f"({report})")
    return report


def _conv_library(x, wt, b, e, sliding, padding):
    """cuDNN's calls for the same three functions, on channels_last
    tensors: F.conv2d, torch.nn.grad.conv2d_input and conv2d_weight."""
    ky, kx, sy, sx, pt, pb, pl, pr = kconv.geometry(wt.shape, sliding,
                                                    padding)
    assert (pt, pl) == (pb, pr), "cuDNN takes symmetric pads"
    cl = torch.channels_last
    xn = x.permute(0, 3, 1, 2).contiguous(memory_format=cl)
    wn = wt.permute(3, 2, 0, 1).contiguous(memory_format=cl)
    en = e.permute(0, 3, 1, 2).contiguous(memory_format=cl)
    kw = {"stride": (sy, sx), "padding": (pt, pl)}
    grad = torch.nn.grad
    return {"fwd": lambda: torch.nn.functional.conv2d(xn, wn, b, **kw),
            "input_grad": lambda: grad.conv2d_input(xn.shape, wn, en, **kw),
            "weight_grad": lambda: grad.conv2d_weight(xn, wn.shape, en,
                                                      **kw)}


def fwd_f32_tile_of(m, cout) -> list:
    """The f32 forward's tile for m output pixels and cout channels
    (``kernels/conv.py fwd_f32_tile``; a tree before it ran one 128 x 128
    tile)."""
    tile = getattr(kconv, "fwd_f32_tile", None)
    return [128, 128] if tile is None else list(tile(m, cout))


def _tile_choices() -> dict:
    """The per-launch tile choices of csrc/conv.cu against their Python
    twins in kernels/conv.py: the input gradient's and the bf16
    forward's over every channel count to 1024, the f32 forward's plan
    (:func:`_fwd_f32_plans`)."""
    lib = kconv._library()
    for c in range(1, 1025):
        if lib.znicz_conv2d_input_grad_tile(c) != \
                kconv.input_grad_tile(c)[1] or \
                lib.znicz_conv2d_fwd_bf16_tile(c) != kconv.fwd_bf16_tile(c):
            fail(f"conv.cu's tile choice at {c} channels differs from "
                 f"kernels/conv.py's")
    return {"input_grad": {c: kconv.input_grad_tile(c)
                           for c in (3, 64, 96, 256, 384)},
            "fwd_bf16": {c: kconv.fwd_bf16_tile(c)
                         for c in (96, 256, 384)},
            "fwd_f32": _fwd_f32_plans()}


def _fwd_f32_plans() -> dict:
    """The f32 forward's tile from csrc/conv.cu (the card's residency)
    against kernels/conv.py fwd_f32_tile at AlexNet's five layers,
    build_deep's shapes and a sweep of pixel and channel counts, and
    every tile's resident blocks an SM (the fewer of its two gathers')
    against FWD_F32_TILES."""
    if not hasattr(kconv, "fwd_f32_residency_on_card"):
        return None                 # a tree before the f32 forward's plan
    card = kconv.fwd_f32_residency_on_card()
    table = {f"{bm}x{bn}": r for (bm, bn), r in kconv.FWD_F32_TILES.items()}
    if card != table:
        fail(f"the f32 forward's residency on the card {card} differs from "
             f"kernels/conv.py FWD_F32_TILES {table}")
    shapes = [(ALEX_BATCH * ((side + 2 * p - k) // s + 1) ** 2, cout)
              for _, side, cin, cout, k, s, p in ALEX_CONVS]
    shapes += [(AE_BATCH * 32 * 32, 64), (AE_BATCH * 16 * 16, 128)]
    shapes += [(m, c) for m in (1, 75, 4000, 21632, 33792, 34000, 93312,
                                387200)
               for c in (1, 3, 64, 65, 96, 97, 128, 200, 256, 384, 1000)]
    for m, c in shapes:
        got = kconv.fwd_f32_plan_on_card(m, c)["tile"]
        if got != list(kconv.fwd_f32_tile(m, c)):
            fail(f"the f32 forward's tile at {(m, c)}: conv.cu {got}, "
                 f"kernels/conv.py {kconv.fwd_f32_tile(m, c)}")
    return {"blocks_per_sm": card, "shapes_checked": len(shapes),
            "blocks_per_sm_by_gather": kconv.fwd_f32_residency_on_card(True),
            "alexnet": [kconv.fwd_f32_tile(m, c) for m, c in shapes[:5]]}


def _weight_grad_plans() -> dict:
    """The weight gradient's schedule from csrc/conv.cu (the card's own
    residency) against kernels/conv.py's twin, at AlexNet's five layers,
    build_deep's four and a sweep of rows, couts and pixel counts; the
    two must agree on every one."""
    shapes = [(k * k * cin + 1, cout, ALEX_BATCH * side_out ** 2)
              for _, side, cin, cout, k, s, p in ALEX_CONVS
              for side_out in [(side + 2 * p - k) // s + 1]]
    shapes += [(49, 64, 65536), (1025, 128, 16384)]
    shapes += [(rows, cout, k) for rows in (2, 10, 28, 49, 65, 129, 1025,
                                            2305, 3457, 9000)
               for cout in (3, 8, 64, 65, 96, 384)
               for k in (5, 108, 4096, 93312)]
    for rows, cout, k in shapes:
        card = kconv.weight_grad_plan_on_card(rows, cout, k)
        twin = kconv.weight_grad_grid(rows, cout, k)
        twin.pop("waves")
        if card != twin:
            fail(f"the weight gradient's schedule at {(rows, cout, k)}: "
                 f"conv.cu {card}, kernels/conv.py {twin}")
    return {f"{bm}x{bn}": kconv.weight_grad_plan_on_card(
        (bm if bm > 64 else 48) + 1, bn, 4096)["blocks_per_sm"]
        for bm, bn in kconv.WEIGHT_GRAD_TILES}


def device_kernels(fn, iters: int = 3, tries: int = 3) -> list:
    """``[(name, ms a call)]`` of the four longest kernels ``fn``
    launches, from ``torch.profiler`` (the library's own kernels, by
    name); a window in which the profiler saw no device time (it happens
    now and then) is profiled again, up to ``tries`` times."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        found = [[e.key[:120], e.self_device_time_total / 1e3 / iters]
                 for e in sorted(prof.key_averages(),
                                 key=lambda e: -e.self_device_time_total)
                 if e.self_device_time_total > 0][:4]
        if found:
            return found
    return []


def sass_counts(name: str, opcode: str) -> dict:
    """How many SASS instructions of ``opcode`` each kernel of library
    ``name`` holds, from the toolkit's ``cuobjdump -sass`` (keys as in
    :func:`ptxas_usage`), or None where the toolkit has no cuobjdump."""
    tool = os.path.join(os.path.dirname(kbuild.nvcc()), "cuobjdump")
    if not os.path.exists(tool):
        return None
    out = subprocess.run([tool, "-sass", str(kbuild.library_path(name))],
                         capture_output=True, text=True, check=True,
                         timeout=300).stdout
    counts, current = {}, None
    for line in out.splitlines():
        fn = re.search(r"Function : (\S+)", line)
        if fn:
            current = _kernel_key(fn.group(1))
            counts[current] = 0
        elif current and re.search(rf"\b{opcode}\b", line):
            counts[current] += 1
    return counts


def phase_conv() -> dict:
    """The conv kernels against their plain versions in f32 (TF32 off) at
    the reference's geometries and AlexNet's five layers at batch 128
    (conv1's stride-4 11x11 input gradient included, which deconv will
    launch), bit-identical across launches, each band rejecting its
    control; then each kernel, its plain version and cuDNN timed at the
    five layers' launches of a train minibatch (conv1's input gradient
    is checked but not timed: the path does not launch it), with the
    bound from this run's inputs and each launch's tile.  Then the bf16
    forward the same way at the reference's four geometries, the
    reference sweep's shape and the five layers, timed beside cuDNN in
    bf16; its SASS must issue wgmma (HGMMA), and both tile choices must
    match their Python twins."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    tiles = _tile_choices()
    tiles["weight_grad_blocks_per_sm"] = _weight_grad_plans()
    hgmma = sass_counts("conv", "HGMMA")
    if hgmma is not None and not all(
            hgmma.get(f"conv_fwd_bf16_kernel<{bn}>", 0) > 0
            for bn in (64, 128, 192, 256)):
        fail(f"the bf16 conv forward's SASS issues no HGMMA ({hgmma})")
    rng = np.random.default_rng(SEED + 12)
    checks = [_conv_check("reference geometry", _conv_inputs(rng, 3, *g),
                          *g[-2:]) for g in CONV_GEOMS]
    n, h, w, cin, cout, k, s, p = CONV_BF16_SWEEP
    bf16_checks = [_bf16_conv_check(
        "sweep", *(t.bfloat16() for t in _conv_inputs(
            rng, n, h, w, cin, cout, k, s, p)[:3]), s, p)]
    ref_rng = np.random.default_rng(SEED + 21)
    bf16_checks += [_bf16_conv_check(
        "reference geometry", *(t.bfloat16() for t in _conv_inputs(
            ref_rng, 3, *g)[:3]), *g[-2:]) for g in CONV_GEOMS]
    timed, bf16_timed = [], []
    for name, side, cin, cout, k, s, p in ALEX_CONVS:
        geom = ((s, s), (p, p, p, p))
        x, wt, b, e = inputs = _conv_inputs(rng, ALEX_BATCH, side, side,
                                            cin, cout, k, *geom)
        checks.append(_conv_check(name, inputs, *geom))
        xb, wb, bb = (t.bfloat16() for t in (x, wt, b))
        bf16_checks.append(_bf16_conv_check(name, xb, wb, bb, *geom))
        xbn = xb.permute(0, 3, 1, 2).contiguous(
            memory_format=torch.channels_last)
        wbn = wb.permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last)
        bf16_timed.append({
            "layer": name, "kernel": "fwd_bf16",
            "tile": [kconv.BF16_TILE_M, kconv.fwd_bf16_tile(cout)],
            "ms": time_cuda_ms(lambda: kconv.conv2d_fwd(xb, wb, bb, *geom)),
            "plain_ms": time_cuda_ms(
                lambda: kconv.conv2d_fwd_plain(xb, wb, bb, *geom)),
            "library_ms": time_cuda_ms(
                lambda: torch.nn.functional.conv2d(xbn, wbn, bb, stride=s,
                                                   padding=p)),
            **kconv.bound("fwd", x.shape, wt.shape, *geom,
                          dtype=torch.bfloat16)})
        del xb, wb, bb, xbn, wbn
        lib = _conv_library(x, wt, b, e, *geom)
        runs = {"fwd": (lambda: kconv.conv2d_fwd(x, wt, b, *geom),
                        lambda: kconv.conv2d_fwd_plain(x, wt, b, *geom)),
                "input_grad": (
                    lambda: kconv.conv2d_input_grad(e, wt, *geom,
                                                    (side, side)),
                    lambda: kconv.conv2d_input_grad_plain(e, wt, *geom,
                                                          (side, side))),
                "weight_grad": (
                    lambda: kconv.conv2d_weight_grad(x, e, wt.shape, *geom),
                    lambda: kconv.conv2d_weight_grad_plain(x, e, wt.shape,
                                                           *geom))}
        for kind, (kernel, plain) in runs.items():
            if kind == "input_grad" and name == "conv1":
                continue        # checked above; AlexNet never launches it
            row = {"layer": name, "kernel": kind,
                   "tile": list(kconv.input_grad_tile(cin))
                   if kind == "input_grad" else
                   fwd_f32_tile_of(e.numel() // cout, cout),
                   "ms": time_cuda_ms(kernel),
                   "plain_ms": time_cuda_ms(plain),
                   "library_ms": time_cuda_ms(lib[kind]),
                   **kconv.bound(kind, x.shape, wt.shape, *geom)}
            if kind == "weight_grad":
                row.update(kconv.weight_grad_grid(
                    k * k * cin + 1, cout, e.numel() // cout))
            if kind != "input_grad":
                row["library_kernels"] = device_kernels(lib[kind])
            timed.append(row)
        del x, wt, b, e, inputs, lib, runs
    # one train minibatch of AlexNet eager runs every layer's forward and
    # weight gradient and conv2-5's input gradients (conv1 needs none)
    path = {}
    for kind in CONV_TOL:
        path[kind] = _summed([t for t in timed if t["kernel"] == kind],
                             max(c[kind]["max_abs_err"] for c in checks))
    path["fwd_bf16"] = _summed(bf16_timed, max(c["max_abs_err"]
                                               for c in bf16_checks))
    usage = ptxas_usage("conv")
    if tiles["fwd_f32"] is not None:
        by = tiles["fwd_f32"]["blocks_per_sm_by_gather"]
        with_blocks(usage, "conv_fwd_kernel",
                    lambda bm, bn, vec: by[f"{bm}x{bn}/{vec}"])
    return {"phase": "conv", "ptxas": usage,
            "sass_hgmma": hgmma, "tiles": tiles, "tol": CONV_TOL,
            "bf16_tol": CONV_BF16_TOL, "checks": checks,
            "bf16_checks": bf16_checks, "timed": timed + bf16_timed,
            "path": path,
            "path_note": "sums over the launches of one AlexNet train "
                         "minibatch at batch 128 (fwd_bf16: its five "
                         "forwards in bf16)"}


def _summed(rows, max_abs_err) -> dict:
    """Timed rows of one kernel summed over the layers of a path."""
    out = {key: sum(t[key] for t in rows)
           for key in ("ms", "plain_ms", "library_ms", "bound_ms", "flops",
                       "bytes")}
    out.update(layers=[t["layer"] for t in rows],
               bound_by="operations" if all(t["bound_by"] == "operations"
                                            for t in rows) else "bytes",
               max_abs_err=max_abs_err)
    return out


#: alexnet_eager: alexnet.build(fused=False) at its defaults (227 px,
#: batch 128, 1000 classes, dropout 0.5, lr 0.01, momentum 0.9, decay
#: 5e-4); the synthetic loader (50 classes) gets n_train 384 and n_valid
#: 128, so 350 train and 100 validation samples: 3 train and 1 validation
#: minibatches an epoch, for 2 epochs
ALEX_EPOCHS, ALEX_TRAIN, ALEX_VALID = 2, 384, 128
#: the loader serve whose minibatch is profiled: the first epoch's second
#: train minibatch (serve 0 is the validation pass, serves 1-3 train;
#: serve 1 warms the tracer up)
ALEX_PROFILED_SERVE = 2
#: the kernel launches one epoch takes: conv2d_fwd at every conv layer of
#: every minibatch, conv2d_input_grad at conv2-5 (conv1 needs no input
#: gradient) and conv2d_weight_grad at every conv layer of every train
#: minibatch
ALEX_TRAIN_MB, ALEX_EVAL_MB = 3, 1
#: alexnet_parity: AlexNet's geometry at 67 px with narrow widths (conv
#: 8/16/16/16/8, fc 32/32, 10 classes), batch 8, 30 train and 10
#: validation samples, lr 0.03, dropout 0.5 with the same masks injected
#: on both sides (the card's and the CPU's generators draw different
#: bits), 3 epochs, f32: the card (the kernels; TF32 off) against the
#: port on the CPU (the plain versions).  Both sum the same f32 products
#: in other orders: the port's CPU run and the JAX package's differ by
#: 6e-8 on these weights (tests/test_torch_port_alexnet.py), so the band
#: is 1e-6, which the same run with TF32 on must fail (its softmax
#: layer's products keep 10 mantissa bits: ~5e-4 relative a product)
ALEX_PARITY_EPOCHS, ALEX_PARITY_WEIGHT_ATOL = 3, 1e-6


def small_alexnet_layers(dropout: float, lr: float) -> list:
    """alexnet.layers at the parity test's narrow widths."""
    specs = talexnet.layers(n_classes=10, lr=lr, dropout=dropout)
    widths = iter((8, 16, 16, 16, 8))
    for spec in specs:
        if spec["type"] == "conv_str":
            spec["->"]["n_kernels"] = next(widths)
        elif spec["type"] == "all2all_str":
            spec["->"]["output_sample_shape"] = 32
    return specs


def inject_dropout_masks(w, seed: int) -> None:
    """Make every dropout unit of ``w`` draw its masks from one numpy
    stream (the same masks on any device, in serve order)."""
    rng = np.random.default_rng(seed)
    for fwd in w.forwards:
        if isinstance(fwd, tdropout.DropoutForward):
            def mask(shape, device, ratio=fwd.dropout_ratio):
                keep = rng.random(shape, dtype=np.float32) >= ratio
                return torch.tensor(keep / np.float32(1.0 - ratio),
                                    dtype=torch.float32, device=device)
            fwd._make_mask_torch = mask


def _conv_fc_weights(w) -> dict:
    """Host copies of every conv and FC layer's weights and bias."""
    return {f.name: (f.weights.map_read().copy(), f.bias.map_read().copy())
            for f in w.forwards if f.weights}


#: the max-pool backward at AlexNet's pool1 (k3 s2 over 55 x 55 x 96 at
#: batch 128): a peak at every (4p + 2, 4q + 2) of the input is the
#: maximum of every window that holds it, so each inner peak wins all
#: four of its windows (13 x 13 cells a channel); the scatter_add_ form
#: the port had before runs this many times beside the deterministic one
POOL_BWD_SHAPE, POOL_BWD_WINDOW = (128, 55, 55, 96), (3, 3, 2, 2)
POOL_BWD_FOUR_TERM_CELLS = 128 * 96 * 13 * 13
POOL_BWD_OLD_RUNS = 4


def pool_backward_check() -> dict:
    """``ops/pooling.py scatter_backward`` at AlexNet's pool1 on the card:
    offsets from the port's max-pool forward over an input whose peaks
    win four windows each, a normal error; two runs bit-identical and
    equal to ``np.add.at`` (the numpy branch, the reference's code) on
    the host's copy, each timed.  The old ``scatter_add_`` form (atomics)
    runs POOL_BWD_OLD_RUNS times beside it: whether its runs differ from
    each other and from ``np.add.at`` is recorded, not gated."""
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 41)
    n, h, w, c = POOL_BWD_SHAPE
    ky, kx, sy, sx = POOL_BWD_WINDOW
    x = torch.rand(POOL_BWD_SHAPE, generator=gen, device=DEVICE)
    x[:, 2::4, 2::4] += 10.0
    _, off = tpool_ops.max_forward(torch, x, ky, kx, sy, sx)
    del x
    err = torch.randn(off.shape, generator=gen, device=DEVICE)
    flat = off.reshape(n, -1, c).long()
    terms = torch.zeros((n, h * w, c), dtype=torch.int32, device=DEVICE)
    terms.scatter_add_(1, flat, torch.ones_like(flat, dtype=torch.int32))
    four = int((terms == 4).sum())
    if four != POOL_BWD_FOUR_TERM_CELLS:
        fail(f"pool backward input: {four} four-term cells, want "
             f"{POOL_BWD_FOUR_TERM_CELLS}")

    def run():
        return tpool_ops.scatter_backward(torch, err, off, POOL_BWD_SHAPE,
                                          POOL_BWD_WINDOW)

    def old():
        out = torch.zeros((n, h * w, c), device=DEVICE)
        out.scatter_add_(1, flat, err.reshape(n, -1, c))
        return out.reshape(POOL_BWD_SHAPE)

    first, second = run(), run()
    olds = [old() for _ in range(POOL_BWD_OLD_RUNS)]
    torch.cuda.synchronize()
    want = tpool_ops.scatter_backward(np, err.cpu().numpy(),
                                      off.cpu().numpy(), POOL_BWD_SHAPE)

    def bits_of(t):
        return t.cpu().numpy().view(np.int32)
    out = {"shape": list(POOL_BWD_SHAPE), "window": list(POOL_BWD_WINDOW),
           "four_term_cells": four,
           "cells_of_3_or_more_terms": int((terms >= 3).sum()),
           "identical_runs": bool(torch.equal(first, second)),
           "equals_np_add_at": bool(np.array_equal(bits_of(first),
                                                   want.view(np.int32))),
           "old_runs": POOL_BWD_OLD_RUNS,
           "old_runs_differ": any(not torch.equal(olds[0], o)
                                  for o in olds[1:]),
           "old_runs_equal_np_add_at": [
               bool(np.array_equal(bits_of(o), want.view(np.int32)))
               for o in olds],
           "old_max_abs_diff": float((olds[0] - first).abs().max()),
           "ms": time_cuda_ms(run, iters=10),
           "old_ms": time_cuda_ms(old, iters=10)}
    if not (out["identical_runs"] and out["equals_np_add_at"]):
        fail(f"scatter_backward on the card is not np.add.at's: {out}")
    return out


def phase_pool_backward() -> dict:
    return {"phase": "pool_backward", **pool_backward_check()}


def phase_alexnet_eager() -> dict:
    """alexnet.build(fused=False) at its defaults on TorchDevice() through
    Workflow.run: every conv layer on the conv kernels, fc6/fc7 on the FC
    kernels, the conv and FC counters set to 0 just before the run and
    read just after; one train minibatch profiled; then the max-pool
    backward's determinism at pool1 (:func:`pool_backward_check`)."""
    from torch.profiler import ProfilerActivity, profile, schedule

    tprng.seed_all(SEED)
    w = talexnet.build(max_epochs=ALEX_EPOCHS, n_train=ALEX_TRAIN,
                       n_valid=ALEX_VALID, fused=False)
    t0 = time.perf_counter()
    w.initialize(device=TorchDevice())
    init_s = time.perf_counter() - t0
    before = _conv_fc_weights(w)
    marks = _per_minibatch_marks(w)
    # the minibatch before the window warms the tracer up: started cold at
    # the window, it missed the window's first activities (it recorded no
    # upload and 4 of the 5 conv2d_fwd launches)
    prof = profile(activities=[ProfilerActivity.CUDA],
                   schedule=schedule(wait=0, warmup=1, active=1, repeat=1))
    window, serve_ms, served_rows = {}, [], []
    served = w.loader.run

    def run():  # the window: from serve ALEX_PROFILED_SERVE to the next
        n = len(marks)              # serves so far
        if n == ALEX_PROFILED_SERVE - 1:
            prof.start()
        elif n == ALEX_PROFILED_SERVE:
            torch.cuda.synchronize()
            prof.step()
            window["t0"] = time.perf_counter()
        elif n == ALEX_PROFILED_SERVE + 1:
            torch.cuda.synchronize()
            window["wall_ms"] = (time.perf_counter() - window["t0"]) * 1e3
            prof.step()
        served()
        torch.cuda.synchronize()    # the serve: host gather + upload
        serve_ms.append((time.perf_counter() - marks[-1][0]) * 1e3)
        served_rows.append(int(w.loader.minibatch_size))  # unpadded

    w.loader.run = run
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kconv.fwd_launches = kconv.input_grad_launches = 0   # 0 just before ...
    kconv.weight_grad_launches = 0
    kgemm.gemm_launches = kgemm.act_launches = 0
    t0 = time.perf_counter()
    w.run()
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    prof.stop()
    launches = {"conv2d_fwd": kconv.fwd_launches,         # ... read after
                "conv2d_input_grad": kconv.input_grad_launches,
                "conv2d_weight_grad": kconv.weight_grad_launches,
                "gemm_fc": kgemm.gemm_launches,
                "act_backward": kgemm.act_launches}
    peak = torch.cuda.max_memory_allocated()
    marks.append((time.perf_counter(), None))
    per_epoch = ALEX_TRAIN_MB + ALEX_EVAL_MB
    last = marks[-per_epoch - 1:]
    train_ms = [(b[0] - a[0]) * 1e3 for a, b in zip(last, last[1:])
                if a[1] == 2]
    loader_ms = [t for t, m in zip(serve_ms[-per_epoch:], last)
                 if m[1] == 2]
    train_rows = sum(r for r, m in zip(served_rows[-per_epoch:], last)
                     if m[1] == 2)
    device = [e for e in prof.key_averages()
              if str(e.device_type).endswith("CUDA")
              and e.self_device_time_total > 0]
    busy_ms = sum(e.self_device_time_total for e in device) / 1e3
    conv_ms = sum(e.self_device_time_total for e in device
                  if "conv_" in e.key or "reduce_splits" in e.key) / 1e3
    fc_ms = sum(e.self_device_time_total for e in device
                if "gemm_f32" in e.key or "gemm_reduce" in e.key) / 1e3
    top = sorted(device, key=lambda e: -e.self_device_time_total)[:10]
    after = _conv_fc_weights(w)
    hist = w.decision.metrics_history
    n_train_mb, n_eval_mb = (ALEX_EPOCHS * ALEX_TRAIN_MB,
                             ALEX_EPOCHS * ALEX_EVAL_MB)
    expect = {"conv2d_fwd": 5 * (n_train_mb + n_eval_mb),
              "conv2d_input_grad": 4 * n_train_mb,
              "conv2d_weight_grad": 5 * n_train_mb}
    med = float(np.median(train_ms))
    out = {"phase": "alexnet_eager", "batch": 128, "input": 227,
           "classes": 1000, "dropout": 0.5, "lr": 0.01,
           "epochs": ALEX_EPOCHS, "n_train": ALEX_TRAIN,
           "n_valid": ALEX_VALID, "train_minibatches": n_train_mb,
           "eval_minibatches": n_eval_mb, "init_s": init_s,
           "wall_s": wall_s, "history": hist, "launches": launches,
           "train_minibatch_ms": med, "train_minibatch_ms_all": train_ms,
           "train_samples": train_rows,
           "samples_per_s": train_rows / (sum(train_ms) / 1e3),
           "peak_mem_bytes": peak,
           "loader_serve_ms": float(np.median(loader_ms)),
           "loader_serve_ms_all": loader_ms,
           # host seconds inside each unit's run over the whole run (a
           # unit that syncs, like the evaluator, also waits there for
           # the device work queued before it)
           "unit_host_s": dict(sorted(
               ((u.name, u.timing[1]) for u in w.units),
               key=lambda kv: -kv[1])[:10]),
           "timing": "host clock between device-synced loader serves, "
                     "last epoch's train minibatches, median; samples/s: "
                     "their unpadded samples over their summed time",
           "profile": {"serve": ALEX_PROFILED_SERVE,
                       "wall_ms": window.get("wall_ms"),
                       "device_busy_ms": busy_ms,
                       "device_ops": sum(e.count for e in device),
                       "conv_kernels_ms": conv_ms,
                       "fc_gemm_kernels_ms": fc_ms,
                       "device_idle_share": 1 - busy_ms / window["wall_ms"]
                       if window.get("wall_ms") else None,
                       "top_device": [
                           {"name": e.key[:80], "count": e.count,
                            "ms": e.self_device_time_total / 1e3}
                           for e in top]}}
    if not (len(hist) == ALEX_EPOCHS and bool(w.decision.complete)):
        fail(f"alexnet eager did not finish its epochs: {hist}")
    finite = all(np.isfinite(v) for h in hist for v in h.values()) and \
        np.isfinite(w.evaluator.max_err_output_sum) and \
        bool(np.isfinite(w.evaluator.err_output.map_read()).all())
    if not finite:
        fail(f"alexnet eager metrics not finite: {out}")
    unchanged = [name for name, (wb, bb) in before.items()
                 if np.array_equal(after[name][0], wb)
                 or np.array_equal(after[name][1], bb)]
    if unchanged:
        fail(f"alexnet eager left weights unchanged: {unchanged}")
    if any(launches[k] != v for k, v in expect.items()):
        fail(f"conv launches {launches} != {expect}")
    if launches["gemm_fc"] < 6 * n_train_mb + 2 * n_eval_mb or \
            launches["act_backward"] < 2 * n_train_mb:
        fail(f"FC launches {launches} for {n_train_mb} train + {n_eval_mb} "
             f"eval minibatches")
    if not conv_ms > 0:
        fail(f"the profiled minibatch shows no conv kernel: {out}")
    del w
    out["pool_backward"] = pool_backward_check()
    return out


def _alexnet_parity_run(device, allow_tf32=False):
    """The test-size AlexNet from one seed on ``device`` in f32 -> (n_err
    history, conv and FC weights)."""
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = allow_tf32
    try:
        tprng.seed_all(SEED)
        w = StandardWorkflow(
            name="AlexNet-small", layers=small_alexnet_layers(0.5, 0.03),
            loss_function="softmax", loader_name="synthetic_image",
            loader_config={"n_classes": 10, "sample_shape": (67, 67, 3),
                           "n_train": 32, "n_valid": 16, "minibatch_size": 8,
                           "spread": 1.0, "noise": 0.5},
            decision_config={"max_epochs": ALEX_PARITY_EPOCHS}, fused=False)
        w.initialize(device=TorchDevice(device, precision="float32"))
        inject_dropout_masks(w, SEED)
        w.run()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    return w.decision.metrics_history, _conv_fc_weights(w)


def phase_alexnet_parity() -> dict:
    """The test-size AlexNet in f32, the card against the CPU: identical
    n_err histories, weights within the band, which TF32 must fail."""
    card, cpu = _alexnet_parity_run(DEVICE), _alexnet_parity_run("cpu")
    tf32 = _alexnet_parity_run(DEVICE, allow_tf32=True)

    def spread(a, b):
        return max(float(np.abs(x - y).max()) for name in a
                   for x, y in zip(a[name], b[name]))

    out = {"phase": "alexnet_parity", "epochs": ALEX_PARITY_EPOCHS,
           "band": {"weight_atol": ALEX_PARITY_WEIGHT_ATOL},
           "history_card": card[0], "history_cpu": cpu[0],
           "weight_max_abs": spread(card[1], cpu[1]),
           "tf32_control": {"history": tf32[0],
                            "weight_max_abs": spread(tf32[1], cpu[1])}}
    if card[0] != cpu[0]:
        fail(f"alexnet n_err history card {card[0]} != cpu {cpu[0]}")
    if not out["weight_max_abs"] <= ALEX_PARITY_WEIGHT_ATOL:
        fail(f"alexnet weights card vs cpu: {out}")
    if not out["tf32_control"]["weight_max_abs"] > ALEX_PARITY_WEIGHT_ATOL:
        fail(f"the alexnet weight band passes the TF32 control: {out}")
    return out


#: deconv phase: build_deep's two deconv layers at its defaults
#: (models/autoencoder.py: 64x64x3, n_kernels (64, 128), batch 64, k4 s2
#: p1): name, input side, n_kernels (its input's channels), n_channels
AE_BATCH = 64
AE_DECONVS = (("deconv1", 16, 128, 64), ("deconv2", 32, 64, 3))
AE_GEOM = ((2, 2), (1, 1, 1, 1))
#: the deconv wrappers vs their plain versions (f32, TF32 off), as the
#: largest norm-relative error of any 64-row tile: the forward is the
#: input-gradient kernel and err_input the forward kernel, each summing
#: <= 1024 products a value in another order than the plain tap loop
#: (u·sqrt(K/2) ~ 1.3e-6), so the conv phase's 1e-5; grad_w sums the
#: n·oh·ow = 16384 and 65536 pixels of the batch, so the conv weight
#: gradient's 1e-4.  Controls: the forward with the centre tap's weights
#: zeroed, err_input with the last k tile skipped, grad_w with one
#: split-K slice of x zeroed
DECONV_TOL = {"deconv2d": 1e-5, "err_input": 1e-5, "grad_w": 1e-4}


def _deconv_check(name, x, wt, e, sliding, padding) -> dict:
    """Both deconv wrappers at one geometry against their plain versions,
    two launches bit for bit, each band rejecting its control."""
    geom = (sliding, padding)
    ky, kx, c, nk = wt.shape
    out_shape = tuple(e.shape)
    got = {"deconv2d": kconv.deconv2d(x, wt, *geom, out_shape),
           **dict(zip(("err_input", "grad_w"),
                      kconv.deconv2d_backward(x, wt, e, *geom)))}
    again = {"deconv2d": kconv.deconv2d(x, wt, *geom, out_shape),
             **dict(zip(("err_input", "grad_w"),
                        kconv.deconv2d_backward(x, wt, e, *geom)))}
    want = {"deconv2d": kconv.deconv2d_plain(x, wt, *geom, out_shape),
            **dict(zip(("err_input", "grad_w"),
                       kconv.deconv2d_backward_plain(x, wt, e, *geom)))}
    w_tap = wt.clone()
    w_tap[ky // 2, kx // 2] = 0
    k_all = ky * kx * c
    w_skip = wt.clone()
    w_skip.view(k_all, nk)[(k_all - 1) // kconv.K_TILE * kconv.K_TILE:] = 0
    splits, per = kconv.split_k(k_all + 1, nk, x.numel() // nk)
    x_cut = x.clone()
    x_cut.view(-1, nk)[splits // 2 * per:(splits // 2 + 1) * per] = 0
    wrong = {"deconv2d": kconv.deconv2d(x, w_tap, *geom, out_shape),
             "err_input": kconv.deconv2d_backward(x, w_skip, e, *geom)[0],
             "grad_w": kconv.deconv2d_backward(x_cut, wt, e, *geom)[1]}
    torch.cuda.synchronize()
    report = {"case": name, "x": list(x.shape), "w": list(wt.shape),
              "out_shape": list(out_shape), "splits": splits, "per": per}
    for kind, tol in DECONV_TOL.items():
        width = got[kind].shape[-1]
        r = {"rel_err": tile_rel_err(_rows(got[kind], width),
                                     _rows(want[kind], width)),
             "control_rel_err": tile_rel_err(_rows(wrong[kind], width),
                                             _rows(want[kind], width)),
             "max_abs_err": _max_abs(got[kind], want[kind]),
             "deterministic": bool(torch.equal(got[kind], again[kind]))}
        report[kind] = r
        if not bool(torch.isfinite(got[kind]).all()):
            fail(f"non-finite deconv {kind} ({report})")
        if not r["rel_err"] <= tol:
            fail(f"deconv {kind} vs plain {r['rel_err']} > {tol} "
                 f"({report})")
        if not r["control_rel_err"] > tol:
            fail(f"the deconv {kind} band passes its control ({report})")
        if not r["deterministic"]:
            fail(f"deconv {kind} differs between two launches ({report})")
    return report


def _ae_input_grads(rng) -> tuple:
    """The input-gradient kernel timed at build_deep's two launches of
    it that are not a deconv wrapper's own row: conv2's input gradient
    (cin 64) and deconv2's forward as the conv input gradient it is (cin
    3, through conv2d_input_grad), each beside its plain version, cuDNN
    (torch.nn.grad.conv2d_input) and the bound, with its tile; first
    the three conv kernels checked there as :func:`_conv_check` checks
    them.  Returns the timed rows and the checks."""
    rows, checks = [], []
    for name, side, cin, cout in (("conv2", 32, 64, 128),
                                  ("deconv2_fwd", 64, 3, 64)):
        x, wt, b, e = inputs = _conv_inputs(rng, AE_BATCH, side, side, cin,
                                            cout, 4, *AE_GEOM)
        checks.append(_conv_check(f"build_deep {name}", inputs, *AE_GEOM))
        lib = _conv_library(x, wt, b, e, *AE_GEOM)["input_grad"]
        rows.append({
            "layer": name, "kernel": "input_grad",
            "tile": list(kconv.input_grad_tile(cin)),
            "ms": time_cuda_ms(lambda: kconv.conv2d_input_grad(
                e, wt, *AE_GEOM, (side, side))),
            "plain_ms": time_cuda_ms(lambda: kconv.conv2d_input_grad_plain(
                e, wt, *AE_GEOM, (side, side))),
            "library_ms": time_cuda_ms(lib),
            **kconv.bound("input_grad", x.shape, wt.shape, *AE_GEOM)})
        del x, wt, b, e, inputs, lib
    return rows, checks


def phase_deconv() -> dict:
    """The deconv wrappers against their plain versions in f32 (TF32 off)
    at build_deep's two deconv layers at batch 64, bit-identical across
    launches, each band rejecting its control; each wrapper, its plain
    version and PyTorch's one call for the same function timed
    (F.conv_transpose2d; aten.convolution_backward of the transposed conv
    for err_input and grad_w together), with the bound from this run's
    inputs.  deconv2's forward is the input-gradient kernel at cin 3; the
    input gradient is also timed as itself at build_deep's conv2 and
    deconv2 (:func:`_ae_input_grads`)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.default_rng(SEED + 17)
    checks, timed = [], []
    for name, side, nk, c in AE_DECONVS:
        x = _dev(rng.normal(size=(AE_BATCH, side, side, nk)))
        wt = _dev(rng.normal(size=(4, 4, c, nk)) / np.sqrt(16 * nk))
        out_shape = tdeconv_ops.output_shape_for(x.shape, wt.shape,
                                                 *AE_GEOM)
        e = _dev(rng.normal(size=out_shape))
        checks.append(_deconv_check(name, x, wt, e, *AE_GEOM))
        cl = torch.channels_last
        xn = x.permute(0, 3, 1, 2).contiguous(memory_format=cl)
        wn = wt.permute(3, 2, 0, 1).contiguous(memory_format=cl)
        en = e.permute(0, 3, 1, 2).contiguous(memory_format=cl)
        (sy, sx), (pt, _, pl, _) = AE_GEOM
        timed.append({
            "layer": name, "kernel": "deconv2d",
            "tile": list(kconv.input_grad_tile(c)),
            "ms": time_cuda_ms(lambda: kconv.deconv2d(x, wt, *AE_GEOM,
                                                      out_shape)),
            "plain_ms": time_cuda_ms(lambda: kconv.deconv2d_plain(
                x, wt, *AE_GEOM, out_shape)),
            "library_ms": time_cuda_ms(
                lambda: torch.nn.functional.conv_transpose2d(
                    xn, wn, stride=(sy, sx), padding=(pt, pl))),
            **kconv.deconv_bound(x.shape, wt.shape, *AE_GEOM, out_shape)})
        timed.append({
            "layer": name, "kernel": "deconv2d_backward",
            **kconv.weight_grad_grid(16 * c + 1, nk, x.numel() // nk),
            "ms": time_cuda_ms(lambda: kconv.deconv2d_backward(
                x, wt, e, *AE_GEOM)),
            "plain_ms": time_cuda_ms(lambda: kconv.deconv2d_backward_plain(
                x, wt, e, *AE_GEOM)),
            "library_ms": time_cuda_ms(
                lambda: torch.ops.aten.convolution_backward(
                    en, xn, wn, None, (sy, sx), (pt, pl), (1, 1), True,
                    (0, 0), 1, (True, True, False))),
            **kconv.deconv_bound(x.shape, wt.shape, *AE_GEOM, out_shape,
                                 backward=True),
            "kernels": device_kernels(lambda: kconv.deconv2d_backward(
                x, wt, e, *AE_GEOM))})
        del x, wt, e, xn, wn, en
    ig_timed, ig_checks = _ae_input_grads(rng)
    timed += ig_timed
    path = {kind: _summed([t for t in timed if t["kernel"] == kind],
                          max(c[k]["max_abs_err"] for c in checks
                              for k in keys))
            for kind, keys in (("deconv2d", ("deconv2d",)),
                               ("deconv2d_backward",
                                ("err_input", "grad_w")))}
    return {"phase": "deconv", "tol": DECONV_TOL, "checks": checks,
            "conv_checks": ig_checks, "timed": timed, "path": path,
            "path_note": "sums over build_deep's two deconv layers at "
                         "batch 64: one train minibatch's launches of each "
                         "wrapper"}


#: ae_eager: build_deep at its defaults (64x64x3, n_kernels (64, 128),
#: batch 64, n_train 256, no validation), fused=False, 2 epochs: 4 train
#: minibatches an epoch, but at lr AE_LR.  The default lr, 0.001, is tuned
#: for the reference tests' 16x16 inputs; the summed MSE gradient grows
#: with the output area (16x at 64x64), and at 0.001 the reference's run
#: (eager and fused, JAX on the CPU, from this smoke's seed) and the
#: port's diverge to inf in the first epoch.  5e-5 (about 0.001/16) falls
#: every epoch in the port's CPU runs, eager and fused
AE_EPOCHS, AE_TRAIN, AE_LR = 2, 256, 5e-5
#: each train minibatch's launches, read from the code: conv2d_fwd's
#: kernel at the two convs' forwards and the two deconvs' err_input (the
#: first gd of a workflow, conv1's, needs no err_input; the deconvs' are
#: needed), the input-gradient kernel at the two deconvs' forwards and
#: conv2's input gradient, the weight-gradient kernel at all four layers;
#: one deconv2d and one deconv2d_backward call a deconv layer
AE_LAUNCHES = {"conv2d_fwd": 4, "conv2d_input_grad": 3,
               "conv2d_weight_grad": 4, "deconv2d": 2,
               "deconv2d_backward": 2}


def _ae_counts() -> dict:
    return {"conv2d_fwd": kconv.fwd_launches,
            "conv2d_input_grad": kconv.input_grad_launches,
            "conv2d_weight_grad": kconv.weight_grad_launches,
            "deconv2d": kconv.deconv_fwd_launches,
            "deconv2d_backward": kconv.deconv_bwd_launches}


def _zero_ae_counts() -> None:
    kconv.fwd_launches = kconv.input_grad_launches = 0
    kconv.weight_grad_launches = 0
    kconv.deconv_fwd_launches = kconv.deconv_bwd_launches = 0


def _ae_eager_run(profiled: bool):
    """build_deep eager at its defaults from SEED on the card: (workflow,
    minibatch marks, launches, wall s, profiler or None)."""
    from torch.profiler import ProfilerActivity, profile, schedule

    tprng.seed_all(SEED)
    w = tautoencoder.build_deep(max_epochs=AE_EPOCHS, n_train=AE_TRAIN,
                                fused=False, lr=AE_LR)
    w.initialize(device=TorchDevice())
    marks = _per_minibatch_marks(w)
    prof = None
    if profiled:
        # one warm-up step on a tiny op first: a tracer started cold at
        # the run misses its first activities (alexnet_eager's finding)
        prof = profile(activities=[ProfilerActivity.CUDA],
                       schedule=schedule(wait=0, warmup=1, active=1,
                                         repeat=1))
        prof.start()
        torch.ones(1, device=DEVICE).add_(1)
        torch.cuda.synchronize()
        prof.step()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_ae_counts()                                    # 0 just before ...
    t0 = time.perf_counter()
    w.run()
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    if prof is not None:
        prof.step()
        prof.stop()
    launches = _ae_counts()                              # ... read after
    marks.append((time.perf_counter(), None))
    return w, marks, launches, wall_s, prof


def phase_ae_eager() -> dict:
    """build_deep(fused=False) at its defaults on TorchDevice() through
    Workflow.run: the convs and deconvs on the conv kernels, the launch
    counters set to 0 just before and read just after; a second run from
    the same seed, profiled, must end bit-identical."""
    w, marks, launches, wall_s, _ = _ae_eager_run(False)
    peak = torch.cuda.max_memory_allocated()
    w2, _, launches2, wall2_s, prof = _ae_eager_run(True)
    n_mb = AE_EPOCHS * AE_TRAIN // AE_BATCH
    per_epoch = AE_TRAIN // AE_BATCH
    last = marks[-per_epoch - 1:]
    train_ms = [(b[0] - a[0]) * 1e3 for a, b in zip(last, last[1:])]
    device = [e for e in prof.key_averages()
              if str(e.device_type).endswith("CUDA")
              and e.self_device_time_total > 0]
    busy_ms = sum(e.self_device_time_total for e in device) / 1e3
    conv_ms = sum(e.self_device_time_total for e in device
                  if "conv_" in e.key or "reduce_splits" in e.key) / 1e3
    top = sorted(device, key=lambda e: -e.self_device_time_total)[:8]
    hist = w.decision.metrics_history
    expect = {k: v * n_mb for k, v in AE_LAUNCHES.items()}
    same_weights = all(np.array_equal(a.weights.map_read(),
                                      b.weights.map_read())
                       for a, b in zip(w.forwards, w2.forwards))
    out = {"phase": "ae_eager", "input": [64, 64, 3], "n_kernels": [64, 128],
           "batch": AE_BATCH, "epochs": AE_EPOCHS, "n_train": AE_TRAIN,
           "lr": AE_LR,
           "train_minibatches": n_mb, "history": hist,
           "launches": launches, "expected_launches": expect,
           "wall_s": wall_s, "train_minibatch_ms": float(np.median(train_ms)),
           "train_minibatch_ms_all": train_ms,
           "samples_per_s": AE_BATCH * len(train_ms) / (sum(train_ms) / 1e3),
           "peak_mem_bytes": peak,
           "timing": "host clock between device-synced loader serves, the "
                     "last epoch's train minibatches, median; samples/s: "
                     "their samples over their summed time",
           "second_run": {"history": w2.decision.metrics_history,
                          "launches": launches2, "wall_s": wall2_s,
                          "bit_identical": same_weights and
                          w2.decision.metrics_history == hist},
           "profile": {"run": "the second run, all of it",
                       "wall_ms": wall2_s * 1e3, "device_busy_ms": busy_ms,
                       "conv_kernels_ms": conv_ms,
                       "device_idle_share": 1 - busy_ms / (wall2_s * 1e3),
                       "top_device": [{"name": e.key[:80], "count": e.count,
                                       "ms": e.self_device_time_total / 1e3}
                                      for e in top]}}
    if not (len(hist) == AE_EPOCHS and bool(w.decision.complete)):
        fail(f"ae eager did not finish its epochs: {hist}")
    if not all(np.isfinite(v) for h in hist for v in h.values()) or \
            not hist[-1]["metric_train"] < hist[0]["metric_train"]:
        fail(f"ae eager train mse not finite and falling: {hist}")
    if [f.output.shape for f in w.forwards] != [
            (AE_BATCH, 32, 32, 64), (AE_BATCH, 16, 16, 128),
            (AE_BATCH, 32, 32, 64), (AE_BATCH, 64, 64, 3)]:
        fail(f"ae eager shapes {[f.output.shape for f in w.forwards]}")
    if launches != expect or launches2 != expect:
        fail(f"ae eager launches {launches} / {launches2} != {expect}")
    if not out["second_run"]["bit_identical"]:
        fail(f"two ae eager runs from one seed differ: {out}")
    if not conv_ms > 0:
        fail(f"the profiled ae run shows no conv kernel: {out}")
    return out


#: ae_parity: models/autoencoder.py build at its defaults but 3 epochs
#: (16x16x1, 8 kernels, batch 50, 500 + 150 samples: 30 train steps), and
#: build_deep shrunk as the CPU tests shrink it (16x16x3, n_kernels (8,
#: 16), batch 16, 64 samples, 3 epochs), in f32, the card against the
#: port on the CPU from one seed (the same initial weights: the host prng
#: draws them).  MSE histories: the reference's pin tolerance, rtol 1e-5.
#: Weights, eager: the kernels against their plain versions sum the same
#: f32 products in other orders, ~1e-7 of each step's gradient, and
#: momentum 0.9 carries those differences on: 1.07e-6 on the H100 after
#: build's 30 steps (the CPU tests' 16 steps against the JAX package:
#: 1.3e-7), so the band is 4e-6 (16 f32 ulps of the weights' 0.5).  The
#: eager path runs no TF32-capable library call (the conv kernels never
#: use TF32; SGD and the MSE are elementwise), so its TF32 run must equal
#: the TF32-off run bit for bit.  Fused (build): cuDNN against oneDNN,
#: the same band; its TF32 control (cuDNN's 10-bit products) must fail
#: the MSE band
AE_PARITY_EPOCHS = 3
AE_PARITY_ATOL = 4e-6
AE_PARITY_MSE_RTOL = 1e-5


def _ae_parity_run(build, device, fused=False, allow_tf32=False):
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = allow_tf32
    torch.backends.cudnn.allow_tf32 = allow_tf32
    try:
        tprng.seed_all(SEED)
        kw = {} if build == "build" else {
            "minibatch_size": 16, "sample_shape": (16, 16, 3),
            "n_kernels": (8, 16), "n_train": 64}
        w = getattr(tautoencoder, build)(max_epochs=AE_PARITY_EPOCHS,
                                         fused=fused, **kw)
        w.initialize(device=TorchDevice(device, precision="float32"))
        w.run()
        if fused:
            w.step.sync_to_units()
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32
    return ([[h[k] for k in sorted(h) if k.startswith("metric")]
             for h in w.decision.metrics_history],
            [np.array(f.weights.map_read()) for f in w.forwards],
            [f.output.shape for f in w.forwards])


def phase_ae_parity() -> dict:
    """build and a shrunk build_deep in f32, the card against the CPU,
    eager and (build) fused; the fused MSE band must reject TF32, and the
    eager path must not move under TF32.  Every run is made before the
    first check fails."""
    def spread(a, b):
        return max(float(np.abs(x - y).max()) for x, y in zip(a[1], b[1]))

    def mse_rel(a, b):
        return max(abs(x - y) / abs(y) for ra, rb in zip(a[0], b[0])
                   for x, y in zip(ra, rb))

    out = {"phase": "ae_parity", "epochs": AE_PARITY_EPOCHS,
           "bands": {"weight_atol": AE_PARITY_ATOL,
                     "mse_rtol": AE_PARITY_MSE_RTOL}}
    bad = []
    for build, fused in (("build", False), ("build_deep", False),
                         ("build", True)):
        kind = "fused" if fused else "eager"
        card = _ae_parity_run(build, DEVICE, fused)
        cpu = _ae_parity_run(build, "cpu", fused)
        tf32 = _ae_parity_run(build, DEVICE, fused, allow_tf32=True)
        r = out[f"{build}_{kind}"] = {
            "mse_card": card[0], "mse_cpu": cpu[0],
            "mse_rel": mse_rel(card, cpu), "weight_max_abs": spread(card,
                                                                    cpu),
            "weight_max": max(float(np.abs(x).max()) for x in cpu[1]),
            "output_shapes": [list(s) for s in card[2]],
            "tf32_control": {"mse": tf32[0], "mse_rel": mse_rel(tf32, cpu),
                             "weight_max_abs": spread(tf32, cpu),
                             "weight_max_abs_vs_card": spread(tf32, card)}}
        if card[2] != cpu[2] or (build == "build_deep" and [
                s[1] for s in card[2]] != [8, 4, 8, 16]):
            bad.append(f"{build} output shapes card {card[2]} cpu {cpu[2]}")
        if not r["mse_rel"] <= AE_PARITY_MSE_RTOL:
            bad.append(f"{build} {kind} mse card vs cpu")
        if not r["weight_max_abs"] <= AE_PARITY_ATOL:
            bad.append(f"{build} {kind} weights card vs cpu")
        if fused and not r["tf32_control"]["mse_rel"] > AE_PARITY_MSE_RTOL:
            bad.append("the fused ae mse band passes the TF32 control")
        if not fused and r["tf32_control"]["weight_max_abs_vs_card"] != 0:
            bad.append(f"the eager ae {build} moved under TF32")
    if bad:
        fail(f"ae_parity: {bad}: {out}")
    return out


#: ae_fused: bench.py bench_deconv_ae (:399-423): build_deep from seed 7,
#: batch 64, no validation (n_train 4 minibatches, for the epochs through
#: Workflow.run after the staged calls), one seeded batch and its K = 64
#: rolled copies staged on the card (identity targets), bf16 compute over
#: f32 masters (the card's default), SGD momentum 0.9; one warm call of
#: train_steps, AE_FUSED_REPS timed with CUDA events, one profiled.  The
#: step's work does not depend on the lr, but its loss does: the 320
#: steps fit one batch, and the fit turns unstable as it sharpens, into
#: a spike and a dead net at loss 0.5 (every soft ReLU saturated) after
#: ~40 steps at 5e-5 and ~120 at 5e-6 (the port fused in f32 on the CPU;
#: the bench's 0.001 goes to inf at once), so the smoke trains at 1e-6,
#: where the loss falls through all 320
AE_FUSED_K, AE_FUSED_REPS, AE_FUSED_LR = 64, 3, 1e-6
#: then AEF_EPOCHS epochs of AEF_TRAIN_MB minibatches through
#: Workflow.run: one warm, two timed on the host clock, one profiled
AEF_EPOCHS, AEF_TRAIN_MB, AEF_WARM, AEF_TIMED = 4, 4, 4, 8


def _ae_step_flops(w, exact: bool) -> float:
    """Training flops of one minibatch: 3x the forward's multiply-adds x
    2.  ``exact`` counts what each layer computes (a deconv as its paired
    conv's products); otherwise the reference's count
    (znicz_tpu/utils/flops.py forward_flops: output positions x
    kx·ky·c_in x c_out for conv and deconv alike, which for a stride-2
    deconv counts the dilated zeros, 4x its products)."""
    total = 0.0
    for f in w.forwards:
        n, h, wd, c_out = f.output.shape
        c_in = f.input.shape[3]
        if exact and isinstance(f, tdeconv_unit.Deconv):
            total += 2.0 * n * np.prod(f.input.shape[1:3]) * f.kx * f.ky * \
                c_in * c_out
        else:
            total += 2.0 * n * h * wd * f.kx * f.ky * c_in * c_out
    return 3.0 * total


def _ae_fused_setup():
    """bench_deconv_ae's build_deep (64x64x3, batch 64) fused on the card
    for AEF_EPOCHS epochs -> ``(w, xs, ms)``: AE_FUSED_K staged batches
    (rolled copies of one normal batch) and their masks."""
    tprng.seed_all(7)
    w = tautoencoder.build_deep(max_epochs=AEF_EPOCHS,
                                minibatch_size=AE_BATCH,
                                n_train=AE_BATCH * AEF_TRAIN_MB, n_valid=0,
                                lr=AE_FUSED_LR)
    w.initialize(device=TorchDevice())
    x = torch.tensor(np.random.default_rng(0).normal(
        size=(AE_BATCH, 64, 64, 3)), dtype=torch.float32, device=DEVICE)
    idx = torch.tensor((np.arange(AE_BATCH)[None, :] -
                        np.arange(AE_FUSED_K)[:, None]) % AE_BATCH,
                       device=DEVICE)
    return w, x[idx], torch.ones((AE_FUSED_K, AE_BATCH), dtype=torch.bool,
                                 device=DEVICE)


def phase_ae_fused() -> dict:
    """bench_deconv_ae's configuration through build_deep(fused=True) on
    the card, every step a graph replay but each body's first: K-step
    train_steps calls (one warm, AE_FUSED_REPS timed, one profiled), then
    AEF_EPOCHS epochs through Workflow.run (warm, timed, profiled); the
    SGD update kernel's counter set to 0 just before and
    read just after.  The forward and backward run cuDNN (torch_apply's
    F.conv2d and F.conv_transpose2d under autograd), not the hand-written
    conv kernels: the reference's fused step runs XLA's convs, not its
    Pallas kernels."""
    w, xs, ms = _ae_fused_setup()
    step = w.step
    n_values = AE_BATCH * AE_FUSED_K * 64 * 64 * 3
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_ae_counts()
    koptim.sgd_launches = 0                          # 0 just before ...
    losses = [float(step.train_steps(xs, xs, ms)["loss"]) / n_values]
    timed = timed_train_steps(step, xs, xs, ms, AE_FUSED_REPS)
    losses += [float(m["loss"]) / n_values for m in timed.pop("metrics")]
    peak = torch.cuda.max_memory_allocated()
    run = workflow_run_profiled(w, AEF_WARM, AEF_TIMED)
    sgd_n = koptim.sgd_launches                      # ... read just after
    hand_conv = _ae_counts()
    staged = AE_FUSED_K * (2 + AE_FUSED_REPS) + ONE_STEP_CALLS
    steps = staged + AEF_EPOCHS * AEF_TRAIN_MB
    replays = replays_of(step)
    want_replays = {"steps": staged - 1,
                    "train": AEF_EPOCHS * AEF_TRAIN_MB - 1}
    sps = AE_BATCH / (timed["step_ms"] / 1e3)
    out = {"phase": "ae_fused",
           "config": {"input": [64, 64, 3], "n_kernels": [64, 128],
                      "batch": AE_BATCH, "K": AE_FUSED_K, "seed": 7,
                      "optimizer": "sgd", "momentum": 0.9,
                      "lr": AE_FUSED_LR,
                      "compute": str(step.compute_dtype),
                      "timed_calls": AE_FUSED_REPS, "epochs": AEF_EPOCHS,
                      "train_minibatches": AEF_TRAIN_MB},
           "route": "cuDNN (torch_apply under autograd) and the SGD "
                    "update kernel, in CUDA graph replays; not the "
                    "hand-written conv kernels",
           "losses_per_value": losses, **timed, "samples_per_s": sps,
           "mfu": _ae_step_flops(w, False) / AE_BATCH * sps / BF16_FLOPS,
           "mfu_exact_products": _ae_step_flops(w, True) / AE_BATCH * sps /
           BF16_FLOPS,
           "mfu_note": "mfu counts the reference's flops (bench.py's, "
                       "deconv dilated zeros included); "
                       "mfu_exact_products the products computed",
           "peak_mem_bytes": peak, "sgd_update_launches": sgd_n,
           "hand_conv_launches": hand_conv, "steps": steps,
           "graph_replays": replays,
           "workflow_run": {**run,
                            "history": w.decision.metrics_history}}
    if step.compute_dtype != torch.bfloat16:
        fail(f"ae fused computes in {step.compute_dtype}, not bf16")
    if not all(np.isfinite(losses)) or \
            not all(b < a for a, b in zip(losses, losses[1:])):
        fail(f"ae fused loss not finite and falling: {losses}")
    n_leaves = sum(k in leaf for leaf in step._params for k in ("w", "b"))
    out["leaves"] = n_leaves
    if sgd_n != n_leaves * steps:
        fail(f"sgd_update_ launched {sgd_n} times over {steps} steps of "
             f"{n_leaves} leaves")
    if replays != want_replays:
        fail(f"ae fused graph replays {replays}, want {want_replays}")
    if any(hand_conv.values()):
        fail(f"the fused ae step launched hand-written conv kernels: "
             f"{hand_conv}")
    if not bool(w.decision.complete):
        fail(f"the fused ae epochs did not finish: {out}")
    out["replayed_launches_profiled"] = replayed_launches(
        lambda: step.train_steps(xs, xs, ms), ("sgd_update",))
    return out


#: stochastic_pool phase, the bits= matrix: input shape, window side,
#: stride, abs variant.  MNIST conv's two pooling layers and AlexNet's
#: pool1 at their batches, then odd sizes whose last windows are clipped
#: (ceil mode), k2 s2 and k3 s2, both variants
POOL_CASES = (((100, 28, 28, 32), 2, 2, False), ((100, 14, 14, 64), 2, 2,
                                                 False),
              ((128, 55, 55, 96), 3, 2, False), ((3, 9, 8, 5), 3, 2, False),
              ((3, 9, 8, 5), 3, 2, True), ((4, 11, 13, 6), 2, 2, False),
              ((4, 11, 13, 6), 2, 2, True), ((2, 7, 5, 4), 2, 3, True))
#: the one-element path beside the four-channel one: three channels
#: (c % 4 != 0) and MNIST conv's pool2 with x 4 bytes off 16-byte
#: alignment (input shape, window side, stride, abs variant, aligned)
POOL_PATH_CASES = (((100, 28, 28, 3), 2, 2, False, True),
                   ((100, 14, 14, 64), 2, 2, False, False))
#: the timed shapes: MNIST conv's pool1 and pool2 (batch 100; one of each
#: a minibatch) and AlexNet's pool1 (batch 128, k3 s2), the largest
POOL_TIMED = (("mnist_pool1", (100, 28, 28, 32), 2, 2),
              ("mnist_pool2", (100, 14, 14, 64), 2, 2),
              ("alexnet_pool1", (128, 55, 55, 96), 3, 2))
#: the frequency check: one 2x2 window repeated over (4096, 4096) outputs,
#: its probabilities (2^-18, 1/4, 1/2, 1/4 - 2^-18) sum to 1 exactly in
#: f32, so with 24-bit uniforms each tap's frequency is exactly its p.  The
#: band is chi-square with 3 degrees of freedom at a 1e-6 upper tail
#: (scipy.stats.chi2.isf(1e-6, 3)).  The control draws u from the top 16
#: bits only: the first tap then wins with probability 2^-16, 4x its p, and
#: its 64 expected wins become 256, a chi-square of ~576
CHI_WINDOW = (2.0 ** -18, 0.25, 0.5, 0.25 - 2.0 ** -18)
CHI_N, CHI_C, CHI_BAND = 4096, 4096, 30.664849706213598


def _taps_of(off, in_w, kx, sy, sx):
    """Each output's winning tap (iy * kx + ix) from its flat offset."""
    oh, ow = off.shape[1], off.shape[2]
    oy = torch.arange(oh, device=off.device)[None, :, None, None] * sy
    ox = torch.arange(ow, device=off.device)[None, None, :, None] * sx
    row, col = off.long() // in_w, off.long() % in_w
    return (row - oy) * kx + (col - ox)


def _bits32(words):
    """int64 words in [0, 2**32) as the int32 tensor of the same bits (the
    kernels' bits= operand takes uint32 or int32)."""
    return torch.where(words >= 2 ** 31, words - 2 ** 32, words).to(
        torch.int32)


def _chi2(off) -> float:
    counts = torch.bincount(off.reshape(-1).long(), minlength=4).double()
    want = torch.tensor(CHI_WINDOW, dtype=torch.float64,
                        device=off.device) * off.numel()
    return float(((counts - want) ** 2 / want).sum())


def phase_stochastic_pool() -> dict:
    """The stochastic-pool kernel against its plain version: bit for bit
    through bits= (y, the taps, the offsets) over POOL_CASES with windows
    of zero mass, and through seed=; the winners' frequencies over a
    fixed window within a chi-square band that the 16-bit control fails;
    then the kernel (with a spin kernel ahead of the start event, and
    its device time alone from the profiler), the plain version and the
    bound at POOL_TIMED.  The
    cases of POOL_PATH_CASES take the one-element path, the others with
    c % 4 == 0 four channels a thread (each check names its path where
    the tree has both)."""
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 21)
    path_of = getattr(kpool, "four_channel_path", None)
    checks = []
    for shape, k, s, use_abs, aligned in \
            [case + (True,) for case in POOL_CASES] + list(POOL_PATH_CASES):
        x = torch.randn(shape, generator=gen, device=DEVICE)
        if not aligned:
            store = torch.empty(x.numel() + 1, device=DEVICE)
            store[1:] = x.reshape(-1)
            x = store[1:].view(shape)
        # a block of windows with zero mass: x <= 0 (x = 0 for |x|)
        z = s + k                   # the rows and columns of 2 x 2 windows
        x[0, :z, :z] = 0.0 if use_abs else -x[0, :z, :z].abs()
        out = kpool.output_shape(shape, k, k, s, s)
        bits = torch.randint(0, 2 ** 32, out, generator=gen, device=DEVICE,
                             dtype=torch.int64)
        bits = _bits32(bits)
        y, off = kpool.stochastic_pool(x, k, k, s, s, use_abs, bits=bits)
        y_p, off_p = kpool.stochastic_pool_plain(
            x, k, k, s, s, use_abs, counter_rng.as_words(bits)
            .reshape(-1))
        taps = _taps_of(off, shape[2], k, s, s)
        same = bool(torch.equal(y, y_p) and torch.equal(off, off_p) and
                    torch.equal(taps, _taps_of(off_p, shape[2], k, s, s)))
        zero_mass = bool((taps[0, :2, :2] == 0).all())
        checks.append({"shape": list(shape), "k": k, "s": s,
                       "abs": use_abs, "aligned": aligned,
                       "four_channels": None if path_of is None else
                       path_of(shape[3], k, k, x, y, off, bits),
                       "identical": same,
                       "max_abs_err": float((y - y_p).abs().max()),
                       "zero_mass_tap0": zero_mass,
                       "taps_in_window": bool(((taps >= 0) &
                                               (taps < k * k)).all())})
        if not (same and zero_mass and checks[-1]["taps_in_window"]):
            fail(f"stochastic_pool bits= vs plain: {checks[-1]}")
    if path_of is not None and not all(
            c["four_channels"] == (c["aligned"] and c["shape"][3] % 4 == 0)
            for c in checks):
        fail(f"stochastic_pool took an unexpected path: {checks}")
    seeded = []
    for shape, k, s in ((100, 28, 28, 32), 2, 2), ((128, 55, 55, 96), 3, 2):
        x = torch.randn(shape, generator=gen, device=DEVICE)
        y, off = kpool.stochastic_pool(x, k, k, s, s, seed=SEED)
        y2, off2 = kpool.stochastic_pool(x, k, k, s, s, seed=SEED)
        out = kpool.output_shape(shape, k, k, s, s)
        words = counter_rng.random_bits(SEED, int(np.prod(out)),
                                              DEVICE)
        y_p, off_p = kpool.stochastic_pool_plain(x, k, k, s, s, False, words)
        seeded.append({"shape": list(shape), "k": k, "s": s,
                       "max_abs_err": float((y - y_p).abs().max()),
                       "identical": bool(torch.equal(y, y_p) and
                                         torch.equal(off, off_p)),
                       "deterministic": bool(torch.equal(y, y2) and
                                             torch.equal(off, off2))})
        if not (seeded[-1]["identical"] and seeded[-1]["deterministic"]):
            fail(f"stochastic_pool seed= vs plain: {seeded[-1]}")
        del x, y, off, y2, off2, y_p, off_p, words
    window = torch.tensor(CHI_WINDOW, dtype=torch.float32, device=DEVICE)
    xc = window.reshape(1, 2, 2, 1).expand(CHI_N, 2, 2, CHI_C).contiguous()
    _, off = kpool.stochastic_pool(xc, 2, 2, 2, 2, seed=SEED + 1)
    chi2 = _chi2(off)
    words = counter_rng.random_bits(SEED + 1, CHI_N * CHI_C, DEVICE)
    _, off16 = kpool.stochastic_pool(
        xc, 2, 2, 2, 2, bits=_bits32(words & 0xFFFF0000).reshape(
            CHI_N, 1, 1, CHI_C))
    chi2_16 = _chi2(off16)
    freq = {"outputs": CHI_N * CHI_C, "p": list(CHI_WINDOW), "band": CHI_BAND,
            "chi2": chi2, "control_16bit_chi2": chi2_16,
            "counts": torch.bincount(off.reshape(-1).long(),
                                     minlength=4).tolist()}
    if not chi2 <= CHI_BAND:
        fail(f"stochastic_pool frequencies off p: {freq}")
    if not chi2_16 > CHI_BAND:
        fail(f"the chi-square band passes the 16-bit control: {freq}")
    del xc, off, off16, words
    timed = []
    for name, shape, k, s in POOL_TIMED:
        x = torch.randn(shape, generator=gen, device=DEVICE)
        m = int(np.prod(kpool.output_shape(shape, k, k, s, s)))

        def plain(x=x, k=k, s=s, m=m):
            return kpool.stochastic_pool_plain(
                x, k, k, s, s, False,
                counter_rng.random_bits(SEED, m, DEVICE))

        timed.append({"layer": name, "shape": list(shape), "k": k, "s": s,
                      "four_channels": None if path_of is None else
                      path_of(shape[3], k, k, x),
                      "ms": time_cuda_ms(lambda: kpool.stochastic_pool(
                          x, k, k, s, s, seed=SEED), lead=True),
                      "kernel_ms": kernel_ms_by_name(
                          lambda: kpool.stochastic_pool(
                              x, k, k, s, s, seed=SEED), "stochastic_pool"),
                      "plain_ms": time_cuda_ms(plain, iters=5),
                      "library_ms": None, **kpool.bound(shape, k, k, s, s)})
        del x
    # MNIST conv's train minibatch launches pool1 and pool2 once each
    path = {key: sum(t[key] for t in timed[:2])
            for key in ("ms", "plain_ms", "bound_ms", "flops", "bytes")}
    path.update(library_ms=None, bound_by="bytes",
                max_abs_err=max(c["max_abs_err"] for c in checks + seeded),
                layers=["mnist_pool1", "mnist_pool2"])
    return {"phase": "stochastic_pool", "ptxas": ptxas_usage("pooling"),
            "bits_checks": checks, "seed_checks": seeded,
            "frequencies": freq, "timed": timed, "path": path,
            "path_note": "sums over MNIST conv's two pooling launches of "
                         "one minibatch at batch 100"}


#: mnist_conv_stochastic: models/mnist_conv.py's published layers and
#: widths with both pooling layers stochastic, batch 100, the synthetic
#: image loader's 2000 train and 500 validation 28x28x1 samples, 2 epochs
MCS_EPOCHS, MCS_TRAIN, MCS_VALID, MCS_BATCH = 2, 2000, 500, 100
#: its parity run: the same layers at narrow widths (conv 4 and 8, fc 16),
#: batch 10, 60 train and 20 validation samples, 2 epochs in f32, the card
#: against the CPU with the same pooling bits injected on both.  Both sum
#: the same f32 products in other orders (the conv and FC kernels' tiles
#: against the plain versions; ~6e-8 on the test-size AlexNet's), so
#: 1e-6, which the same run with TF32 on must fail (the softmax layer's
#: products through cuBLAS keep 10 mantissa bits)
MCS_PARITY_WEIGHT_ATOL = 1e-6


def stochastic_mnist_layers(narrow: bool = False) -> list:
    """models/mnist_conv.py's LAYERS with both pooling layers stochastic
    (the substitution the reference's StandardWorkflow accepts)."""
    specs = [dict(s, **{k: dict(s[k]) for k in ("->", "<-") if k in s})
             for s in tmnist_conv.LAYERS]
    widths = iter((4, 8))
    for spec in specs:
        if spec["type"] == "max_pooling":
            spec["type"] = "stochastic_pooling"
        elif narrow and spec["type"] == "conv_relu":
            spec["->"]["n_kernels"] = next(widths)
        elif narrow and spec["type"] == "all2all_relu":
            spec["->"]["output_sample_shape"] = 16
    return specs


def _mnist_conv_workflow(narrow: bool, epochs: int, n_train: int,
                         n_valid: int, batch: int):
    return StandardWorkflow(
        name="MnistConv", layers=stochastic_mnist_layers(narrow),
        loss_function="softmax", loader_name="synthetic_image",
        loader_config={"n_classes": 10, "sample_shape": (28, 28, 1),
                       "n_train": n_train, "n_valid": n_valid,
                       "minibatch_size": batch, "spread": 2.5, "noise": 1.0},
        decision_config={"max_epochs": epochs}, fused=False)


def inject_pool_bits(w, seed: int) -> None:
    """Every stochastic pooling unit of ``w`` takes its bits from one numpy
    stream (the same bits on any device, in forward order); each forward
    still draws its seed from the host stream, as the unit does."""
    rng = np.random.default_rng(seed)
    for fwd in w.forwards:
        if isinstance(fwd, tpooling.StochasticPooling):
            def random(fwd=fwd, draw=fwd._random):
                draw()
                bits = rng.integers(0, 2 ** 32, fwd.output.shape,
                                    dtype=np.uint32)
                return {"bits": torch.from_numpy(bits).to(
                    fwd.device.torch_device)}
            fwd._random = random


def _mcs_parity_run(device, allow_tf32=False):
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = allow_tf32
    try:
        tprng.seed_all(SEED)
        w = _mnist_conv_workflow(True, 2, 60, 20, 10)
        w.initialize(device=TorchDevice(device, precision="float32"))
        inject_pool_bits(w, SEED)
        w.run()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    return w.decision.metrics_history, _conv_fc_weights(w)


def phase_mnist_conv_stochastic() -> dict:
    """MNIST conv with stochastic pooling eager on TorchDevice(): the
    stochastic-pool, conv and FC counters set to 0 just before the run and
    read just after (exactly 2 stochastic-pool launches a minibatch, train
    and validation alike); then the card against the CPU at test size with
    the same bits, TF32 as the control."""
    tprng.seed_all(SEED)
    w = _mnist_conv_workflow(False, MCS_EPOCHS, MCS_TRAIN, MCS_VALID,
                             MCS_BATCH)
    t0 = time.perf_counter()
    w.initialize(device=TorchDevice())
    init_s = time.perf_counter() - t0
    marks = _per_minibatch_marks(w)
    torch.cuda.synchronize()
    kpool.launches = 0                                   # 0 just before ...
    kconv.fwd_launches = kconv.input_grad_launches = 0
    kconv.weight_grad_launches = 0
    kgemm.gemm_launches = kgemm.act_launches = 0
    t0 = time.perf_counter()
    w.run()
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = {"stochastic_pool": kpool.launches,       # ... read after
                "conv2d_fwd": kconv.fwd_launches,
                "conv2d_input_grad": kconv.input_grad_launches,
                "conv2d_weight_grad": kconv.weight_grad_launches,
                "gemm_fc": kgemm.gemm_launches,
                "act_backward": kgemm.act_launches}
    marks.append((time.perf_counter(), None))
    per_epoch = (MCS_TRAIN + MCS_VALID) // MCS_BATCH
    last = marks[-per_epoch - 1:]
    train_ms = [(b[0] - a[0]) * 1e3 for a, b in zip(last, last[1:])
                if a[1] == 2]
    hist = w.decision.metrics_history
    n_train_mb = MCS_EPOCHS * MCS_TRAIN // MCS_BATCH
    n_mb = MCS_EPOCHS * per_epoch
    expect = {"stochastic_pool": 2 * n_mb, "conv2d_fwd": 2 * n_mb,
              "conv2d_input_grad": n_train_mb,
              "conv2d_weight_grad": 2 * n_train_mb}
    card, cpu = _mcs_parity_run(DEVICE), _mcs_parity_run("cpu")
    tf32 = _mcs_parity_run(DEVICE, allow_tf32=True)

    def spread(a, b):
        return max(float(np.abs(x - y).max()) for name in a
                   for x, y in zip(a[name], b[name]))

    out = {"phase": "mnist_conv_stochastic", "batch": MCS_BATCH,
           "epochs": MCS_EPOCHS, "n_train": MCS_TRAIN, "n_valid": MCS_VALID,
           "init_s": init_s, "wall_s": wall_s, "history": hist,
           "launches": launches, "expect": expect,
           "train_minibatch_ms": float(np.median(train_ms)),
           "train_minibatch_ms_all": train_ms,
           "samples_per_s": MCS_BATCH * len(train_ms) / (sum(train_ms) / 1e3),
           "timing": "host clock between device-synced loader serves, last "
                     "epoch's train minibatches, median; samples/s: their "
                     "samples over their summed time",
           "parity": {"band": {"weight_atol": MCS_PARITY_WEIGHT_ATOL},
                      "history_card": card[0], "history_cpu": cpu[0],
                      "weight_max_abs": spread(card[1], cpu[1]),
                      "tf32_control_weight_max_abs": spread(tf32[1],
                                                            cpu[1])}}
    if not (len(hist) == MCS_EPOCHS and bool(w.decision.complete)):
        fail(f"mnist conv did not finish its epochs: {hist}")
    if not hist[-1]["metric_train"] < hist[0]["metric_train"]:
        fail(f"mnist conv train n_err did not fall: {hist}")
    if any(launches[k] != v for k, v in expect.items()):
        fail(f"mnist conv launches {launches} != {expect}")
    if launches["gemm_fc"] < 3 * n_train_mb + (n_mb - n_train_mb) or \
            launches["act_backward"] < n_train_mb:
        fail(f"FC launches {launches} for {n_mb} minibatches")
    if card[0] != cpu[0]:
        fail(f"mnist conv n_err card {card[0]} != cpu {cpu[0]}")
    par = out["parity"]
    if not par["weight_max_abs"] <= MCS_PARITY_WEIGHT_ATOL:
        fail(f"mnist conv weights card vs cpu: {par}")
    if not par["tf32_control_weight_max_abs"] > MCS_PARITY_WEIGHT_ATOL:
        fail(f"the mnist conv band passes the TF32 control: {par}")
    return out


#: kohonen phase: som_step at bench_kohonen's shape (x 500 x 16, a 16x16
#: grid of 16-wide weights, alpha 0.5, sigma 8 = the grid's radius) and the
#: reference sweep's (utils/pallas_hw.py: x 64 x 128, 256 x 128, alpha
#: 0.3, sigma 1.5).  The kernel and the plain version sum the same f32
#: products in other orders (its d-loop against cuBLAS's blocking; b in
#: order against cuBLAS's hᵀx): ~1e-7 of the weights' norm.  The band on
#: the norm-relative error of each 64-row tile is 1e-5; the control, the
#: kernel at bs - 1, drops one sample (~1/B of the update: >= 2e-3)
SOM_SHAPES = (("bench_kohonen", 500, 256, 16, 0.5, 8.0),
              ("parity_sweep", 64, 256, 128, 0.3, 1.5))
SOM_TOL = 1e-5
#: bench.py bench_kohonen: a 16x16 grid over 16-wide samples, 4000 train
#: samples at minibatch 500 (8 steps an epoch), 3 epochs after a 1-epoch
#: warm-up, scan_epoch on, min_delta 0
SOM_BENCH = {"shape": (16, 16), "sample_shape": (16,), "n_train": 4000,
             "minibatch_size": 500, "min_delta": 0.0}
SOM_EPOCHS = 3
#: card against CPU on the demo's defaults (per-minibatch mode): identical
#: winner sequences; weights within 1e-5 (the same sums in other orders,
#: ~1e-7, carried over 100 steps)
SOM_PARITY_ATOL = 1e-5


def _som_run(device, scan: bool, epochs=None, warm=False, **kw):
    """models/kohonen.build on ``device`` from the smoke's seed -> the
    workflow, its wall seconds and the winners each per-minibatch step
    produced."""
    prev = root.common.engine.get("scan_epoch", False)
    root.common.engine.scan_epoch = scan
    try:
        tprng.seed_all(SEED)
        args = dict(kw)
        if epochs is not None:
            args["max_epochs"] = epochs
        w = tkohonen.build(**args)
        w.initialize(device=TorchDevice(device))
        winners, step = [], w.trainer.run

        def run():
            step()
            if not scan:
                winners.append(w.trainer.winners.map_read().copy())

        w.trainer.run = run
        if device == DEVICE:
            torch.cuda.synchronize()
            if not warm:
                ksom.launches = 0                        # 0 just before ...
        t0 = time.perf_counter()
        w.run()
        w.trainer.weights.map_read()      # the run's last device work
        wall = time.perf_counter() - t0
    finally:
        root.common.engine.scan_epoch = prev
    return w, wall, winners


#: shapes past SOM_SHAPES' paths, on small integers so that every distance
#: is exact in f32 (the winners then cannot differ by rounding, and exact
#: ties across ranks are common): ten chunks; fewer neurons than ranks;
#: W too large for shared memory (the plan's device-memory sums); h a
#: chunk at a time over three chunks, 75 neurons a rank
SOM_EDGES = (("ten_chunks", 5000, 256, 16, 0.5, 8.0),
             ("three_chunks", 700, 600, 16, 0.5, 4.0),
             ("three_neurons", 50, 3, 3, 0.5, 1.0),
             ("seven_neurons", 50, 7, 3, 0.5, 1.0),
             ("not_resident", 300, 2048, 512, 0.2, 4.0))
#: the plan twin's sweep: every (B, N, D) of these against som_plan
SOM_PLAN_SWEEP = [(b, n, d) for b in (1, 5, 50, 64, 500, 2048, 2049, 5000)
                  for n in (1, 3, 7, 9, 64, 256, 1000, 2048, 20000)
                  for d in (1, 2, 3, 16, 128, 512)]


def _som_inputs(rng, b, n, d, integers=False):
    if integers:
        x = _dev(rng.integers(-3, 4, size=(b, d)))
        w = _dev(rng.integers(-3, 4, size=(n, d)))
    else:
        x = _dev(rng.normal(size=(b, d)))
        w = _dev(rng.normal(size=(n, d)) * 0.5)
    side = int(np.sqrt(n))
    rows = side if side * side == n else 1
    return x, w, _dev(tk_ops.grid_coords(np, rows, n // rows))


def _som_check(name, x, w, coords, alpha, sigma, control) -> dict:
    b = x.shape[0]
    new_w, idx = ksom.som_step(x, w, coords, alpha, sigma, b)
    new_w2, idx2 = ksom.som_step(x, w, coords, alpha, sigma, b)
    ref_w, ref_idx = ksom.som_step_plain(x, w, coords, alpha, sigma, b)
    torch.cuda.synchronize()
    check = {"case": name, "b": b, "n": w.shape[0], "d": x.shape[1],
             "rel_err": tile_rel_err(new_w[None], ref_w[None]),
             "winners_identical": bool(torch.equal(idx, ref_idx)),
             "bits_identical": bool(torch.equal(new_w, new_w2) and
                                    torch.equal(idx, idx2)),
             "max_abs_err": float((new_w - ref_w).abs().max())}
    if control:
        ctl, _ = ksom.som_step(x, w, coords, alpha, sigma, b - 1)
        check["control_rel_err"] = tile_rel_err(ctl[None], ref_w[None])
    if hasattr(ksom, "som_plan"):
        plan = ksom.som_plan(b, w.shape[0], x.shape[1])
        check.update(chunk=plan["chunk"], slices=plan["slices"],
                     resident=plan["resident"],
                     clusters=ksom.clusters_on_card(b, w.shape[0],
                                                    x.shape[1]))
    if not (check["winners_identical"] and check["rel_err"] <= SOM_TOL and
            check["bits_identical"] and
            check.get("control_rel_err", 1.0) > SOM_TOL and
            check.get("clusters", 1) >= 1):
        fail(f"som_step vs plain: {check}")
    return check


def _som_plans() -> dict:
    """The card's plan (``znicz_som_plan``) against ``som_plan`` over
    SOM_PLAN_SWEEP; a tree before the cluster kernel has neither and
    reports None."""
    if not hasattr(ksom, "som_plan_on_card"):
        return None
    for b, n, d in SOM_PLAN_SWEEP:
        twin = ksom.som_plan(b, n, d)
        try:
            card = ksom.som_plan_on_card(b, n, d)
        except RuntimeError:
            card = None
        if card != twin:
            fail(f"som_step's plan at {(b, n, d)}: kohonen.cu {card}, "
                 f"kernels/kohonen.py {twin}")
    return {"shapes_checked": len(SOM_PLAN_SWEEP),
            "bench_kohonen": ksom.som_plan(500, 256, 16)}


def phase_kohonen() -> dict:
    """som_step against its plain version (band, bs - 1 control, winners
    and bits identical across launches, the card's plan against its twin
    and at least one cluster resident) at SOM_SHAPES and SOM_EDGES; its
    time with a spin kernel ahead of the start event, the profiler's
    kernel time by name and its kernels a step (one on the cluster tree,
    two before); bench_kohonen's run (scan mode, exact launches); the
    demo's defaults per minibatch until the decision stops; the card
    against the CPU on the demo."""
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(SEED + 31)
    checks, timed = [], []
    for name, b, n, d, alpha, sigma in SOM_SHAPES:
        x, w, coords = _som_inputs(rng, b, n, d)
        checks.append(_som_check(name, x, w, coords, alpha, sigma, True))

        def step():
            return ksom.som_step(x, w, coords, alpha, sigma, b)

        kernel_ms = kernel_ms_by_name(step, "som_")
        timed.append({
            "case": name, "shape": f"x {b}x{d}, w {n}x{d}",
            "ms": time_cuda_ms(step, lead=True), "kernel_ms": kernel_ms,
            "kernels_a_step": len(kernel_ms),
            "plain_ms": time_cuda_ms(lambda: ksom.som_step_plain(
                x, w, coords, alpha, sigma, b), lead=True),
            "library_ms": None, **ksom.bound(x.shape, w.shape)})
        # one kernel a step: one som_ kernel, launched once a call (the
        # profiler's count, held exactly by kernel_ms_by_name)
        if hasattr(ksom, "som_plan") and len(kernel_ms) != 1:
            fail(f"som_step is not one kernel a step: {timed[-1]}")
    for name, b, n, d, alpha, sigma in SOM_EDGES:
        x, w, coords = _som_inputs(rng, b, n, d, integers=True)
        checks.append(_som_check(name, x, w, coords, alpha, sigma, False))
        del x, w, coords
    _som_run(DEVICE, True, epochs=1, warm=True, **SOM_BENCH)   # warm-up
    bench, wall, _ = _som_run(DEVICE, True, epochs=SOM_EPOCHS, **SOM_BENCH)
    bench_launches = ksom.launches                       # ... read after
    steps = SOM_BENCH["n_train"] // SOM_BENCH["minibatch_size"]
    demo, demo_wall, card_win = _som_run(DEVICE, False)
    demo_launches = ksom.launches
    cpu, _, cpu_win = _som_run("cpu", False)
    demo_hist = demo.decision.metrics_history
    w_card = demo.trainer.weights.map_read()
    w_cpu = cpu.trainer.weights.map_read()
    out = {"phase": "kohonen", "tol": SOM_TOL, "checks": checks,
           "plans": _som_plans(), "ptxas": ptxas_usage("kohonen"),
           "timed": {**timed[0], "by_shape": timed},
           "bench": {**{k: list(v) if isinstance(v, tuple) else v
                        for k, v in SOM_BENCH.items()},
                     "epochs": SOM_EPOCHS, "scan_epoch": True,
                     "launches": bench_launches,
                     "expect": SOM_EPOCHS * steps, "wall_s": wall,
                     "ms_per_epoch": wall / SOM_EPOCHS * 1e3,
                     "samples_per_s": SOM_BENCH["n_train"] * SOM_EPOCHS /
                     wall,
                     "deltas": [h["metric_train"] for h in
                                bench.decision.metrics_history]},
           "demo": {"epochs_run": len(demo_hist), "launches": demo_launches,
                    "wall_s": demo_wall,
                    "deltas": [h["metric_train"] for h in demo_hist],
                    "stopped": bool(demo.decision.complete)},
           "parity": {"steps": len(card_win),
                      "winners_identical": len(card_win) == len(cpu_win) and
                      all(np.array_equal(a, b)
                          for a, b in zip(card_win, cpu_win)),
                      "weight_max_abs": float(np.abs(w_card - w_cpu).max()),
                      "band": SOM_PARITY_ATOL}}
    if bench_launches != SOM_EPOCHS * steps or \
            len(bench.decision.metrics_history) != SOM_EPOCHS:
        fail(f"bench_kohonen launches {bench_launches} != "
             f"{SOM_EPOCHS * steps}: {out['bench']}")
    if not out["demo"]["stopped"] or \
            demo_launches != len(demo_hist) * 500 // 50:
        fail(f"the SOM demo: {out['demo']}")
    if not (out["parity"]["winners_identical"] and
            out["parity"]["weight_max_abs"] <= SOM_PARITY_ATOL):
        fail(f"SOM card vs cpu: {out['parity']}")
    return out


#: lrn_dropout phase: AlexNet's two norm layers at batch 128 (alexnet.py:
#: alpha 1e-4, beta 0.75, k 2, n 5).  The kernels repeat the plain
#: versions' f32 operations in their order (beta 0.75 takes the two
#: square roots), so they agree to the bit; the band on the norm-relative
#: error of each 64-row tile is 1e-6 all the same, and must reject the
#: kernel run with the window cut to n - 1 (one x^2 of five dropped)
LRN_SHAPES = (("norm1", (128, 55, 55, 96)), ("norm2", (128, 27, 27, 256)))
LRN_ARGS = (1e-4, 0.75, 2.0, 5)
LRN_TOL = 1e-6
#: dropout: AlexNet's fc6 input at batch 128 and one 64 M-element tensor,
#: ratio 0.5, in f32 and bf16 (the kernel's vector path); the drop rate
#: within 0.1 % of the ratio on the 64 M
DROP_SHAPES = (("fc6_input", (128, 9216)), ("64M", (8192, 8192)))
DROP_DTYPES = (torch.float32, torch.bfloat16)
DROP_RATIO, DROP_RATE_TOL = 0.5, 1e-3
#: the element path, in both dtypes: an n that fills no whole 16-byte
#: group (1001 x 7) and fc6's input one element off 16 bytes (shape,
#: x's offset in elements)
DROP_PATH_CASES = (((1001, 7), 0), ((128, 9216), 1))
#: the plan twin's sweep: (n, aligned) in each dtype
DROP_PLAN_SWEEP = [(n, al) for n in (1, 3, 4, 8, 1000, 7007, 1179648,
                                     1 << 20, 8192 * 8192, 8192 * 8192 + 4)
                   for al in (True, False)]

#: both LRN kernels off AlexNet's shapes: c 5 (the element path), an x
#: one float off 16 bytes at c 96 (the element path), and c 128 with
#: run_parity's rows (the quad path): (shape, x's offset in floats)
LRN_PATH_CASES = (((2, 13, 13, 5), 0), ((4, 13, 13, 96), 1),
                  ((4, 8, 8, 128), 0))
#: the plan twin's sweep: (rows, c, n, beta, aligned), each direction
LRN_PLAN_SWEEP = [(r, c, n, beta, al) for r in (1, 7, 387200)
                  for c in (1, 3, 4, 5, 96, 128, 256, 384, 4096, 4100, 8192)
                  for n in (1, 4, 5, 9) for beta in (0.75, 0.6)
                  for al in (True, False)]


def lrn_path_of(x, e, backward: bool):
    c = x.shape[-1]
    return klrn.lrn_plan(x.numel() // c, c, LRN_ARGS[3], LRN_ARGS[1],
                         klrn.aligned16(x, e), backward=backward)["path"]


def _lrn_plans() -> dict:
    """Each direction's plan from lrn.cu against ``kernels/lrn.py
    lrn_plan`` over LRN_PLAN_SWEEP."""
    for case in LRN_PLAN_SWEEP:
        for backward in (True, False):
            card = klrn.lrn_plan_on_card(*case, backward=backward)
            twin = klrn.lrn_plan(*case, backward=backward)
            if card != twin:
                fail(f"lrn plan (backward {backward}) at {case}: lrn.cu "
                     f"{card}, kernels/lrn.py {twin}")
    return {"cases_checked": 2 * len(LRN_PLAN_SWEEP),
            **{f"{name}_{kind}": klrn.lrn_plan(
                int(np.prod(shape[:-1])), shape[-1], 5,
                backward=kind == "bwd")
               for name, shape in LRN_SHAPES for kind in ("fwd", "bwd")}}


def phase_lrn_dropout() -> dict:
    """The LRN kernels against their plain versions at AlexNet's norm
    shapes (bit for bit on the quad path, band, cut-window control, each
    layer timed against its bound and F.local_response_norm, which
    computes the same forward with alpha·n) and off them (the element
    path), their plans against the Python twin, and the dropout kernel
    against its plain version at one seed (bit for bit, the drop rate,
    y == x·mask, times)."""
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 41)
    alpha, beta, k, n = LRN_ARGS
    lrn_checks, lrn_timed = [], []
    for name, shape in LRN_SHAPES:
        x = torch.randn(shape, generator=gen, device=DEVICE) * 3.0
        e = torch.randn(shape, generator=gen, device=DEVICE)
        got = {"fwd": klrn.lrn_forward(x, *LRN_ARGS),
               "bwd": klrn.lrn_backward(x, e, *LRN_ARGS)}
        want = {"fwd": klrn.lrn_forward_plain(x, *LRN_ARGS),
                "bwd": klrn.lrn_backward_plain(x, e, *LRN_ARGS)}
        cut = {"fwd": klrn.lrn_forward(x, alpha, beta, k, n - 1),
               "bwd": klrn.lrn_backward(x, e, alpha, beta, k, n - 1)}
        xn = x.permute(0, 3, 1, 2).contiguous()    # the library's NCHW
        lib_fwd = torch.nn.functional.local_response_norm(
            xn, n, alpha=alpha * n, beta=beta, k=k)
        torch.cuda.synchronize()
        c = shape[-1]
        check = {"layer": name, "shape": list(shape),
                 "library_fwd_max_abs": float(
                     (lib_fwd.permute(0, 2, 3, 1) - want["fwd"]).abs().max())}
        for kind in ("fwd", "bwd"):
            check[kind] = {
                "rel_err": tile_rel_err(_rows(got[kind], c),
                                        _rows(want[kind], c)),
                "control_rel_err": tile_rel_err(_rows(cut[kind], c),
                                                _rows(want[kind], c)),
                "identical": bool(torch.equal(got[kind], want[kind])),
                "max_abs_err": float((got[kind] - want[kind]).abs().max())}
            if not (check[kind]["rel_err"] <= LRN_TOL and
                    check[kind]["control_rel_err"] > LRN_TOL):
                fail(f"lrn {kind} vs plain: {check}")
        for kind in ("fwd", "bwd"):
            check[f"{kind}_path"] = path = lrn_path_of(x, e, kind == "bwd")
            if not (check[kind]["identical"] and path == "quad"):
                fail(f"lrn {kind} not bit-identical on the quad path: "
                     f"{check}")
        lrn_checks.append(check)
        for kind, kern, plain, lib in (
                ("fwd", lambda: klrn.lrn_forward(x, *LRN_ARGS),
                 lambda: klrn.lrn_forward_plain(x, *LRN_ARGS),
                 lambda: torch.nn.functional.local_response_norm(
                     xn, n, alpha=alpha * n, beta=beta, k=k)),
                ("bwd", lambda: klrn.lrn_backward(x, e, *LRN_ARGS),
                 lambda: klrn.lrn_backward_plain(x, e, *LRN_ARGS), None)):
            row = {"layer": name, "kernel": kind, "ms": time_cuda_ms(kern),
                   "plain_ms": time_cuda_ms(plain, iters=5),
                   "library_ms": None if lib is None
                   else time_cuda_ms(lib, iters=5),
                   **klrn.bound(shape, n, kind == "bwd")}
            row["bound_share"] = row["bound_ms"] / row["ms"]
            lrn_timed.append(row)
        del x, e, got, want, cut, lib_fwd, xn
    lrn_paths, lrn_plans = [], _lrn_plans()
    for shape, offset in LRN_PATH_CASES:
        store = torch.randn(int(np.prod(shape)) + offset, generator=gen,
                            device=DEVICE) * 3.0
        x = store[offset:].view(shape)
        e = torch.randn(shape, generator=gen, device=DEVICE)
        got = {"fwd": klrn.lrn_forward(x, *LRN_ARGS),
               "bwd": klrn.lrn_backward(x, e, *LRN_ARGS)}
        want = {"fwd": klrn.lrn_forward_plain(x, *LRN_ARGS),
                "bwd": klrn.lrn_backward_plain(x, e, *LRN_ARGS)}
        torch.cuda.synchronize()
        for kind in ("fwd", "bwd"):
            lrn_paths.append({
                "kernel": kind, "shape": list(shape),
                "offset_floats": offset,
                "path": lrn_path_of(x, e, kind == "bwd"),
                "identical": bool(torch.equal(got[kind], want[kind])),
                "max_abs_err": float((got[kind] - want[kind]).abs().max())})
            quad = offset == 0 and shape[-1] % 4 == 0
            if not (lrn_paths[-1]["identical"] and lrn_paths[-1]["path"]
                    == ("quad" if quad else "element")):
                fail(f"lrn {kind} vs plain: {lrn_paths[-1]}")
        del store, x, e, got, want
    drop = phase_dropout(gen)
    lrn_path = {}
    for kind in ("fwd", "bwd"):
        rows = [t for t in lrn_timed if t["kernel"] == kind]
        lrn_path[kind] = {key: sum(t[key] for t in rows)
                          for key in ("ms", "plain_ms", "bound_ms")}
        lrn_path[kind].update(
            library_ms=None if kind == "bwd"
            else sum(t["library_ms"] for t in rows),
            bound_by="bytes", bound_share=lrn_path[kind]["bound_ms"] /
            lrn_path[kind]["ms"], max_abs_err=max(c[kind]["max_abs_err"]
                                                  for c in lrn_checks))
    return {"phase": "lrn_dropout", "ptxas": {"lrn": ptxas_usage("lrn"),
                                             "dropout":
                                             ptxas_usage("dropout")},
            "lrn_args": list(LRN_ARGS), "lrn_tol": LRN_TOL,
            "lrn_checks": lrn_checks, "lrn_path_checks": lrn_paths,
            "lrn_plans": lrn_plans, "lrn_timed": lrn_timed,
            "lrn_path": lrn_path, **drop,
            "path_note": "lrn: sums over AlexNet's norm1 and norm2 at batch "
                         "128; dropout: the 64 M-element tensor"}


def _drop_plans() -> list:
    """dropout.cu's launch against ``dropout_plan`` over DROP_PLAN_SWEEP,
    both dtypes."""
    rows = []
    for dtype in DROP_DTYPES:
        for n, aligned in DROP_PLAN_SWEEP:
            card = kdrop.dropout_plan_on_card(n, dtype, aligned)
            twin = kdrop.dropout_plan(n, dtype, aligned)
            if card != twin:
                fail(f"dropout.cu's plan differs from dropout_plan at n {n} "
                     f"{dtype} aligned {aligned}: {card} {twin}")
            rows.append((str(dtype), n, aligned, card["path"],
                         card["blocks"]))
    return rows


def _drop_check(x) -> dict:
    """The kernel at one seed against its plain version on the same x:
    y and mask bit for bit, y == x·mask, the drop rate."""
    y, mask = kdrop.dropout_forward(x, DROP_RATIO, seed=SEED)
    words = counter_rng.random_bits(SEED, x.numel(), DEVICE)
    y_p, mask_p = kdrop.dropout_forward_plain(x, DROP_RATIO, words)
    check = {"shape": list(x.shape), "dtype": str(x.dtype),
             "drop_rate": float((mask == 0).double().mean()),
             "max_abs_err": float((y.float() - y_p.float()).abs().max()),
             "identical": bool(torch.equal(y, y_p) and
                               torch.equal(mask, mask_p)),
             "y_is_x_mask": bool(torch.equal(y, x * mask))}
    if not (check["identical"] and check["y_is_x_mask"]):
        fail(f"dropout vs plain: {check}")
    return check


def _drop_timed(x) -> dict:
    """The kernel, its plain version and ``aten.native_dropout`` on x
    (64 M elements), each with the same iterations but the plain
    version's 5; the library call writes a 1-byte bool mask, so its own
    byte bound (9 bytes an element at f32, 5 at bf16) stands beside
    it."""
    def plain():
        return kdrop.dropout_forward_plain(
            x, DROP_RATIO, counter_rng.random_bits(SEED, x.numel(), DEVICE))

    size = x.element_size()
    row = {"shape": list(x.shape), "dtype": str(x.dtype),
           "ms": time_cuda_ms(lambda: kdrop.dropout_forward(
               x, DROP_RATIO, seed=SEED)),
           "plain_ms": time_cuda_ms(plain, iters=5),
           "library_ms": time_cuda_ms(
               lambda: torch.ops.aten.native_dropout(x, DROP_RATIO, True)),
           "library_bound_ms": x.numel() * (2 * size + 1) /
           HBM_BYTES_PER_S * 1e3,
           **kdrop.bound(x.numel(), dtype=x.dtype)}
    row["bound_share"] = row["bound_ms"] / row["ms"]
    row["library_bound_share"] = row["library_bound_ms"] / row["library_ms"]
    return row


def phase_dropout(gen) -> dict:
    """The dropout kernel against its plain version at one seed, bit for
    bit (y and mask), in f32 and bf16, on the vector path at DROP_SHAPES
    and on the element path at DROP_PATH_CASES; its plan from dropout.cu
    against ``dropout_plan``; at 64 M elements the drop rate, and the
    kernel, its plain version and ``aten.native_dropout`` timed
    (_drop_timed)."""
    checks, paths, timed = [], [], []
    for name, shape in DROP_SHAPES:
        for dtype in DROP_DTYPES:
            x = torch.randn(shape, generator=gen, device=DEVICE).to(dtype)
            checks.append({"name": name, **_drop_check(x)})
            path = kdrop.dropout_plan_on_card(x.numel(), dtype)["path"]
            if path != "vector":
                fail(f"dropout at {shape} {dtype} took the {path} path")
            if name == "64M":
                rate = checks[-1]["drop_rate"]
                if not abs(rate - DROP_RATIO) <= DROP_RATE_TOL:
                    fail(f"dropout rate {rate} not within {DROP_RATE_TOL} "
                         f"of {DROP_RATIO}")
                timed.append(_drop_timed(x))
            del x
    for shape, offset in DROP_PATH_CASES:
        for dtype in DROP_DTYPES:
            n = int(np.prod(shape))
            store = torch.randn(n + offset, generator=gen,
                                device=DEVICE).to(dtype)
            x = store[offset:].view(shape)
            path = kdrop.dropout_plan_on_card(
                n, dtype, x.data_ptr() % 16 == 0)["path"]
            paths.append({"offset": offset, "path": path, **_drop_check(x)})
            if path != "element":
                fail(f"dropout at {shape} offset {offset} took the {path} "
                     f"path")
            del store, x
    return {"dropout_checks": checks, "dropout_path_checks": paths,
            "dropout_plans_checked": len(_drop_plans()),
            "dropout_timed": timed}


#: alexnet_fused: alexnet.build() at its defaults, fused (227 px, batch
#: 128, 1000 classes, dropout 0.5, lr 0.01, momentum 0.9, decay 5e-4, bf16
#: compute over f32 masters), on the synthetic loader's data set of
#: alexnet_eager (n_train 384, n_valid 128: 3 train and 1 validation
#: minibatches an epoch) pinned on the card.  K staged batches (rolled
#: copies of the data set's first 128 samples); one warm train_steps
#: call, AF_REPS timed with CUDA events, one profiled; then the epochs
#: through Workflow.run
AF_K, AF_REPS = 4, 3
#: then AF_EPOCHS epochs through Workflow.run: two warm (by their end the
#: train body, 2 minibatches, and the eval body, 2 epochs' validation
#: minibatch, each ran eagerly once and were captured), one timed on the
#: host clock, one profiled
AF_EPOCHS, AF_WARM, AF_TIMED = 4, 8, 4


def _forward_flops(w) -> float:
    """Flops of one forward of ``w``'s conv and FC layers at its batch:
    2 x the multiply-adds (output positions x kx·ky·c_in x c_out for a
    conv, in x out for an FC layer)."""
    total = 0.0
    for f in w.forwards:
        if not f.weights:
            continue
        out = f.output.shape
        if len(out) == 4:
            total += 2.0 * np.prod(out) * f.kx * f.ky * f.input.shape[3]
        else:
            total += 2.0 * np.prod(out) * np.prod(f.input.shape[1:])
    return total


def _lrn_sgd_counts() -> dict:
    return {"lrn_forward": klrn.fwd_launches,
            "lrn_backward": klrn.bwd_launches,
            "sgd_update": koptim.sgd_launches,
            "hand_conv": kconv.fwd_launches + kconv.input_grad_launches +
            kconv.weight_grad_launches}


def _zero_lrn_sgd_counts() -> None:
    klrn.fwd_launches = klrn.bwd_launches = koptim.sgd_launches = 0
    kconv.fwd_launches = kconv.input_grad_launches = 0
    kconv.weight_grad_launches = 0


def _fused_sgd_leaves_check(step) -> dict:
    """The SGD kernel against its plain version at the fused step's own
    leaves (every w and b: fc6's 9216 x 4096 down to the 96-element
    bias), each with the hyperparameters the step passes it (its layer's
    lr, wd, l1 and momentum, the bias's own), bs the batch, with the
    bs = 1 control: in the step's velocity dtype and in bf16 (the
    ``state_dtype`` option).  w, the summed gradient and the velocity
    come from a seeded generator on the card."""
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 47)

    def randn(shape, scale, dtype=torch.float32):
        return (torch.randn(shape, generator=gen, device=DEVICE) *
                scale).to(dtype)

    shapes, hs, vel_dtypes = [], [], set()
    for leaf, h in zip(step._params, step._hyper_device()):
        for k, lr, wd, mom in (("w", "lr", "wd", "mom"),
                               ("b", "lr_b", "wd_b", "mom_b")):
            if k in leaf:
                shapes.append(tuple(leaf[k].shape))
                hs.append((h[lr], h[wd], h["l1"], h[mom]))
                vel_dtypes.add(leaf["v" + k].dtype)
    if vel_dtypes != {torch.float32}:
        fail(f"alexnet fused velocity dtypes {vel_dtypes}, expected f32")
    bs = _dev(np.float32(ALEX_BATCH))
    out = {"leaves": len(shapes), "shapes": shapes,
           "elements": int(sum(np.prod(sh) for sh in shapes)),
           "hyper": [[float(v) for v in h] for h in hs], "bs": ALEX_BATCH}
    for vel_dtype in (torch.float32, torch.bfloat16):
        leaves = [{"w": randn(sh, 0.05), "g": randn(sh, 32.0),
                   "vel": randn(sh, 0.01, vel_dtype)} for sh in shapes]
        out[f"vel_{str(vel_dtype).split('.')[-1]}"] = _sgd_checked(
            leaves, hs, bs, vel_dtype)
        del leaves
    return out


def _alexnet_fused_setup():
    """alexnet.build() at its defaults, fused on the card for AF_EPOCHS
    epochs -> ``(w, xs, ys, ms, init_s)``: AF_K staged batches (rolled
    copies of the pinned data set's first 128 samples), their masks, and
    the seconds initialize took."""
    tprng.seed_all(SEED)
    w = talexnet.build(n_train=ALEX_TRAIN, n_valid=ALEX_VALID,
                       max_epochs=AF_EPOCHS)
    t0 = time.perf_counter()
    w.initialize(device=TorchDevice())
    init_s = time.perf_counter() - t0
    data, labels = w.step._dataset_dev
    idx = torch.tensor((np.arange(ALEX_BATCH)[None, :] -
                        np.arange(AF_K)[:, None]) % ALEX_BATCH,
                       device=DEVICE)
    return w, data[idx], labels[idx], torch.ones(
        (AF_K, ALEX_BATCH), dtype=torch.bool, device=DEVICE), init_s


def phase_alexnet_fused() -> dict:
    """alexnet.build() at its defaults through the fused step on the
    card, every step a graph replay but each body's first: cuDNN convs
    and cuBLAS matmuls under autograd (the reference's fused step runs
    XLA's), LRN on its two kernels through the ``lrn`` Function, the
    update on the SGD kernel.  The LRN and SGD counters set to 0 just
    before the staged calls and read just after (exactly 2 LRN forwards,
    2 LRN backwards and one SGD launch a leaf a train step), step ms by
    CUDA events, samples/s, MFU, peak memory, the idle share of one
    profiled call; then AF_EPOCHS epochs through Workflow.run (warm,
    timed, profiled), the counters again exact (an eval
    minibatch runs the LRN forward only).  First, before the counters
    are set to 0, the SGD kernel is held against its plain version at
    the step's own leaves."""
    w, xs, ys, ms, init_s = _alexnet_fused_setup()
    step = w.step
    if step.compute_dtype != torch.bfloat16 or step._dataset_dev is None:
        fail(f"alexnet fused: compute {step.compute_dtype}, dataset pinned "
             f"{step._dataset_dev is not None}")
    sgd_leaves = _fused_sgd_leaves_check(step)
    n_leaves = sum(k in leaf for leaf in step._params for k in ("w", "b"))
    before = _conv_fc_weights(w)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_lrn_sgd_counts()                           # 0 just before ...
    losses = [float(step.train_steps(xs, ys, ms)["loss"]) /
              (ALEX_BATCH * AF_K)]
    timed = timed_train_steps(step, xs, ys, ms, AF_REPS, sums=("lrn_",))
    losses += [float(m["loss"]) / (ALEX_BATCH * AF_K)
               for m in timed.pop("metrics")]
    peak = torch.cuda.max_memory_allocated()
    launches = _lrn_sgd_counts()                     # ... read just after
    steps = AF_K * (2 + AF_REPS) + ONE_STEP_CALLS
    # what the replays ran, by the profiler, against the counters
    profiled = replayed_launches(
        lambda: step.train_steps(xs, ys, ms),
        ("sgd_update", "lrn_forward", "lrn_backward"))
    expect = {"lrn_forward": 2 * steps, "lrn_backward": 2 * steps,
              "sgd_update": n_leaves * steps, "hand_conv": 0}
    del xs, ys, ms
    # AF_EPOCHS epochs through the graph: Repeater -> Loader -> FusedStep
    # -> Decision, the loader serving indices into the pinned data set
    _zero_lrn_sgd_counts()                           # 0 just before ...
    run = workflow_run_profiled(w, AF_WARM, AF_TIMED)
    epoch_launches = _lrn_sgd_counts()               # ... read just after
    classes = run["classes"]
    n_train_mb = classes.count(2)
    n_eval_mb = len(classes) - n_train_mb
    epoch_expect = {"lrn_forward": 2 * (n_train_mb + n_eval_mb),
                    "lrn_backward": 2 * n_train_mb,
                    "sgd_update": n_leaves * n_train_mb, "hand_conv": 0}
    replays = replays_of(step)
    want_replays = {"steps": steps + AF_K * profiled["calls"] - 1,
                    "train": n_train_mb - 1, "eval": n_eval_mb - 1}
    step.sync_to_units()
    after = _conv_fc_weights(w)
    hist = w.decision.metrics_history
    sps = ALEX_BATCH / (timed["step_ms"] / 1e3)
    flops = 3.0 * _forward_flops(w)
    out = {"phase": "alexnet_fused",
           "config": {"batch": ALEX_BATCH, "input": 227, "classes": 1000,
                      "dropout": 0.5, "lr": 0.01, "momentum": 0.9,
                      "compute": str(step.compute_dtype), "K": AF_K,
                      "timed_calls": AF_REPS, "n_train": ALEX_TRAIN,
                      "n_valid": ALEX_VALID, "epochs": AF_EPOCHS,
                      "dataset_on_device": True},
           "route": "cuDNN convs and matmuls under autograd, LRN on its "
                    "forward and backward kernels, SGD on the update "
                    "kernel, in CUDA graph replays; pooling and dropout "
                    "plain torch",
           "init_s": init_s, "losses_per_sample": losses, **timed,
           "samples_per_s": sps, "train_flops_per_step": flops,
           "mfu": flops / ALEX_BATCH * sps / BF16_FLOPS,
           "mfu_note": "3 x the conv and FC layers' forward flops against "
                       "989 TFLOP/s bf16",
           "peak_mem_bytes": peak, "steps": steps, "leaves": n_leaves,
           "sgd_at_leaves": sgd_leaves,
           "launches": launches, "expect": expect,
           "replayed_launches_profiled": profiled,
           "graph_replays": replays,
           "workflow_run": {**run, "history": hist,
                            "train_minibatches": n_train_mb,
                            "eval_minibatches": n_eval_mb,
                            "launches": epoch_launches,
                            "expect": epoch_expect}}
    lrn_ms = timed["profile"]["ms_per_step_of"]["lrn_"]
    if not all(np.isfinite(losses)):
        fail(f"alexnet fused loss not finite: {out}")
    if launches != expect or epoch_launches != epoch_expect:
        fail(f"alexnet fused launches: {out}")
    if replays != want_replays:
        fail(f"alexnet fused graph replays {replays}, want {want_replays}")
    if not (len(hist) == AF_EPOCHS and bool(w.decision.complete)):
        fail(f"the fused alexnet epochs did not finish: {hist}")
    unchanged = [name for name, (wb, bb) in before.items()
                 if np.array_equal(after[name][0], wb)
                 or np.array_equal(after[name][1], bb)]
    if unchanged or not all(np.isfinite(a).all() for wb in after.values()
                            for a in wb):
        fail(f"alexnet fused weights unchanged {unchanged} or not finite")
    if not lrn_ms > 0:
        fail(f"the profiled call shows no LRN kernel: {out}")
    return out


#: fused_conv_parity: the test-size AlexNet (alexnet_parity's, dropout 0)
#: and MNIST conv with both pools stochastic at narrow widths
#: (mnist_conv_stochastic's parity run), fused, in f32: the card (cuDNN
#: and cuBLAS with TF32 off, the LRN kernels) against the port on the CPU
#: (oneDNN, the plain versions), the same numpy uniforms drawn on both
#: sides.  They sum the same f32 products in other orders (the fused AE
#: moved 1e-6 under the same change, ae_parity), so the weight band is
#: 2e-6; the same run with TF32 on must fail it.  MNIST conv's first
#: layer (c_in 1, 5x5) is where cuDNN picks a non-fused Winograd weight
#: gradient (winogradWgradDelta9x9_5x5), 6.5e-4 from an f64 reference
#: against oneDNN's 5.3e-7 (the profiler and an f64 probe, PERF.md):
#: that run moves the layer's weights 1.1e-5, so it is held to the band
#: with cuDNN off (the native im2col conv on cuBLAS: 6e-8), and the
#: cuDNN run, the route users take, to FCP_CUDNN_WEIGHT_ATOL: 9x its
#: 1.1e-5 and 100x under the TF32 control's 1.1e-2, which it must fail
#: too with cuDNN on (the same n_err in all three)
FCP_EPOCHS, FCP_WEIGHT_ATOL, FCP_CUDNN_WEIGHT_ATOL = 3, 2e-6, 1e-4
#: MNIST conv and CIFAR conv at their own widths, fused on the card in
#: bf16 (batch 100; 500 train and 100 validation samples, one epoch)
FCP_MODEL_TRAIN, FCP_MODEL_VALID = 500, 100


def inject_uniforms(w, seed: int) -> list:
    """Every NEEDS_RNG forward of ``w`` draws its uniforms from one numpy
    stream (the same on any device, in forward order) through a tensor
    of its own on the step's device: its first train draw fills it, and
    a wrapper around ``w.step.run`` refills each, in forward order,
    before every later train minibatch.  The step body reads the tensor,
    so a graph replay reads each minibatch's values as an eager step
    does.  Returns the list the wrapper appends each minibatch's class
    to."""
    rng = np.random.default_rng(seed)
    units = [f for f in w.forwards if f.NEEDS_RNG]
    bufs, classes = {}, []

    def fill(i, shape, device):
        u = torch.from_numpy(rng.random(tuple(shape), dtype=np.float32))
        if i in bufs:
            bufs[i].copy_(u)
        else:
            bufs[i] = u.to(device)
        return bufs[i]

    for i, fwd in enumerate(units):
        fwd.draw_uniform = lambda gen, shape, device, i=i: \
            bufs[i] if i in bufs else fill(i, shape, device)
    orig = w.step.run

    def run():
        classes.append(int(w.loader.minibatch_class))
        if classes[-1] == TRAIN:
            for i in sorted(bufs):
                fill(i, bufs[i].shape, None)
        orig()

    w.step.run = run
    return classes


def _fused_parity_run(which, device, allow_tf32=False, cudnn=True):
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = allow_tf32
    torch.backends.cudnn.allow_tf32 = allow_tf32
    torch.backends.cudnn.enabled = cudnn
    try:
        tprng.seed_all(SEED)
        if which == "alexnet":
            layers = small_alexnet_layers(0.0, 0.03)
            cfg = {"n_classes": 10, "sample_shape": (67, 67, 3),
                   "n_train": 32, "n_valid": 16, "minibatch_size": 8,
                   "spread": 1.0, "noise": 0.5}
        else:
            layers = stochastic_mnist_layers(narrow=True)
            cfg = {"n_classes": 10, "sample_shape": (28, 28, 1),
                   "n_train": 60, "n_valid": 20, "minibatch_size": 10,
                   "spread": 2.5, "noise": 1.0}
        w = StandardWorkflow(
            name=which, layers=layers, loss_function="softmax",
            loader_name="synthetic_image", loader_config=cfg,
            decision_config={"max_epochs": FCP_EPOCHS}, fused=True)
        w.initialize(device=TorchDevice(device, precision="float32"))
        classes = inject_uniforms(w, SEED)
        w.run()
        w.step.sync_to_units()
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32
        torch.backends.cudnn.enabled = True
    replays, want = None, None
    if device != "cpu":
        # every train and eval step a graph replay but each body's first
        replays = replays_of(w.step)
        n_train = classes.count(TRAIN)
        want = {"train": n_train - 1, "eval": len(classes) - n_train - 1}
    return w.decision.metrics_history, _conv_fc_weights(w), replays, want


def fused_pool_backward_check() -> dict:
    """``ops/pooling.py max_forward_fast``'s backward at AlexNet's pool1
    (the input whose peaks win four windows each, a normal cotangent):
    two runs on the card bit-identical, in f32 and in the fused step's
    bf16, the f32 one equal to the CPU's bits; each timed."""
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 43)
    ky, kx, sy, sx = POOL_BWD_WINDOW
    x = torch.rand(POOL_BWD_SHAPE, generator=gen, device=DEVICE)
    x[:, 2::4, 2::4] += 10.0
    out = {"shape": list(POOL_BWD_SHAPE), "window": list(POOL_BWD_WINDOW)}
    for dtype in (torch.float32, torch.bfloat16):
        xd = x.to(dtype).requires_grad_(True)
        y = tpool_ops.max_forward_fast(xd, ky, kx, sy, sx)
        g = torch.randn(y.shape, generator=gen, device=DEVICE).to(dtype)

        def run():
            return torch.autograd.grad(y, xd, g, retain_graph=True)[0]

        first, second = run(), run()
        r = {"identical_runs": bool(torch.equal(first, second)),
             "ms": time_cuda_ms(run, iters=10)}
        if dtype == torch.float32:
            xc = xd.detach().cpu().requires_grad_(True)
            yc = tpool_ops.max_forward_fast(xc, ky, kx, sy, sx)
            want = torch.autograd.grad(yc, xc, g.cpu())[0]
            r["equals_cpu"] = bool(torch.equal(first.cpu(), want))
        out[str(dtype).replace("torch.", "")] = r
        del xd, y, g, first, second
    if not (out["float32"]["identical_runs"] and out["float32"]["equals_cpu"]
            and out["bfloat16"]["identical_runs"]):
        fail(f"the fused max-pool backward is not deterministic: {out}")
    return out


#: the fused max pool's two forms at MNIST conv's and CIFAR conv's 2x2
#: pools, batch 100 in the fused step's bf16: (pool, NHWC input)
MAXPOOL_FORM_SHAPES = (("mnist_conv.pool1", (100, 28, 28, 32)),
                       ("mnist_conv.pool2", (100, 14, 14, 64)),
                       ("cifar_conv.pool1", (100, 32, 32, 32)),
                       ("cifar_conv.pool2", (100, 16, 16, 64)))


def fused_maxpool_forms() -> list:
    """``max_forward_fast``'s reshape form (windows that tile the input)
    against the strided-tap form, which computes the same bits, at the
    2x2 pools that take it: forward and backward bit for bit on an input
    of a few levels (ties in most windows), then each form's forward and
    forward + backward timed on the device (a spin kernel ahead) and on
    the host (what a host-bound step pays to issue it)."""
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 53)
    forms = {"reshape": lambda t: tpool_ops._MaxPoolNonoverlap.apply(
                 t, 2, 2),
             "taps": lambda t: tpool_ops._MaxPoolTaps.apply(t, 2, 2, 2, 2)}
    rows = []
    for pool, shape in MAXPOOL_FORM_SHAPES:
        x = torch.randint(0, 4, shape, generator=gen,
                          device=DEVICE).to(torch.bfloat16)
        x.requires_grad_(True)
        g = torch.randn((shape[0], shape[1] // 2, shape[2] // 2, shape[3]),
                        generator=gen, device=DEVICE).to(torch.bfloat16)
        row, got = {"pool": pool, "shape": list(shape)}, {}
        for form, fn in forms.items():
            y = fn(x)
            got[form] = (y, torch.autograd.grad(y, x, g)[0])

            def both(fn=fn):
                return torch.autograd.grad(fn(x), x, g)[0]

            row[form] = {"fwd_ms": time_cuda_ms(lambda fn=fn: fn(x),
                                                lead=True),
                         "fwd_bwd_ms": time_cuda_ms(both, lead=True),
                         "fwd_host_us": host_us(lambda fn=fn: fn(x)),
                         "fwd_bwd_host_us": host_us(both)}
        row["identical"] = all(torch.equal(a, b) for a, b in
                               zip(got["reshape"], got["taps"]))
        rows.append(row)
        if not row["identical"]:
            fail(f"the fused max pool's two forms differ: {row}")
    return rows


def phase_fused_conv_parity() -> dict:
    """The fused conv shape in f32, the card against the CPU (identical
    n_err, weights within FCP_WEIGHT_ATOL, which TF32 must fail) for the
    test-size AlexNet and MNIST conv with stochastic pools (cuDNN off,
    then on at FCP_CUDNN_WEIGHT_ATOL); MNIST conv and CIFAR conv fused at
    their own widths on the card; the fused max-pool backward's
    determinism at AlexNet's pool1 and its two forms at the 2x2 pools.
    Every run is made before the first check fails."""
    def spread(a, b):
        return max(float(np.abs(x - y).max()) for name in a
                   for x, y in zip(a[name], b[name]))

    out = {"phase": "fused_conv_parity", "epochs": FCP_EPOCHS,
           "band": {"weight_atol": FCP_WEIGHT_ATOL,
                    "cudnn_weight_atol": FCP_CUDNN_WEIGHT_ATOL}}
    bad, cpu = [], {}
    for name, which, cudnn, band in (
            ("alexnet", "alexnet", True, FCP_WEIGHT_ATOL),
            ("mnist_conv_stochastic", "mnist_conv_stochastic", False,
             FCP_WEIGHT_ATOL),
            ("mnist_conv_stochastic_cudnn", "mnist_conv_stochastic", True,
             FCP_CUDNN_WEIGHT_ATOL)):
        if which not in cpu:
            cpu[which] = _fused_parity_run(which, "cpu")
        card = _fused_parity_run(which, DEVICE, cudnn=cudnn)
        tf32 = _fused_parity_run(which, DEVICE, allow_tf32=True,
                                 cudnn=cudnn)
        r = out[name] = {"cudnn": cudnn, "band": band,
                         "history_card": card[0],
                         "history_cpu": cpu[which][0],
                         "weight_max_abs": spread(card[1], cpu[which][1]),
                         "tf32_control_weight_max_abs": spread(
                             tf32[1], cpu[which][1]),
                         "graph_replays": card[2]}
        if card[0] != cpu[which][0]:
            bad.append(f"{name} n_err card != cpu")
        if not r["weight_max_abs"] <= band:
            bad.append(f"{name} weights card vs cpu")
        if not r["tf32_control_weight_max_abs"] > band:
            bad.append(f"the {name} band passes the TF32 control")
        if card[2] != card[3] or tf32[2] != tf32[3]:
            bad.append(f"{name} replays {card[2]} {tf32[2]}, want "
                       f"{card[3]}")
    from znicz_tpu_torch.models import cifar_conv as tcifar

    for name, mod in (("mnist_conv", tmnist_conv), ("cifar_conv", tcifar)):
        tprng.seed_all(SEED)
        w = mod.build(loader_name="synthetic_image", max_epochs=1,
                      n_train=FCP_MODEL_TRAIN, n_valid=FCP_MODEL_VALID)
        w.initialize(device=TorchDevice())
        before = _conv_fc_weights(w)
        t0 = time.perf_counter()
        w.run()
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        w.step.sync_to_units()
        after = _conv_fc_weights(w)
        r = out[name] = {"compute": str(w.step.compute_dtype),
                         "batch": w.loader.max_minibatch_size,
                         "wall_s": wall_s,
                         "history": w.decision.metrics_history,
                         "weights_finite": all(np.isfinite(a).all()
                                               for v in after.values()
                                               for a in v),
                         "layers_trained": sum(
                             not np.array_equal(after[k][0], before[k][0])
                             for k in after), "layers": len(after)}
        if not (bool(w.decision.complete) and r["weights_finite"] and
                r["layers_trained"] == r["layers"]):
            bad.append(f"{name} fused did not train")
        del w
    out["pool_backward"] = fused_pool_backward_check()
    out["maxpool_forms"] = fused_maxpool_forms()
    if bad:
        fail(f"fused_conv_parity: {bad}: {out}")
    return out


#: graph_parity: the graphed step against its unrolled body over GP_STEPS
#: train steps, every learning rate halved before step GP_LR_AT
GP_STEPS, GP_LR_AT = 8, 4
#: the fused step's modes on the card (f32, TF32 off) against the CPU:
#: the bands of tests/test_torch_port_fused_modes.py (summation order
#: only, ~1e-7 on these tiny nets)
MODES_WEIGHT_ATOL = 1e-6


def _gp_mnist(**kw):
    return lambda: tmnist.build_fused(max_epochs=1, layers=FC_LAYERS,
                                      minibatch_size=FC_BATCH,
                                      n_train=2 * FC_BATCH, n_valid=0, **kw)


def _gp_alexnet():
    return StandardWorkflow(
        name="alexnet67", layers=small_alexnet_layers(0.5, 0.03),
        loss_function="softmax", loader_name="synthetic_image",
        loader_config={"n_classes": 10, "sample_shape": (67, 67, 3),
                       "n_train": 64, "n_valid": 0, "minibatch_size": 8,
                       "spread": 1.0, "noise": 0.5},
        decision_config={"max_epochs": 1}, fused=True)


def _gp_mnist_conv():
    return StandardWorkflow(
        name="mnist_conv_stochastic", layers=stochastic_mnist_layers(),
        loss_function="softmax", loader_name="synthetic_image",
        loader_config={"n_classes": 10, "sample_shape": (28, 28, 1),
                       "n_train": 200, "n_valid": 0, "minibatch_size": 100,
                       "spread": 2.5, "noise": 1.0},
        decision_config={"max_epochs": 1}, fused=True)


def _gp_staged(w, k: int):
    """``k`` minibatches staged on the card from the step's pinned data
    set (rolled copies of its first minibatch's rows)."""
    data, labels = w.step._dataset_dev
    b = w.loader.max_minibatch_size
    idx = torch.tensor((np.arange(b)[None, :] - np.arange(k)[:, None]) %
                       data.shape[0], device=DEVICE)
    return data[idx], labels[idx], torch.ones((k, b), dtype=torch.bool,
                                              device=DEVICE)


def _graph_parity_case(make, deterministic: bool) -> dict:
    """Two workflows from one seed on the card: one through
    ``train_steps`` a step at a time (each a graph replay but the first),
    its twin through the step's unrolled body (``_train_step``, eager
    launches), the learning rates halved on both before step GP_LR_AT.
    Every step's metrics and, at the end, every tensor of the params
    (weights, velocities, moments, step counts) compared bit for bit.
    ``deterministic``: cuDNN's deterministic algorithms on both twins
    (its backward may sum with atomics in a varying order)."""
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = deterministic
    try:
        twins = []
        for _ in range(2):
            tprng.seed_all(SEED + 61)
            w = make()
            w.initialize(device=TorchDevice())
            twins.append(w)
        graphed, eager = twins
        xs, ys, ms = _gp_staged(graphed, GP_STEPS)
        buf = graphed.step._hyper_buf.data_ptr()
        differ = []
        for k in range(GP_STEPS):
            if k == GP_LR_AT:
                for w in twins:
                    for gd in w.gds:
                        gd.learning_rate *= 0.5
                        gd.learning_rate_bias *= 0.5
            got = graphed.step.train_steps(xs[k:k + 1], ys[k:k + 1],
                                           ms[k:k + 1])
            want = eager.step._train_step(xs[k], ys[k], ms[k])
            differ += [f"step {k} {key}" for key in want
                       if not torch.equal(got[key], want[key])]
        torch.cuda.synchronize()
        differ += [f"{i}.{key}" for i, (a, b) in enumerate(zip(
            graphed.step._params, eager.step._params)) for key in a
            if not torch.equal(a[key], b[key])]
        lr = float(graphed.step._hyper_views[0]["lr"])
        return {"differ": differ, "replays": replays_of(graphed.step),
                "hyper_buffer_kept": graphed.step._hyper_buf.data_ptr() ==
                buf, "lr_after": lr,
                "tensors": sum(len(leaf) for leaf in graphed.step._params),
                "loss_last": float(got["loss"])}
    finally:
        torch.backends.cudnn.deterministic = det


def _modes_run(mode: str, device: str) -> tuple:
    """One fused mode from one seed in f32 on ``device`` -> (history,
    weights): accumulate_steps 4 (4 x 16, SGD), ema_decay 0.8 (the
    averaged weights) or scan_epoch."""
    tprng.seed_all(SEED + 67)
    hyper = {"learning_rate": 0.05, "learning_rate_bias": 0.05,
             "gradient_moment": 0.9, "gradient_moment_bias": 0.9}
    layers = [{"type": "all2all_tanh", "->": {"output_sample_shape": 12},
               "<-": dict(hyper)},
              {"type": "softmax", "->": {"output_sample_shape": 4},
               "<-": dict(hyper)}]
    loader = {"n_classes": 4, "sample_shape": (6,), "n_train": 64,
              "n_valid": 0 if mode == "accumulate" else 30,
              "minibatch_size": 16, "shuffle_limit": 0}
    kw = {"accumulate": {"accumulate_steps": 4},
          "ema": {"ema_decay": 0.8}, "scan": {}}[mode]
    root.common.engine.scan_epoch = mode == "scan"
    try:
        w = StandardWorkflow(name=mode, layers=layers,
                             loss_function="softmax",
                             loader_name="synthetic_classifier",
                             loader_config=loader,
                             decision_config={"max_epochs": 3}, **kw)
        w.initialize(device=TorchDevice(device, precision="float32"))
    finally:
        root.common.engine.scan_epoch = False
    w.run()
    w.step.sync_to_units()
    weights = [np.array(a.map_read()) for f in w.forwards
               for a in (f.weights, f.bias)]
    if mode == "ema":
        weights = [leaf[k] for leaf in w.step.ema_params() for k in "wb"]
    return w.decision.metrics_history, weights, w.step


def phase_graph_parity() -> dict:
    """The graphed fused step against its unrolled body on the card, bit
    for bit over GP_STEPS steps with an LR change: MNIST FC at bench_fc's
    widths with bf16 velocity, the same with AdamW, the 67-px AlexNet
    with dropout 0.5 and MNIST conv with both pools stochastic at its
    own widths (the step's generator drawn in every replay); then
    accumulate_steps, ema_decay and scan_epoch each once on the card
    against the CPU in f32."""
    out = {"phase": "graph_parity", "steps": GP_STEPS, "lr_halved_at":
           GP_LR_AT, "modes_weight_atol": MODES_WEIGHT_ATOL}
    bad = []
    for name, make, det in (
            ("mnist_sgd_bf16_velocity",
             _gp_mnist(optimizer_config={"state_dtype": "bfloat16"}), False),
            ("mnist_adamw", _gp_mnist(optimizer="adam"), False),
            ("alexnet67_dropout", _gp_alexnet, True),
            ("mnist_conv_stochastic", _gp_mnist_conv, True)):
        r = out[name] = _graph_parity_case(make, det)
        if r["differ"] or r["replays"] != {"steps": GP_STEPS - 1} or \
                not r["hyper_buffer_kept"]:
            bad.append(name)
    for mode in ("accumulate", "ema", "scan"):
        card, cpu = _modes_run(mode, DEVICE), _modes_run(mode, "cpu")
        r = out[mode] = {
            "history_card": card[0], "history_cpu": cpu[0],
            "weight_max_abs": max(float(np.abs(a - b).max())
                                  for a, b in zip(card[1], cpu[1])),
            "replays": replays_of(card[2])}
        if card[0] != cpu[0] or not r["weight_max_abs"] <= \
                MODES_WEIGHT_ATOL or not r["replays"] or \
                not all(r["replays"].values()):
            bad.append(mode)
    if bad:
        fail(f"graph_parity: {bad}: {out}")
    return out


#: the reference's kernel-layer families (utils/pallas_hw.py run_parity)
KERNEL_HW_FAMILIES = {"sgd", "adam", "dropout", "lrn", "fc_gemm",
                      "conv_fwd", "conv_bwd", "deconv", "stochastic_pool",
                      "kohonen", "flash_attention", "conv_fwd_bf16",
                      "flash_attention_bf16", "sgd_bf16state"}


def phase_kernel_hw() -> dict:
    """utils/kernel_hw.run_parity on the card, the launch counters of the
    kernels only this path reaches (dropout, the bf16 conv forward) and
    of LRN's set to 0 just before and read just after: all fourteen
    families of the reference must be there and ok."""
    torch.cuda.synchronize()
    klrn.fwd_launches = klrn.bwd_launches = kdrop.launches = 0
    kconv.fwd_bf16_launches = 0
    t0 = time.perf_counter()
    results = run_parity(DEVICE)
    wall_s = time.perf_counter() - t0
    launches = {"lrn_forward": klrn.fwd_launches,
                "lrn_backward": klrn.bwd_launches,
                "dropout_forward": kdrop.launches,
                "conv2d_fwd_bf16": kconv.fwd_bf16_launches}
    out = {"phase": "kernel_hw", "results": results, "launches": launches,
           "wall_s": wall_s}
    if set(results) != KERNEL_HW_FAMILIES or \
            any(v != "ok" for v in results.values()) or \
            not all(launches.values()):
        fail(f"run_parity on the card: {out}")
    return out


def _stream(port: int, ids: list, out: dict,
            max_tokens: int = MAX_TOKENS) -> None:
    body = json.dumps({"tokens": ids, "max_tokens": max_tokens,
                       "temperature": 0.0}).encode()
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/generate", data=body,
        headers={"Content-Type": "application/json"})
    t0 = time.perf_counter()
    events = []
    with urllib.request.urlopen(req, timeout=600) as r:
        for raw in r:
            if not events:
                out["ttft_ms"] = (time.perf_counter() - t0) * 1e3
            events.append(json.loads(raw))
    out["events"] = events
    out["total_ms"] = (time.perf_counter() - t0) * 1e3


def serve_prompts() -> list:
    """The serve phase's 12 prompts of PROMPT_LENS ids, from its seed."""
    rng = np.random.default_rng(SEED + 1)
    return [rng.integers(0, VOCAB, n).tolist() for n in PROMPT_LENS]


def serve_args(pkg: str, *extra: str):
    return build_generate_parser().parse_args(
        [pkg, "--serve", "--port", "0", "--slots", str(SLOTS),
         "--max-len", str(MAX_LEN), "--page-size", str(PAGE),
         "--device", DEVICE, *extra])


def stream_all(port: int, prompts: list) -> tuple:
    """Every prompt streamed at once, a thread each -> (results, wall
    s); fails if a stream does not finish."""
    results = [{} for _ in prompts]
    t0 = time.perf_counter()
    threads = [threading.Thread(target=_stream, args=(port, ids, out))
               for ids, out in zip(prompts, results)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    if any(t.is_alive() for t in threads):
        fail("a request stream did not finish")
    return results, time.perf_counter() - t0


def streamed_tokens(prompts, results) -> list:
    """Each request's tokens; fails unless it streamed MAX_TOKENS ids in
    the vocab and ended with its one terminal ``length`` event."""
    streams = []
    for ids, res in zip(prompts, results):
        events = res.get("events", [])
        toks = [e["token"] for e in events if "token" in e]
        last = events[-1] if events else {}
        if not (last.get("done") and last.get("reason") == "length"
                and "error" not in last):
            fail(f"prompt of {len(ids)} tokens ended with {last}")
        if len(toks) != MAX_TOKENS or not all(0 <= t < VOCAB
                                              for t in toks):
            fail(f"prompt of {len(ids)} tokens streamed {len(toks)} "
                 f"tokens, want {MAX_TOKENS} ids in [0, {VOCAB})")
        streams.append(toks)
    return streams


def phase_serve(pkg: str) -> dict:
    args = serve_args(pkg)
    t0 = time.perf_counter()
    lm_params, meta = load_lm(pkg)
    server = start_generate_server(args, lm_params, meta)
    boot_s = time.perf_counter() - t0
    decoder = server.decoder
    if decoder.device.type != DEVICE or \
            decoder.dtype != resolve_compute_dtype(DEVICE):
        fail(f"server decodes in {decoder.dtype} on {decoder.device}")
    prompts = serve_prompts()
    steps0 = decoder.decode_steps
    TRACER.clear()
    kdecode.launches = 0                     # counts: 0 just before ...
    results, wall_s = stream_all(server.port, prompts)
    launches = kdecode.launches              # ... and read just after
    steps = decoder.decode_steps - steps0
    server.stop()                            # drains: the ledger is final
    snap = server.metrics.snapshot()
    streams = streamed_tokens(prompts, results)
    n_tokens = sum(map(len, streams))
    if launches < steps * N_LAYERS or launches == 0:
        fail(f"paged_decode launched {launches} times over {steps} "
             f"decode steps x {N_LAYERS} layers")
    step_ms = [e["dur"] / 1e3 for e in TRACER.tail(len(TRACER))
               if e["name"] == "generate.decode_step"]
    ttft = [r["ttft_ms"] for r in results]
    if snap["completed"] != len(prompts):
        fail(f"ledger: {snap}")
    return {"phase": "serve", "boot_s": boot_s, "requests": len(prompts),
            "prompt_lens": list(PROMPT_LENS), "max_tokens": MAX_TOKENS,
            "dtype": str(decoder.dtype), "decode_steps": steps,
            "kernel_launches": launches,
            "launches_per_step": launches / max(steps, 1),
            "ttft_ms": ttft, "ttft_ms_p50": float(np.median(ttft)),
            "ttft_ms_max": float(max(ttft)),
            "decode_step_ms_p50": float(np.median(step_ms)),
            "decode_step_ms_mean": float(np.mean(step_ms)),
            "tokens": n_tokens, "wall_s": wall_s,
            "tokens_per_s": n_tokens / wall_s,
            "ledger": {k: snap[k] for k in ("admitted", "completed",
                                            "failed", "abandoned")},
            "_streams": streams, "_decoder": decoder}


@contextlib.contextmanager
def shifted_frontier():
    """The control: while open, every verify pass (a paged_decode call
    on the SLOTS·(SPEC_K + 1) flattened queries) sees one row past its
    frontier (query ``i`` also sees row ``pos + i + 1``, the proposal it
    judges), clamped to the page view; single-query steps are left as
    they are."""
    kernel = kdecode.paged_decode
    n_verify = SLOTS * (SPEC_K + 1)

    def shifted(q, k_pages, v_pages, page_table, lengths):
        if q.shape[0] == n_verify:
            lengths = torch.clamp(
                lengths + 1, max=page_table.shape[1] * k_pages.shape[1])
        return kernel(q, k_pages, v_pages, page_table, lengths)

    kdecode.paged_decode = shifted
    try:
        yield
    finally:
        kdecode.paged_decode = kernel


def redecode_logits(dec, prompt, prefix) -> np.ndarray:
    """Plain decode of ``prompt`` then ``prefix`` (teacher-forced) in
    slot 0 of the paged decoder ``dec``; the logits that choose the
    token after the prefix."""
    pages = dec.ledger.alloc(dec.pages_for(len(prompt) + len(prefix)))
    try:
        kv1, logits = dec.prefill(prompt)
        dec.adopt_paged(kv1, pages[:dec.pages_for(len(prompt))])
        pt = np.zeros((dec.batch, dec.view_bucket(len(pages))), np.int32)
        pt[0, :len(pages)] = pages
        pos = np.zeros(dec.batch, np.int32)
        tok = np.zeros(dec.batch, np.int32)
        for i, t in enumerate(prefix):
            pos[0], tok[0] = len(prompt) + i, t
            logits = dec.decode_paged(pt, pos, tok)[0]
        return logits
    finally:
        dec.ledger.release(pages)


def stream_identity(got, want, prompts, plain_decoder, band) -> dict:
    """The token-identity gate: every speculative stream must equal its
    plain one.  At a stream's first mismatch the prefix is re-decoded
    by a plain decoder (``plain_decoder()``, made at the first need) and
    the mismatch passes only as a tie: both tokens' logits within
    ``band`` of the top one (the top-2 gap is printed beside)."""
    ties, bad, dec = [], [], None
    for r, (g, w, ids) in enumerate(zip(got, want, prompts)):
        if g == w:
            continue
        if len(g) != len(w):
            bad.append({"request": r, "lengths": [len(g), len(w)]})
            continue
        j = next(i for i, (a, b) in enumerate(zip(g, w)) if a != b)
        dec = dec or plain_decoder()
        lg = redecode_logits(dec, ids, w[:j])
        top = np.sort(lg)[-2:]
        case = {"request": r, "prompt_len": len(ids), "position": j,
                "spec": g[j], "plain": w[j],
                "top2_gap": float(top[1] - top[0]),
                "deficit": float(top[1] - min(lg[g[j]], lg[w[j]]))}
        (ties if case["deficit"] <= band else bad).append(case)
    return {"identical": sum(g == w for g, w in zip(got, want)),
            "streams": len(got), "ties": ties, "mismatches": bad,
            "band": band, "ok": not bad}


def _spec_http(pkg, prompts, plain_streams) -> tuple:
    """(a): the CLI's speculative server, bf16, the serve phase's
    traffic; -> (reading, failures)."""
    t0 = time.perf_counter()
    lm_params, meta = load_lm(pkg)
    server = start_generate_server(
        serve_args(pkg, "--speculative", "--spec-k", str(SPEC_K),
                   "--draft-layers", str(DRAFT_LAYERS)),
        lm_params, meta)
    boot_s = time.perf_counter() - t0
    target, draft = server.decoder, server.batcher._draft
    with urllib.request.urlopen(
            f"http://127.0.0.1:{server.port}/meta", timeout=60) as r:
        meta_doc = json.loads(r.read())
    TRACER.clear()
    kdecode.launches = 0                     # counts: 0 just before ...
    results, wall_s = stream_all(server.port, prompts)
    launches = kdecode.launches              # ... and read just after
    spans = [e for e in TRACER.tail(len(TRACER))
             if e["name"] == "generate.decode_step"]
    server.stop()                            # drains: the ledgers are final
    snap = server.metrics.snapshot()
    ledger = server.batcher.page_ledger()
    streams = streamed_tokens(prompts, results)
    spec_ms = [e["dur"] / 1e3 for e in spans if e["args"]["spec_k"]]
    plain_rounds = sum(not e["args"]["spec_k"] for e in spans)
    want_launches = len(spec_ms) * ((SPEC_K + 1) * draft.n_layers
                                    + target.n_layers) \
        + plain_rounds * target.n_layers
    judged = snap["spec_accepted"] + snap["spec_rejected"]
    slot_rounds = judged // SPEC_K
    ident = stream_identity(
        streams, plain_streams, prompts,
        lambda: PagedKVDecoder(lm_params, heads=HEADS, max_len=MAX_LEN,
                               batch=SLOTS, page=PAGE, device=DEVICE),
        PARITY_ATOL_BF16)
    bad = []
    if not ident["ok"]:
        bad.append(f"(a) streams differ from plain decode: {ident}")
    if launches != want_launches:
        bad.append(f"(a) paged_decode launched {launches} times, want "
                   f"{want_launches} ({len(spec_ms)} speculative and "
                   f"{plain_rounds} plain rounds)")
    if judged <= 0 or judged % SPEC_K:
        bad.append(f"(a) {judged} draft tokens judged, want a positive "
                   f"multiple of {SPEC_K}")
    if ledger.get("pages_used") != 0 or ledger.get("draft_pages_used") \
            != 0:
        bad.append(f"(a) page ledgers after stop: {ledger}")
    if meta_doc.get("speculative") is not True:
        bad.append(f"(a) /meta: {meta_doc}")
    if snap["completed"] != len(prompts):
        bad.append(f"(a) admission ledger: {snap}")
    ttft = [r["ttft_ms"] for r in results]
    return {"boot_s": boot_s, "dtype": str(target.dtype),
            "requests": len(prompts), "max_tokens": MAX_TOKENS,
            "identity": ident, "kernel_launches": launches,
            "expected_launches": want_launches,
            "rounds": {"speculative": len(spec_ms), "plain": plain_rounds},
            "spec_accepted": snap["spec_accepted"],
            "spec_rejected": snap["spec_rejected"],
            "acceptance_rate": snap["spec_accepted"] / max(judged, 1),
            "tokens_per_greedy_slot_round":
                1 + snap["spec_accepted"] / max(slot_rounds, 1),
            "round_ms_p50": float(np.median(spec_ms)) if spec_ms
            else None,
            "ttft_ms_p50": float(np.median(ttft)),
            "tokens": sum(map(len, streams)), "wall_s": wall_s,
            "tokens_per_s": sum(map(len, streams)) / wall_s,
            "page_ledger": ledger, "speculative_meta":
                meta_doc.get("speculative")}, bad


def _f32_decoders(lm_params, draft_params=None) -> tuple:
    root.common.engine.precision = "float32"
    try:
        kw = dict(heads=HEADS, max_len=MAX_LEN, batch=SLOTS, page=PAGE,
                  device=DEVICE)
        return (PagedKVDecoder(lm_params, **kw),
                None if draft_params is None else
                PagedKVDecoder(draft_params, **kw))
    finally:
        root.common.engine.precision = "bfloat16"


def _batched(decoder, prompts, n_new, draft=None) -> tuple:
    """-> (each prompt's stream, the draft tokens accepted and rejected)."""
    batcher = ContinuousBatcher(decoder, draft=draft, spec_k=SPEC_K,
                                default_timeout_s=600.0)
    try:
        streams = [batcher.submit(ids, max_new_tokens=n_new)
                   for ids in prompts]
        streams = [s.result(timeout_s=600) for s in streams]
    finally:
        batcher.stop()
    snap = batcher.metrics.snapshot()
    return streams, (snap["spec_accepted"], snap["spec_rejected"])


def _spec_f32(lm_params, prompts) -> tuple:
    """(b): target and draft in f32 on the card, TF32 off; the batcher
    with and without the draft; with a draft of the target's own
    weights, which accepts, so rounds emit several tokens and the next
    round reuses the accepted rows; and the control (the target's
    frontier one row later), which the identity gate must reject."""
    target, draft = _f32_decoders(lm_params,
                                  truncate_draft(lm_params, DRAFT_LAYERS))
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        plain, _ = _batched(target, prompts, SPEC_F32_TOKENS)
        spec, judged = _batched(target, prompts, SPEC_F32_TOKENS, draft)
        self_draft = _f32_decoders(lm_params)[0]
        own, own_judged = _batched(target, prompts, SPEC_F32_TOKENS,
                                   self_draft)
        del self_draft
        with shifted_frontier():
            shifted, _ = _batched(target, prompts, SPEC_F32_TOKENS, draft)

        def plain_decoder():
            return _f32_decoders(lm_params)[0]

        ident = stream_identity(spec, plain, prompts, plain_decoder,
                                PARITY_ATOL_F32)
        own_ident = stream_identity(own, plain, prompts, plain_decoder,
                                    PARITY_ATOL_F32)
        control = stream_identity(shifted, plain, prompts, plain_decoder,
                                  PARITY_ATOL_F32)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    bad = []
    if not ident["ok"]:
        bad.append(f"(b) f32 streams differ from plain decode: {ident}")
    if not own_ident["ok"]:
        bad.append(f"(b) f32 streams with the target's own weights as "
                   f"the draft differ from plain decode: {own_ident}")
    if own_judged[0] <= 0:
        bad.append(f"(b) the target's own weights as the draft accepted "
                   f"nothing: {own_judged}")
    if control["ok"]:
        bad.append(f"(b) the identity gate passed the shifted-frontier "
                   f"control: {control}")
    return {"dtype": str(target.dtype), "requests": len(prompts),
            "max_tokens": SPEC_F32_TOKENS, "identity": ident,
            "accepted_rejected": list(judged),
            "own_weights_draft": {
                "identity": own_ident, "accepted_rejected": list(own_judged),
                "acceptance_rate": own_judged[0] / max(sum(own_judged), 1)},
            "control": {"rejected": not control["ok"],
                        "mismatches": len(control["mismatches"]),
                        "identical": control["identical"]}}, bad


def _verify_parity(lm_params, precision, prompts, band) -> dict:
    """(c): two decoders with identical arenas (the prompts adopted
    into one, its arena copied into the other), one verify of SPEC_K + 1
    rows against as many single-token decode steps fed the same tokens,
    and the control (the frontier one row later) from the same arena."""
    root.common.engine.precision = precision
    try:
        kw = dict(heads=HEADS, max_len=MAX_LEN, batch=SLOTS, page=PAGE,
                  device=DEVICE)
        a, b = PagedKVDecoder(lm_params, **kw), PagedKVDecoder(lm_params,
                                                               **kw)
    finally:
        root.common.engine.precision = "bfloat16"
    q_len = SPEC_K + 1
    pos = np.asarray([len(p) for p in prompts], np.int32)
    pages = []
    for ids in prompts:
        pg = a.ledger.alloc(a.pages_for(len(ids) + q_len))
        kv1, _ = a.prefill(ids)
        a.adopt_paged(kv1, pg[:a.pages_for(len(ids))])
        pages.append(pg)
    crossing = [int(n) for n in pos if n // PAGE != (n + q_len - 1) // PAGE]
    if not crossing:
        fail(f"verify_parity: no slot crosses a page inside {q_len} rows")
    pt = np.zeros((SLOTS, a.view_bucket(max(map(len, pages)))), np.int32)
    for i, pg in enumerate(pages):
        pt[i, :len(pg)] = pg
    start = {n: t.clone() for n, t in a._arena.items()}
    for n, t in b._arena.items():
        t.copy_(start[n])
    tokens = np.random.default_rng(SEED + 4).integers(
        0, VOCAB, (SLOTS, q_len)).astype(np.int32)
    got = a.verify_paged(pt, pos, tokens)
    want = np.stack([b.decode_paged(pt, pos + i, tokens[:, i])
                     for i in range(q_len)], axis=1)
    for n, t in a._arena.items():
        t.copy_(start[n])
    with shifted_frontier():
        shifted = a.verify_paged(pt, pos, tokens)
    if not (np.isfinite(got).all() and np.isfinite(want).all()):
        fail(f"verify_parity: non-finite logits ({precision})")
    out = {"dtype": str(a.dtype), "q_len": q_len, "slot_lengths":
           pos.tolist(), "crossing_page": crossing,
           "max_abs_logit_diff": float(np.abs(got - want).max()),
           "argmax_flips": int((got.argmax(-1) != want.argmax(-1)).sum()),
           "compared": SLOTS * q_len, "band": band,
           "control_max_abs_diff": float(np.abs(shifted - want).max())}
    out["ok"] = out["max_abs_logit_diff"] <= band
    out["control_rejected"] = out["control_max_abs_diff"] > band
    if precision == "bfloat16":
        out["timed"] = _verify_timed(a, pt, pos, q_len)
    return out


def verify_bound_bytes(q, k_pages, pt, pos, q_len) -> int:
    """Bytes the verify pass's attention must move: the B·Q queries,
    each slot's live K and V rows (``pos + Q`` of them) read ONCE for
    all its Q queries, the slots' page table and positions, and the f32
    output.  The flattened call reads a slot's rows Q times; that is its
    cost, not the function's."""
    n, H, Dh = q.shape
    rows = int((np.asarray(pos, np.int64) + q_len).sum())
    return (q.numel() * q.element_size()
            + 2 * rows * H * Dh * k_pages.element_size()
            + pt.size * 4 + pos.size * 4 + n * H * Dh * 4)


def _verify_timed(dec, pt, pos, q_len) -> dict:
    """The verify pass's kernel call (B·Q flattened queries, each with
    its slot's page-table row and frontier) beside the single-query
    step's at the same view, on one arena layer, with their splits and
    byte bounds.  The verify's bound reads each slot's rows once
    (:func:`verify_bound_bytes`); ``flattened_bytes_ms`` is the time
    of the bytes the flattened call reads, each slot's rows Q times."""
    rng = np.random.default_rng(SEED + 5)
    ka, va = dec._arena["k"][0], dec._arena["v"][0]
    rows = pos[:, None] + np.arange(q_len)[None, :]
    cases = {"verify": (np.repeat(pt, q_len, axis=0), (rows + 1).ravel()),
             "decode": (pt, pos + 1)}
    out = {}
    for name, (table, lengths) in cases.items():
        q = torch.tensor(rng.normal(size=(len(lengths), HEADS, D // HEADS)),
                         dtype=dec.dtype, device=DEVICE)
        table = torch.tensor(table, device=DEVICE)
        lengths = torch.tensor(lengths, dtype=torch.int32, device=DEVICE)
        ms = time_cuda_ms(lambda: kdecode.paged_decode(q, ka, va, table,
                                                       lengths), lead=True)
        flat = kdecode.bound_bytes(q, ka, table, lengths)
        nbytes = verify_bound_bytes(q, ka, pt, pos, q_len) \
            if name == "verify" else flat
        out[name] = {"queries": len(lengths), "ms": ms,
                     "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
                     "bound_by": "bytes",
                     "flattened_bytes_ms": flat / HBM_BYTES_PER_S * 1e3,
                     "split": dict(zip(("pages_per_split", "splits"),
                                       kdecode.decode_split(
                                           len(lengths), table.shape[1],
                                           PAGE, HEADS)))}
    return out


def phase_speculative(pkg: str, serve: dict, plain_streams: list) -> dict:
    """Speculative decoding (``generate --serve --speculative --spec-k
    SPEC_K --draft-layers DRAFT_LAYERS``) on the serve phase's package:
    (a) its 12 greedy requests over HTTP in bf16, held token for token
    against the serve phase's plain streams, with exact paged_decode
    launches (k + 1 draft steps of one layer and a 6-layer verify a
    speculative round, 6 a plain one, the rounds counted by kind from
    the decode-step spans), both page ledgers closed after stop and
    /meta speculative; (b) the batcher with and without the draft in
    f32 on the card, TF32 off, and the shifted-frontier control the
    identity gate must reject; (c) verify_parity in bf16 and f32: one
    verify of k + 1 rows against k + 1 decode steps on identical
    arenas, within the parity bands, its control outside them."""
    t0 = time.perf_counter()
    prompts = serve_prompts()
    http, bad = _spec_http(pkg, prompts, plain_streams)
    t_a = time.perf_counter()
    lm_params, _ = load_lm(pkg)
    f32, bad_b = _spec_f32(lm_params, prompts[:SPEC_F32_REQUESTS])
    bad += bad_b
    t_b = time.perf_counter()
    parity = {"bf16": _verify_parity(lm_params, "bfloat16",
                                     prompts[:SLOTS], PARITY_ATOL_BF16),
              "f32": _verify_parity(lm_params, "float32",
                                    prompts[:SLOTS], PARITY_ATOL_F32)}
    for name, r in parity.items():
        if not r["ok"]:
            bad.append(f"(c) verify vs decode logits ({name}): {r}")
        if not r["control_rejected"]:
            bad.append(f"(c) the {name} band passed the shifted-frontier "
                       f"control: {r}")
    seconds = time.perf_counter() - t0
    out = {"phase": "speculative", "spec_k": SPEC_K,
           "draft_layers": DRAFT_LAYERS, "http": http, "f32": f32,
           "verify_parity": parity,
           "plain": {k: serve.get(k) for k in (
               "decode_step_ms_p50", "tokens_per_s", "ttft_ms_p50",
               "boot_s")},
           "part_s": {"http": t_a - t0, "f32": t_b - t_a,
                      "verify_parity": seconds - (t_b - t0)},
           "seconds": seconds, "budget_s": SPEC_BUDGET_S,
           "within_budget": seconds <= SPEC_BUDGET_S}
    if bad:
        fail(f"speculative: {bad}")
    return out


def phase_speculative_alone() -> dict:
    """``--phase speculative``: a package of the seeded initial weights
    and its own plain serve pass first (not on the phase's clock)."""
    params = init_params(np.random.default_rng(SEED), N_LAYERS, D, HEADS,
                         FF, VOCAB)
    with tempfile.TemporaryDirectory() as tmp:
        pkg = export_lm(params, os.path.join(tmp, "lm.npz"), heads=HEADS)
        serve = phase_serve(pkg)
        streams = serve.pop("_streams")
        serve.pop("_decoder")
        return phase_speculative(pkg, serve, streams)


def phase_profile(decoder) -> dict:
    """All slots live at the first prompts' lengths plus their 32
    tokens; time PROFILE_STEPS decode steps on the host clock, then
    profile the same steps for device time by kernel.  The idle share
    sets the device's busy time against the wall time of the profiled
    window itself (profiler on)."""
    from torch.profiler import ProfilerActivity, profile

    lens = [n + MAX_TOKENS for n in PROMPT_LENS[:decoder.batch]]
    pages = [decoder.ledger.alloc(decoder.pages_for(n + 1)) for n in lens]
    pt = np.zeros((decoder.batch,
                   decoder.view_bucket(max(map(len, pages)))), np.int32)
    for i, pg in enumerate(pages):
        pt[i, :len(pg)] = pg
    pos = np.asarray(lens, np.int32)
    tok = np.random.default_rng(SEED + 3).integers(
        0, decoder.vocab, decoder.batch).astype(np.int32)

    def steps():
        for _ in range(PROFILE_STEPS):
            decoder.decode_paged(pt, pos, tok)
        torch.cuda.synchronize()

    steps()                                  # warm
    t0 = time.perf_counter()
    steps()
    step_ms = (time.perf_counter() - t0) * 1e3 / PROFILE_STEPS
    # busy and wall time (the idle share) from the same profiled window;
    # device activity only, as recording every host op would stretch
    # this host-bound step
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        steps()
        profiled_ms = (time.perf_counter() - t0) * 1e3 / PROFILE_STEPS
    for pg in pages:
        decoder.ledger.release(pg)
    device = [e for e in prof.key_averages()
              if str(e.device_type).endswith("CUDA")
              and e.self_device_time_total > 0]
    busy_ms = sum(e.self_device_time_total for e in device) / 1e3 \
        / PROFILE_STEPS
    kernel_ms = sum(e.self_device_time_total for e in device
                    if "paged_decode_kernel" in e.key) / 1e3 / PROFILE_STEPS
    top = sorted(device, key=lambda e: -e.self_device_time_total)[:8]
    return {"phase": "profile", "steps": PROFILE_STEPS,
            "slot_lengths": lens, "page_view": int(pt.shape[1]),
            "decode_split": dict(zip(("pages_per_split", "splits"),
                                     kdecode.decode_split(
                                         decoder.batch, pt.shape[1],
                                         decoder.page))),
            "step_ms": step_ms, "profiled_step_ms": profiled_ms,
            "device_busy_ms_per_step": busy_ms or None,
            "paged_decode_ms_per_step": kernel_ms or None,
            "device_idle_share": (1 - busy_ms / profiled_ms) if busy_ms
            else None,
            "kernels_per_step": sum(e.count for e in device)
            / PROFILE_STEPS,
            "top_device": [{"name": e.key[:80], "count": e.count,
                            "ms_per_step": e.self_device_time_total / 1e3
                            / PROFILE_STEPS} for e in top]}


def _teacher_forced(params, precision: str, prompts, n_steps: int) -> dict:
    """Decode ``prompts`` through the paged decoder (kernel attention)
    and the contiguous decoder (plain attention) on the card, feeding
    both the paged decoder's greedy tokens; compare logits at every
    step and count argmax disagreements."""
    root.common.engine.precision = precision
    try:
        batch = len(prompts)
        paged = PagedKVDecoder(params, heads=HEADS, max_len=MAX_LEN,
                               batch=batch, page=PAGE, device=DEVICE)
        contig = KVDecoder(params, heads=HEADS, max_len=MAX_LEN,
                           batch=batch, device=DEVICE)
    finally:
        root.common.engine.precision = "bfloat16"
    bucket = contig.bucket_for(max(len(p) for p in prompts) + n_steps)
    kv = contig.alloc(bucket)
    pages, pos, tok = [], np.zeros(batch, np.int32), \
        np.zeros(batch, np.int32)
    for i, ids in enumerate(prompts):
        pg = paged.ledger.alloc(paged.pages_for(len(ids)))
        kv1, lg = paged.prefill(ids)
        paged.adopt_paged(kv1, pg)
        # the decode rows to come: a page-table append, as the batcher
        pg += paged.ledger.alloc(paged.pages_for(len(ids) + n_steps)
                                 - len(pg))
        kv1c, _ = contig.prefill(ids)
        kv = contig.adopt(kv, kv1c, i)
        pages.append(pg)
        pos[i], tok[i] = len(ids), int(np.argmax(lg))
    pt = np.zeros((batch, paged.view_bucket(max(map(len, pages)))),
                  np.int32)
    for i, pg in enumerate(pages):
        pt[i, :len(pg)] = pg
    worst, flips = 0.0, 0
    for _ in range(n_steps):
        lp = paged.decode_paged(pt, pos, tok)
        kv, lc = contig.decode(kv, pos, tok)
        if not np.isfinite(lp).all():
            fail(f"non-finite paged logits ({precision})")
        worst = max(worst, float(np.abs(lp - lc).max()))
        flips += int((lp.argmax(1) != lc.argmax(1)).sum())
        tok = lp.argmax(1).astype(np.int32)
        pos += 1
    return {"max_abs_logit_diff": worst, "argmax_flips": flips,
            "compared": batch * n_steps, "dtype": str(paged.dtype)}


def phase_parity(params) -> dict:
    rng = np.random.default_rng(SEED + 2)
    prompts = [rng.integers(0, VOCAB, n).tolist() for n in PARITY_LENS]
    out = {"phase": "parity", "prompt_lens": list(PARITY_LENS),
           "steps": PARITY_STEPS,
           "f32": _teacher_forced(params, "float32", prompts,
                                  PARITY_STEPS),
           "bf16": _teacher_forced(params, "bfloat16", prompts,
                                   PARITY_STEPS),
           "atol": {"f32": PARITY_ATOL_F32, "bf16": PARITY_ATOL_BF16},
           "exact": "kernel output bit-identical across two runs "
                    "(phase kernel); the band: logits, kernel vs plain "
                    "attention; bf16 argmax flips are counted, not "
                    "failed"}
    if out["f32"]["max_abs_logit_diff"] > PARITY_ATOL_F32:
        fail(f"f32 kernel-vs-plain logits {out['f32']} > "
             f"{PARITY_ATOL_F32}")
    if out["bf16"]["max_abs_logit_diff"] > PARITY_ATOL_BF16:
        fail(f"bf16 kernel-vs-plain logits {out['bf16']} > "
             f"{PARITY_ATOL_BF16}")
    return out


def _n_matmul(n_layers: int) -> int:
    """Matmul weights of the model, the embedding excluded (its lookup
    does no matmul flops) — bench.py's ``mfu_matmul_only`` count."""
    shapes = param_shapes(n_layers, D, FF, VOCAB)
    leaves = [shapes["head"]] + [s for blk in shapes["blocks"]
                                 for s in blk.values()]
    return sum(int(np.prod(s)) for s in leaves if len(s) >= 2)


def _train_batch(seed: int, b: int, t: int):
    """Seeded tokens with the learnable rule labels = (tokens + 1) mod
    vocab, made on the host and put on the card."""
    tokens = np.random.default_rng(seed).integers(0, VOCAB, (b, t))
    return (torch.tensor(tokens, device=DEVICE),
            torch.tensor((tokens + 1) % VOCAB, device=DEVICE))


def phase_train(params) -> tuple:
    """The full-width training step of bench.py bench_transformer on the
    card, a CUDA graph replay from its second call: two warm steps (the
    eager one and the capture) and TRAIN_STEPS timed ones with both
    flash launch counters set to 0 just before and read just after, then
    two profiled steps (device busy time against the wall time of that
    same window) and the host's time to issue one; then the step's eager
    body (``step.eager``) the same way on a copy of the initial params.
    Returns the report and the trained params."""
    from torch.profiler import ProfilerActivity, profile

    step = make_train_step(None, N_LAYERS, D, HEADS, FF, VOCAB, lr=TRAIN_LR,
                           loss_chunks=TRAIN_CHUNKS, device=DEVICE)
    ps = params_from_numpy(params, DEVICE)
    tokens, labels = _train_batch(SEED, TRAIN_B, TRAIN_T)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kflash.fwd_launches = kflash.bwd_launches = 0   # counts: 0 just before
    losses = [step(ps, tokens, labels)[1] for _ in range(2)]   # warm
    events = []
    for _ in range(TRAIN_STEPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        ps, loss = step(ps, tokens, labels)
        end.record()
        losses.append(loss)
        events.append((start, end))
    torch.cuda.synchronize()
    fwd, bwd = kflash.fwd_launches, kflash.bwd_launches  # ... read after
    peak = torch.cuda.max_memory_allocated()
    losses = [float(x) for x in losses]
    steps = TRAIN_STEPS + 2
    if not all(np.isfinite(losses)):
        fail(f"non-finite training loss: {losses}")
    if not losses[-1] < losses[0]:
        fail(f"training loss did not fall: {losses}")
    if fwd < steps * N_LAYERS or bwd < steps * N_LAYERS:
        fail(f"flash kernels launched fwd {fwd} / bwd {bwd} times over "
             f"{steps} steps x {N_LAYERS} layers")
    step_ms = float(np.median([s.elapsed_time(e) for s, e in events]))
    tokens_per_s = TRAIN_B * TRAIN_T / (step_ms / 1e3)

    def profiled(run, ps) -> dict:
        """Two steps of ``run`` under the profiler (busy and wall time
        from the same window; device activity only, as recording every
        host op would stretch the step), then the host's time to issue
        one step from an idle card: where it exceeds the device busy
        time, the timed step is the host's."""
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(2):
                run(ps, tokens, labels)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3 / 2
        device = [e for e in prof.key_averages()
                  if str(e.device_type).endswith("CUDA")
                  and e.self_device_time_total > 0]
        busy_ms = sum(e.self_device_time_total for e in device) / 1e3 / 2

        def kernel_ms(tag):
            return sum(e.self_device_time_total for e in device
                       if tag in e.key) / 1e3 / 2

        fwd_ms, bwd_ms = kernel_ms("flash_fwd_"), kernel_ms("flash_bwd_")
        top = sorted(device, key=lambda e: -e.self_device_time_total)[:10]
        issue_ms = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run(ps, tokens, labels)
            issue_ms.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
        return {"host_issue_ms": float(np.median(issue_ms)),
                "profile": {
                    "steps": 2, "wall_ms_per_step": wall_ms,
                    "device_busy_ms_per_step": busy_ms or None,
                    "device_idle_share":
                        (1 - busy_ms / wall_ms) if busy_ms else None,
                    "flash_fwd_ms_per_step": fwd_ms or None,
                    "flash_bwd_ms_per_step": bwd_ms or None,
                    "flash_share_of_busy":
                        (fwd_ms + bwd_ms) / busy_ms if busy_ms else None,
                    "ops_per_step": sum(e.count for e in device) / 2,
                    "top_device": [
                        {"name": e.key[:80], "count": e.count,
                         "ms_per_step": e.self_device_time_total / 1e3 / 2}
                        for e in top]}}

    graphed = profiled(step, ps)
    # the eager body on a copy of the initial params (the trained ones
    # stay as they are): timed as the graphed steps were, then where
    # its host time goes (host ops and CUDA API calls by self CPU time)
    probe = params_from_numpy(params, DEVICE)
    step.eager(probe, tokens, labels)
    eager_events = []
    for _ in range(3):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        step.eager(probe, tokens, labels)
        end.record()
        eager_events.append((start, end))
    torch.cuda.synchronize()
    eager = profiled(step.eager, probe)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as host_prof:
        step.eager(probe, tokens, labels)
        torch.cuda.synchronize()
    del probe
    host_ops = [e for e in host_prof.key_averages()
                if e.self_cpu_time_total > 0]
    host_top = sorted(host_ops, key=lambda e: -e.self_cpu_time_total)[:12]
    eager["step_ms"] = float(np.median([s.elapsed_time(e)
                                        for s, e in eager_events]))
    eager["host_profile"] = {
        "self_cpu_ms": sum(e.self_cpu_time_total for e in host_ops) / 1e3,
        "top": [{"name": e.key[:60], "count": e.count,
                 "self_cpu_ms": e.self_cpu_time_total / 1e3}
                for e in host_top]}
    return {"phase": "train", "steps": steps, "timed_steps": TRAIN_STEPS,
            "shape": {"n_layers": N_LAYERS, "d": D, "heads": HEADS,
                      "ff": FF, "vocab": VOCAB, "b": TRAIN_B, "t": TRAIN_T,
                      "loss_chunks": TRAIN_CHUNKS, "lr": TRAIN_LR,
                      "compute": "bfloat16", "masters": "float32"},
            "losses": losses, "step_ms": step_ms,
            "tokens_per_s": tokens_per_s,
            "mfu": 6.0 * _n_matmul(N_LAYERS) * tokens_per_s / BF16_FLOPS,
            "peak_mem_bytes": peak,
            "fwd_launches": fwd, "bwd_launches": bwd,
            "replays": sum(g.replays for g in step.graphs.values() if g),
            **graphed, "eager": eager}, ps


def phase_train_parity() -> dict:
    """Three steps at reduced depth and batch from one seed: on the card
    in f32 with TF32 off (the f32 kernels) against the port on the CPU
    (the plain versions), then on the card in bf16 against the card's
    f32 losses.  The control, the same f32 steps on the card with TF32
    on, must fall outside the f32 bands."""
    params = init_params(np.random.default_rng(SEED + 5), PARITY_LAYERS, D,
                         HEADS, FF, VOCAB)
    tokens, labels = _train_batch(SEED + 6, PARITY_B, PARITY_T)
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)

    def run(device, cdt, allow_tf32=False):
        torch.backends.cuda.matmul.allow_tf32 = allow_tf32
        torch.backends.cudnn.allow_tf32 = allow_tf32
        step = make_train_step(None, PARITY_LAYERS, D, HEADS, FF, VOCAB,
                               lr=TRAIN_LR, compute_dtype=cdt,
                               loss_chunks=PARITY_CHUNKS, device=device)
        ps = params_from_numpy(params, device)
        losses = [float(step(ps, tokens, labels)[1]) for _ in range(3)]
        return losses, params_to_numpy(ps)

    try:
        card, card_params = run(DEVICE, torch.float32)
        cpu, cpu_params = run("cpu", torch.float32)
        card_bf16, bf16_params = run(DEVICE, torch.bfloat16)
        card_tf32, tf32_params = run(DEVICE, torch.float32, allow_tf32=True)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32

    def leaves(p):
        return [p["emb"], p["head"]] + [x for blk in p["blocks"]
                                        for x in blk.values()]

    def vs_cpu(losses, ps):
        """(max relative loss error, max abs param error) against the
        CPU's f32 run."""
        return (max(abs(a - b) / abs(b) for a, b in zip(losses, cpu)),
                max(float(np.abs(a - b).max())
                    for a, b in zip(leaves(ps), leaves(cpu_params))))

    loss_rel, param_err = vs_cpu(card, card_params)
    controls = {"card_tf32": vs_cpu(card_tf32, tf32_params),
                "card_bf16": vs_cpu(card_bf16, bf16_params)}
    bf16_rel = max(abs(a - b) / abs(b) for a, b in zip(card_bf16, card))
    out = {"phase": "train_parity",
           "shape": {"n_layers": PARITY_LAYERS, "d": D, "heads": HEADS,
                     "ff": FF, "vocab": VOCAB, "b": PARITY_B, "t": PARITY_T,
                     "loss_chunks": PARITY_CHUNKS, "lr": TRAIN_LR},
           "losses": {"card_f32": card, "cpu_f32": cpu,
                      "card_bf16": card_bf16, "card_tf32": card_tf32},
           "loss_rel_f32": loss_rel, "param_max_abs_f32": param_err,
           "controls_vs_cpu": {
               name: {"loss_rel": lr_, "param_max_abs": pe}
               for name, (lr_, pe) in controls.items()},
           "loss_rel_bf16_vs_f32": bf16_rel,
           "bands": {"loss_rel_f32": TRAIN_LOSS_RTOL,
                     "param_atol_f32": TRAIN_PARAM_ATOL,
                     "loss_rel_bf16": TRAIN_BF16_RTOL}}
    if not loss_rel <= TRAIN_LOSS_RTOL:
        fail(f"card f32 losses {card} vs cpu {cpu}: {loss_rel}")
    if not param_err <= TRAIN_PARAM_ATOL:
        fail(f"card f32 params vs cpu differ by {param_err}")
    tf32_loss, tf32_param = controls["card_tf32"]
    if tf32_loss <= TRAIN_LOSS_RTOL and tf32_param <= TRAIN_PARAM_ATOL:
        fail(f"the f32 bands pass the TF32 control: losses {tf32_loss}, "
             f"params {tf32_param}")
    if not bf16_rel <= TRAIN_BF16_RTOL:
        fail(f"card bf16 losses {card_bf16} vs f32 {card}: {bf16_rel}")
    return out


def phase_handoff(lm_params) -> dict:
    """The trained params, as read back from their LM package, into a
    paged decoder on the card in f32; 8 greedy tokens from a 100-token
    prompt, each step's logits held against the training forward
    (make_logits_fn, flash forward kernel) on the growing sequence."""
    root.common.engine.precision = "float32"
    try:
        dec = PagedKVDecoder(lm_params, heads=HEADS, max_len=MAX_LEN,
                             batch=1, page=PAGE, device=DEVICE)
    finally:
        root.common.engine.precision = "bfloat16"
    oracle = make_logits_fn(None, N_LAYERS, D, HEADS, FF, VOCAB,
                            compute_dtype=torch.float32, device=DEVICE)
    ps32 = params_from_numpy(lm_params, DEVICE)
    prompt = np.random.default_rng(SEED + 7).integers(
        0, VOCAB, HANDOFF_PROMPT).tolist()
    pages = dec.ledger.alloc(dec.pages_for(HANDOFF_PROMPT + HANDOFF_TOKENS))
    kv1, logits = dec.prefill(prompt)
    dec.adopt_paged(kv1, pages)
    pt = np.zeros((1, dec.view_bucket(len(pages))), np.int32)
    pt[0, :len(pages)] = pages
    seq, decoded, oracle_tokens, worst = list(prompt), [], [], 0.0
    for i in range(HANDOFF_TOKENS):
        want = oracle(ps32, np.asarray([seq]))[0, -1].cpu().numpy()
        if not np.isfinite(logits).all():
            fail("non-finite decoder logits in the handoff")
        worst = max(worst, float(np.abs(logits - want).max()))
        decoded.append(int(np.argmax(logits)))
        oracle_tokens.append(int(np.argmax(want)))
        seq.append(decoded[-1])
        if i + 1 < HANDOFF_TOKENS:
            logits = dec.decode_paged(pt, [len(seq) - 1], [decoded[-1]])[0]
    dec.ledger.release(pages)
    out = {"phase": "handoff", "prompt_len": HANDOFF_PROMPT,
           "tokens": decoded, "oracle_tokens": oracle_tokens,
           "max_abs_logit_diff": worst, "atol": HANDOFF_ATOL,
           "dtype": str(dec.dtype)}
    if decoded != oracle_tokens:
        fail(f"decoded {decoded} != oracle {oracle_tokens}")
    if worst > HANDOFF_ATOL:
        fail(f"decoder vs training-forward logits {worst} > "
             f"{HANDOFF_ATOL}")
    return out


#: the char_lm phase: bench_transformer's block widths over the
#: synthesized corpus (vocab 14): seq_len, minibatch, plain-SGD learning
#: rate (1e-2 diverges within 3 steps, dense and MoE, as 0.05 does for
#: the train phase), epochs through Workflow.run (the first captures
#: the graphs)
CHAR_T, CHAR_B, CHAR_LR, CHAR_EPOCHS = 2048, 8, 1e-3, 2
#: (b) graphed steps against as many eager ones, then timed steps a side
CHAR_GRAPH_STEPS, CHAR_TIMED = 4, 5
#: (c) a remat policy's losses against no remat over 2 steps: the same
#: kernels recompute the same values, so bit-equal is expected; 1e-6
#: leaves room for a reordered sum
CHAR_REMAT_RTOL = 1e-6
#: (d) the MoE step: experts, routing k, aux and z-loss weights; its
#: card-vs-CPU run at 2 layers, d 64 (head dim 64), b 2, t 256, f32.
#: The port's CPU band against JAX is rtol 1e-4 / atol 1e-5 on losses
#: and 1e-5 on params, but three f32 steps at d 64 with TF32 on stay
#: inside it, so the card is held to train_parity's bands (5e-7, 1e-6:
#: summation order only), which the TF32 control must fail
CHAR_MOE = {"n_experts": 4, "moe_top_k": 2, "moe_aux_weight": 0.01,
            "moe_zloss_weight": 1e-3}
CHAR_MOE_SMALL = (2, 64, 1, 256, 2, 256)     # layers, d, heads, ff, b, t
#: (e) requests served, their prompt characters and new tokens each
CHAR_PROMPTS, CHAR_NEW = ("1\tw00", "0\tw01", "1\tw0002 w", "0\t"), 16


def _char_corpus(tmp: str) -> tuple:
    """The synthesized corpus in ``tmp`` -> (directory, vocab)."""
    from znicz_tpu_torch.loader.sequence import CharSequenceLoader

    loader = CharSequenceLoader(None, data_dir=tmp, seq_len=CHAR_T)
    loader.load_data()
    return tmp, loader.vocab


def _char_batch(data_dir: str, vocab: list) -> tuple:
    """The corpus's first CHAR_B - 2 train windows and two padding rows
    as (tokens, labels, mask) on the card."""
    with open(os.path.join(data_dir, "train.txt")) as f:
        ids = np.array([vocab.index(c) for c in f.read()], np.int64)
    n = CHAR_B - 2
    win = ids[:n * CHAR_T + 1]
    tokens = np.zeros((CHAR_B, CHAR_T), np.int64)
    labels = np.zeros((CHAR_B, CHAR_T), np.int64)
    tokens[:n] = win[:-1].reshape(n, CHAR_T)
    labels[:n] = win[1:].reshape(n, CHAR_T)
    mask = np.arange(CHAR_B) < n
    return tuple(torch.tensor(a, device=DEVICE) for a in (tokens, labels,
                                                          mask))


def _char_workflow(data_dir: str) -> tuple:
    """(a): models/char_lm.py ``run(load, main)`` as the CLI drives it
    (``-o root.char_lm.*`` at full width, ``-o
    root.common.engine.lm_export``), through a Launcher on the card.
    Each minibatch's class and host ms recorded; epoch 2's minibatches
    profiled; the flash counters set to 0 just before ``main`` and read
    just after."""
    from torch.profiler import ProfilerActivity, profile

    from znicz_tpu_torch.launcher import Launcher
    from znicz_tpu_torch.models import char_lm

    pkg = os.path.join(data_dir, "char_lm.npz")
    root.char_lm.update({"max_epochs": CHAR_EPOCHS, "seq_len": CHAR_T,
                         "minibatch_size": CHAR_B, "n_layers": N_LAYERS,
                         "d": D, "heads": HEADS, "lr": CHAR_LR,
                         "data_dir": data_dir})
    root.common.engine.lm_export = pkg
    launcher = Launcher(device=TorchDevice())
    seen, prof = [], profile(activities=[ProfilerActivity.CUDA])
    window = []                 # the profiled window's start and end

    def load(builder, **kw):
        w, snap = launcher.load(builder, **kw)
        run, export = w.step.run, w.step.export_lm

        def recorded():
            cls = int(w.loader.minibatch_class)
            epoch = seen[-1][0] + (seen[-1][1] == TRAIN != cls) \
                if seen else 0
            if epoch == CHAR_EPOCHS - 1 and not window:
                prof.start()       # (a process's first start takes s)
                torch.cuda.synchronize()
                window.append(time.perf_counter())
            t0 = time.perf_counter()
            run()
            seen.append((epoch, cls, (time.perf_counter() - t0) * 1e3,
                         w.step.minibatch_mse))

        def exported(path, **kwargs):
            torch.cuda.synchronize()
            window.append(time.perf_counter())
            prof.stop()
            return export(path, **kwargs)

        w.step.run, w.step.export_lm = recorded, exported
        return w, snap

    try:
        tprng.seed_all(SEED + 80)
        kflash.fwd_launches = kflash.bwd_launches = 0   # 0 just before
        t0 = time.perf_counter()
        char_lm.run(load, launcher.main)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        fwd, bwd = kflash.fwd_launches, kflash.bwd_launches  # read after
    finally:
        del root.char_lm
        root.common.engine.lm_export = ""
    w = launcher.workflow
    del w.step.run, w.step.export_lm
    if len(window) != 2 or not os.path.exists(pkg):
        fail(f"char_lm: the run exported nothing ({window}, {pkg})")
    return w, pkg, seen, (fwd, bwd), run_s, device_profile(
        prof, (window[1] - window[0]) * 1e3,
        sum(1 for s in seen if s[0] == CHAR_EPOCHS - 1))


def _char_graphed_vs_eager(params, vocab, batch) -> dict:
    """(b): the graphed step against its eager body from the same params,
    CHAR_GRAPH_STEPS steps each: losses and every param bit for bit;
    then CHAR_TIMED timed steps a side (CUDA events), two profiled steps
    a side (busy and idle share), and the flash kernels a replay runs
    against the counters' increments (the profiler)."""
    from torch.profiler import ProfilerActivity, profile

    step = make_train_step(None, N_LAYERS, D, HEADS, FF, len(vocab),
                           lr=CHAR_LR, masked=True, device=DEVICE)
    graphed = params_from_numpy(params, DEVICE)
    eager = params_from_numpy(params, DEVICE)
    lg = [step(graphed, *batch)[1] for _ in range(CHAR_GRAPH_STEPS)]
    le = [step.eager(eager, *batch)[1] for _ in range(CHAR_GRAPH_STEPS)]
    torch.cuda.synchronize()
    differ = [f"loss {k}" for k, (a, b) in enumerate(zip(lg, le))
              if not torch.equal(a, b)]
    differ += [f"param {i}" for i, (a, b) in enumerate(zip(
        lm_leaves(graphed), lm_leaves(eager))) if not torch.equal(a, b)]
    replays = {key[0]: g.replays for key, g in step.graphs.items() if g}
    out = {"differ": differ, "losses": [float(x) for x in lg],
           "replays": replays}
    for name, fn, ps in (("graphed", step, graphed),
                         ("eager", step.eager, eager)):
        def one(fn=fn, ps=ps):
            fn(ps, *batch)
        ms = []
        for _ in range(CHAR_TIMED):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            one()
            end.record()
            ms.append((start, end))
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(2):
                one()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        issue = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            one()
            issue.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
        out[name] = {"step_ms": float(np.median([s.elapsed_time(e)
                                                 for s, e in ms])),
                     "host_issue_ms": float(np.median(issue)),
                     "profile": device_profile(prof, wall_ms, 2, top=5)}
    out["replayed"] = replayed_launches(lambda: step(graphed, *batch),
                                        ["flash_fwd", "flash_bwd"])
    return out


def _char_remat(params, vocab, batch) -> dict:
    """(c): two steps a policy from the same params: losses against no
    remat, and the peak memory of the eager first step and of the
    second, which captures the graph."""
    out = {}
    for policy in (None, "dots", "dots_no_batch", "nothing"):
        step = make_train_step(None, N_LAYERS, D, HEADS, FF, len(vocab),
                               lr=CHAR_LR, masked=True, remat_policy=policy,
                               device=DEVICE)
        ps = params_from_numpy(params, DEVICE)
        losses, peaks = [], []
        for _ in range(2):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            losses.append(float(step(ps, *batch)[1]))
            peaks.append(torch.cuda.max_memory_allocated())
        out[str(policy)] = {"losses": losses, "peak_bytes_eager": peaks[0],
                            "peak_bytes_capture": peaks[1]}
        del step, ps
        gc.collect()
    base = out["None"]["losses"]
    for r in out.values():
        r["loss_rel_vs_none"] = max(abs(a - b) / abs(b)
                                    for a, b in zip(r["losses"], base))
    return out


def _char_moe(vocab, batch) -> dict:
    """(d): the MoE step at full width (2 warm steps, the eager one and
    the capture, then CHAR_TIMED timed replays), then at CHAR_MOE_SMALL
    card (f32, TF32 off) against the CPU over 3 steps, with the TF32-on
    control."""
    params = init_params(np.random.default_rng(SEED + 82), N_LAYERS, D,
                         HEADS, FF, len(vocab), n_experts=CHAR_MOE[
                             "n_experts"])
    step = make_train_step(None, N_LAYERS, D, HEADS, FF, len(vocab),
                           lr=CHAR_LR, masked=True, device=DEVICE,
                           **CHAR_MOE)
    ps = params_from_numpy(params, DEVICE)
    del params
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses = [step(ps, *batch)[1] for _ in range(2)]
    ms = []
    for _ in range(CHAR_TIMED):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        losses.append(step(ps, *batch)[1])
        end.record()
        ms.append((start, end))
    torch.cuda.synchronize()
    full = {"losses": [float(x) for x in losses],
            "step_ms": float(np.median([s.elapsed_time(e) for s, e in ms])),
            "peak_bytes": torch.cuda.max_memory_allocated(),
            "replays": sum(g.replays for g in step.graphs.values() if g)}
    del step, ps
    gc.collect()
    layers, d, heads, ff, b, t = CHAR_MOE_SMALL
    small = init_params(np.random.default_rng(SEED + 83), layers, d, heads,
                        ff, len(vocab), n_experts=CHAR_MOE["n_experts"])
    rng = np.random.default_rng(SEED + 84)
    tokens = rng.integers(0, len(vocab), (b, t))
    labels = rng.integers(0, len(vocab), (b, t))
    mask = np.arange(b) < b - 1
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)

    def run(device, allow_tf32=False):
        torch.backends.cuda.matmul.allow_tf32 = allow_tf32
        torch.backends.cudnn.allow_tf32 = allow_tf32
        s = make_train_step(None, layers, d, heads, ff, len(vocab),
                            lr=CHAR_LR, masked=True,
                            compute_dtype=torch.float32, device=device,
                            **CHAR_MOE)
        p = params_from_numpy(small, device)
        run_losses = [float(s(p, tokens, labels, mask)[1])
                      for _ in range(3)]
        return run_losses, params_to_numpy(p)

    try:
        card, cpu, control = run(DEVICE), run("cpu"), run(DEVICE, True)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32

    def vs_cpu(r):
        return {"loss_rel": max(abs(a - b) / abs(b)
                                for a, b in zip(r[0], cpu[0])),
                "param_max_abs": max(
                    float(np.abs(a - b).max()) for a, b in
                    zip(lm_leaves(r[1]), lm_leaves(cpu[1])))}

    return {"full": full, "small_shape": dict(zip(
        ("n_layers", "d", "heads", "ff", "b", "t"), CHAR_MOE_SMALL)),
        "small_losses": {"card": card[0], "cpu": cpu[0],
                         "card_tf32": control[0]},
        "card_vs_cpu": vs_cpu(card), "tf32_vs_cpu": vs_cpu(control)}


def _char_serve(pkg: str, vocab: list) -> dict:
    """(e): the exported package through ``generate --serve`` on the card
    in f32 (CHAR_PROMPTS greedy, CHAR_NEW tokens each, streamed at
    once), the paged-decode counter set to 0 just before and read just
    after; each stream held against make_logits_fn's argmax (flash
    forward, f32) on its growing sequence."""
    args = build_generate_parser().parse_args(
        [pkg, "--serve", "--port", "0", "--slots", "4", "--max-len", "128",
         "--page-size", str(PAGE), "--max-tokens", str(CHAR_NEW),
         "--device", DEVICE])
    lm_params, meta = load_lm(pkg)
    root.common.engine.precision = "float32"
    try:
        server = start_generate_server(args, lm_params, meta)
    finally:
        root.common.engine.precision = "bfloat16"
    prompts = [[vocab.index(c) for c in p] for p in CHAR_PROMPTS]
    results = [{} for _ in prompts]
    kdecode.launches = 0                           # 0 just before ...
    threads = [threading.Thread(target=_stream, args=(
        server.port, ids, res, CHAR_NEW)) for ids, res in zip(prompts,
                                                              results)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=300)
    launches = kdecode.launches                    # ... and read after
    server.stop()
    dtype = str(server.decoder.dtype)
    oracle = make_logits_fn(None, N_LAYERS, D, HEADS, FF, len(vocab),
                            compute_dtype=torch.float32, device=DEVICE)
    ps32 = params_from_numpy(lm_params, DEVICE)
    streams, oracle_streams = [], []
    for ids, res in zip(prompts, results):
        toks = [e["token"] for e in res.get("events", []) if "token" in e]
        seq, want = list(ids), []
        for tok in toks:
            lg = oracle(ps32, np.asarray([seq]))[0, -1]
            want.append(int(torch.argmax(lg)))
            seq.append(tok)
        streams.append(toks)
        oracle_streams.append(want)
    return {"dtype": dtype, "streams": streams,
            "text": ["".join(meta["charmap"][t] for t in s)
                     for s in streams],
            "oracle_streams": oracle_streams, "decode_launches": launches,
            "ttft_ms": [r.get("ttft_ms") for r in results]}


def lm_leaves(ps) -> list:
    """The leaves of an LM param pytree (tensors or numpy), keys sorted
    within each block."""
    return [ps["emb"], ps["head"]] + [blk[k] for blk in ps["blocks"]
                                      for k in sorted(blk)]


def phase_char_lm() -> dict:
    """models/char_lm.py at bench_transformer's block widths (6 layers, d
    512, 8 heads, ff 2048) over the synthesized corpus (vocab 14) at
    seq_len 2048, minibatch 8: (a) CHAR_EPOCHS epochs through the CLI's
    ``run(load, main)`` on the card, every minibatch but the first of
    each kind a CUDA graph replay on the flash kernels (launches counted
    exactly), exporting through ``lm_export``; (b) the graphed step bit-
    identical to its eager body, both timed; (c) each remat policy;
    (d) the MoE step, and card against CPU at 2 layers; (e) the export
    served by ``generate --serve`` on the paged-decode kernel, greedy
    streams equal to the logits oracle's argmax."""
    t_phase = time.perf_counter()
    part_s = {}

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        part_s[name] = time.perf_counter() - t0
        return out

    with tempfile.TemporaryDirectory() as tmp:
        data_dir, vocab = _char_corpus(tmp)
        w, pkg, seen, (fwd, bwd), run_s, prof = timed("a", _char_workflow,
                                                      data_dir)
        n_train = sum(1 for s in seen if s[1] == TRAIN)
        n_eval = len(seen) - n_train
        graphs = {key[0]: g.replays for body in (w.step._step, w.step._eval)
                  for key, g in body.graphs.items() if g is not None}
        train_mse = [s[3] for s in seen if s[1] == TRAIN]
        steady = [s for s in seen if s[0] == CHAR_EPOCHS - 1]
        a = {"minibatches": len(seen), "train": n_train, "eval": n_eval,
             "vocab": len(vocab), "run_s": run_s,
             "fwd_launches": fwd, "bwd_launches": bwd,
             "replays": graphs, "train_mse": train_mse,
             "history": w.decision.metrics_history,
             "train_ms": [s[2] for s in seen if s[1] == TRAIN],
             "eval_ms": [s[2] for s in seen if s[1] != TRAIN],
             "train_ms_steady_p50": float(np.median(
                 [s[2] for s in steady if s[1] == TRAIN])),
             "eval_ms_steady_p50": float(np.median(
                 [s[2] for s in steady if s[1] != TRAIN])),
             "profiled_epoch": CHAR_EPOCHS, "profile": prof}
        params = params_to_numpy(w.step._params)
        del w
        gc.collect()
        batch = _char_batch(data_dir, vocab)
        b = timed("b", _char_graphed_vs_eager, params, vocab, batch)
        c = timed("c", _char_remat, params, vocab, batch)
        d = timed("d", _char_moe, vocab, batch)
        e = timed("e", _char_serve, pkg, vocab)
    out = {"phase": "char_lm",
           "shape": {"n_layers": N_LAYERS, "d": D, "heads": HEADS, "ff": FF,
                     "vocab": len(vocab), "b": CHAR_B, "t": CHAR_T,
                     "lr": CHAR_LR, "compute": "bfloat16"},
           "a_workflow": a, "b_graphed_vs_eager": b, "c_remat": c,
           "d_moe": d, "e_serve": e,
           "bands": {"remat_loss_rel": CHAR_REMAT_RTOL,
                     "moe_loss_rel_f32": TRAIN_LOSS_RTOL,
                     "moe_param_atol_f32": TRAIN_PARAM_ATOL},
           "part_s": part_s, "seconds": time.perf_counter() - t_phase}
    bad = []
    if fwd != N_LAYERS * len(seen) or bwd != N_LAYERS * n_train:
        bad.append(f"(a) flash fwd {fwd} / bwd {bwd} over {len(seen)} "
                   f"minibatches, {n_train} train, x {N_LAYERS} layers")
    if graphs != {"train": n_train - 1, "eval": n_eval - 1}:
        bad.append(f"(a) replays {graphs}")
    if not all(np.isfinite(train_mse)) or not train_mse[-1] < train_mse[0]:
        bad.append(f"(a) train mse {train_mse}")
    if b["differ"] or b["replays"] != {"train": CHAR_GRAPH_STEPS - 1}:
        bad.append(f"(b) differ {b['differ']}, replays {b['replays']}")
    for policy, r in c.items():
        if not r["loss_rel_vs_none"] <= CHAR_REMAT_RTOL:
            bad.append(f"(c) {policy}: {r['losses']}")
    if not c["nothing"]["peak_bytes_eager"] < c["None"]["peak_bytes_eager"]:
        bad.append("(c) full remat saved no memory")
    if not all(np.isfinite(d["full"]["losses"])):
        bad.append(f"(d) MoE losses {d['full']['losses']}")
    if not (d["card_vs_cpu"]["loss_rel"] <= TRAIN_LOSS_RTOL and
            d["card_vs_cpu"]["param_max_abs"] <= TRAIN_PARAM_ATOL):
        bad.append(f"(d) card vs cpu {d['card_vs_cpu']}")
    if d["tf32_vs_cpu"]["loss_rel"] <= TRAIN_LOSS_RTOL and \
            d["tf32_vs_cpu"]["param_max_abs"] <= TRAIN_PARAM_ATOL:
        bad.append(f"(d) the bands pass the TF32 control "
                   f"{d['tf32_vs_cpu']}")
    if e["streams"] != e["oracle_streams"] or \
            any(len(s) != CHAR_NEW for s in e["streams"]) or \
            not e["decode_launches"] or e["dtype"] != str(torch.float32):
        bad.append(f"(e) streams {e['streams']} vs {e['oracle_streams']}, "
                   f"{e['decode_launches']} decode launches, {e['dtype']}")
    if bad:
        fail(f"char_lm: {bad}: {out}")
    return out


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()


#: every kernel source of the port's paths, built together at the start
KERNEL_SOURCES = ("paged_decode", "flash_attention", "gemm", "optim",
                  "conv", "kohonen", "pooling", "lrn", "dropout")


def phase_build() -> dict:
    """One nvcc per source, all started together."""
    t0 = time.perf_counter()
    libs = kbuild.build(KERNEL_SOURCES)
    return {"phase": "build", "build_s": time.perf_counter() - t0,
            "libraries": {k: os.path.basename(v) for k, v in libs.items()}}


def kernel_line(kernel, flash, gemm, optim, serve, train, eager,
                fused, conv, alexnet, deconv, ae, spool, mcs, som,
                lrn_drop, alex_fused, kernel_hw, spec, char,
                data_parallel, serve_forward, lm_axes, pipe_expert,
                zoo, fleet, services) -> dict:
    """The eighteen kernels: launches from the main paths' runs, times
    and errors from the kernel phases, bounds from this run's inputs.  A
    conv kernel's times and bound sum its launches of one AlexNet train
    minibatch at batch 128 (the bf16 forward: AlexNet's five forwards),
    a deconv wrapper's its launches of one build_deep train minibatch at
    batch 64, the stochastic pool's its two launches of one MNIST conv
    minibatch, an LRN kernel's AlexNet's two norm layers (its launches
    alexnet_fused's, two a train step); the dropout kernel's are at 64 M
    elements.  AdamW's launches are the fused
    step's, one a step over all its leaves, and its ms one such call
    over bench_fc's six.  Each conv.cu entry names the kernels
    it launches (``cuda_kernels``); paged_decode's also carries the
    speculative path's launches and its verify call's time, the
    flash and paged_decode entries the char_lm phase's launches (its
    workflow's and its served package's), the flash entries the lm_axes
    phase's (the ring's composition, Σ(r+1) a causal ring of n, and the
    LM step on the one-rank world in each layout) and the pipe_expert
    phase's (its checkpointed LM runs, uninterrupted and resumed), and
    the SGD, AdamW
    and LRN
    entries the data_parallel phase's (its AlexNet epochs with no group
    and in the three layouts, its MNIST FC codec runs on the card), and
    the LRN forward's the serve_forward phase's HTTP load (two a replayed
    batch of the served AlexNet).  act_backward's times are its one
    launch with grad_b at AlexNet's fc7 and fc6, its library call
    threshold_backward and a column sum.  The gemm_fc, act_backward,
    SGD and three f32 conv entries carry the zoo phase's launches (its
    model runs on the card, its LR/rollback and online runs).  The
    paged_decode entry carries the fleet_learn phase's (b) launches (the
    adopted in-process worker behind the router), the flash entries the
    kernels its (c) trainer ran, counted in that process's profiler
    trace.  The SGD entry carries the services phase's ``--optimize``
    population (bench_fc's widths), gemm_fc and act_backward its
    ``--ensemble-train`` on eager Wine, the LRN forward its forge-fetched
    AlexNet package."""
    def entry(name, source, replaces, launches, timed, max_abs_err,
              **extra):
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches,
                "max_abs_err": max_abs_err, "ms": timed["ms"],
                "plain_ms": timed["plain_ms"],
                "bound_ms": timed["bound_ms"],
                "bound_by": timed["bound_by"],
                "library_ms": timed["library_ms"], **extra}

    sgd = optim["timed"]["sgd_vel_bfloat16"]
    hw = kernel_hw["launches"]
    lm_axes_flash = {k: {"ring": sum(r["launches"][k]
                                     for r in lm_axes["ring"]["rows"]),
                         "lm_step": sum(r["flash_launches"][k] for r in
                                        lm_axes["lm_step"].values())}
                     for k in ("fwd", "bwd")}
    pe_flash = {k: sum(r["flash_launches"][k] for r in
                       pipe_expert["d_checkpoint"].values())
                for k in ("fwd", "bwd")}
    dp = {k: sum(r["launches"][k] for r in data_parallel["alexnet"].values())
          for k in ("sgd_update", "lrn_forward", "lrn_backward")}
    dp["adam_update"] = sum(data_parallel["mnist_fc_codecs"][k][
        "adam_launches"] for k in DP_CODECS)
    zoo_runs = [r["launches"] for r in zoo["models"].values()] + [
        zoo[part]["launches"] for part in ("rbm_own_draws", "lr_rollback",
                                           "online_serve")]
    zl = {k: sum(r[k] for r in zoo_runs) for k in ZOO_COUNTERS}
    lrn_path = lrn_drop["lrn_path"]
    drop_f32, drop_bf16 = (
        next(r for r in lrn_drop["dropout_timed"] if r["dtype"] == str(dt))
        for dt in (torch.float32, torch.bfloat16))
    return {"kernels": [
        entry("paged_decode", kdecode.SOURCE, kdecode.REPLACES,
              serve["kernel_launches"], kernel, kernel["max_abs_err"],
              cuda_kernels=["paged_decode_kernel<T,DH>",
                            "paged_decode_kernel_combine<DH>"],
              char_lm_launches=char["e_serve"]["decode_launches"],
              fleet_learn_launches=fleet["b_adopted"]["launches"],
              speculative={
                  "launches": spec["http"]["kernel_launches"],
                  "rounds": spec["http"]["rounds"],
                  **{f"{name}_{key}": t[key] for name, t in
                     spec["verify_parity"]["bf16"]["timed"].items()
                     for key in ("ms", "bound_ms")}}),
        entry("flash_attention_fwd", kflash.SOURCE, kflash.REPLACES_FWD,
              train["fwd_launches"], flash["fwd"],
              flash["fwd"]["max_abs_err"],
              char_lm_launches=char["a_workflow"]["fwd_launches"],
              lm_axes_launches=lm_axes_flash["fwd"],
              pipe_expert_launches=pe_flash["fwd"],
              fleet_learn_launches=fleet["c_learn"]["trace"]["flash_fwd"]),
        entry("flash_attention_bwd", kflash.SOURCE, kflash.REPLACES_BWD,
              train["bwd_launches"], flash["bwd"],
              flash["bwd"]["max_abs_err"],
              char_lm_launches=char["a_workflow"]["bwd_launches"],
              lm_axes_launches=lm_axes_flash["bwd"],
              pipe_expert_launches=pe_flash["bwd"],
              fleet_learn_launches=fleet["c_learn"]["trace"]["flash_bwd"]),
        entry("gemm_fc", kgemm.SOURCE, kgemm.REPLACES_GEMM,
              eager["gemm_fc_launches"], gemm["gemm"],
              gemm["gemm"]["max_abs_err"],
              cuda_kernels=["gemm_f32_kernel<BM,BN,A_KC,B_KC>",
                            "gemm_reduce_kernel<VEC>"],
              zoo_launches=zl["gemm_fc"],
              services_launches=services["ensemble"]["launches"][
                  "gemm_fc"]),
        entry("act_backward", kgemm.SOURCE, kgemm.REPLACES_ACT,
              alexnet["launches"]["act_backward"],
              gemm["act_backward_alexnet"],
              gemm["act_backward_alexnet"]["max_abs_err"],
              path="alexnet_eager", zoo_launches=zl["act_backward"],
              services_launches=services["ensemble"]["launches"][
                  "act_backward"],
              bench_fc_tanh={"launches": eager["act_backward_launches"],
                             **{k: gemm["act_backward"][k] for k in (
                                 "ms", "plain_ms", "bound_ms", "bound_by",
                                 "library_ms")}}),
        entry("sgd_update", koptim.SOURCE, koptim.REPLACES,
              fused["sgd_update_launches"], sgd,
              max(optim[k]["sound"]["max_abs_err"]
                  for k in ("sgd_vel_float32", "sgd_vel_bfloat16")),
              data_parallel_launches=dp["sgd_update"],
              zoo_launches=zl["sgd_update"],
              services_launches=services["optimize"]["vmapped"][
                  "launches"]["sgd_update"]),
        entry("adam_update", koptim.SOURCE, koptim.REPLACES,
              fused["adam"]["adam_update_launches"], optim["timed"]["adam"],
              optim["adam"]["sound"]["max_abs_err"],
              data_parallel_launches=dp["adam_update"]),
        *(entry(f"conv2d_{kind}", kconv.SOURCE, replaces,
                alexnet["launches"][f"conv2d_{kind}"], conv["path"][kind],
                conv["path"][kind]["max_abs_err"], cuda_kernels=cuda,
                zoo_launches=zl[f"conv2d_{kind}"])
          for kind, replaces, cuda in (
              ("fwd", kconv.REPLACES_FWD, ["conv_fwd_kernel<BM,BN,VEC>"]),
              ("input_grad", kconv.REPLACES_INPUT_GRAD,
               ["conv_input_grad_kernel<BM,BN,TM,TN,BK>"]),
              ("weight_grad", kconv.REPLACES_WEIGHT_GRAD,
               ["conv_weight_grad_kernel<BM,BN,MinBlocks,VA>",
                "reduce_splits_kernel"]))),
        entry("conv2d_fwd_bf16", kconv.SOURCE, kconv.REPLACES_FWD,
              kernel_hw["launches"]["conv2d_fwd_bf16"],
              conv["path"]["fwd_bf16"], conv["path"]["fwd_bf16"][
                  "max_abs_err"],
              cuda_kernels=["conv_fwd_bf16_kernel<BN>"]),
        entry("deconv2d", kconv.SOURCE, kconv.REPLACES_DECONV,
              ae["launches"]["deconv2d"], deconv["path"]["deconv2d"],
              deconv["path"]["deconv2d"]["max_abs_err"],
              cuda_kernels=["conv_input_grad_kernel<BM,BN,TM,TN,BK>"]),
        entry("deconv2d_backward", kconv.SOURCE, kconv.REPLACES_DECONV_BWD,
              ae["launches"]["deconv2d_backward"],
              deconv["path"]["deconv2d_backward"],
              deconv["path"]["deconv2d_backward"]["max_abs_err"],
              cuda_kernels=["conv_fwd_kernel<BM,BN,VEC>",
                            "conv_weight_grad_kernel<BM,BN,MinBlocks,VA>",
                            "reduce_splits_kernel"]),
        entry("som_step", ksom.SOURCE, ksom.REPLACES,
              som["bench"]["launches"], som["timed"],
              max(c["max_abs_err"] for c in som["checks"]),
              cuda_kernels=["som_step_kernel<Resident>"]),
        entry("stochastic_pool", kpool.SOURCE, kpool.REPLACES,
              mcs["launches"]["stochastic_pool"], spool["path"],
              spool["path"]["max_abs_err"]),
        entry("lrn_forward", klrn.SOURCE, klrn.REPLACES_FWD,
              alex_fused["launches"]["lrn_forward"], lrn_path["fwd"],
              lrn_path["fwd"]["max_abs_err"], path="alexnet_fused",
              cuda_kernels=["lrn_fwd_quad_kernel<N>", "lrn_fwd_kernel"],
              data_parallel_launches=dp["lrn_forward"],
              serve_forward_launches=serve_forward["http"][
                  "lrn_forward_launches"],
              services_launches=services["forge"]["lrn_forward_launches"]),
        entry("lrn_backward", klrn.SOURCE, klrn.REPLACES_BWD,
              alex_fused["launches"]["lrn_backward"], lrn_path["bwd"],
              lrn_path["bwd"]["max_abs_err"], path="alexnet_fused",
              cuda_kernels=["lrn_bwd_quad_kernel<N>", "lrn_bwd_kernel"],
              data_parallel_launches=dp["lrn_backward"]),
        entry("dropout_forward", kdrop.SOURCE, kdrop.REPLACES,
              hw["dropout_forward"], drop_f32,
              max(c["max_abs_err"] for c in lrn_drop["dropout_checks"]),
              library_bound_ms=drop_f32["library_bound_ms"],
              bf16={k: drop_bf16[k] for k in (
                  "ms", "plain_ms", "bound_ms", "library_ms",
                  "library_bound_ms")})]}


def phase_waves() -> dict:
    """The weight gradient at AlexNet's five layers and build_deep's two
    shapes with ``split_k``'s slices, one slice fewer and one more, each
    timed in turns (plan, fewer, more, plan) through the C entry
    (``znicz_conv2d_weight_grad_f32`` takes the slices from its caller),
    with its grid's blocks: how much the grid's fill of its last wave
    costs.  It calls only the C entry and ``split_k``, which older
    checkouts of the port have too, so it runs on them as well (the k
    tile from ``WEIGHT_GRAD_K_TILE`` where the module has it, else
    ``K_TILE``)."""
    torch.backends.cudnn.allow_tf32 = False
    kt = getattr(kconv, "WEIGHT_GRAD_K_TILE", kconv.K_TILE)
    lib = kconv._library()
    rng = np.random.default_rng(SEED + 31)
    shapes = [(name, ALEX_BATCH, side, cin, cout, k, s, p)
              for name, side, cin, cout, k, s, p in ALEX_CONVS]
    shapes += [("build_deep conv1", AE_BATCH, 64, 3, 64, 4, 2, 1),
               ("build_deep conv2", AE_BATCH, 32, 64, 128, 4, 2, 1)]
    rows_out = []
    for name, batch, side, cin, cout, k, s, p in shapes:
        geom = ((s, s), (p, p, p, p))
        x, _, _, e = _conv_inputs(rng, batch, side, side, cin, cout, k,
                                  *geom)
        _, oh, ow, _ = e.shape
        n_pix = e.numel() // cout
        rows = k * k * cin + 1
        splits, _ = kconv.split_k(rows, cout, n_pix)
        gw = torch.empty((k, k, cin, cout), device=DEVICE)
        gb = torch.empty((cout,), device=DEVICE)

        def run(want):
            per = -(-(-(-n_pix // kt)) // want) * kt
            sp = -(-n_pix // per)
            part = torch.empty((sp, rows, cout), device=DEVICE)

            def call():
                rc = lib.znicz_conv2d_weight_grad_f32(
                    x.data_ptr(), e.data_ptr(), part.data_ptr(),
                    gw.data_ptr(), gb.data_ptr(), batch, side, side, cin,
                    oh, ow, cout, k, k, s, s, p, p, sp, per,
                    torch.cuda.current_stream().cuda_stream)
                if rc != 0:
                    fail(f"weight gradient launch failed ({name}, {sp})")
            return sp, call

        runs = {"plan": run(splits), "fewer": run(max(1, splits - 1)),
                "more": run(splits + 1)}
        ms = {key: [] for key in runs}
        for key in ("plan", "fewer", "more", "plan", "fewer", "more"):
            ms[key].append(time_cuda_ms(runs[key][1], iters=10))
        rows_out.append({"layer": name, "rows": rows, "cout": cout,
                         "pixels": n_pix,
                         **{key: {"splits": runs[key][0],
                                  "ms": float(np.median(ms[key]))}
                            for key in runs}})
        del x, e, gw, gb, runs
    return {"phase": "waves", "k_tile": kt, "layers": rows_out,
            "plan_ms": sum(r["plan"]["ms"] for r in rows_out[:5]),
            "fewer_ms": sum(r["fewer"]["ms"] for r in rows_out[:5])}


def _compare_path(w, xs, ys, ms, reps, warm, timed) -> dict:
    w.step.train_steps(xs, ys, ms)
    t = timed_train_steps(w.step, xs, ys, ms, reps)
    run = workflow_run_profiled(w, warm, timed)
    return {"train_steps": {
                "step_ms": t["step_ms"],
                "host_issue_us_per_step": t["host_issue_us_per_step"],
                "busy_ms_per_step": t["profile"]["busy_ms_per_step"],
                "idle_share": t["profile"]["device_idle_share"]},
            "workflow_run": {
                "ms_per_minibatch": run["ms_per_minibatch"],
                "step_host_us": run["step_host_us"],
                "busy_ms_per_minibatch": run["profile"]["busy_ms_per_step"],
                "idle_share": run["profile"]["device_idle_share"]}}


def phase_fused_compare() -> dict:
    """The readings that hold a change against its parent on one card,
    without the other phases' gates: the dropout kernel at 64 M elements
    (f32, and bf16 where the tree's kernel takes it) beside
    ``aten.native_dropout``, and bench_fc's MNIST FC, build_deep and
    AlexNet at 227 px fused, each through ``train_steps`` (one warm call,
    timed ones, one profiled) and ``Workflow.run`` (warm, timed,
    profiled) as mnist_fused, ae_fused and alexnet_fused run them.  It
    calls only entry points the port has had since AlexNet first trained
    fused, so a copy of this file runs it in an older checkout too (run
    parent, change, change, parent in one call)."""
    import znicz_tpu_torch

    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    out = {"phase": "fused_compare", "package": os.path.dirname(
        os.path.realpath(znicz_tpu_torch.__file__)), "dropout_64M": {}}
    for dtype in DROP_DTYPES:
        x = torch.randn((8192, 8192), generator=gen, device=DEVICE).to(dtype)
        try:
            kdrop.dropout_forward(x, DROP_RATIO, seed=SEED)
        except ValueError:          # a tree whose kernel takes f32 only
            out["dropout_64M"][str(dtype)] = None
            continue
        out["dropout_64M"][str(dtype)] = {
            "ms": time_cuda_ms(lambda: kdrop.dropout_forward(
                x, DROP_RATIO, seed=SEED)),
            "library_ms": time_cuda_ms(
                lambda: torch.ops.aten.native_dropout(x, DROP_RATIO, True))}
        del x
    w = _fused_workflow(max_epochs=MF_EPOCHS, n_train=MF_TRAIN_MB * FC_BATCH,
                        optimizer_config={"state_dtype": "bfloat16"})
    xs, ys, ms = _staged_batches(np.random.default_rng(SEED + 10), FUSED_K)
    out["mnist_fused"] = _compare_path(w, xs, ys, ms, FUSED_REPS, MF_WARM,
                                       MF_TIMED)
    w, xs, ms = _ae_fused_setup()
    out["ae_fused"] = _compare_path(w, xs, xs, ms, AE_FUSED_REPS, AEF_WARM,
                                    AEF_TIMED)
    del w, xs, ys, ms
    w, xs, ys, ms, _ = _alexnet_fused_setup()
    out["alexnet_fused"] = _compare_path(w, xs, ys, ms, AF_REPS, AF_WARM,
                                         AF_TIMED)
    return out


#: input_pipeline: host-fed AlexNet — models/alexnet.py layers() through
#: StandardWorkflow(fused=True) at 227 px, batch 128, 1000 classes, bf16
#: over f32 masters, on the synthetic_image loader with 1024 train and
#: 256 validation samples asked (the loader serves 20 and 5 a class of
#: its 50: 1000 and 250, 8 and 2 minibatches an epoch) for IP_EPOCHS
#: epochs, with dataset_on_device_max_bytes 0, so every minibatch ships
#: its 79.1 MB from the host; once synchronously, once at IP_DEPTH.  The
#: first IP_WARM minibatches (each body's eager step and its capture)
#: are warm, the next IP_TIMED (the first epoch's other train
#: minibatches) timed on the host clock, the second epoch profiled
IP_TRAIN, IP_VALID, IP_EPOCHS, IP_DEPTH = 1024, 256, 2, 2
IP_WARM, IP_TIMED = 4, 6
#: index-fed MNIST FC: bench_fc's widths (784-4096-4096-10, batch 1024),
#: 32 train and 2 validation minibatches an epoch, the data set pinned
IP_FC_TRAIN, IP_FC_VALID, IP_FC_EPOCHS = 32 * 1024, 2 * 1024, 2
IP_FC_WARM, IP_FC_TIMED = 4, 24
#: the native gather timed against numpy fancy indexing, median of this
#: many calls each
IP_GATHER_REPS = 10
#: CIFAR conv on its own (synthesized) pickle files, fused, one epoch of
#: 500 train and 100 validation samples, batch 100: the validation
#: minibatch, the train body's eager step and its capture warm, two
#: replays timed, the last profiled
IP_CIFAR_TRAIN, IP_CIFAR_VALID = 500, 100
IP_CIFAR_WARM, IP_CIFAR_TIMED = 3, 2


def stream_table(prof) -> dict:
    """The device activities of a profiled window, from its chrome
    trace: by CUDA stream, the kernels and each kind of copy with its
    count, bytes, ms and its most frequent sizes; and ``union_ms``, the
    time at least one activity ran on any stream (the busy time, with
    copies that overlap kernels counted once)."""
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    table, spans = {}, []
    for e in events:
        args = e.get("args") or {}
        if e.get("ph") != "X" or e.get("cat") not in (
                "kernel", "gpu_memcpy", "gpu_memset") or "stream" not in args:
            continue
        name = e["name"]
        kind = "kernel" if e["cat"] == "kernel" else \
            next((k for k in ("HtoD", "DtoH", "DtoD", "Memset")
                  if k in name), "other")
        if "Pinned" in name:
            kind += " pinned"
        row = table.setdefault(str(args["stream"]), {}).setdefault(
            kind, {"count": 0, "bytes": 0, "ms": 0.0, "sizes": {}})
        row["count"] += 1
        nbytes = int(args.get("bytes", 0))
        row["bytes"] += nbytes
        row["ms"] += float(e.get("dur", 0.0)) / 1e3
        if kind != "kernel":
            row["sizes"][nbytes] = row["sizes"].get(nbytes, 0) + 1
        spans.append((float(e["ts"]), float(e["ts"]) + float(e["dur"])))
    for kinds in table.values():
        for row in kinds.values():
            row["sizes"] = dict(sorted(row["sizes"].items(),
                                       key=lambda kv: -kv[1])[:6])
    union, end = 0.0, None
    for lo, hi in sorted(spans):
        if end is None or lo > end:
            union += hi - lo
            end = hi
        elif hi > end:
            union += hi - end
            end = hi
    return {"by_stream": table, "union_ms": union / 1e3}


def _pipeline_run(make, depth, warm, timed) -> tuple:
    """``make(depth)`` -> an initialized workflow, run through
    workflow_run_profiled (warm, timed, the rest profiled with the
    streams of its device activities), then stopped -> ``(reading,
    workflow, weights)``: ms a minibatch, the profiled window's busy ms
    and idle share, the stall table, the streams, the ring, the graphs
    and their replays, the history, and whether the worker thread is
    dead after ``stop``."""
    w = make(depth)
    step = w.step
    run = workflow_run_profiled(w, warm, timed, streams=True)
    streams = run["streams"]["by_stream"]
    union_ms = run["streams"]["union_ms"] / run["profiled_minibatches"]
    pipe = getattr(w.loader, "pipeline", None)
    stats = pipe.stats.snapshot() if pipe is not None else None
    thread = pipe._thread if pipe is not None else None
    step.sync_to_units()
    weights = _conv_fc_weights(w)
    rings = {k: {"slots": len(r["bufs"]),
                 "pinned": all(torch.from_numpy(b).is_pinned()
                               for b in r["bufs"]),
                 "served": r["i"] + len(r["bufs"])}
             for k, r in getattr(w.loader, "_rings", {}).items()}
    w.stop()
    reading = {"depth": depth, "ms_per_minibatch": run["ms_per_minibatch"],
               "step_host_us": run["step_host_us"],
               "timed_minibatches": run["timed_minibatches"],
               "profiled_minibatches": run["profiled_minibatches"],
               "busy_ms_per_minibatch": union_ms,
               "idle_share": 1 - union_ms * run["profiled_minibatches"] /
               run["profile"]["wall_ms"],
               "idle_share_timed": 1 - union_ms / run["ms_per_minibatch"],
               "activity_ms_per_minibatch": run["profile"][
                   "busy_ms_per_step"],
               "profile_wall_ms": run["profile"]["wall_ms"],
               "top_device": run["profile"]["top_device"][:5],
               "streams": streams, "stats": stats, "rings": rings,
               "graphs": sorted(str(k) for k in step._graphs or ()),
               "graph_replays": replays_of(step),
               "history": w.decision.metrics_history,
               "worker_alive_after_stop": bool(thread is not None and
                                               thread.is_alive()),
               "classes": run["classes"]}
    return reading, w, weights


def _pipeline_gates(name, sync, piped, sync_w, piped_w, host_fed) -> list:
    """The phase's gates on one pipelined run against its synchronous
    run; returns what failed."""
    bad = []
    if piped["history"] != sync["history"]:
        bad.append(f"{name}: history {piped['history']} != sync "
                   f"{sync['history']}")
    moved = [k for k in sync_w if not all(
        np.array_equal(a, b) for a, b in zip(sync_w[k], piped_w[k]))]
    if moved:
        bad.append(f"{name}: weights differ from the sync run's at {moved}")
    if piped["graphs"] != sync["graphs"] or \
            piped["graph_replays"] != sync["graph_replays"]:
        bad.append(f"{name}: graphs {piped['graphs']} replays "
                   f"{piped['graph_replays']} != sync {sync['graphs']} "
                   f"{sync['graph_replays']} (a capture in the steady "
                   f"state)")
    n = len(piped["classes"])
    n_train = piped["classes"].count(2)
    if piped["graph_replays"] != {"train": n_train - 1,
                                  "eval": n - n_train - 1}:
        bad.append(f"{name}: replays {piped['graph_replays']} for "
                   f"{n_train} train and {n - n_train} eval minibatches")
    if piped["worker_alive_after_stop"]:
        bad.append(f"{name}: the prefetch worker outlived run and stop")
    if piped["stats"]["consumed"] != n:
        bad.append(f"{name}: {piped['stats']['consumed']} batches consumed "
                   f"for {n} minibatches")
    if host_fed:
        depth = piped["depth"]
        for key, ring in piped["rings"].items():
            if ring["slots"] != depth + 2 or not ring["pinned"] or \
                    ring["served"] != n:
                bad.append(f"{name}: ring {key} {ring}, want {depth + 2} "
                           f"pinned slots serving {n} batches")
        if set(piped["rings"]) != {"data", "labels"}:
            bad.append(f"{name}: rings {sorted(piped['rings'])}")
        step_streams = {s for s, kinds in piped["streams"].items()
                        if "kernel" in kinds}
        h2d = {s: kinds for s, kinds in piped["streams"].items()
               if any(k.startswith("HtoD") for k in kinds)}
        if not any("HtoD pinned" in kinds for kinds in h2d.values()):
            bad.append(f"{name}: no pinned HtoD copy in the profiled "
                       f"window: {piped['streams']}")
        if set(h2d) & step_streams:
            bad.append(f"{name}: HtoD copies on a stream that runs the "
                       f"step: {piped['streams']}")
    return bad


def _host_fed_alexnet(depth, data=None):
    """Host-fed AlexNet at ``depth`` (None: synchronous).  ``data``, an
    earlier run's ``(original_data, original_labels, class_lengths)``,
    is served again instead of making the 791 MB set anew (the loader
    draws it from its own prng stream, so the shuffles do not move)."""
    tprng.seed_all(SEED)
    prev = root.common.engine.get("dataset_on_device_max_bytes", 1 << 30)
    root.common.engine.dataset_on_device_max_bytes = 0
    try:
        w = StandardWorkflow(
            name="AlexNet-host-fed", layers=talexnet.layers(),
            loss_function="softmax", loader_name="synthetic_image",
            loader_config={"n_classes": 50, "sample_shape": (227, 227, 3),
                           "n_train": IP_TRAIN, "n_valid": IP_VALID,
                           "minibatch_size": ALEX_BATCH, "spread": 1.0,
                           "noise": 0.5},
            decision_config={"max_epochs": IP_EPOCHS}, fused=True,
            pipeline_config={"depth": depth} if depth else None)
        if data is not None:
            def load_data(loader=w.loader):
                loader.original_data.mem, loader.original_labels.mem = \
                    data[:2]
                loader.class_lengths = list(data[2])
            w.loader.load_data = load_data
        w.initialize(device=TorchDevice())
    finally:
        root.common.engine.dataset_on_device_max_bytes = prev
    if w.step._dataset_dev is not None or w.loader.serve_indices_only:
        fail("host-fed alexnet: the data set was pinned on the card")
    return w


def _index_fed_mnist(depth):
    tprng.seed_all(SEED)
    w = tmnist.build_fused(max_epochs=IP_FC_EPOCHS, layers=FC_LAYERS,
                           minibatch_size=FC_BATCH, n_train=IP_FC_TRAIN,
                           n_valid=IP_FC_VALID, pipeline_depth=depth)
    w.initialize(device=TorchDevice())
    if w.step._dataset_dev is None:
        fail("index-fed mnist: the data set was not pinned")
    return w


def _cifar_on_files(depth):
    from znicz_tpu_torch.models import cifar_conv as tcifar
    from znicz_tpu_torch.pipeline import attach_prefetcher

    tprng.seed_all(SEED)
    w = tcifar.build(max_epochs=1, n_train=IP_CIFAR_TRAIN,
                     n_valid=IP_CIFAR_VALID)
    if depth:
        w.input_pipeline = attach_prefetcher(
            w.loader, stager=w.step.make_stager(), depth=depth)
    w.initialize(device=TorchDevice())
    return w


def gather_timed(src: np.ndarray, batch: int) -> dict:
    """``gather_rows`` at one minibatch of ``batch`` rows of ``src``
    (shuffled indices, the last 3 rows padding) against numpy fancy
    indexing into a preallocated buffer, as fill_minibatch's numpy path
    does: median ms of IP_GATHER_REPS calls each, and the two results
    bit-identical."""
    from znicz_tpu_torch import native

    rng = np.random.default_rng(SEED + 61)
    idx = np.full(batch, -1, np.int64)
    idx[:batch - 3] = rng.permutation(len(src))[:batch - 3]
    got = np.empty((batch,) + src.shape[1:], src.dtype)
    want = np.empty_like(got)

    def by_numpy():
        want[:batch - 3] = src[idx[:batch - 3]]
        want[batch - 3:] = 0

    times = {"native": [], "numpy": []}
    for _ in range(IP_GATHER_REPS):
        for key, fn in (("native", lambda: native.gather_rows(src, idx,
                                                               got)),
                        ("numpy", by_numpy)):
            t0 = time.perf_counter()
            fn()
            times[key].append((time.perf_counter() - t0) * 1e3)
    out = {"rows": batch, "row_bytes": got[0].nbytes,
           "bytes": got.nbytes, "threads": min(native.MAX_THREADS,
                                               os.cpu_count() or 1),
           "native_ms": float(np.median(times["native"])),
           "numpy_ms": float(np.median(times["numpy"])),
           "identical": bool(np.array_equal(got, want))}
    out["native_gb_per_s"] = got.nbytes / out["native_ms"] / 1e6
    out["numpy_gb_per_s"] = got.nbytes / out["numpy_ms"] / 1e6
    return out


def phase_input_pipeline() -> dict:
    """The port's input layer on the card.  Host-fed AlexNet (IP_*: every
    minibatch's 79.1 MB shipped from the host) synchronously and through
    the input pipeline at depth IP_DEPTH: ms a minibatch, the profiled
    epoch's busy ms and idle share, the stall table, the HtoD copies by
    stream; index-fed MNIST FC at bench_fc's widths and CIFAR conv on its
    own pickle files, each sync against depth IP_DEPTH; the native gather
    at AlexNet's minibatch against numpy.  Gates: every pipelined history
    and every weight equal to its synchronous run's; the ring of
    host-fed AlexNet holds depth + 2 pinned slots that serve every batch
    (none allocated after the first fills); its staged HtoD copies on a
    stream that runs none of the step's kernels; the same graphs and
    replays as the synchronous run (no capture in the steady state); the
    worker dead after the workflow's run and stop (it parks at the last
    epoch boundary until stop, as the reference's does); the gather
    bit-identical to numpy.  cuDNN runs deterministic here, so a race in
    the staging would show as a moved weight."""
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    out = {"phase": "input_pipeline", "cudnn_deterministic": True}
    bad = []
    try:
        sync, w, sync_w = _pipeline_run(_host_fed_alexnet, None, IP_WARM,
                                        IP_TIMED)
        data = (w.loader.original_data.mem, w.loader.original_labels.mem,
                w.loader.class_lengths)
        out["gather"] = gather_timed(data[0], ALEX_BATCH)
        del w
        piped, w, piped_w = _pipeline_run(
            lambda depth: _host_fed_alexnet(depth, data), IP_DEPTH,
            IP_WARM, IP_TIMED)
        del w, data
        out["alexnet_host_fed"] = {
            "config": {"batch": ALEX_BATCH, "input": 227, "classes": 1000,
                       "n_train": IP_TRAIN, "n_valid": IP_VALID,
                       "epochs": IP_EPOCHS, "dataset_on_device": False,
                       "minibatch_bytes": ALEX_BATCH * 227 * 227 * 3 * 4,
                       "warm": IP_WARM, "timed": IP_TIMED},
            "sync": sync, "pipelined": piped,
            "speedup": sync["ms_per_minibatch"] / piped["ms_per_minibatch"]}
        bad += _pipeline_gates("alexnet host-fed", sync, piped, sync_w,
                               piped_w, True)
        if not out["gather"]["identical"]:
            bad.append(f"gather_rows differs from numpy: {out['gather']}")
        fc = {}
        for depth in (None, IP_DEPTH):
            fc[depth] = _pipeline_run(_index_fed_mnist, depth, IP_FC_WARM,
                                      IP_FC_TIMED)
        out["mnist_fc_index_fed"] = {
            "config": {"layers": list(FC_LAYERS), "batch": FC_BATCH,
                       "n_train": IP_FC_TRAIN, "n_valid": IP_FC_VALID,
                       "epochs": IP_FC_EPOCHS, "dataset_on_device": True},
            "sync": fc[None][0], "pipelined": fc[IP_DEPTH][0]}
        bad += _pipeline_gates("mnist fc index-fed", fc[None][0],
                               fc[IP_DEPTH][0], fc[None][2], fc[IP_DEPTH][2],
                               False)
        del fc
        cifar = {}
        for depth in (None, IP_DEPTH):
            cifar[depth] = _pipeline_run(_cifar_on_files, depth,
                                         IP_CIFAR_WARM, IP_CIFAR_TIMED)
        out["cifar_conv_files"] = {
            "loader": type(cifar[None][1].loader).__name__,
            "data_dir": cifar[None][1].loader.data_dir,
            "n_train": IP_CIFAR_TRAIN, "n_valid": IP_CIFAR_VALID,
            "sync": cifar[None][0], "pipelined": cifar[IP_DEPTH][0]}
        if out["cifar_conv_files"]["loader"] != "PicklesImageLoader":
            bad.append(f"cifar conv loader {out['cifar_conv_files']}")
        bad += _pipeline_gates("cifar conv files", cifar[None][0],
                               cifar[IP_DEPTH][0], cifar[None][2],
                               cifar[IP_DEPTH][2], False)
        del cifar
    finally:
        torch.backends.cudnn.deterministic = False
    if bad:
        fail(f"input_pipeline: {bad}: {out}")
    return out


#: image_files (a): alexnet.build() at full width (227-px crops of 256-px
#: decodes with mirrors, 1000 classes, batch 128, dropout 0.5), fused,
#: ``file_image`` with ``augment`` over a synthesized tree of IF_CLASSES
#: x IF_PER_CLASS PNGs of IF_TREE_PX px and no validation: one class
#: pass of two train minibatches, synchronous and at depth IF_DEPTH; the
#: loaders' decode (PIL, as the reference's) timed over IF_DECODE_IMAGES
#: of them.  Cut to the phase's 15 s: the files are IF_TREE_PX px, so
#: each decode resizes them to 256 px, as it does ImageNet's files of
#: assorted sizes (256-px files took PIL 5.2 s to write and 3.7 ms an
#: image to read on the H100's host, PERF.md), and each loader fits its
#: normalizer on IF_FIT_SAMPLES train images, not the loader's default
#: 256 (a decode and a pass over each: 0.8-1.2 s of each AlexNet
#: initialize there)
IF_CLASSES, IF_PER_CLASS, IF_DEPTH, IF_INPUT = 8, 32, 2, 227
IF_TREE_PX, IF_DECODE_IMAGES, IF_FIT_SAMPLES = 128, 64, 32
#: (b) image_ae.build() and (c) yale_faces.build() at their defaults
#: (24-px RGB, 16 kernels; 15 subjects at 32-px grayscale) but
#: IF_EPOCHS epochs (their default 10; at 3 the two took 0.7-4.1 s and
#: 1.1-2.1 s on the H100's host, PERF.md), each on the card against the
#: port on the CPU in f32 from one seed.  The image AE's bands are
#: ae_parity's (the conv AE's); Yale's weights sum the same f32 products
#: in other orders through cuBLAS, so its band is fused_conv_parity's
#: 2e-6, with the same n_err
IF_EPOCHS, IF_YALE_WEIGHT_ATOL = 2, 2e-6
#: each image AE minibatch's launches, read from the code (ae_eager's
#: AE_LAUNCHES for one conv and one deconv): a forward runs conv2d_fwd
#: at the conv and deconv2d (the input-gradient kernel) at the deconv; a
#: train minibatch adds deconv2d_backward (its weight-gradient kernel and
#: conv2d_fwd for its err_input) and the conv's weight gradient (the
#: first layer needs no err_input)
IF_AE_LAUNCHES = {"train": {"conv2d_fwd": 2, "conv2d_input_grad": 1,
                            "conv2d_weight_grad": 2, "deconv2d": 1,
                            "deconv2d_backward": 1},
                  "eval": {"conv2d_fwd": 1, "conv2d_input_grad": 1,
                           "conv2d_weight_grad": 0, "deconv2d": 1,
                           "deconv2d_backward": 0}}
#: Yale's, eager: gemm_fc at the tanh layer's forward, and its err_input
#: and weight gradient after act_backward in a train minibatch (the
#: softmax layer's forward and backward are plain torch)
IF_YALE_LAUNCHES = {"train": {"gemm_fc": 3, "act_backward": 1},
                    "eval": {"gemm_fc": 1, "act_backward": 0}}


def _weights_of(w) -> list:
    """Host copies of every forward's weights and bias (where it has one)."""
    return [np.array(getattr(f, a).map_read()) for f in w.forwards
            for a in ("weights", "bias") if getattr(f, a, None)]


def _image_alexnet_run(tree: str, depth) -> tuple:
    """alexnet.build() on ``tree`` with augment, fused on the card, one
    class pass synchronously (``depth`` None) or through the input
    pipeline, all of it profiled -> (reading, weights, first served
    minibatch's data, the CPU loader's config).  The LRN and SGD
    counters are set to 0 just before ``run`` and read just after."""
    from torch.profiler import ProfilerActivity, profile

    from znicz_tpu_torch.pipeline import attach_prefetcher

    tprng.seed_all(SEED)
    t0 = time.perf_counter()
    w = talexnet.build(max_epochs=1, minibatch_size=ALEX_BATCH,
                       input_size=IF_INPUT, loader_name="file_image",
                       loader_config={"data_dir": tree, "augment": True,
                                      "valid_fraction": 0.0,
                                      "fit_samples": IF_FIT_SAMPLES})
    if depth:
        w.input_pipeline = attach_prefetcher(
            w.loader, stager=w.step.make_stager(), depth=depth)
    w.initialize(device=TorchDevice())
    init_s = time.perf_counter() - t0
    loader, step = w.loader, w.step
    if step._dataset_dev is not None or loader.serve_indices_only:
        fail("image_files alexnet: the augmenting loader was pinned")
    first, serve_s = [], []
    fill = loader.fill_batch if depth else loader.fill_minibatch

    def timed_fill(*args):
        t = time.perf_counter()
        out = fill(*args)
        serve_s.append(time.perf_counter() - t)
        if not first:
            first.append((out if depth else {"data": loader.minibatch_data
                                             .mem})["data"].copy())
        return out
    setattr(loader, "fill_batch" if depth else "fill_minibatch", timed_fill)
    prof = profile(activities=[ProfilerActivity.CUDA])
    torch.cuda.synchronize()
    _zero_lrn_sgd_counts()                           # 0 just before ...
    prof.start()
    t0 = time.perf_counter()
    w.run()
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    prof.stop()
    launches = _lrn_sgd_counts()                     # ... read just after
    n_mb = len(serve_s)
    t0 = time.perf_counter()
    streams = stream_table(prof)
    trace_s = time.perf_counter() - t0
    pipe = loader.pipeline
    stats = pipe.stats.snapshot() if pipe is not None else None
    # the trained leaves, compared on the card (a host copy of AlexNet's
    # 62 M parameters would cost the phase ~0.3 s a run)
    weights = {f"{i}.{k}": leaf[k].detach().clone()
               for i, leaf in enumerate(step._params) for k in ("w", "b")
               if k in leaf}
    n_leaves = len(weights)
    cfg = dict(w._loader_config)
    w.stop()
    busy_ms = streams["union_ms"] / n_mb
    reading = {
        "depth": depth, "init_s": init_s, "run_s": wall_s,
        "trace_s": trace_s, "minibatches": n_mb,
        "ms_per_minibatch": wall_s * 1e3 / n_mb,
        "busy_ms_per_minibatch": busy_ms,
        "idle_share": 1 - busy_ms * n_mb / (wall_s * 1e3),
        "loader_serve_ms": float(np.mean(serve_s)) * 1e3,
        "loader_serve_ms_all": [s * 1e3 for s in serve_s],
        "streams": streams["by_stream"], "stats": stats,
        "rings": sorted(loader._rings),
        "graphs": sorted(str(k) for k in step._graphs or ()),
        "graph_replays": replays_of(step),
        "history": w.decision.metrics_history,
        "launches": launches, "leaves": n_leaves,
        "expect": {"lrn_forward": 2 * n_mb, "lrn_backward": 2 * n_mb,
                   "sgd_update": n_leaves * n_mb, "hand_conv": 0},
        "worker_alive_after_stop": bool(
            pipe is not None and pipe._thread is not None and
            pipe._thread.is_alive())}
    return reading, weights, first[0], cfg


def _decode_timings(tree: str) -> dict:
    """The loaders' decode (``_decode``: PIL's read, convert, float32) over
    IF_DECODE_IMAGES files of the tree."""
    import PIL

    from znicz_tpu_torch.loader import image as timage

    paths, _, _ = timage.scan_image_tree(tree)
    shape = (IF_INPUT + 29,) * 2 + (3,)
    t0 = time.perf_counter()
    for p in paths[:IF_DECODE_IMAGES]:
        timage._decode(p, shape)
    return {"decoder": f"PIL {PIL.__version__}",
            "images": IF_DECODE_IMAGES,
            "decode_ms_per_image": (time.perf_counter() - t0) * 1e3 /
            IF_DECODE_IMAGES}


def _image_alexnet(tmp: str) -> tuple:
    """(a): the tree, the two runs and their gates -> (reading, bad)."""
    from znicz_tpu_torch.loader import image as timage
    from znicz_tpu_torch.loader.base import get_loader

    tree = os.path.join(tmp, "alexnet")
    t0 = time.perf_counter()
    decode = IF_INPUT + 29                  # alexnet.build's augment
    timage.synthesize_image_dataset(tree, n_classes=IF_CLASSES,
                                    n_per_class=IF_PER_CLASS,
                                    size=(IF_TREE_PX, IF_TREE_PX))
    synth_s = time.perf_counter() - t0
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    try:
        sync, sync_w, sync_first, cfg = _image_alexnet_run(tree, None)
        piped, piped_w, piped_first, _ = _image_alexnet_run(tree, IF_DEPTH)
    finally:
        torch.backends.cudnn.deterministic = False
    # the first served minibatch against a CPU loader of the same seed
    t0 = time.perf_counter()
    tprng.seed_all(SEED)
    cpu = get_loader("file_image")(None, **cfg)
    cpu.initialize(device=TorchDevice("cpu"))
    cpu.run()
    cpu_first = cpu.minibatch_data.mem
    cpu_loader_s = time.perf_counter() - t0
    out = {"tree": {"classes": IF_CLASSES, "per_class": IF_PER_CLASS,
                    "size": [IF_TREE_PX] * 2, "images": IF_CLASSES *
                    IF_PER_CLASS},
           "synth_s": synth_s, "cpu_loader_s": cpu_loader_s,
           "config": {"batch": ALEX_BATCH, "input": IF_INPUT,
                      "decode": decode,
                      "classes": 1000, "dropout": 0.5, "epochs": 1,
                      "valid_fraction": 0.0, "loader": "file_image",
                      "augment": True,
                      "fit_samples": cfg["fit_samples"]},
           "sync": sync, "pipelined": piped,
           "first_minibatch_equals_cpu_loader": {
               "sync": sync_first.tobytes() == cpu_first.tobytes(),
               "pipelined": piped_first.tobytes() == cpu_first.tobytes()},
           **_decode_timings(tree)}
    bad = []
    if sync["history"] != piped["history"] or len(sync["history"]) != 1:
        bad.append(f"alexnet histories {sync['history']} / "
                   f"{piped['history']}")
    moved = [k for k in sync_w if not torch.equal(sync_w[k], piped_w[k])]
    if moved:
        bad.append(f"alexnet depth {IF_DEPTH} weights differ from the "
                   f"sync run's at {moved}")
    for run in (sync, piped):
        name = f"alexnet depth {run['depth']}"
        if run["minibatches"] != 2:
            bad.append(f"{name}: {run['minibatches']} minibatches, not 2")
        if run["launches"] != run["expect"]:
            bad.append(f"{name}: launches {run['launches']} != "
                       f"{run['expect']}")
        if run["graph_replays"] != {"train": run["minibatches"] - 1}:
            bad.append(f"{name}: graph replays {run['graph_replays']}")
        if run["worker_alive_after_stop"]:
            bad.append(f"{name}: the prefetch worker outlived run and stop")
    if piped["rings"] != ["data", "labels"] or \
            piped["stats"]["consumed"] != 2:
        bad.append(f"alexnet depth {IF_DEPTH}: rings {piped['rings']}, "
                   f"stats {piped['stats']}")
    if not all(out["first_minibatch_equals_cpu_loader"].values()):
        bad.append(f"alexnet first minibatch differs from the CPU loader's:"
                   f" {out['first_minibatch_equals_cpu_loader']}")
    infinite = [k for k, t in sync_w.items() if not torch.isfinite(t).all()]
    if infinite:
        bad.append(f"alexnet weights not finite at {infinite}")
    del sync_w, piped_w
    gc.collect()            # the two workflows' cycles, in this phase
    return out, bad


def _small_image_run(make, device, fused, counts=None) -> dict:
    """``make()`` (seeded here) on ``device`` in f32, TF32 off, through
    ``Workflow.run``; with ``counts`` (zero, read) the kernel counters
    set to 0 just before the run and read just after, and the classes of
    its minibatches."""
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        tprng.seed_all(SEED)
        w = make()
        w.initialize(device=TorchDevice(device, precision="float32"))
        classes, serve = [], w.loader.run

        def run():
            serve()
            classes.append(int(w.loader.minibatch_class))
        w.loader.run = run
        if counts:
            counts[0]()                              # 0 just before ...
        t0 = time.perf_counter()
        w.run()
        if device != "cpu":
            torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        launches = counts[1]() if counts else None   # ... read just after
        if fused:
            w.step.sync_to_units()
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32
    return {"history": w.decision.metrics_history, "weights": _weights_of(w),
            "wall_s": wall_s, "launches": launches, "classes": classes,
            "minibatches": len(classes),
            "pinned": fused and w.step._dataset_dev is not None,
            "leaves": sum(bool(f.weights) + bool(f.bias)
                          for f in w.forwards),
            "loader": type(w.loader).__name__,
            "served_shape": list(w.loader.served_shape)}


def _per_class(table: dict, classes: list) -> dict:
    n_train = classes.count(TRAIN)
    n_eval = len(classes) - n_train
    return {k: table["train"][k] * n_train + table["eval"][k] * n_eval
            for k in table["train"]}


def _held(card: dict, cpu: dict) -> dict:
    return {"max_abs_weight_err": max(float(np.abs(a - b).max()) for a, b in
                                      zip(card["weights"], cpu["weights"])),
            "cpu_history": cpu["history"], "cpu_wall_s": cpu["wall_s"]}


def _image_ae(tmp: str) -> tuple:
    """(b): the image AE eager (conv kernels, counted) and fused (cuDNN),
    each on the card against the CPU -> (reading, bad)."""
    from znicz_tpu_torch.models import image_ae as timage_ae

    tree = timage_ae.ensure_dataset(os.path.join(tmp, "image_ae"))
    out, bad = {}, []

    def mse(h):
        return [[r[k] for k in sorted(r) if k.startswith("metric")]
                for r in h]
    for fused in (False, True):
        kind = "fused" if fused else "eager"

        def make():
            return timage_ae.build(max_epochs=IF_EPOCHS, fused=fused,
                                   loader_config={"data_dir": tree})
        card = _small_image_run(make, DEVICE, fused, None if fused else
                                (_zero_ae_counts, _ae_counts))
        cpu = _small_image_run(make, "cpu", fused)
        r = out[kind] = {k: v for k, v in card.items() if k != "weights"}
        r.update(_held(card, cpu))
        r["mse_rel_vs_cpu"] = max(
            abs(x - y) / abs(y) for a, b in zip(mse(card["history"]),
                                                 mse(cpu["history"]))
            for x, y in zip(a, b))
        if not fused:
            r["expect"] = _per_class(IF_AE_LAUNCHES, card["classes"])
            if card["launches"] != r["expect"]:
                bad.append(f"image_ae eager launches {card['launches']} != "
                           f"{r['expect']}")
        if len(card["history"]) != IF_EPOCHS or \
                not r["mse_rel_vs_cpu"] <= AE_PARITY_MSE_RTOL:
            bad.append(f"image_ae {kind} mse {card['history']} against the "
                       f"CPU's {cpu['history']}")
        if not r["max_abs_weight_err"] <= AE_PARITY_ATOL:
            bad.append(f"image_ae {kind} weights {r['max_abs_weight_err']} "
                       f"from the CPU's")
    if not out["fused"]["pinned"]:
        bad.append("image_ae fused: the data set was not pinned")
    return out, bad


def _gemm_counts() -> dict:
    return {"gemm_fc": kgemm.gemm_launches,
            "act_backward": kgemm.act_launches}


def _zero_gemm_counts() -> None:
    kgemm.gemm_launches = kgemm.act_launches = 0


def _yale(tmp: str) -> tuple:
    """(c): Yale faces fused (SGD launches counted) and eager (gemm_fc and
    act_backward counted), each on the card against the CPU ->
    (reading, bad)."""
    from znicz_tpu_torch.models import yale_faces as tyale

    tree = tyale.ensure_dataset(os.path.join(tmp, "yale"))
    out, bad = {}, []
    for fused in (True, False):
        kind = "fused" if fused else "eager"

        def make():
            return tyale.build(max_epochs=IF_EPOCHS, fused=fused,
                               loader_config={"data_dir": tree})
        counts = ((lambda: setattr(koptim, "sgd_launches", 0)),
                  lambda: {"sgd_update": koptim.sgd_launches}) if fused \
            else (_zero_gemm_counts, _gemm_counts)
        card = _small_image_run(make, DEVICE, fused, counts)
        cpu = _small_image_run(make, "cpu", fused)
        r = out[kind] = {k: v for k, v in card.items() if k != "weights"}
        r.update(_held(card, cpu))
        n_train = card["classes"].count(TRAIN)
        r["expect"] = ({"sgd_update": card["leaves"] * n_train} if fused
                       else _per_class(IF_YALE_LAUNCHES, card["classes"]))
        if card["launches"] != r["expect"]:
            bad.append(f"yale {kind} launches {card['launches']} != "
                       f"{r['expect']}")
        if card["history"] != cpu["history"] or \
                len(card["history"]) != IF_EPOCHS:
            bad.append(f"yale {kind} history {card['history']} != the "
                       f"CPU's {cpu['history']}")
        if not r["max_abs_weight_err"] <= IF_YALE_WEIGHT_ATOL:
            bad.append(f"yale {kind} weights {r['max_abs_weight_err']} from "
                       f"the CPU's")
    if not out["fused"]["pinned"] or out["fused"]["served_shape"] != [
            32, 32, 1]:
        bad.append(f"yale fused: pinned {out['fused']['pinned']}, served "
                   f"{out['fused']['served_shape']}")
    return out, bad


def phase_image_files() -> dict:
    """The image-file loaders on the card (``loader/image.py``, decoding
    with PIL).  (a) AlexNet at full width from a synthesized 128-px PNG
    tree, resized to 256 px, with seeded crops and mirrors, fused: one
    class pass synchronous and at depth IF_DEPTH, profiled (ms a
    minibatch, busy ms, idle share, the loader's serve ms), the decode
    ms an image and the tree's synthesis seconds; gates: the histories
    and weights bit-identical, the first served minibatch (of
    both routes) byte-equal to a CPU loader's of the same seed, the LRN
    and SGD launches and the graph replays exact.  (b) image_ae.build()
    eager (conv2d_fwd, the input gradient, the weight gradient,
    deconv2d and deconv2d_backward counted exactly) and fused, each
    against the CPU within the conv AE's bands.  (c) yale_faces.build()
    fused (SGD launches exact) and eager (gemm_fc and act_backward
    exact), each with the CPU's n_err and its weights within
    IF_YALE_WEIGHT_ATOL.  Every part runs before the first failure is
    raised."""
    t0 = time.perf_counter()
    out = {"phase": "image_files"}
    bad = []
    with tempfile.TemporaryDirectory() as tmp:
        for key, part in (("alexnet", _image_alexnet),
                          ("image_ae", _image_ae), ("yale_faces", _yale)):
            t1 = time.perf_counter()
            out[key], b = part(tmp)
            out[key]["seconds"] = time.perf_counter() - t1
            bad += b
    out["seconds"] = time.perf_counter() - t0
    if bad:
        fail(f"image_files: {bad}: {out}")
    return out


#: snapshot_resume (a): AlexNet at full width (227 px, batch 128, 1000
#: classes, dropout 0.5), 2 train minibatches an epoch and no
#: validation; the first CLI run to SR_EPOCHS - 1 epochs writes the
#: snapshot, the second resumes it to SR_EPOCHS; each CLI process's
#: time limit in seconds
SR_TRAIN, SR_EPOCHS, SR_CLI_TIMEOUT = 2 * 128, 2, 300
#: (b): CIFAR conv on its pickle files, pipelined at depth 2
SR_CIFAR_EPOCHS = 4
#: (c): MNIST FC at bench_fc's width, cut to one hidden layer (its
#: AdamW + EMA snapshot of both hidden layers is 253 MB and took 21-26 s
#: of one core's compression on the H100 host), AdamW and EMA: the
#: layers, train and validation samples, the EMA decay
SR_FC_LAYERS = FC_LAYERS[:1]
SR_FC_TRAIN, SR_FC_VALID, SR_FC_EMA = 4 * 1024, 1024, 0.999
#: the workflow file the CLI runs in (a): alexnet.build() at its full
#: width, its epochs, sample count and snapshotter from
#: root.snapshot_smoke; after main() a result file: the history, a
#: SHA-256 of every param, momentum and optimizer leaf of the step and
#: of its generator's state, the SGD and LRN launch counters (set to 0
#: just before main), the seconds the restore took and the snapshot
#: written (its size and seconds)
SR_WORKFLOW = '''
import hashlib
import json
import os
import time

import torch

from znicz_tpu_torch.core.config import root
from znicz_tpu_torch.kernels import lrn, optim
from znicz_tpu_torch.models import alexnet


def build():
    cfg = root.snapshot_smoke
    snaps = cfg.get("snapshotter_config")
    return alexnet.build(max_epochs=cfg.max_epochs, n_train=cfg.n_train,
                         n_valid=0, dropout=0.5,
                         snapshotter_config=snaps.as_dict() if snaps
                         else None)


def digests(step):
    out = {f"{i}.{k}": hashlib.sha256(
        t.detach().reshape(-1).cpu().view(torch.uint8).numpy().tobytes()
        ).hexdigest()
        for i, leaf in enumerate(step._params) for k, t in leaf.items()}
    out["generator"] = hashlib.sha256(
        step._gen.get_state().numpy().tobytes()).hexdigest()
    return out


def wait_after_initialize(w, path, timeout):
    """Make ``w.initialize`` wait, once done, until ``path`` exists (a
    snapshot another process publishes with os.replace)."""
    initialize = w.initialize
    waited = {}

    def wrapped(**kwargs):
        initialize(**kwargs)
        t0 = time.perf_counter()
        while not os.path.exists(path):
            if time.perf_counter() - t0 > timeout:
                raise TimeoutError(f"{path} did not appear")
            time.sleep(0.02)
        waited["s"] = time.perf_counter() - t0

    w.initialize = wrapped
    return waited


def run(load, main):
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    w, _ = load(build)
    cfg = root.snapshot_smoke
    waited = {} if not cfg.get("wait_for") else wait_after_initialize(
        w, cfg.wait_for, cfg.wait_timeout)
    optim.sgd_launches = lrn.fwd_launches = lrn.bwd_launches = 0
    t0 = time.perf_counter()
    main()
    main_s = time.perf_counter() - t0
    launcher = getattr(main, "__self__", None)
    snap = getattr(w, "snapshotter", None)
    with open(cfg.result_file, "w") as f:
        json.dump({"history": w.decision.metrics_history,
                   "digests": digests(w.step),
                   "launches": {"sgd_update": optim.sgd_launches,
                                "lrn_forward": lrn.fwd_launches,
                                "lrn_backward": lrn.bwd_launches},
                   "graph_replays": sum(g.replays for g in
                                        (w.step._graphs or {}).values()
                                        if g),
                   "restore_s": getattr(launcher, "restore_seconds", None),
                   "waited_s": waited.get("s"),
                   "snapshot": None if snap is None else snap.last_export,
                   "main_s": main_s, "end_time": time.time()}, f)
'''


class _SrCli:
    """One ``python -m znicz_tpu_torch`` run of the workflow file, started
    at once in its own process; ``result()`` waits for it and returns
    (its result document, the seconds from its start to its result
    written), failing on a non-zero exit; ``kill()`` stops it if it
    still runs."""

    def __init__(self, tmp, wf, name, *args) -> None:
        self.name = name
        self.path = os.path.join(tmp, f"{name}.json")
        self.t0 = time.time()
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "znicz_tpu_torch", wf, "--random-seed",
             str(SEED), "-o", f"root.snapshot_smoke.n_train={SR_TRAIN}",
             "-o", f"root.snapshot_smoke.result_file={self.path}", *args],
            cwd=os.path.dirname(os.path.abspath(__file__)),
            env={**os.environ, "ZNICZ_TPU_SITE_CONFIG": ""},
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)

    def result(self) -> tuple:
        out, err = self.proc.communicate(timeout=SR_CLI_TIMEOUT)
        if self.proc.returncode != 0:
            fail(f"snapshot_resume: the {self.name} CLI run exited "
                 f"{self.proc.returncode}: {out[-2000:]} {err[-4000:]}")
        with open(self.path) as f:
            doc = json.load(f)
        # from the start to the result written (the process's own clock)
        return doc, doc["end_time"] - self.t0

    def kill(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.communicate()


def _sr_in_process(wf: str, tmp: str) -> tuple:
    """The uninterrupted SR_EPOCHS-epoch run of the same workflow file in
    this process, through the launcher as the CLI drives it (seeded as
    ``--random-seed`` seeds) -> (result document, wall seconds)."""
    from znicz_tpu_torch.__main__ import load_workflow_module
    from znicz_tpu_torch.launcher import Launcher

    result = os.path.join(tmp, "uninterrupted.json")
    root.snapshot_smoke.update({"max_epochs": SR_EPOCHS,
                                "n_train": SR_TRAIN,
                                "result_file": result})
    try:
        tprng.seed_all(SEED)
        module = load_workflow_module(wf)
        launcher = Launcher(device=TorchDevice())
        t0 = time.perf_counter()
        module.run(launcher.load, launcher.main)
        wall = time.perf_counter() - t0
    finally:
        del root.snapshot_smoke
    with open(result) as f:
        return json.load(f), wall


def _sr_cli_round_trip(tmp: str, overlapped) -> tuple:
    """(a): the CLI to epoch SR_EPOCHS - 1 with the snapshotter on, the
    CLI again from that snapshot (``-w``) to SR_EPOCHS, and the
    uninterrupted run in this process.  Both CLI processes start at once
    (the second restores when the first has published its snapshot)
    and run while ``overlapped()`` (the phase's other parts) and the
    uninterrupted run go on here -> (reading, the other parts' result,
    what failed)."""
    wf = os.path.join(tmp, "alexnet_wf.py")
    with open(wf, "w") as f:
        f.write(SR_WORKFLOW)
    snaps = os.path.join(tmp, "snaps")
    snap_path = os.path.join(snaps, f"alexnet_{SR_EPOCHS - 1}.npz")
    clis = [_SrCli(
        tmp, wf, "first",
        "-o", f"root.snapshot_smoke.max_epochs={SR_EPOCHS - 1}",
        "-o", "root.snapshot_smoke.snapshotter_config={"
        f"'directory': '{snaps}', 'prefix': 'alexnet', "
        "'only_improved': False}")]
    try:
        # the resumed process starts too: it initializes, then waits for
        # the first one to publish the snapshot before it restores it
        clis.append(_SrCli(
            tmp, wf, "resumed", "-w", snap_path,
            "-o", f"root.snapshot_smoke.max_epochs={SR_EPOCHS}",
            "-o", f"root.snapshot_smoke.wait_for={snap_path}",
            "-o", f"root.snapshot_smoke.wait_timeout={SR_CLI_TIMEOUT}"))
        others = overlapped()
        straight, straight_s = _sr_in_process(wf, tmp)
        first, first_s = clis[0].result()
        resumed, resumed_s = clis[1].result()
    finally:
        for cli in clis:
            cli.kill()
    snap = first["snapshot"]
    if snap is None or snap["path"] != snap_path:
        fail(f"snapshot_resume: the first run wrote no snapshot at "
             f"{snap_path}: {first}")
    bad = []
    steps = SR_TRAIN // ALEX_BATCH              # train minibatches an epoch
    want = {"sgd_update": 16 * steps, "lrn_forward": 2 * steps,
            "lrn_backward": 2 * steps}
    if resumed["history"] != straight["history"]:
        bad.append(f"history {resumed['history']} != uninterrupted "
                   f"{straight['history']}")
    moved = sorted(k for k, v in straight["digests"].items()
                   if resumed["digests"].get(k) != v)
    if moved or set(resumed["digests"]) != set(straight["digests"]):
        bad.append(f"digests differ from the uninterrupted run: {moved}")
    if resumed["launches"] != want:
        bad.append(f"the resumed run's launches {resumed['launches']} != "
                   f"{want}")
    if resumed["graph_replays"] < 1:
        bad.append("the resumed run replayed no graph")
    reading = {
        "config": {"input": 227, "batch": ALEX_BATCH, "classes": 1000,
                   "dropout": 0.5, "n_train": SR_TRAIN, "n_valid": 0,
                   "epochs": SR_EPOCHS, "snapshot_epoch": SR_EPOCHS - 1},
        "snapshot_mb": snap["bytes"] / 1e6,
        "collect_s": snap["collect_s"], "write_s": snap["write_s"],
        "restore_s": resumed["restore_s"],
        "cli_first_s": first_s, "cli_resumed_s": resumed_s,
        "uninterrupted_s": straight_s,
        "first_main_s": first["main_s"], "resumed_main_s":
        resumed["main_s"], "resumed_waited_s": resumed["waited_s"],
        "overlapped": "both CLI processes ran beside each other and the "
        "phase's other parts; the resumed one restored once the first "
        "published its snapshot",
        "history": resumed["history"],
        "leaves_compared": len(straight["digests"]),
        "resumed_launches": resumed["launches"],
        "resumed_graph_replays": resumed["graph_replays"],
        "identical": not bad}
    return reading, others, bad


def _sr_cifar(snap_dir, depth, built):
    """CIFAR conv on its pickle files (the reference's config, fused),
    SR_CIFAR_EPOCHS epochs, at pipeline ``depth`` (None: synchronous),
    snapshotting every epoch into ``snap_dir`` when given; appended to
    ``built``."""
    from znicz_tpu_torch.models import cifar_conv as tcifar
    from znicz_tpu_torch.pipeline import attach_prefetcher

    tprng.seed_all(SEED)
    cfg = None if snap_dir is None else {
        "directory": snap_dir, "prefix": "cifar", "only_improved": False,
        "keep_all": True}
    w = tcifar.build(max_epochs=SR_CIFAR_EPOCHS, n_train=IP_CIFAR_TRAIN,
                     n_valid=IP_CIFAR_VALID, snapshotter_config=cfg)
    if depth:
        w.input_pipeline = attach_prefetcher(
            w.loader, stager=w.step.make_stager(), depth=depth)
    w.initialize(device=TorchDevice())
    built.append(w)
    return w


def _sr_supervised_drill() -> tuple:
    """(b): the synchronous run, then the pipelined one crashed at a
    seeded epoch and resumed by ``run_supervised`` -> (reading, what
    failed)."""
    from znicz_tpu_torch.pipeline import BatchPrefetcher
    from znicz_tpu_torch.resilience import faults
    from znicz_tpu_torch.resilience.supervisor import (SupervisorPolicy,
                                                       run_supervised)

    built = []
    t0 = time.perf_counter()
    sync = _sr_cifar(None, None, built)
    sync.run()
    sync.step.sync_to_units()
    sync_w = _conv_fc_weights(sync)
    crash_epoch = int(np.random.default_rng(SEED).integers(
        1, SR_CIFAR_EPOCHS))
    plan = faults.FaultPlan(seed=SEED)
    plan.crash_at("workflow.step", when=lambda workflow, unit:
                  int(workflow.decision.epoch_number) == crash_epoch)
    with tempfile.TemporaryDirectory() as snaps:
        with faults.active(plan):
            report = run_supervised(
                lambda: _sr_cifar(snaps, IP_DEPTH, built), snaps,
                SupervisorPolicy(sleep=lambda s: None))
        w = report.workflow
        w.step.sync_to_units()
        weights = _conv_fc_weights(w)
        staged = w.input_pipeline.stats.snapshot()["bytes_staged"]
        for each in built:
            each.stop()
        alive = [t.name for t in threading.enumerate()
                 if t.name == BatchPrefetcher.THREAD_NAME and t.is_alive()]
        flights = len(report.flights)
    bad = []
    if not plan.log or report.restarts != 1 or not report.resumed_from:
        bad.append(f"the drill: {report.as_dict()}, fired {plan.log}")
    if w.decision.metrics_history != sync.decision.metrics_history:
        bad.append(f"supervised history {w.decision.metrics_history} != "
                   f"sync {sync.decision.metrics_history}")
    moved = [k for k in sync_w if not all(
        np.array_equal(a, b) for a, b in zip(sync_w[k], weights[k]))]
    if moved:
        bad.append(f"supervised weights moved from the sync run: {moved}")
    if alive or staged <= 0:
        bad.append(f"workers alive {alive}, bytes staged {staged}")
    reading = {"epochs": SR_CIFAR_EPOCHS, "n_train": IP_CIFAR_TRAIN,
               "n_valid": IP_CIFAR_VALID, "depth": IP_DEPTH,
               "loader": type(w.loader).__name__,
               "crash_epoch": crash_epoch, "restarts": report.restarts,
               "resumed_from": [os.path.basename(p)
                                for p in report.resumed_from],
               "flights": flights, "bytes_staged": staged,
               "workers_alive": alive,
               "history": w.decision.metrics_history,
               "seconds": time.perf_counter() - t0, "identical": not bad}
    return reading, bad


def _step_digests(step) -> dict:
    """Every leaf of the fused step's params (weights, velocities,
    moments, step counts, EMA mirrors) and its generator's state as
    host bytes, for a bit-for-bit comparison."""
    out = {f"{i}.{k}": t.detach().reshape(-1).cpu().view(
        torch.uint8).numpy().tobytes()
        for i, leaf in enumerate(step._params) for k, t in leaf.items()}
    out["generator"] = step._gen.get_state().numpy().tobytes()
    return out


def _sr_resume_pair(make, tmp: str, name: str, count=None) -> tuple:
    """(c) and (d) for one workflow: ``make(epochs)`` -> an initialized
    fused workflow.  The uninterrupted 2-epoch run; a 1-epoch run's
    snapshot resumed (the launcher's ``resume``: the restore, the
    Decision re-armed for the second epoch) in a fresh 2-epoch workflow
    (the counter
    ``count`` read over its run); and the same snapshot restored into a
    2-epoch workflow that has already run both epochs, every body
    captured and replayed, which must replay the restored state and not
    the buffers it had -> (reading, what failed)."""
    from znicz_tpu_torch.launcher import resume
    from znicz_tpu_torch.snapshotter import collect_state, write_snapshot

    full = make(2)
    full.run()
    want = (full.decision.metrics_history, _step_digests(full.step))
    first = make(1)
    first.run()
    path = os.path.join(tmp, f"{name}.npz")
    t0 = time.perf_counter()
    arrays, meta = collect_state(first)
    write_snapshot(path, arrays, meta)
    write_s = time.perf_counter() - t0
    del first
    bad, reading = [], {"snapshot_mb": os.path.getsize(path) / 1e6,
                        "write_s": write_s}
    fresh = make(2)
    t0 = time.perf_counter()
    resume(fresh, path)
    reading["restore_s"] = time.perf_counter() - t0
    if count is not None:
        setattr(*count, 0)
    fresh.run()
    if count is not None:
        reading["launches"] = getattr(*count)
    got = (fresh.decision.metrics_history, _step_digests(fresh.step))
    if got != want:
        bad.append(f"{name}: the fresh restore differs from the "
                   f"uninterrupted run: {got[0]} vs {want[0]}, leaves "
                   f"{sorted(k for k in want[1] if got[1].get(k) != want[1][k])}")
    del fresh
    stepped = make(2)
    stepped.run()
    graphs = dict(stepped.step._graphs or {})
    before = replays_of(stepped.step)
    resume(stepped, path)
    stepped.run()
    after = replays_of(stepped.step)
    got = (stepped.decision.metrics_history, _step_digests(stepped.step))
    same_graphs = all(stepped.step._graphs.get(k) is g
                      for k, g in graphs.items())
    if got != want:
        bad.append(f"{name}: the restore into the captured step differs "
                   f"(a stale replay?): {got[0]} vs {want[0]}, leaves "
                   f"{sorted(k for k in want[1] if got[1].get(k) != want[1][k])}")
    if not graphs or not same_graphs or \
            after.get("train", 0) <= before.get("train", 0):
        bad.append(f"{name}: graphs recaptured or not replayed: "
                   f"{before} -> {after}")
    reading.update({"history": want[0], "leaves": len(want[1]),
                    "captured_graphs": len(graphs),
                    "replays_before_restore": before,
                    "replays_after_restore": after,
                    "graphs_kept": same_graphs, "identical": not bad})
    return reading, bad


def _sr_mnist_adam(epochs):
    tprng.seed_all(SEED)
    w = tmnist.build_fused(max_epochs=epochs, layers=SR_FC_LAYERS,
                           minibatch_size=FC_BATCH, n_train=SR_FC_TRAIN,
                           n_valid=SR_FC_VALID, optimizer="adam",
                           ema_decay=SR_FC_EMA)
    w.initialize(device=TorchDevice())
    return w


def _sr_alexnet67(epochs):
    tprng.seed_all(SEED)
    w = _gp_alexnet()
    w.decision.max_epochs = epochs
    w.initialize(device=TorchDevice())
    return w


def phase_snapshot_resume() -> dict:
    """Snapshots, the workflow CLI and the supervisor on the card.  (a)
    ``python -m znicz_tpu_torch wf.py`` trains alexnet.build() at full
    width to epoch 1 and writes a snapshot; a second process resumes it
    with ``-w`` to epoch 2; its history, a digest of every param,
    momentum leaf and of the step's generator state equal those of the
    uninterrupted 2-epoch run made here, and its counters show the SGD
    and LRN kernels launched (16 and 2 + 2 a train step).  (b) CIFAR conv
    on its pickle files at pipeline depth 2, crashed at a seeded epoch
    and resumed by ``run_supervised``: history and weights equal to the
    synchronous run's, no prefetch worker left.  (c) MNIST FC at
    bench_fc's width with one hidden layer, AdamW and EMA (one
    ``adam_multi_kernel``
    launch a step): snapshot, restore into a fresh workflow, continue,
    bit-identical to the uninterrupted run.  (d) that snapshot, and the
    67-px AlexNet's with dropout, restored into a workflow whose step
    has already captured and replayed its graphs: it continues
    bit-identical, the graphs kept.  (b)-(d) and the uninterrupted run
    of (a) run here while the first CLI process runs (most of it the
    snapshot's compression, on one host core).  cuDNN runs
    deterministic."""
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    t0 = time.perf_counter()
    out = {"phase": "snapshot_resume", "cudnn_deterministic": True}

    def others(tmp):
        bad, t1 = [], time.perf_counter()
        out["cifar_supervised"], b = _sr_supervised_drill()
        bad += b
        out["mnist_adam_ema"], b = _sr_resume_pair(
            _sr_mnist_adam, tmp, "mnist_adam_ema",
            (koptim, "adam_launches"))
        bad += b
        steps = SR_FC_TRAIN // FC_BATCH
        if out["mnist_adam_ema"]["launches"] != steps:
            bad.append(f"adam launches {out['mnist_adam_ema']['launches']}"
                       f" != one a train step ({steps})")
        out["alexnet67_dropout"], b = _sr_resume_pair(
            _sr_alexnet67, tmp, "alexnet67_dropout")
        # (b)-(d) in this process, beside the CLI processes of (a)
        out["in_process_s"] = time.perf_counter() - t1
        return bad + b

    try:
        with tempfile.TemporaryDirectory() as tmp:
            out["alexnet_cli"], bad, b = _sr_cli_round_trip(
                tmp, lambda: others(tmp))
            bad += b
    finally:
        torch.backends.cudnn.deterministic = False
    out["seconds"] = time.perf_counter() - t0
    if bad:
        fail(f"snapshot_resume: {bad}: {out}")
    return out


#: data_parallel (a): alexnet.build() at its defaults (alexnet_fused's
#: configuration: 227 px, batch 128, 1000 classes, dropout 0.5, bf16 over
#: f32 masters, the data set pinned) for one epoch of DP_TRAIN_MB train
#: minibatches (350 samples: the last one padded) through Workflow.run,
#: with no group and in each layout on a one-rank NCCL world; then DP_REPS
#: timed train_steps calls of DP_K staged batches a layout
DP_LAYOUTS = {"replicated": {}, "shard_update": {"shard_update": True},
              "shard_params": {"shard_params": True}}
DP_TRAIN_MB, DP_K, DP_REPS = 3, 4, 3
#: (b): MNIST FC at bench_fc's widths (784-4096-4096-10, batch 1024),
#: AdamW at lr 1e-3, for DP_FC_STEPS train steps with each codec, the card
#: (f32, TF32 off) on the one-rank world against the CPU with no group.
#: The MNIST FC bands: identical n_err, weights within the AdamW band
#: (2e-3: a gradient element the two devices round to either side of an
#: int8 or bf16 step moves by up to lr there), the train loss within
#: mnist_parity's 1e-5, which the card's run with TF32 on must fail
DP_FC_STEPS, DP_FC_LR, DP_FC_WEIGHT_ATOL = 4, 1e-3, 2e-3
DP_CODECS = {"int8_ef": {"mode": "int8", "error_feedback": True},
             "bf16": {"mode": "bf16", "error_feedback": False}}
#: (c): the (world size, rank) whose shards of AlexNet's 16 leaves the
#: update kernels take: ranks 0 and n - 1 of n = 2 and 4 (fc8's bias at
#: n = 4 is a 250-element slice, not a multiple of 4, at a 16-byte
#: misaligned offset on rank 3)
DP_SHARDS = ((2, 0), (2, 1), (4, 0), (4, 3))
#: (d): the pre-multiplied sum that NCCL runs a kernel for at one rank
#: (a one-rank sum is no operation and a one-rank gather one copy, so
#: the step's own collectives show no NCCL kernel on one card): x · 0.5,
#: exact in f32, over DP_PREMUL_N elements
DP_PREMUL, DP_PREMUL_N = 0.5, 1 << 20
#: a device activity NCCL launches, by its kernel's name
DP_NCCL_KERNEL = re.compile(r"nccl|oneRank", re.I)


def _dp_weights(w) -> dict:
    """Host bytes of every weight, bias and momentum in the param shape
    (regathered from shards) and of the step's generator state."""
    w.step.sync_to_units()
    out = {f"{f.name}.{a}": np.asarray(arr.map_read()).tobytes()
           for f in w.forwards for a, arr in (("w", f.weights),
                                              ("b", f.bias)) if arr}
    out.update({f"{g.name}.v{a}": np.asarray(arr.map_read()).tobytes()
                for g in w.gds for a, arr in (("w", g.gradient_weights),
                                              ("b", g.gradient_bias))
                if arr})
    out["generator"] = w.step._gen.get_state().numpy().tobytes()
    return out


def _dp_replay_activities(step, xs, ys, ms) -> dict:
    """One train_steps call of one staged batch (a replay of the captured
    step) under torch.profiler: the device activities after the mark,
    those whose names hold "nccl" or "memcpy" by name, and all of them."""
    acts = None
    for _ in range(3):
        acts = profiled_after_mark(
            lambda: step.train_steps(xs[:1], ys[:1], ms[:1]), 1)
        if acts:
            break
    if not acts:
        fail("data_parallel: three profiled windows lost their mark")
    coll = {}
    for name, us in acts:
        if re.search("nccl|memcpy", name, re.I):
            coll[name[:80]] = coll.get(name[:80], 0) + 1
    return {"activities": len(acts), "nccl_or_memcpy": coll,
            "copies": sum(coll.values())}


@contextlib.contextmanager
def _dp_data_once(made: dict):
    """AlexNet's synthetic data set drawn once for the phase's runs: the
    loader's ``load_data`` draws it at the first build and hands later
    builds of the same configuration a copy (``made`` keeps them).  The
    data has a stream of its own ("synthetic"), so no other draw
    moves."""
    from znicz_tpu_torch.loader.synthetic import SyntheticImageLoader

    draw = SyntheticImageLoader.load_data

    def load_data(self):
        key = (self.sample_shape, self.n_classes, str(self.n_per_class),
               self.spread, self.noise)
        if key not in made:
            draw(self)
            made[key] = (self.original_data.mem.copy(),
                         self.original_labels.mem.copy(),
                         list(self.class_lengths))
        data, labels, lengths = made[key]
        self.original_data.mem = data.copy()
        self.original_labels.mem = labels.copy()
        self.class_lengths = list(lengths)

    SyntheticImageLoader.load_data = load_data
    try:
        yield
    finally:
        SyntheticImageLoader.load_data = draw


def _dp_nccl_in_replay(step) -> dict:
    """(d): one all-reduce that NCCL runs a kernel for at one rank (the
    pre-multiplied sum), captured in a CUDA graph on the step's capture
    stream after one eager call there, and replayed under torch.profiler:
    the replay's device activities by name, the NCCL kernels among them,
    and the result against x · DP_PREMUL."""
    import torch.distributed as dist

    group, stream = step.mesh.group, step._stream
    x = torch.arange(DP_PREMUL_N, dtype=torch.float32, device=DEVICE)
    buf = x.clone()
    op = dist._make_nccl_premul_sum(DP_PREMUL)
    torch.cuda.synchronize()
    with torch.cuda.stream(stream):
        dist.all_reduce(buf, op=op, group=group)          # eager, warm
    torch.cuda.synchronize()
    eager_ok = torch.equal(buf, x * DP_PREMUL)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        dist.all_reduce(buf, op=op, group=group)

    def replay():
        buf.copy_(x)
        graph.replay()
    acts = None
    for _ in range(3):
        acts = profiled_after_mark(replay, 1)
        if acts:
            break
    if not acts:
        fail("data_parallel: three profiled windows lost their mark")
    names = {}
    for name, _us in acts:
        names[name[:80]] = names.get(name[:80], 0) + 1
    torch.cuda.synchronize()
    return {"op": f"premul_sum({DP_PREMUL})", "elements": DP_PREMUL_N,
            "stream": "the step's capture stream", "activities": names,
            "nccl_kernels": {k: v for k, v in names.items()
                             if DP_NCCL_KERNEL.search(k)},
            "eager_equal": eager_ok,
            "replay_equal": torch.equal(buf, x * DP_PREMUL)}


def _dp_alexnet_run(layout) -> dict:
    """(a) for one layout (None: no group, replicated): the epoch through
    Workflow.run with the SGD, LRN and collective counters set to 0 just
    before and read just after, the graph replays, the digests; then the
    timed train_steps calls (ms a step, the collectives a step, peak
    memory) and one profiled replay."""
    gc.collect()                        # the last run's graphs and pools
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    mem_start = torch.cuda.memory_allocated()
    t_start = time.perf_counter()
    tprng.seed_all(SEED)
    w = talexnet.build(n_train=DP_TRAIN_MB * ALEX_BATCH, n_valid=0,
                       max_epochs=1, **DP_LAYOUTS[layout or "replicated"])
    t0 = time.perf_counter()
    w.initialize(device=TorchDevice())
    init_s = time.perf_counter() - t0
    step = w.step
    _zero_lrn_sgd_counts()                           # 0 just before ...
    tmesh.collective_launches = 0
    t0 = time.perf_counter()
    w.run()
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = {**_lrn_sgd_counts(),
                "collectives": tmesh.collective_launches}
    replays = replays_of(step)                       # ... read just after
    out = {"mesh": repr(step.mesh), "init_s": init_s, "run_s": run_s,
           "history": w.decision.metrics_history, "launches": launches,
           "graph_replays": replays, "digests": _dp_weights(w),
           "leaf_shapes": [{k: tuple(v.shape) for k, v in leaf.items()}
                           for leaf in step._params]}
    data, labels = step._dataset_dev
    idx = torch.tensor((np.arange(ALEX_BATCH)[None, :] -
                        np.arange(DP_K)[:, None]) % ALEX_BATCH,
                       device=DEVICE)
    xs, ys = data[idx], labels[idx]
    ms = torch.ones((DP_K, ALEX_BATCH), dtype=torch.bool, device=DEVICE)
    step.train_steps(xs, ys, ms)                     # eager, capture
    torch.cuda.synchronize()
    before = tmesh.collective_launches
    events = []
    for _ in range(DP_REPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        step.train_steps(xs, ys, ms)
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    out["step_ms"] = [s.elapsed_time(e) / DP_K for s, e in events]
    out["collectives_per_step"] = (tmesh.collective_launches - before) / \
        (DP_REPS * DP_K)
    # the run's own peak: from initialize through the timed calls, over
    # what was allocated before it was built
    out["peak_mem_bytes"] = torch.cuda.max_memory_allocated() - mem_start
    out["replay_profile"] = _dp_replay_activities(step, xs, ys, ms)
    out["seconds"] = time.perf_counter() - t_start
    out["_step"] = step
    return out


def _dp_fc_run(device, codec, allow_tf32=False) -> dict:
    """(b): one epoch of DP_FC_STEPS train minibatches in f32 on
    ``device`` (the card on the world, the CPU with no group) -> the
    history, the epoch's train loss, the weights, the AdamW launches and
    the error-feedback residuals' largest magnitude."""
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = allow_tf32
    try:
        tprng.seed_all(SEED)
        w = tmnist.build_fused(
            max_epochs=1, layers=FC_LAYERS, minibatch_size=FC_BATCH,
            n_train=DP_FC_STEPS * FC_BATCH, n_valid=0, lr=DP_FC_LR,
            optimizer="adam", quantized_collectives=codec,
            mesh=None if device == DEVICE else tmesh.DataMesh(1))
        w.initialize(device=TorchDevice(device, precision="float32"))
        losses, logged = [], w.decision.on_epoch_logged

        def on_epoch_logged():
            losses.append(float(w.step.loss))
            logged()

        w.decision.on_epoch_logged = on_epoch_logged
        koptim.adam_launches = 0
        w.run()
        launches = koptim.adam_launches
        extra = w.step.extra_state_arrays()
        w.step.sync_to_units()
        weights = [a.copy() for f in w.forwards
                   for a in (f.weights.map_read(), f.bias.map_read())]
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    return {"history": w.decision.metrics_history, "losses": losses,
            "weights": weights, "adam_launches": launches,
            "mesh": repr(w.step.mesh),
            "residual_max": max((float(np.abs(v).max()) for k, v in
                                 extra.items() if k.endswith(("rw", "rb"))),
                                default=0.0)}


#: (b)'s CPU runs, in a process of their own: the whole smoke starts it
#: before snapshot_resume, whose host work keeps one core busy, and
#: ``--phase data_parallel`` at the phase's start; DP_CPU_THREADS of the
#: host's cores, the rest left to the phase it runs beside
DP_CPU_THREADS = 6
DP_CPU_SCRIPT = """
import pickle, sys
sys.path.insert(0, {root!r})
import torch
torch.set_num_threads({threads})
import chip_smoke as cs
runs = {{name: cs._dp_fc_run("cpu", codec)
        for name, codec in cs.DP_CODECS.items()}}
with open({out!r}, "wb") as f:
    pickle.dump(runs, f)
"""


def _dp_cpu_start() -> tuple:
    """Start (b)'s CPU runs in a process of their own (no card in its
    view) -> ``(process, result path, its directory)``."""
    tmp = tempfile.mkdtemp()
    out = os.path.join(tmp, "dp_cpu.pkl")
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    proc = subprocess.Popen(
        [sys.executable, "-c", DP_CPU_SCRIPT.format(
            root=os.path.dirname(os.path.abspath(__file__)), out=out,
            threads=DP_CPU_THREADS)],
        env=env, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
        text=True)
    return proc, out, tmp


def _dp_cpu_stop(started) -> None:
    """Stop the CPU runs' process if it still runs, and remove its
    directory."""
    proc, _, tmp = started
    if proc.poll() is None:
        proc.kill()
        proc.wait()
    shutil.rmtree(tmp, ignore_errors=True)


def _dp_cpu_results(proc, path) -> dict:
    import pickle

    _, err = proc.communicate(timeout=600)
    if proc.returncode != 0:
        fail(f"data_parallel: the CPU runs exited {proc.returncode}: "
             f"{err[-3000:]}")
    with open(path, "rb") as f:
        return pickle.load(f)


def _dp_fc_codecs(cpu_runs) -> dict:
    t0 = time.perf_counter()
    out, bad = {}, []
    for name, codec in DP_CODECS.items():
        card, cpu = _dp_fc_run(DEVICE, codec), cpu_runs()[name]
        row = {"history_card": card["history"], "history_cpu": cpu["history"],
               "losses_card": card["losses"], "losses_cpu": cpu["losses"],
               "loss_rel": max(abs(a - b) / abs(b) for a, b in
                               zip(card["losses"], cpu["losses"])),
               "weight_max_abs": max(float(np.abs(a - b).max()) for a, b in
                                     zip(card["weights"], cpu["weights"])),
               "adam_launches": card["adam_launches"],
               "residual_max": card["residual_max"], "mesh": card["mesh"]}
        if name == "int8_ef":
            tf = _dp_fc_run(DEVICE, codec, allow_tf32=True)
            row["tf32_control"] = {
                "losses": tf["losses"],
                "loss_rel": max(abs(a - b) / abs(b) for a, b in
                                zip(tf["losses"], cpu["losses"]))}
            if not row["tf32_control"]["loss_rel"] > MNIST_PARITY_LOSS_RTOL:
                bad.append(f"{name}: the loss band passes the TF32 control")
            if not row["residual_max"] > 0:
                bad.append(f"{name}: no error-feedback residual accrued")
        if row["history_card"] != row["history_cpu"]:
            bad.append(f"{name}: n_err histories differ")
        if not row["loss_rel"] <= MNIST_PARITY_LOSS_RTOL:
            bad.append(f"{name}: train loss card vs cpu")
        if not row["weight_max_abs"] <= DP_FC_WEIGHT_ATOL:
            bad.append(f"{name}: weights card vs cpu")
        if row["adam_launches"] != DP_FC_STEPS:
            bad.append(f"{name}: {row['adam_launches']} AdamW launches, "
                       f"not one a step")
        out[name] = row
    out["seconds"] = time.perf_counter() - t0
    return out, bad


def _dp_update_kernels(shapes) -> tuple:
    """(c): ``sgd_update_`` leaf by leaf and one ``adam_update_multi_``
    over AlexNet's 16 leaves, each leaf cut as ``zero.pad_slice`` gives
    rank r of n its slice (a view of the leaf at the rank's offset, as the
    shard_update step passes them), against the plain versions on the
    same slices and against one launch on the whole leaves, bit for bit."""
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 61)
    h = _scalars(OPTIM_HYPER)
    ah = _scalars(ADAM_HYPER)
    t_step = _dev(np.float32(3.0))
    ah["c1"], ah["c2"] = 1.0 - ah["b1"] ** t_step, 1.0 - ah["b2"] ** t_step
    bs = _dev(np.float32(ALEX_BATCH))

    def randn(shape, scale):
        return torch.randn(shape, generator=gen, device=DEVICE) * scale

    rows, bad = [], []
    t0 = time.perf_counter()
    for n, rank in DP_SHARDS:
        full = [{"w": randn(sh, 0.05), "g": randn(sh, 32.0),
                 "v": randn(sh, 0.01), "m": randn(sh, 0.1),
                 "s": randn(sh, 0.01).abs()} for sh in shapes]
        ker, ref, whole = _clone(full), _clone(full), _clone(full)

        def cut(leaves, keys):
            return [{k: tzero.pad_slice(leaf[k], rank, n) for k in keys}
                    for leaf in leaves]
        ks, rs = cut(ker, "wgv"), cut(ref, "wgv")
        before = koptim.sgd_launches
        for kl, rl in zip(ks, rs):
            koptim.sgd_update_(kl["w"], kl["g"], kl["v"], h["lr"], h["wd"],
                               h["l1"], h["mom"], bs)
            koptim.sgd_update_plain(rl["w"], rl["g"], rl["v"], h["lr"],
                                    h["wd"], h["l1"], h["mom"], bs)
        sgd_launches = koptim.sgd_launches - before
        for wl in whole:
            koptim.sgd_update_(wl["w"], wl["g"], wl["v"], h["lr"], h["wd"],
                               h["l1"], h["mom"], bs)
        wcut = cut(whole, "wv")
        sgd = {"to_plain": all(torch.equal(a[k], b[k]) for a, b in
                               zip(ks, rs) for k in "wv"),
               "to_whole_leaf": all(torch.equal(a[k], b[k]) for a, b in
                                    zip(ks, wcut) for k in "wv"),
               "max_abs_err": max(_max_abs(a[k], b[k]) for a, b in
                                  zip(ks, rs) for k in "wv")}
        ker, ref, whole = _clone(full), _clone(full), _clone(full)
        ks, rs = cut(ker, "wgms"), cut(ref, "wgms")
        before = koptim.adam_launches

        def multi(leaves):
            koptim.adam_update_multi_(
                [(lf["w"], lf["g"], lf["m"], lf["s"], ah["lr"], ah["wd"],
                  ah["c1"], ah["c2"]) for lf in leaves], ah["b1"], ah["b2"],
                ah["eps"], bs)
        multi(ks)
        adam_launches = koptim.adam_launches - before
        multi(whole)
        for rl in rs:
            koptim.adam_update_plain(rl["w"], rl["g"], rl["m"], rl["s"],
                                     ah["lr"], ah["wd"], ah["b1"], ah["b2"],
                                     ah["eps"], ah["c1"], ah["c2"], bs)
        wcut = cut(whole, "wms")
        adam = {"to_plain": all(torch.equal(a[k], b[k]) for a, b in
                                zip(ks, rs) for k in "wms"),
                "to_whole_leaf": all(torch.equal(a[k], b[k]) for a, b in
                                     zip(ks, wcut) for k in "wms"),
                "max_abs_err": max(_max_abs(a[k], b[k]) for a, b in
                                   zip(ks, rs) for k in "wms")}
        torch.cuda.synchronize()
        lengths = [int(x["w"].numel()) for x in ks]
        row = {"n": n, "rank": rank, "slices": len(lengths),
               "slice_lengths": lengths,
               "not_multiple_of_4": [m for m in lengths if m % 4],
               "misaligned": sum(1 for x in ks
                                 if x["w"].data_ptr() % 16),
               "sgd_launches": sgd_launches, "sgd": sgd,
               "adam_launches": adam_launches, "adam": adam}
        rows.append(row)
        if not (sgd["to_plain"] and sgd["to_whole_leaf"] and
                adam["to_plain"] and adam["to_whole_leaf"]):
            bad.append(f"update kernels at n={n} rank {rank}: {row}")
        if sgd_launches != len(shapes) or adam_launches != 1:
            bad.append(f"update launches at n={n} rank {rank}: {row}")
        del full, ker, ref, whole, ks, rs, wcut
    if not any(r["not_multiple_of_4"] for r in rows):
        bad.append("no shard slice whose length is not a multiple of 4")
    return {"shards": rows, "seconds": time.perf_counter() - t0}, bad


def phase_data_parallel(cpu_started=None) -> dict:
    """Data parallel of the fused step on a one-rank NCCL world (the card
    is one H100, and NCCL refuses two ranks on one device): (c) the update
    kernels at the shard shapes of 2 and 4 ranks; (a) full-width fused
    AlexNet with no group, then joined through ``launcher.multihost`` in
    each layout, each bit-identical to the run with no group, the SGD,
    LRN and collective launches exact, the replays counted, ms a step,
    peak memory and one profiled replay's collective activities; (b)
    MNIST FC AdamW with int8 (error feedback) and bf16 collectives, the
    card against the CPU with a TF32 control, the CPU's runs in a process
    of their own (``cpu_started``, else started first); (d) a collective
    NCCL runs a kernel for
    at one rank, captured on the step's capture stream, its kernel seen
    in a profiled replay.  AlexNet's data set is drawn once for the
    phase.  cuDNN runs deterministic; the group is destroyed at the
    end."""
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    t0 = time.perf_counter()
    out = {"phase": "data_parallel", "cudnn_deterministic": True,
           "config": {"alexnet_train_minibatches": DP_TRAIN_MB,
                      "K": DP_K, "timed_calls": DP_REPS,
                      "fc_steps": DP_FC_STEPS, "fc_lr": DP_FC_LR,
                      "codecs": DP_CODECS, "shards": DP_SHARDS},
           "bands": {"fc_loss_rel": MNIST_PARITY_LOSS_RTOL,
                     "fc_weight_atol": DP_FC_WEIGHT_ATOL}}
    bad, cpu = [], {}

    def cpu_runs():
        if not cpu:
            t1 = time.perf_counter()
            cpu.update(_dp_cpu_results(proc, path))
            out["cpu_wait_s"] = time.perf_counter() - t1
        return cpu

    started = cpu_started or _dp_cpu_start()
    proc, path, _ = started
    made = {}
    try:
        with _dp_data_once(made):
            runs = {"ungrouped": _dp_alexnet_run(None)}
        del runs["ungrouped"]["_step"]
        shapes = [runs["ungrouped"]["leaf_shapes"][i][k]
                  for i, leaf in enumerate(runs["ungrouped"]["leaf_shapes"])
                  for k in ("w", "b") if k in leaf]
        out["update_kernels_at_shards"], b = _dp_update_kernels(shapes)
        bad += b
        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            port = sock.getsockname()[1]
        t1 = time.perf_counter()
        launcher.multihost(f"127.0.0.1:{port}", 1, 0)
        out["join_s"] = time.perf_counter() - t1
        try:
            with _dp_data_once(made):
                for layout in DP_LAYOUTS:
                    runs[layout] = _dp_alexnet_run(layout)
                    step = runs[layout].pop("_step")
            out["nccl_kernel_in_replay"] = d = _dp_nccl_in_replay(step)
            del step
            if not (d["nccl_kernels"] and d["eager_equal"] and
                    d["replay_equal"]):
                bad.append(f"(d) no NCCL kernel in the replay, or a wrong "
                           f"sum: {d}")
            out["mnist_fc_codecs"], b = _dp_fc_codecs(cpu_runs)
            bad += b
        finally:
            torch.distributed.destroy_process_group()
    finally:
        torch.backends.cudnn.deterministic = False
        _dp_cpu_stop(started)
    n_leaves = len(shapes)
    want = runs["ungrouped"]["digests"]
    per_step = {"ungrouped": 0, "replicated": 2,
                "shard_update": 2 + n_leaves, "shard_params": 2 + n_leaves}
    for name, run in runs.items():
        expect = {"lrn_forward": 2 * DP_TRAIN_MB,
                  "lrn_backward": 2 * DP_TRAIN_MB,
                  "sgd_update": n_leaves * DP_TRAIN_MB, "hand_conv": 0,
                  "collectives": per_step[name] * DP_TRAIN_MB}
        run["expect"] = expect
        if run["launches"] != expect:
            bad.append(f"{name}: launches {run['launches']} != {expect}")
        if run["collectives_per_step"] != per_step[name]:
            bad.append(f"{name}: {run['collectives_per_step']} collectives "
                       f"a replayed step, not {per_step[name]}")
        # the first minibatch runs eagerly, the second captures and
        # replays, the third replays
        if run["graph_replays"].get("train") != DP_TRAIN_MB - 1:
            bad.append(f"{name}: replays {run['graph_replays']}")
        # a one-rank NCCL sum is no operation, a one-rank all-gather one
        # device copy: a replay copies what the run with no group's does,
        # plus a gather a leaf (shard_params) or a gather and the copy
        # into the weights a leaf (shard_update)
        extra = run["replay_profile"]["copies"] - \
            runs["ungrouped"]["replay_profile"]["copies"]
        want_extra = {"ungrouped": 0, "replicated": 0,
                      "shard_update": 2 * n_leaves,
                      "shard_params": n_leaves}[name]
        run["replay_copies_over_ungrouped"] = extra
        if extra != want_extra:
            bad.append(f"{name}: a replay made {extra} device copies more "
                       f"than the run with no group, not {want_extra}")
        digests = run.pop("digests")
        run["identical_to_ungrouped"] = digests == want and \
            run["history"] == runs["ungrouped"]["history"]
        if not run["identical_to_ungrouped"]:
            diff = sorted(k for k in want if digests.get(k) != want[k])
            bad.append(f"{name}: differs from the run with no group in "
                       f"{diff}")
    out["alexnet"] = runs
    out["seconds"] = time.perf_counter() - t0
    if bad:
        fail(f"data_parallel: {bad}: {out}")
    return out


#: lm_axes (a): the ring's composition at the training step's attention
#: (b·h 64: batch 8, 8 heads; t 2048; dh 64; bf16), the sequence split
#: over n of LM_RING_NS ranks that the one card plays one after another
LM_RING_NS = (2, 4)
#: ring against one whole-sequence flash launch, as the largest norm-
#: relative error of any 64-row tile (tile_rel_err), fixed before the
#: first run.  Each ring block's o is rounded to bf16 before the f32
#: lse merge and each block's dq, dk, dv partial is a bf16 kernel output
#: summed in bf16, where the whole sequence normalises and sums once:
#: a few bf16 roundings (2^-9 relative each) a value, as FLASH_TOL's
#: bf16 kernel-vs-plain band allows.  A rank that merges a future block
#: (the control) moves its rows' outputs by order 1
LM_RING_TOL = {"o": 1e-2, "dq": 1e-2, "dk": 1e-2, "dv": 1e-2}
#: lm_axes (b): the layouts of the one-rank NCCL world, three steps each
#: (eager, captured and replayed, replayed) from the seeded initial
#: weights, then LM_AXES_TIMED timed replays
LM_AXES_LAYOUTS = {"replicated": {}, "head_sharded": {"head_sharded": True},
                   "shard_update": {"shard_update": True},
                   "shard_params": {"shard_params": True}}
LM_AXES_STEPS, LM_AXES_TIMED = 3, 5
#: the int8 codec at one rank quantizes each gradient chunk to 255
#: levels (~0.4 % of its absmax) before the update: the first loss is
#: the forward at the initial weights (bit-identical), the next two
#: move by the update's quantization, a few 1e-5 of losses near 10 at
#: lr 1e-3; the band, fixed before the first run, is rtol 1e-3
LM_INT8_RTOL = 1e-3


class SeqStandIn:
    """The ring's seq axis for rank ``index`` of ``size`` played on one
    device over the WHOLE folded K and V ``(b·h, t, dh)``: the s-th
    rotation hands over block ``(index - s - 1) mod size`` as slices of
    the whole tensors, so autograd carries each block's gradient back
    to them (``parallel/ring_attention.py ring_blocks``' stand-in
    contract)."""

    def __init__(self, kf, vf, index: int, size: int) -> None:
        self.kf, self.vf, self.index, self.size = kf, vf, index, size
        self.rotations = 0

    def ppermute(self, _tensors):
        self.rotations += 1
        j = (self.index - self.rotations) % self.size
        t_l = self.kf.shape[1] // self.size
        return [x[:, j * t_l:(j + 1) * t_l].contiguous()
                for x in (self.kf, self.vf)]


def ring_composition_run(q, k, v, do, n: int, causal: bool):
    """Every rank of an n-rank ring through ``ring_flash_attention`` with
    :class:`SeqStandIn` axes, one after another, then one backward of
    ``(o · do).sum()`` -> (o, dq, dk, dv) over the whole ``(b, t, h,
    dh)`` tensors."""
    from znicz_tpu_torch.parallel import ring_attention as ring

    q, k, v = (x.detach().requires_grad_(True) for x in (q, k, v))
    b, t, h, dh = q.shape
    t_l = t // n
    kf, vf = (x.transpose(1, 2).reshape(b * h, t, dh) for x in (k, v))
    outs = [ring.ring_flash_attention(
        q[:, r * t_l:(r + 1) * t_l], k[:, r * t_l:(r + 1) * t_l],
        v[:, r * t_l:(r + 1) * t_l], SeqStandIn(kf, vf, r, n), causal)
        for r in range(n)]
    o = torch.cat(outs, 1)
    return (o.detach(),) + torch.autograd.grad(o, (q, k, v), do)


def whole_run(q, k, v, do, causal: bool):
    """One whole-sequence flash_attention forward and backward."""
    q, k, v = (x.detach().requires_grad_(True) for x in (q, k, v))
    o = kflash.flash_attention(q, k, v, causal)
    return (o.detach(),) + torch.autograd.grad(o, (q, k, v), do)


@contextlib.contextmanager
def future_block_merged():
    """The control: rank 0 merges block 1, a future block under causal
    masking, unmasked."""
    from znicz_tpu_torch.parallel import ring_attention as ring

    rule = ring.ring_block
    ring.ring_block = lambda me, blk, causal: \
        "full" if (me, blk) == (0, 1) else rule(me, blk, causal)
    try:
        yield
    finally:
        ring.ring_block = rule


def ring_composition(device, b, h, t, dh, dtype, ns=LM_RING_NS,
                     seed=SEED, timed=False) -> tuple:
    """(a): the ring composition against the whole-sequence flash kernel
    at (b, t, h, dh) for each n of ``ns``, causal and not: each output's
    tile error against LM_RING_TOL, the flash launches of the ring's
    forward and backward (counted on CUDA tensors: Σ(r+1) under causal,
    n² without), and the control (causal, n = ns[0]: rank 0 merging a
    future block) which the band must reject; ``timed`` adds ms of the
    ring's forward and backward over all ranks beside the whole
    kernel's.  Runs on CPU tensors too (the plain versions, no launch
    counts).  -> (report, failures)"""
    gen = torch.Generator(device="cpu").manual_seed(seed)
    q, k, v, do = (torch.randn((b, t, h, dh), generator=gen).to(
        device=device, dtype=dtype) for _ in range(4))
    rows, bad = [], []
    for causal in (True, False):
        want = whole_run(q, k, v, do, causal)
        for n in ns:
            kflash.fwd_launches = kflash.bwd_launches = 0
            got = ring_composition_run(q, k, v, do, n, causal)
            launches = (kflash.fwd_launches, kflash.bwd_launches)
            row = {"n": n, "causal": causal,
                   "err": {name: tile_rel_err(
                       g.transpose(1, 2).reshape(b * h, t, dh),
                       w.transpose(1, 2).reshape(b * h, t, dh))
                       for name, g, w in zip(("o", "dq", "dk", "dv"), got,
                                             want)}}
            expect = n * (n + 1) // 2 if causal else n * n
            if torch.device(device).type == "cuda":
                row["launches"] = {"fwd": launches[0], "bwd": launches[1],
                                   "expect": expect}
                if launches != (expect, expect):
                    bad.append(f"ring n={n} causal={causal}: launches "
                               f"{launches}, not {expect} each")
            bad += [f"ring n={n} causal={causal}: {name} tile error {e}"
                    for name, e in row["err"].items()
                    if not e <= LM_RING_TOL[name]]
            if timed:
                row["ms"] = time_cuda_ms(
                    lambda: ring_composition_run(q, k, v, do, n, causal),
                    iters=5, warmup=1)
                row["whole_ms"] = time_cuda_ms(
                    lambda: whole_run(q, k, v, do, causal), iters=5,
                    warmup=1)
            rows.append(row)
    with future_block_merged():
        ctl = ring_composition_run(q, k, v, do, ns[0], True)
    want = whole_run(q, k, v, do, True)
    control = {"n": ns[0], "o_err": tile_rel_err(
        ctl[0].transpose(1, 2).reshape(b * h, t, dh),
        want[0].transpose(1, 2).reshape(b * h, t, dh))}
    control["rejected"] = not control["o_err"] <= LM_RING_TOL["o"]
    if not control["rejected"]:
        bad.append(f"the band passes the future-block control: {control}")
    return {"shape": {"b": b, "h": h, "t": t, "dh": dh,
                      "dtype": str(dtype)},
            "band": LM_RING_TOL, "rows": rows, "control": control}, bad


def _global_digests(params) -> dict:
    """sha256 of every leaf's bytes of a global numpy pytree (the LM's, or
    a flat dict of leaves)."""
    import hashlib

    flat = dict(params)
    for i, blk in enumerate(flat.pop("blocks", ())):
        flat.update({f"blocks.{i}.{k}": a for k, a in blk.items()})
    return {k: hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()
            for k, a in flat.items()}


def _lm_axes_run(mesh, params, tokens, labels, profile_replay=False,
                 **options) -> dict:
    """(b) for one layout: the full-width step (phase train's) on
    ``mesh`` (None: no group) from ``params``: LM_AXES_STEPS steps with
    the flash and collective counters set to 0 just before and read
    just after, the gathered params' digests, the collectives of one
    more (replayed) step, LM_AXES_TIMED timed replays, the peak memory
    and, with ``profile_replay``, one replay's NCCL and copy
    activities."""
    from znicz_tpu_torch.parallel import transformer as tfm

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    mem_start = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    step = make_train_step(mesh, N_LAYERS, D, HEADS, FF, VOCAB,
                           lr=TRAIN_LR, loss_chunks=TRAIN_CHUNKS,
                           device=DEVICE, **options)
    specs = tfm.param_specs(N_LAYERS, options.get("head_sharded", False))
    host = tfm.shard_params_host(params, specs, 1) \
        if options.get("shard_params") else params
    ps = params_from_numpy(host, DEVICE, mesh=mesh, specs=step.specs)
    kflash.fwd_launches = kflash.bwd_launches = 0
    tmesh.collective_launches = 0
    losses = [step(ps, tokens, labels)[1] for _ in range(LM_AXES_STEPS)]
    torch.cuda.synchronize()
    out = {"losses": [float(x) for x in losses],
           "flash_launches": {"fwd": kflash.fwd_launches,
                              "bwd": kflash.bwd_launches},
           "collectives": tmesh.collective_launches}
    got = tfm.params_to_numpy(ps, mesh, step.specs if mesh else None)
    if options.get("shard_params"):
        got = tfm.unshard_params_host(got, specs, param_shapes(
            N_LAYERS, D, FF, VOCAB))
    out["digests"] = _global_digests(got)
    del got
    before = tmesh.collective_launches
    step(ps, tokens, labels)
    torch.cuda.synchronize()
    out["collectives_per_step"] = tmesh.collective_launches - before
    events = []
    for _ in range(LM_AXES_TIMED):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        step(ps, tokens, labels)
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    out["ms_per_step"] = [s.elapsed_time(e) for s, e in events]
    out["step_ms"] = float(np.median(out["ms_per_step"]))
    # the run's own peak: from the step's build through the timed steps
    out["peak_mem_bytes"] = torch.cuda.max_memory_allocated() - mem_start
    out["replays"] = sum(g.replays for g in step.graphs.values() if g)
    if profile_replay:
        acts = None
        for _ in range(3):
            acts = profiled_after_mark(lambda: step(ps, tokens, labels), 1)
            if acts:
                break
        names = {}
        for name, _us in acts or ():
            if re.search("nccl|memcpy", name, re.I):
                names[name[:80]] = names.get(name[:80], 0) + 1
        out["replay_profile"] = {
            "activities": len(acts or ()), "nccl_or_memcpy": names,
            "nccl_kernels": {k: v for k, v in names.items()
                             if DP_NCCL_KERNEL.search(k)}}
    del step, ps
    return out


def phase_lm_axes() -> dict:
    """The transformer's (data, seq, model) mesh on the one card: (a)
    the ring's composition at the training step's attention against the
    whole-sequence kernel (LM_RING_NS ranks played one after another,
    a control, exact launch counts, ms); (b) phase train's full-width
    step joined to a one-rank NCCL world (``launcher.multihost``)
    through ``make_mesh({"data": 1, "seq": 1, "model": 1})`` in each
    layout — replicated and head_sharded bit-identical to the step with
    no group and the same options, shard_update and shard_params
    bit-identical to the grouped replicated step — then the int8 codec
    within LM_INT8_RTOL of the replicated losses; collectives a step,
    replays, flash launches, ms a step and peak memory each, one
    replay's NCCL activities.  The group is destroyed at the end."""
    t0 = time.perf_counter()
    out = {"phase": "lm_axes"}
    out["ring"], bad = ring_composition(DEVICE, TRAIN_B, HEADS, TRAIN_T,
                                        D // HEADS, torch.bfloat16,
                                        timed=True)
    out["ring"]["seconds"] = time.perf_counter() - t0
    t1 = time.perf_counter()
    params = init_params(np.random.default_rng(SEED), N_LAYERS, D, HEADS, FF,
                         VOCAB)
    tokens, labels = _train_batch(SEED, TRAIN_B, TRAIN_T)
    runs = {"ungrouped": _lm_axes_run(None, params, tokens, labels),
            "ungrouped_head_sharded": _lm_axes_run(
                None, params, tokens, labels, head_sharded=True)}
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    launcher.multihost(f"127.0.0.1:{port}", 1, 0)
    try:
        mesh = tmesh.make_mesh({"data": 1, "seq": 1, "model": 1})
        out["mesh"] = {"repr": repr(mesh), "backend": mesh.backend}
        for name, opts in LM_AXES_LAYOUTS.items():
            runs[name] = _lm_axes_run(mesh, params, tokens, labels,
                                      profile_replay=name == "replicated",
                                      **opts)
        runs["int8"] = _lm_axes_run(
            mesh, params, tokens, labels,
            quantized_collectives={"mode": "int8"})
    finally:
        torch.distributed.destroy_process_group()
    same = {"replicated": "ungrouped",
            "head_sharded": "ungrouped_head_sharded",
            "shard_update": "replicated", "shard_params": "replicated"}
    for name, ref in same.items():
        ok = runs[name]["digests"] == runs[ref]["digests"] and \
            runs[name]["losses"] == runs[ref]["losses"]
        runs[name]["identical_to"] = {ref: ok}
        if not ok:
            bad.append(f"{name} differs from {ref}")
    rel = [abs(a - b) / abs(b) for a, b in
           zip(runs["int8"]["losses"], runs["replicated"]["losses"])]
    runs["int8"]["loss_rel_to_replicated"] = rel
    if not (max(rel) <= LM_INT8_RTOL and
            runs["int8"]["losses"][0] == runs["replicated"]["losses"][0]):
        bad.append(f"int8 losses {runs['int8']['losses']} against "
                   f"{runs['replicated']['losses']}")
    for name, run in runs.items():
        if run["flash_launches"] != {"fwd": LM_AXES_STEPS * N_LAYERS,
                                     "bwd": LM_AXES_STEPS * N_LAYERS}:
            bad.append(f"{name}: flash launches {run['flash_launches']}")
        # the first step runs eagerly, the second captures and replays:
        # every later step (the collectives' one, the timed) replays
        if run["replays"] != LM_AXES_STEPS + LM_AXES_TIMED:
            bad.append(f"{name}: {run['replays']} replays")
        if not all(np.isfinite(run["losses"])):
            bad.append(f"{name}: non-finite losses {run['losses']}")
        run.pop("digests")
    grouped = [n for n in runs if not n.startswith("ungrouped")]
    if any(runs[n]["collectives_per_step"] == 0 for n in grouped):
        bad.append("a grouped step made no collective")
    out["lm_step"] = runs
    out["lm_step_seconds"] = time.perf_counter() - t1
    out["seconds"] = time.perf_counter() - t0
    if bad:
        fail(f"lm_axes: {bad}: {out}")
    return out


#: pipe_expert: the char LM's MoE block widths (models/char_lm.py: d 512,
#: ff 2048, 4 experts), PE_MICRO microbatches of PE_ROWS rows from SEED
PE_EXPERTS, PE_MICRO, PE_ROWS = 4, 8, 1024
#: (a) the GPipe schedule at S of PE_STAGES stages played in turn
PE_STAGES = (2, 4)
#: (b) the pipeline step: steps a run, and its target ys = xs / 2 (the
#: reference's bf16 test's) at lr 2.0, which the CPU run of these widths
#: (256 rows) took to 0.71x its first loss in 20 steps; bf16 against f32
#: over the first PE_BF16_STEPS losses, the reference's band
#: (tests/test_transformer_spmd.py:191); the loss must fall below
#: PE_LEARN x its first
PE_STEPS, PE_LR, PE_BF16_STEPS, PE_BF16_RTOL, PE_LEARN = 20, 2.0, 5, 5e-2, \
    0.8
#: (c) moe_ffn_dispatch: tokens, and the band against moe_ffn in f32
#: (TF32 off) as the largest error over the largest magnitude of the
#: reference, values and each gradient: the same products summed in
#: another order (buckets against all tokens), a few f32 ulps
PE_TOKENS, PE_DISPATCH_BAND = 16384, 1e-5
#: (d) the LM train cell resumed from a checkpoint: steps before the save
#: and after the restore
PE_CKPT_STEPS = 2


class StageStandIn:
    """The ``pipe`` axis for stage ``index`` of ``size`` played on one
    device after the stage before it (``prev``): each tick's rotation
    records what this stage sends and hands over what ``prev`` sent
    ``lag`` ticks before (1: the same tick, the schedule's rule; 2: the
    control, a stage fed one tick late)."""

    def __init__(self, index: int, size: int, prev=None, lag: int = 1):
        self.index, self.size, self.prev, self.lag = index, size, prev, lag
        self.sent = []

    def ppermute(self, tensors, shift=1):
        self.sent.append(tensors[0])
        t = len(self.sent) - self.lag
        if self.prev is None or t < 0:
            return [torch.zeros_like(tensors[0])]
        return [self.prev.sent[t]]


def gpipe_played(stage_fn, stages, xs, lags=None):
    """Every stage of a pipeline through ``parallel/pipeline.py
    pipeline_ticks`` with :class:`StageStandIn` axes, stage 0 first, the
    stages' emissions summed (the ``psum``) -> ``(outputs, stage
    applications)``."""
    from znicz_tpu_torch.parallel.pipeline import pipeline_ticks

    n = len(stages)
    lags = lags or [1] * n
    calls = [0]

    def counted(p, x):
        calls[0] += 1
        return stage_fn(p, x)
    prev, out = None, None
    for s, p in enumerate(stages):
        prev = StageStandIn(s, n, prev, lags[s])
        emitted = pipeline_ticks(counted, p, xs, prev)
        out = emitted if out is None else out + emitted
    return out, calls[0]


def gpipe_sequential(stage_fn, stages, xs):
    """Each microbatch through the stages one after another."""
    outs = []
    for x in xs:
        for p in stages:
            x = stage_fn(p, x)
        outs.append(x)
    return torch.stack(outs)


def _pe_schedule(tfm) -> tuple:
    """(a): the schedule at each S of PE_STAGES in f32 and bf16 against
    the stages applied one after another, bit for bit; the control (the
    last stage fed one tick late) must differ.  -> (report, failures)"""
    rng = np.random.default_rng(SEED)
    xs32 = torch.tensor(rng.normal(size=(PE_MICRO, PE_ROWS, D)).astype(
        np.float32), device=DEVICE)
    rows, bad = [], []
    for n in PE_STAGES:
        host = tfm.init_moe_pipeline_params(rng, n, D, FF, PE_EXPERTS)
        for dtype in (torch.float32, torch.bfloat16):
            stages = [{k: torch.tensor(v[s:s + 1], device=DEVICE,
                                       dtype=dtype) for k, v in host.items()}
                      for s in range(n)]
            xs = xs32.to(dtype)
            with torch.no_grad():
                got, calls = gpipe_played(tfm.moe_stage, stages, xs)
                want = gpipe_sequential(tfm.moe_stage, stages, xs)
                row = {"stages": n, "dtype": str(dtype),
                       "ticks": PE_MICRO + n - 1, "stage_calls": calls,
                       "sequential_calls": n * PE_MICRO,
                       "identical": torch.equal(got, want),
                       "finite": bool(torch.isfinite(got).all())}
                row["ms"] = time_cuda_ms(
                    lambda: gpipe_played(tfm.moe_stage, stages, xs),
                    iters=3, warmup=1)
                row["sequential_ms"] = time_cuda_ms(
                    lambda: gpipe_sequential(tfm.moe_stage, stages, xs),
                    iters=3, warmup=1)
                if n == PE_STAGES[0]:
                    ctl, _ = gpipe_played(tfm.moe_stage, stages, xs,
                                          lags=[1] * (n - 1) + [2])
                    row["control_max_abs"] = float(
                        (ctl.float() - want.float()).abs().max())
                    row["control_rejected"] = not torch.equal(ctl, want)
                    if not row["control_rejected"]:
                        bad.append(f"(a) the late-fed control passes: {row}")
            if not (row["identical"] and row["finite"] and
                    calls == n * (PE_MICRO + n - 1)):
                bad.append(f"(a) schedule: {row}")
            rows.append(row)
            del stages
    return {"rows": rows}, bad


def _pe_step_run(tfm, mesh, host, xs, ys, dtype) -> dict:
    """(b) one run: PE_STEPS steps of the pipeline step on ``mesh`` (None:
    no group) in ``dtype`` from ``host``, the collective counter set to
    0 just before and read just after; ms of each step (a replay from
    the second), peak memory, replays and the params' digests."""
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    mem_start = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    step = tfm.make_pipeline_step(mesh, PE_EXPERTS, lr=PE_LR,
                                  compute_dtype=dtype, device=DEVICE)
    ps = params_from_numpy(host, DEVICE, mesh=mesh, specs=step.specs)
    tmesh.collective_launches = 0
    losses, events = [], []
    for _ in range(PE_STEPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        losses.append(step(ps, xs, ys)[1])
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    out = {"losses": [float(x) for x in losses],
           "collectives_per_step": tmesh.collective_launches / PE_STEPS,
           "replays": sum(g.replays for g in step.graphs.values() if g),
           "ms_per_step": [s.elapsed_time(e) for s, e in events][2:],
           "peak_mem_bytes": torch.cuda.max_memory_allocated() - mem_start,
           "params_f32": all(w.dtype == torch.float32 for w in ps.values())}
    out["step_ms"] = float(np.median(out["ms_per_step"]))
    out["digests"] = _global_digests(params_to_numpy(ps, mesh, step.specs))
    del step, ps
    return out


def _pe_step(tfm, mesh) -> tuple:
    """(b): the step with no group and on the one-rank world in f32 (bit
    for bit), on the world in bf16 (the losses within PE_BF16_RTOL of
    f32's, the params f32); the f32 loss falls below PE_LEARN x its
    first.  -> (report, failures)"""
    rng = np.random.default_rng(SEED + 1)
    host = tfm.init_moe_pipeline_params(rng, 1, D, FF, PE_EXPERTS)
    xs = torch.tensor(rng.normal(size=(PE_MICRO, PE_ROWS, D)).astype(
        np.float32), device=DEVICE)
    ys = 0.5 * xs
    runs = {"ungrouped": _pe_step_run(tfm, None, host, xs, ys,
                                      torch.float32),
            "grouped": _pe_step_run(tfm, mesh, host, xs, ys, torch.float32),
            "grouped_bf16": _pe_step_run(tfm, mesh, host, xs, ys, None)}
    bad = []
    f32, bf16 = runs["grouped"], runs["grouped_bf16"]
    runs["grouped"]["identical_to_ungrouped"] = same = \
        f32["digests"] == runs["ungrouped"]["digests"] and \
        f32["losses"] == runs["ungrouped"]["losses"]
    rel = [abs(a - b) / abs(b) for a, b in
           zip(bf16["losses"][:PE_BF16_STEPS], f32["losses"])]
    bf16["loss_rel_to_f32"] = rel
    if not same:
        bad.append("(b) the grouped step differs from the step with no group")
    if not (max(rel) <= PE_BF16_RTOL and bf16["params_f32"]):
        bad.append(f"(b) bf16 losses {bf16['losses']} against f32's")
    if not f32["losses"][-1] < PE_LEARN * f32["losses"][0]:
        bad.append(f"(b) the loss does not fall: {f32['losses']}")
    for name, run in runs.items():
        run.pop("digests")
        if run["replays"] != PE_STEPS - 1 or \
                not all(np.isfinite(run["losses"])):
            bad.append(f"(b) {name}: {run['replays']} replays, losses "
                       f"{run['losses']}")
    if runs["ungrouped"]["collectives_per_step"] != 0 or \
            f32["collectives_per_step"] == 0:
        bad.append("(b) the collectives a step")
    return runs, bad


def _rel_err(got, want) -> float:
    return float((got.double() - want.double()).abs().max() /
                 want.double().abs().max())


@contextlib.contextmanager
def slot_misrouted(tmoe):
    """The control: the first (token, choice) pair's slot moved to the
    next expert's bucket (its last slot, empty at lossless capacity)."""
    slots = tmoe.bucket_slots

    def wrong(choice, n_experts, capacity):
        slot, keep = slots(choice, n_experts, capacity)
        e = (choice.reshape(-1)[0] + 1) % n_experts
        slot = slot.clone()
        slot[0] = e * capacity + capacity - 1
        return slot, keep
    tmoe.bucket_slots = wrong
    try:
        yield
    finally:
        tmoe.bucket_slots = slots


def _host_drops(choice: np.ndarray, n_experts: int, capacity: int) -> int:
    """The (token, choice) pairs past their expert's capacity, counted
    on the host in token-major order."""
    seen = [0] * n_experts
    dropped = 0
    for e in choice.reshape(-1):
        dropped += seen[e] >= capacity
        seen[e] += 1
    return int(dropped)


def _pe_dispatch(tfm, mesh) -> tuple:
    """(c): moe_ffn_dispatch over the one-rank world's expert line
    (NCCL's all-to-all) at PE_TOKENS tokens, top-1 and top-2: at the
    lossless capacity E / top_k its values and gradients against
    moe_ffn within PE_DISPATCH_BAND, a misrouted slot rejected; at
    capacity 1.0 its dropped pairs against the host's count and its
    values against the plain version with those drops; one call
    captured in a CUDA graph (:func:`_pe_dispatch_graph`).  -> (report,
    failures)"""
    from znicz_tpu_torch.parallel import moe as tmoe

    expert = mesh.axis("expert")
    rng = np.random.default_rng(SEED + 2)
    host = tfm.init_moe_pipeline_params(rng, 1, D, FF, PE_EXPERTS)
    w = {k: torch.tensor(v[0], device=DEVICE) for k, v in host.items()}
    x = torch.tensor(rng.normal(size=(PE_TOKENS, D)).astype(np.float32),
                     device=DEVICE)
    wsum = torch.tensor(rng.normal(size=(PE_TOKENS, D)).astype(np.float32),
                        device=DEVICE)
    names = ("x", "gate", "w1", "b1", "w2", "b2")
    gelu = tfm._GELU

    def run(fn, **kw):
        args = [t.detach().clone().requires_grad_(True) for t in
                (x, w["gate"], w["w1"], w["b1"], w["w2"], w["b2"])]
        y, _ = fn(*args, gelu, **kw)
        return [y.detach()] + [g for g in torch.autograd.grad(
            (y * wsum).sum(), args)]

    out, bad = {}, []
    for k in (1, 2):
        lossless = PE_EXPERTS / k
        want = run(tmoe.moe_ffn, axis=None, top_k=k)
        tmesh.collective_launches = 0
        got = run(tmoe.moe_ffn_dispatch, axis=expert,
                  capacity_factor=lossless, top_k=k)
        row = {"top_k": k, "capacity_factor": lossless,
               "collectives": tmesh.collective_launches,
               "err": dict(zip(("y",) + names,
                               (_rel_err(g, r) for g, r in zip(got, want))))}
        with torch.no_grad(), slot_misrouted(tmoe):
            ctl, _ = tmoe.moe_ffn_dispatch(
                x, w["gate"], w["w1"], w["b1"], w["w2"], w["b2"], gelu,
                expert, capacity_factor=lossless, top_k=k)
        row["control_err"] = _rel_err(ctl, want[0])
        if any(e > PE_DISPATCH_BAND for e in row["err"].values()) or \
                row["control_err"] <= PE_DISPATCH_BAND or \
                row["collectives"] != 4:
            bad.append(f"(c) lossless top-{k}: {row}")
        # capacity 1.0: drops, counted on the host and held against the
        # plain version with them
        with torch.no_grad():
            y, _ = tmoe.moe_ffn_dispatch(
                x, w["gate"], w["w1"], w["b1"], w["w2"], w["b2"], gelu,
                expert, capacity_factor=1.0, top_k=k)
            scores = x @ w["gate"]
            choice = torch.topk(scores, k, dim=-1).indices
            cap = int(np.ceil(1.0 * PE_TOKENS * k / PE_EXPERTS))
            _slot, keep = tmoe.bucket_slots(choice, PE_EXPERTS, cap)
            probs = torch.softmax(scores, -1).gather(1, choice)
            if k > 1:
                probs = probs / probs.sum(-1, keepdim=True)
            h = gelu(torch.einsum("td,edf->etf", x, w["w1"]) +
                     w["b1"][:, None])
            y_e = torch.einsum("etf,efd->etd", h, w["w2"]) + w["b2"][:, None]
            plain = sum(keep.view(-1, k)[:, j, None] * probs[:, j, None] *
                        y_e[choice[:, j], torch.arange(PE_TOKENS)]
                        for j in range(k))
        row["capacity_1"] = {
            "capacity": cap, "dropped": int((~keep).sum()),
            "host_dropped": _host_drops(choice.cpu().numpy(), PE_EXPERTS,
                                        cap),
            "err": _rel_err(y, plain)}
        c1 = row["capacity_1"]
        if c1["dropped"] != c1["host_dropped"] or c1["dropped"] == 0 or \
                c1["err"] > PE_DISPATCH_BAND:
            bad.append(f"(c) capacity 1.0 top-{k}: {c1}")
        out[f"top{k}"] = row
        del want, got
    out["graph"], b = _pe_dispatch_graph(tmoe, expert, x, w, gelu)
    bad += b
    return out, bad


def _replay_counts(fn) -> collections.Counter:
    """The device activities of one call of ``fn`` (a graph replay), by
    name, from a profiled window."""
    acts = None
    for _ in range(3):
        acts = profiled_after_mark(fn, 1)
        if acts:
            break
    if not acts:
        fail("pipe_expert: three profiled windows lost their mark")
    return collections.Counter(name[:80] for name, _us in acts)


def _pe_dispatch_graph(tmoe, expert, x, w, gelu) -> tuple:
    """(c)'s capture: one top-2 dispatch at lossless capacity through
    ``run_graphed`` (eager, captured and replayed, replayed), its
    replays against the eager call and its collectives counted; then
    the replay's device activities beside those of the same body with no
    expert axis (no all-to-all): two more, one for each of NCCL's
    exchanges, as many as two replays of one bare captured
    ``expert.all_to_all`` of its buckets run (less its copy out).  ->
    (report, failures)"""
    from znicz_tpu_torch.parallel.graphs import run_graphed

    dev = torch.device(DEVICE)
    cap = int(np.ceil(2.0 * PE_TOKENS * 2 / PE_EXPERTS))

    def graphed(axis):
        graphs, stream = {}, torch.cuda.Stream()

        def body(xb):
            return tmoe.moe_ffn_dispatch(
                xb, w["gate"], w["w1"], w["b1"], w["w2"], w["b2"], gelu,
                axis, capacity_factor=PE_EXPERTS / 2, top_k=2)[0]

        def call():
            return run_graphed(graphs, "dispatch", "dispatch", body, (x,),
                               dev, stream)
        return call, graphs
    with torch.no_grad():
        call, graphs = graphed(expert)
        eager = call().clone()
        tmesh.collective_launches = 0
        replays = [call().clone() for _ in range(2)]
        torch.cuda.synchronize()
        collectives = tmesh.collective_launches
        with_a2a = _replay_counts(call)
        bare_call, _ = graphed(None)
        for _ in range(2):                  # eager, then captured
            bare_call()
        without = _replay_counts(bare_call)
        buckets = torch.randn(1, PE_EXPERTS, cap, D, device=DEVICE)
        exchanged = torch.empty_like(buckets)
        stream = torch.cuda.Stream()
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream):
            exchanged.copy_(expert.all_to_all(buckets))     # eager, warm
        torch.cuda.current_stream().wait_stream(stream)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=stream):
            exchanged.copy_(expert.all_to_all(buckets))
        copy = torch.cuda.CUDAGraph()
        with torch.cuda.graph(copy, stream=stream):
            exchanged.copy_(buckets)
        a2a = _replay_counts(graph.replay) - _replay_counts(copy.replay)
        torch.cuda.synchronize()
    out = {"replays": graphs["dispatch"].replays,
           "collectives_in_two_calls": collectives,
           "identical_to_eager": all(torch.equal(r, eager) for r in replays),
           "replay_activities": dict(with_a2a),
           "without_all_to_all": dict(without),
           "all_to_all_activities": dict(a2a),
           "bare_exchange_equal": torch.equal(exchanged, buckets)}
    # a captured device copy runs on the copy engine or as an SM copy
    # kernel, so the names may differ between graphs: the counts are
    # held, two exchanges' worth of activities more than without them
    extra = sum(with_a2a.values()) - sum(without.values())
    out["extra_activities"] = extra
    bad = []
    if not (out["identical_to_eager"] and collectives == 4 and a2a and
            extra == 2 * sum(a2a.values()) and out["bare_exchange_equal"]):
        bad.append(f"(c) the captured dispatch: {out}")
    return out, bad


def _pe_lm_run(tfm, mesh, params, tokens, labels, path=None) -> dict:
    """(d) one run of phase train's step on the one-rank mesh from
    ``params``: 2 · PE_CKPT_STEPS steps in the replicated layout, or with
    ``path`` PE_CKPT_STEPS steps, a ``save_pytree`` to ``path``, the step
    rebuilt in the shard_params layout from ``load_pytree`` and
    PE_CKPT_STEPS more; the flash counters set to 0 just before the
    first step and read just after the last."""
    from znicz_tpu_torch.parallel import checkpoint as tckpt

    def make(**opts):
        return make_train_step(mesh, N_LAYERS, D, HEADS, FF, VOCAB,
                               lr=TRAIN_LR, loss_chunks=TRAIN_CHUNKS,
                               device=DEVICE, **opts)
    gc.collect()
    torch.cuda.empty_cache()
    specs = tfm.param_specs(N_LAYERS)
    step = make()
    ps = params_from_numpy(params, DEVICE, mesh=mesh, specs=step.specs)
    kflash.fwd_launches = kflash.bwd_launches = 0
    steps = PE_CKPT_STEPS if path else 2 * PE_CKPT_STEPS
    losses = [step(ps, tokens, labels)[1] for _ in range(steps)]
    out = {}
    if path:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tckpt.save_pytree(path, ps, mesh=mesh, specs=step.specs)
        out["save_s"] = time.perf_counter() - t0
        out["mb_written"] = sum(
            os.path.getsize(os.path.join(path, f))
            for f in os.listdir(path)) / 1e6
        del step
        t0 = time.perf_counter()
        # the live params as the template: their shapes, dtype and device
        restored = tckpt.load_pytree(path, like=ps, mesh=mesh, specs=specs)
        torch.cuda.synchronize()
        out["restore_s"] = time.perf_counter() - t0
        del ps
        step = make(shard_params=True)
        # the shard_params layout: each replicated leaf flat, this data
        # rank's slice of it
        ps = tfm._map(lambda w, s: tzero.pad_slice(
            w, step.mesh.axis("data").index,
            step.mesh.axis("data").size).clone() if s == () else w,
            restored, specs)
        del restored
        losses += [step(ps, tokens, labels)[1] for _ in range(PE_CKPT_STEPS)]
    torch.cuda.synchronize()
    out["losses"] = [float(x) for x in losses]
    out["flash_launches"] = {"fwd": kflash.fwd_launches,
                             "bwd": kflash.bwd_launches}
    got = tfm.params_to_numpy(ps, mesh, step.specs)
    if path:
        got = tfm.unshard_params_host(got, specs, param_shapes(
            N_LAYERS, D, FF, VOCAB))
    out["digests"] = _global_digests(got)
    out["replays"] = sum(g.replays for g in step.graphs.values() if g)
    del step, ps, got
    return out


def _pe_checkpoint(tfm, mesh) -> tuple:
    """(d): phase train's step for 2 · PE_CKPT_STEPS steps uninterrupted,
    then saved after PE_CKPT_STEPS and resumed from the checkpoint in
    the shard_params layout: the losses and the final params bit for
    bit, the flash launches exactly N_LAYERS a step each way.  ->
    (report, failures)"""
    params = init_params(np.random.default_rng(SEED), N_LAYERS, D, HEADS, FF,
                         VOCAB)
    tokens, labels = _train_batch(SEED, TRAIN_B, TRAIN_T)
    with tempfile.TemporaryDirectory() as tmp:
        runs = {"uninterrupted": _pe_lm_run(tfm, mesh, params, tokens,
                                            labels),
                "resumed": _pe_lm_run(tfm, mesh, params, tokens, labels,
                                      os.path.join(tmp, "ckpt"))}
    bad = []
    a, b = runs["uninterrupted"], runs["resumed"]
    b["identical"] = a["losses"] == b["losses"] and \
        a["digests"] == b["digests"]
    if not b["identical"]:
        bad.append(f"(d) resumed {b['losses']} against {a['losses']}")
    for name, run in runs.items():
        n = 2 * PE_CKPT_STEPS * N_LAYERS
        if run["flash_launches"] != {"fwd": n, "bwd": n}:
            bad.append(f"(d) {name}: flash launches {run['flash_launches']}")
        if not all(np.isfinite(run["losses"])):
            bad.append(f"(d) {name}: losses {run['losses']}")
        run.pop("digests")
    return runs, bad


def phase_pipe_expert() -> dict:
    """The pipeline step and the expert axis on the one card: (a) the
    GPipe schedule of ``parallel/pipeline.py`` at the char LM's MoE
    block widths, PE_STAGES stages played in turn (StageStandIn), bit
    for bit the stages applied one after another, in f32 and bf16, a
    late-fed control rejected; then on a one-rank NCCL world
    (``launcher.multihost``, ``make_mesh({"data": 1, "pipe": 1,
    "expert": 1})``): (b) ``make_pipeline_step`` bit for bit the step
    with no group, bf16 within the reference's band of f32, learning;
    (c) ``moe_ffn_dispatch`` against ``moe_ffn`` at PE_TOKENS tokens,
    its drops, and one call captured with NCCL's all-to-all in the
    replay; (d) phase train's step saved through ``parallel/
    checkpoint.py`` and resumed in the shard_params layout, bit for bit
    the uninterrupted run, its flash launches counted.  The group is
    destroyed at the end."""
    from znicz_tpu_torch.parallel import transformer as tfm

    t0 = time.perf_counter()
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {"phase": "pipe_expert", "widths": {
        "d": D, "ff": FF, "experts": PE_EXPERTS, "microbatches": PE_MICRO,
        "rows": PE_ROWS}}
    try:
        out["a_schedule"], bad = _pe_schedule(tfm)
        out["a_seconds"] = time.perf_counter() - t0
        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            port = sock.getsockname()[1]
        launcher.multihost(f"127.0.0.1:{port}", 1, 0)
        try:
            mesh = tmesh.make_mesh({"data": 1, "pipe": 1, "expert": 1})
            out["mesh"] = {"repr": repr(mesh), "backend": mesh.backend}
            for part, fn in (("b_step", _pe_step),
                             ("c_dispatch", _pe_dispatch),
                             ("d_checkpoint", _pe_checkpoint)):
                t1 = time.perf_counter()
                out[part], b = fn(tfm, mesh)
                out[f"{part[0]}_seconds"] = time.perf_counter() - t1
                bad += b
        finally:
            torch.distributed.destroy_process_group()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    out["seconds"] = time.perf_counter() - t0
    if bad:
        fail(f"pipe_expert: {bad}: {out}")
    return out


#: serve_forward: AlexNet at its own configuration (models/alexnet.py:
#: 227 px, 1000 classes), initialized from the seed on the card, exported
#: once and served with buckets up to SF_MAX_BATCH (1, 2, 4, 8)
SF_MAX_BATCH = 8
#: the HTTP load: SF_CLIENTS concurrent clients of SF_REQUESTS requests
#: each, of 1 or 2 images (a 227-px image is ~3 MB of JSON)
SF_CLIENTS, SF_REQUESTS = 4, 2
#: card vs CPU on served rows, norm-relative on the centred
#: log-probabilities (the logits up to a constant a row): the card
#: computes in eval's type, bf16 (~3 significant digits through eight
#: layers), the CPU in f32.  The band must reject the control, the CPU's
#: forward with both LRN layers skipped (what a card path that lost its
#: lrn_forward launches would return)
SF_BAND = 5e-2
#: ExportedForward against the native runtime, both f32 on the host
SF_NATIVE_ATOL = 1e-5
#: MNIST FC's default widths (models/mnist_fc.py: 784-64-10) as a
#: StandardWorkflow: the sample's own build functions assemble units without
#: layer specs, which export_forward needs (in both packages)
SF_FC_LAYERS = [{"type": "all2all_tanh", "->": {"output_sample_shape": 64}},
                {"type": "softmax", "->": {"output_sample_shape": 10}}]
SF_CLI_TIMEOUT = 300


def _centred_logp(p) -> np.ndarray:
    lp = np.log(np.maximum(np.asarray(p, np.float64), 1e-30))
    return lp - lp.mean(axis=1, keepdims=True)


def _sf_rel(got, want) -> float:
    """Norm-relative error of ``got``'s centred log-probabilities
    against ``want``'s."""
    a, b = _centred_logp(got), _centred_logp(want)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _post_json(url: str, doc: dict, timeout: float = 120) -> dict:
    req = urllib.request.Request(
        url, data=json.dumps(doc).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read())


def _sf_http(engine, backend, shape, rng) -> tuple:
    """SF_CLIENTS concurrent clients POST /predict to a ServeServer over
    the warmed engine -> (report, the requests, their answers): every
    answer arrives, nothing is captured, and the lrn_forward launches are
    two a replayed batch."""
    from znicz_tpu_torch.serve.server import ServeServer

    server = ServeServer(engine, warmup=False, max_wait_ms=2.0)
    port = server.start()
    reqs = [rng.normal(size=(1 + i % 2,) + shape).astype(np.float32)
            for i in range(SF_CLIENTS * SF_REQUESTS)]
    answers, errors = {}, []
    runs0, compiles0 = engine.run_count, engine.compile_count
    captures0 = backend.captures
    klrn.fwd_launches = 0

    def client(c):
        try:
            for j in range(SF_REQUESTS):
                i = c * SF_REQUESTS + j
                doc = _post_json(f"http://127.0.0.1:{port}/predict",
                                 {"input": reqs[i].tolist()})
                answers[i] = np.asarray(doc["output"], np.float32)
        except Exception as exc:  # noqa: BLE001 — failed below
            errors.append(repr(exc))

    t0 = time.perf_counter()
    threads = [threading.Thread(target=client, args=(c,))
               for c in range(SF_CLIENTS)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(300)
    wall = time.perf_counter() - t0
    snap = server.metrics_snapshot()
    server.stop()
    runs = engine.run_count - runs0
    report = {"requests": len(reqs), "rows": sum(len(r) for r in reqs),
              "wall_s": wall, "batches": runs,
              "batch_size_histogram": snap["serving"][
                  "batch_size_histogram"],
              "latency_ms": {k: snap["serving"]["latency"][k]
                             for k in ("p50_ms", "p95_ms", "mean_ms")},
              "captures_after_warmup": backend.captures - captures0,
              "compiles_after_warmup": engine.compile_count - compiles0,
              "lrn_forward_launches": klrn.fwd_launches,
              "errors": errors}
    bad = []
    if errors or len(answers) != len(reqs) or \
            snap["serving"]["completed"] != len(reqs):
        bad.append(f"HTTP: {report}")
    if report["captures_after_warmup"] or report["compiles_after_warmup"]:
        bad.append(f"HTTP serving captured after warmup: {report}")
    if klrn.fwd_launches != 2 * runs:
        bad.append(f"HTTP: {klrn.fwd_launches} lrn_forward launches in "
                   f"{runs} replayed batches, not {2 * runs}")
    return report, reqs, answers, bad


def _sf_mnist_fc(tmp, cpu_ok) -> tuple:
    """MNIST FC's default widths exported from the card and served by
    ``python -m znicz_tpu_torch serve --smoke-test`` on cuda (its own
    process) and with ``--native`` (this process), the native runtime
    held against the torch forward."""
    from znicz_tpu_torch.__main__ import main as cli_main
    from znicz_tpu_torch.native import infer as tinfer
    from znicz_tpu_torch.utils.export import ExportedForward, export_forward

    tprng.seed_all(SEED)
    w = StandardWorkflow(
        name="MnistFC", loss_function="softmax", layers=SF_FC_LAYERS,
        loader_name="synthetic_classifier",
        loader_config={"n_classes": 10, "sample_shape": (28, 28),
                       "n_train": 64, "n_valid": 0, "minibatch_size": 64},
        decision_config={"max_epochs": 1})
    w.initialize(device=TorchDevice())
    pkg = export_forward(w, os.path.join(tmp, "mnist_fc.npz"))
    del w
    bad = []
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "znicz_tpu_torch", "serve", pkg, "--port",
         "0", "--max-batch", "8", "--smoke-test"],
        cwd=os.path.dirname(os.path.abspath(__file__)),
        env={**os.environ, "ZNICZ_TPU_SITE_CONFIG": ""},
        capture_output=True, text=True, timeout=SF_CLI_TIMEOUT)
    cli = {"rc": proc.returncode, "s": time.perf_counter() - t0}
    if proc.returncode != 0:
        fail(f"serve_forward: the serve CLI on cuda exited "
             f"{proc.returncode}: {proc.stdout[-2000:]} "
             f"{proc.stderr[-4000:]}")
    doc = json.loads(proc.stdout.strip().splitlines()[-1])
    cli.update(smoke=doc["smoke"],
               compile_count=doc["metrics"]["engine"]["compile_count"])
    if doc["smoke"] != "ok" or cli["compile_count"] != 4:
        bad.append(f"the serve CLI on cuda: {cli}")
    cpu_ok()                          # the native runtime is built
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli_main(["serve", pkg, "--port", "0", "--max-batch", "8",
                       "--smoke-test", "--native"])
    native_doc = json.loads(buf.getvalue().strip().splitlines()[-1])
    native = {"rc": rc, "s": time.perf_counter() - t0,
              "smoke": native_doc["smoke"],
              "static_shapes": native_doc["metrics"]["engine"][
                  "static_shapes"]}
    if rc != 0 or native["smoke"] != "ok" or native["static_shapes"]:
        bad.append(f"the serve CLI with --native: {native}")
    x = np.random.default_rng(SEED + 23).normal(
        size=(16, 28, 28)).astype(np.float32)
    cc = tinfer.NativeForward(pkg)(x)
    host = ExportedForward(pkg, device="cpu")(x)
    card = ExportedForward(pkg)(x)
    native.update(max_abs_vs_torch_cpu=float(np.abs(cc - host).max()),
                  card_rel=_sf_rel(card, cc))
    if not native["max_abs_vs_torch_cpu"] <= SF_NATIVE_ATOL or \
            not native["card_rel"] <= SF_BAND:
        bad.append(f"the native runtime against the torch forward: "
                   f"{native}")
    return {"cli_cuda": cli, "native": native}, bad


def sf_export_alexnet(pkg: str) -> dict:
    """AlexNet at its own configuration initialized from the seed on the
    card and exported as a forward package to ``pkg`` -> the seconds and
    the package's size."""
    from znicz_tpu_torch.utils.export import export_forward

    tprng.seed_all(SEED)
    t0 = time.perf_counter()
    # the synthetic loader's 50 classes need 50 samples at least
    w = talexnet.build(n_train=50, n_valid=0, minibatch_size=SF_MAX_BATCH)
    w.initialize(device=TorchDevice())
    init_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    export_forward(w, pkg)
    out = {"init_s": init_s, "export_s": time.perf_counter() - t0,
           "package_mb": os.path.getsize(pkg) / 1e6}
    del w
    gc.collect()
    return out


def phase_serve_forward(package_dir=None) -> dict:
    """The forward-serving plane at full width: AlexNet (227 px, 1000
    classes) initialized on the card, exported once (into
    ``package_dir`` when given, where the services phase fetches it
    through the forge) and loaded as an
    ExportedForward in eval's type; a BatchEngine whose warmup captures
    buckets 1, 2, 4 and 8 once each; every bucket's replay bit-identical
    to its eager body, lrn_forward launched exactly twice a forward
    (replays counted); the card against the CPU's f32 forward within
    SF_BAND, whose control (LRN skipped) it rejects; served over HTTP by
    SF_CLIENTS concurrent clients with nothing captured after warmup;
    then MNIST FC's package through ``serve --smoke-test`` on cuda and
    with ``--native`` (the native runtime built beside the AlexNet
    work)."""
    from znicz_tpu_torch.native import infer as tinfer
    from znicz_tpu_torch.serve.engine import BatchEngine
    from znicz_tpu_torch.units.normalization import LRNormalizerForward
    from znicz_tpu_torch.utils.export import ExportedForward

    t0 = time.perf_counter()
    out = {"phase": "serve_forward", "max_batch": SF_MAX_BATCH,
           "bands": {"card_vs_cpu": SF_BAND, "native": SF_NATIVE_ATOL}}
    bad, built = [], {}

    def build_native():
        t1 = time.perf_counter()
        try:
            tinfer.lib()
            built["s"] = time.perf_counter() - t1
        except Exception as exc:  # noqa: BLE001 — raised by built_ok
            built["error"] = exc

    native_build = threading.Thread(target=build_native, daemon=True)
    native_build.start()

    def built_ok():
        native_build.join()
        if "error" in built:
            raise built["error"]
        out["native_build_s"] = built["s"]

    with tempfile.TemporaryDirectory() as tmp:
        pkg = os.path.join(package_dir or tmp, "alexnet.npz")
        out.update(sf_export_alexnet(pkg))
        t1 = time.perf_counter()
        backend = ExportedForward(pkg)
        out["load_s"] = time.perf_counter() - t1
        out["compute_dtype"] = str(backend.compute_dtype)
        shape = backend.input_shape
        engine = BatchEngine(backend, max_batch=SF_MAX_BATCH)
        klrn.fwd_launches = 0
        t1 = time.perf_counter()
        engine.warmup()
        torch.cuda.synchronize()
        out["warmup_s"] = time.perf_counter() - t1
        n_buckets = len(engine.buckets)
        # a bucket's materialization: its eager first run, then the
        # capture's replay, two lrn_forward launches each
        out["warmup"] = {"buckets": list(engine.buckets),
                         "compile_count": engine.compile_count,
                         "captures": backend.captures,
                         "lrn_forward_launches": klrn.fwd_launches}
        if engine.compile_count != n_buckets or \
                backend.captures != n_buckets or \
                klrn.fwd_launches != 4 * n_buckets:
            bad.append(f"warmup: {out['warmup']}")
        rng = np.random.default_rng(SEED + 22)
        xs = {b: rng.normal(size=(b,) + shape).astype(np.float32)
              for b in engine.buckets}
        replays0 = {k: g.replays for k, g in backend.graphs.items()}
        klrn.fwd_launches = 0
        identical, ms = {}, {}
        for b, x in xs.items():
            identical[b] = bool(np.array_equal(backend(x), backend.eager(x)))
        out["replay_vs_eager"] = {
            "identical": identical, "lrn_forward_launches": klrn.fwd_launches,
            "replays": {str(k[0]): g.replays - replays0[k]
                        for k, g in backend.graphs.items()}}
        if not all(identical.values()):
            bad.append(f"a replay differs from its eager body: {identical}")
        if klrn.fwd_launches != 4 * n_buckets or \
                any(v != 1 for v in out["replay_vs_eager"]["replays"]
                    .values()):
            bad.append(f"replay vs eager launches: "
                       f"{out['replay_vs_eager']}")
        # a forward of the largest bucket through the engine (host clock,
        # the H2D of its input and the D2H of its answer included)
        for name, fn in (("replay", backend), ("eager", backend.eager)):
            fn(xs[SF_MAX_BATCH])
            times = []
            for _ in range(5):
                t1 = time.perf_counter()
                fn(xs[SF_MAX_BATCH])
                times.append((time.perf_counter() - t1) * 1e3)
            ms[name] = float(np.median(times))
        out["batch8_host_ms"] = ms
        out["http"], reqs, answers, b = _sf_http(engine, backend, shape,
                                                 rng)
        bad += b
        # the card against the CPU's f32 forward, and the band's control
        host = ExportedForward(pkg, device="cpu")
        control = ExportedForward(pkg, device="cpu")
        for unit in control._units:
            if isinstance(unit, LRNormalizerForward):
                unit.torch_apply = lambda p, x, **kw: x
        card_rows = np.concatenate([answers[0], answers[1]])
        host_rows = host(np.concatenate(reqs[:2]))
        x2 = xs[2]
        host2 = host(x2)
        out["card_vs_cpu"] = {
            "eager_rel": _sf_rel(backend.eager(x2), host2),
            "replay_rel": _sf_rel(backend(x2), host2),
            "http_rel": _sf_rel(card_rows, host_rows),
            "control_rel": _sf_rel(control(x2), host2),
            "argmax_agree": float(np.mean(card_rows.argmax(1) ==
                                          host_rows.argmax(1))),
            "max_abs": float(np.abs(card_rows - host_rows).max())}
        cvc = out["card_vs_cpu"]
        if not max(cvc["eager_rel"], cvc["replay_rel"],
                   cvc["http_rel"]) <= SF_BAND:
            bad.append(f"card vs CPU past {SF_BAND}: {cvc}")
        if not cvc["control_rel"] > SF_BAND:
            bad.append(f"the card-vs-CPU band passes its control: {cvc}")
        del backend, engine, host, control
        gc.collect()
        torch.cuda.empty_cache()
        out["mnist_fc"], b = _sf_mnist_fc(tmp, built_ok)
        bad += b
    out["seconds"] = time.perf_counter() - t0
    if bad:
        fail(f"serve_forward: {bad}: {out}")
    return out


#: zoo phase (a): the rest of the zoo at each model's build() defaults
#: (their epochs included), f32 with TF32 off, on the card and on the
#: CPU from one seed: (name, model module, build kwargs).  Wine and the
#: nearest-target Approximator also run eager, so the FC kernels' path is
#: counted beside TvChannels' conv path
ZOO_RUNS = (("wine_fused", twine, {}),
            ("wine_eager", twine, {"fused": False}),
            ("approximator_fused", tapprox, {}),
            ("approximator_prototypes_fused", tapprox, {"prototypes": 5}),
            ("approximator_prototypes_eager", tapprox,
             {"prototypes": 5, "fused": False}),
            ("spam_fused", tspam, {}),
            ("tv_channels_fused", ttv, {}),
            ("tv_channels_eager", ttv, {"fused": False}),
            ("rbm", trbm, {}))
#: the runs with no TF32-capable library call on their path: the eager
#: Approximator's layers are the FC kernels (gemm_fc, act_backward), its
#: SGD and MSE elementwise torch, so its TF32 run must equal its TF32-off
#: run bit for bit.  Every other run meets a torch product or cuDNN
#: (the fused steps' matmuls and convolutions, the eager softmax layer's
#: products, the RBM's statistics), and its TF32 run must fail a band
ZOO_TF32_BLIND = ("approximator_prototypes_eager",)
#: card against CPU, both f32: the n_err histories identical, the MSE
#: histories within ZOO_MSE_RTOL, and the weights at the end of epoch
#: ZOO_HELD_EPOCH within ZOO_WEIGHT_ATOL (the models' later epochs go on
#: at learning rates up to 0.3 with momentum 0.9, where the two sides'
#: summation-order differences grow; the final weights' distance is
#: reported).  The same bands as mnist_parity's and ae_parity's
ZOO_HELD_EPOCH = 2
ZOO_MSE_RTOL, ZOO_WEIGHT_ATOL = 1e-5, 1e-6
#: the counted kernels of the zoo's paths
ZOO_COUNTERS = ("gemm_fc", "act_backward", "conv2d_fwd",
                "conv2d_input_grad", "conv2d_weight_grad", "sgd_update")
#: (b): a fused Wine run with a per-minibatch LearningRateAdjust
#: (ExpPolicy(ZOO_LR_GAMMA)) and an NNRollback forced at the end of
#: epoch ZOO_ROLLBACK_EPOCH after the step's leaves were set to NaN, to
#: ZOO_LR_EPOCHS epochs
ZOO_LR_GAMMA, ZOO_ROLLBACK_EPOCH, ZOO_LR_EPOCHS = 0.99, 2, 4
#: (c): the reference's online-training shape (tests/
#: test_interactive_restful.py): samples, features, classes, hidden
#: width, capacity, minibatch, epochs; the request batches served
ZOO_ONLINE = {"n": 96, "features": 6, "classes": 3, "hidden": 16,
              "minibatch": 24, "epochs": 6}
ZOO_SERVE_BATCHES = (1, 5, 16)
#: the served rows against the CPU forward of the same package, both f32
#: (TF32 off): summation order only, ~1e-7 on softmax outputs of order 1
ZOO_SERVE_ATOL = 1e-5
#: (d): the CLI's time limit in seconds
ZOO_CLI_TIMEOUT = 300


def _zoo_counts() -> dict:
    return {"gemm_fc": kgemm.gemm_launches,
            "act_backward": kgemm.act_launches,
            "conv2d_fwd": kconv.fwd_launches,
            "conv2d_input_grad": kconv.input_grad_launches,
            "conv2d_weight_grad": kconv.weight_grad_launches,
            "sgd_update": koptim.sgd_launches}


def _zero_zoo_counts() -> None:
    kgemm.gemm_launches = kgemm.act_launches = 0
    kconv.fwd_launches = kconv.input_grad_launches = 0
    kconv.weight_grad_launches = 0
    koptim.sgd_launches = 0


def zoo_launch_table(w) -> dict:
    """One train and one eval minibatch's launches of ZOO_COUNTERS, read
    from the workflow's units: fused, one SGD launch a param leaf a train
    step (the forwards and the backward are torch products and cuDNN);
    eager, gemm_fc at each FC forward but the softmax layer (plain torch,
    as the reference's), conv2d_fwd at each conv, and in a train
    minibatch an FC gradient's err_input and weight-gradient GEMMs (the
    err_input is computed even where the first layer drops it) after
    act_backward where its activation is applied, and a conv gradient's
    weight gradient and, below a layer that takes it (GDCutter), its
    input gradient.  The RBM's three All2AllSigmoid units count as FC
    forwards; its statistics and update are torch."""
    train, ev = dict.fromkeys(ZOO_COUNTERS, 0), dict.fromkeys(
        ZOO_COUNTERS, 0)
    if getattr(w, "step", None) is not None:
        train["sgd_update"] = sum(len(f.param_arrays()) for f in w.forwards)
        return {"train": train, "eval": ev}
    for u in w.units:
        if isinstance(u, All2All) and not isinstance(u, All2AllSoftmax):
            train["gemm_fc"] += 1
            ev["gemm_fc"] += 1
        elif isinstance(u, Conv):
            train["conv2d_fwd"] += 1
            ev["conv2d_fwd"] += 1
        elif isinstance(u, GradientDescentConv):
            train["conv2d_weight_grad"] += 1
            train["conv2d_input_grad"] += int(u.need_err_input)
        elif isinstance(u, GradientDescent) and \
                u.ACTIVATION in kgemm.FUSED_ACTIVATIONS:
            train["gemm_fc"] += 2
            train["act_backward"] += int(
                u.ACTIVATION != activations.LINEAR and u.ACTIVATION_APPLIED)
    return {"train": train, "eval": ev}


def _zoo_weights(w) -> list:
    """Host copies of the trained params: the forwards' weights and
    biases, the RBM's shared W and its two biases."""
    upd = next((u for u in w.units if isinstance(u, WeightsUpdater)), None)
    if upd is not None:
        return [np.array(a.map_read()) for a in (upd.weights, upd.vbias,
                                                 upd.hbias)]
    if getattr(w, "step", None) is not None:
        w.step.sync_to_units()
    return _weights_of(w)


class _SeededUniforms:
    """The RBM's Binarization draws, card and CPU alike: seeded numpy
    uniforms in draw order, copied to the unit's device."""

    def __init__(self) -> None:
        self.rng = np.random.default_rng(SEED)

    def __call__(self, shape, device):
        return torch.from_numpy(self.rng.uniform(size=tuple(shape)).astype(
            np.float32)).to(device)


def _zoo_run(make, device, allow_tf32=False, prepare=None,
             seeded_draws=True) -> dict:
    """``make()`` (seeded here) on ``device`` in f32 through
    ``Workflow.run``, with the ZOO_COUNTERS set to 0 just before and read
    just after, the classes of its minibatches, the weights at the end
    of epoch ZOO_HELD_EPOCH and at the end, ms a minibatch over the run
    and after its first epoch; ``prepare(w)`` after initialize (a
    schedule's hooks).  With ``seeded_draws`` the RBM's Binarization
    draws seeded numpy uniforms, the same on every device; without, its
    own generator's."""
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = allow_tf32
    torch.backends.cudnn.allow_tf32 = allow_tf32
    try:
        tprng.seed_all(SEED)
        w = make()
        w.initialize(device=TorchDevice(device, precision="float32"))
        for u in w.units:
            if seeded_draws and isinstance(u, Binarization):
                u.draw_uniform = _SeededUniforms()
        extra = prepare(w) if prepare is not None else None
        classes, serve = [], w.loader.run

        def run():
            serve()
            classes.append(int(w.loader.minibatch_class))
        w.loader.run = run
        held, first, logged = [], [], w.decision.on_epoch_logged

        def on_epoch_logged():
            logged()
            epoch = len(w.decision.metrics_history)
            if epoch == 1:
                first[:] = [time.perf_counter(), len(classes)]
            if epoch == ZOO_HELD_EPOCH:
                held.extend(_zoo_weights(w))
        w.decision.on_epoch_logged = on_epoch_logged
        _zero_zoo_counts()                           # 0 just before ...
        t0 = time.perf_counter()
        w.run()
        if device != "cpu":
            torch.cuda.synchronize()
        t1 = time.perf_counter()
        launches = _zoo_counts()                     # ... read just after
        final = _zoo_weights(w)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32
    return {"w": w, "history": w.decision.metrics_history, "held": held,
            "final": final, "launches": launches, "classes": classes,
            "wall_s": t1 - t0, "extra": extra,
            "ms_per_minibatch": 1e3 * (t1 - t0) / len(classes),
            # after the first epoch: graphs captured, libraries loaded
            "steady_ms_per_minibatch": 1e3 * (t1 - first[0]) /
            (len(classes) - first[1])}


def _zoo_distance(run: dict, cpu: dict) -> dict:
    """``run`` against ``cpu``: identical histories, the MSE histories'
    largest relative difference, the weights' largest absolute one at
    the held epoch and at the end."""
    def floats(h):
        return [v for r in h for k, v in sorted(r.items())
                if k.startswith("metric") and isinstance(v, float)]
    a, b = floats(run["history"]), floats(cpu["history"])
    return {
        "history_identical": run["history"] == cpu["history"],
        "mse_rel": max((abs(x - y) / abs(y) for x, y in zip(a, b)
                        if y != 0), default=0.0),
        "held_weight_err": max(float(np.abs(x - y).max()) for x, y in
                               zip(run["held"], cpu["held"], strict=True)),
        "final_weight_err": max(float(np.abs(x - y).max()) for x, y in
                                zip(run["final"], cpu["final"],
                                    strict=True))}


def _zoo_within(d: dict, mse: bool) -> bool:
    return (d["mse_rel"] <= ZOO_MSE_RTOL if mse else
            d["history_identical"]) and \
        d["held_weight_err"] <= ZOO_WEIGHT_ATOL


def _zoo_makes(tmp: str) -> dict:
    """ZOO_RUNS' builders, by run name (Spam's corpus under ``tmp``)."""
    makes = {}
    for name, module, kw in ZOO_RUNS:
        kw = dict(kw)
        if module is tspam:
            kw["loader_config"] = {"data_dir": os.path.join(tmp, "spam")}

        def make(module=module, kw=kw):
            return module.build(**kw)
        makes[name] = make
    return makes


def _zoo_models(makes: dict, cpu_runs: dict) -> tuple:
    """(a): each run on the card, with TF32 off and on, against its CPU
    run -> (reading, what failed)."""
    out, bad = {}, []
    for name, module, _ in ZOO_RUNS:
        make, cpu = makes[name], cpu_runs.pop(name)
        card = _zoo_run(make, DEVICE)
        tf32 = _zoo_run(make, DEVICE, allow_tf32=True)
        mse = card["w"].decision.__class__.__name__ == "DecisionMSE"
        table = zoo_launch_table(card["w"])
        r = out[name] = {
            "epochs": len(card["history"]),
            "minibatches": len(card["classes"]),
            "train_minibatches": card["classes"].count(TRAIN),
            "launches": card["launches"],
            "expect": _per_class(table, card["classes"]),
            "card_s": card["wall_s"], "cpu_s": cpu["wall_s"],
            "ms_per_minibatch": card["ms_per_minibatch"],
            "steady_ms_per_minibatch": card["steady_ms_per_minibatch"],
            "cpu_ms_per_minibatch": cpu["ms_per_minibatch"],
            "cpu_steady_ms_per_minibatch": cpu["steady_ms_per_minibatch"],
            "history": [{k: v for k, v in h.items()
                         if k.startswith("metric")}
                        for h in card["history"]],
            "vs_cpu": _zoo_distance(card, cpu),
            "tf32_vs_cpu": _zoo_distance(tf32, cpu)}
        if getattr(card["w"], "step", None) is not None:
            r["graph_replays"] = replays_of(card["w"].step)
            r["pinned"] = card["w"].step._dataset_dev is not None
        if r["launches"] != r["expect"]:
            bad.append(f"{name} launches {r['launches']} != {r['expect']}")
        if card["classes"] != cpu["classes"]:
            bad.append(f"{name}: the card served other classes than the "
                       f"CPU")
        if not _zoo_within(r["vs_cpu"], mse):
            bad.append(f"{name} card vs cpu {r['vs_cpu']}")
        if name in ZOO_TF32_BLIND:
            same = tf32["history"] == card["history"] and all(
                np.array_equal(x, y) for x, y in zip(tf32["final"],
                                                     card["final"]))
            r["tf32_bit_identical"] = same
            if not same:
                bad.append(f"{name}: its TF32 run moved")
        elif _zoo_within(r["tf32_vs_cpu"], mse):
            bad.append(f"{name}: the bands pass its TF32 run "
                       f"{r['tf32_vs_cpu']}")
        if module is trbm:
            r["h2v"] = _zoo_h2v_check(card["w"])
            if not r["h2v"]["ok"]:
                bad.append(f"rbm h2v {r['h2v']}")
        del card, cpu, tf32
    return out, bad


def _zoo_rbm_own_draws() -> tuple:
    """(a): the RBM's ``build()`` + ``run()`` on the card with its own
    draws (Binarization's ``torch.Generator`` from ``prng.get().key``,
    no seeded uniforms), launches counted as for the others, held to the
    reference's property: the last validation MSE below the first, and
    a finite W that moved -> (reading, what failed)."""
    start = []
    run = _zoo_run(trbm.build, DEVICE, seeded_draws=False,
                   prepare=lambda w: start.extend(_zoo_weights(w)))
    mse = [h["metric_validation"] for h in run["history"]]
    weights = run["final"][0]
    out = {"launches": run["launches"],
           "expect": _per_class(zoo_launch_table(run["w"]), run["classes"]),
           "complete": bool(run["w"].decision.complete),
           "validation_mse": mse, "w_finite": bool(
               np.isfinite(weights).all()),
           "w_moved": float(np.abs(weights - start[0]).max()),
           "ms_per_minibatch": run["ms_per_minibatch"],
           "steady_ms_per_minibatch": run["steady_ms_per_minibatch"]}
    bad = []
    if out["launches"] != out["expect"]:
        bad.append(f"rbm own draws launches {out['launches']} != "
                   f"{out['expect']}")
    if not (out["complete"] and mse[-1] < mse[0] and out["w_finite"] and
            out["w_moved"] > 0):
        bad.append(f"rbm own draws {out}")
    return out, bad


def _zoo_h2v_check(w) -> dict:
    """The RBM's h2v product as its unit launches it: ``gemm_fc`` of the
    binary hidden states and the transposed view of the shared (nv, nh)
    weights (trans_b, no copy) with the visible bias and the sigmoid,
    against its plain twin on the same tensors; the band must reject
    the same call reading the weights' memory untransposed."""
    units = {u.name: u for u in w.units}
    h2v, v2h = units["h2v"], units["v2h"]
    h = h2v.input.devmem
    wt = h2v.weights.devmem
    view = wt.t()
    args = (h, view, h2v.bias.devmem, activations.SIGMOID)
    got = kgemm.fc_forward(*args)
    want = kgemm.fc_forward_plain(*args)
    control = kgemm.fc_forward(h, wt.reshape(view.shape),
                               h2v.bias.devmem, activations.SIGMOID)
    err = float((got - want).abs().max())
    control_err = float((control - want).abs().max())
    return {"shape": {"h": list(h.shape), "weights": list(wt.shape)},
            "shared": h2v.weights is v2h.weights,
            "trans_b": kgemm._stored(view, "b"),
            "no_copy": view.data_ptr() == wt.data_ptr(),
            "max_abs_err": err, "control_err": control_err,
            "ok": (h2v.weights is v2h.weights and
                   kgemm._stored(view, "b") == 1 and
                   view.data_ptr() == wt.data_ptr() and
                   err <= ZOO_WEIGHT_ATOL < control_err)}


def _zoo_schedule_make(with_schedule: bool):
    """(b)'s workflow: fused Wine to ZOO_LR_EPOCHS epochs, the loop
    decision -> LearningRateAdjust -> NNRollback -> repeater."""
    def make():
        w = twine.build(max_epochs=ZOO_LR_EPOCHS)
        tail = w.decision
        w.repeater.links_from.clear()
        w.decision.links_to.remove(w.repeater)
        if with_schedule:
            adj = w.lr_adjust = LearningRateAdjust(
                w, lr_policy=ExpPolicy(ZOO_LR_GAMMA), name="lr_adjust")
            for gd in w.gds:
                adj.add_gd_unit(gd)
            adj.link_from(tail)
            tail = adj
        rb = w.nn_rollback = NNRollback(w, fail_iterations=10 ** 6)
        rb.link_workflow_state(w)
        rb.link_from(tail)
        rb.gate_skip = ~w.decision.epoch_ended
        w.repeater.link_from(rb)
        return w
    return make


def _zoo_force_rollback(w) -> dict:
    """Hooked at the end of epoch ZOO_ROLLBACK_EPOCH: every w/b leaf of
    the step set to NaN in place, then ``force_rollback``; -> what the
    restore left in the leaves, read at once, and the graphs then."""
    step, rb = w.step, w.nn_rollback
    reading = {}
    if step._graphs is not None:                # the card's graphs
        reading["graphs_before"] = {str(k): id(g) for k, g in
                                    step._graphs.items()}
        reading["replays_before"] = sum(replays_of(step).values())
    ptrs = [{k: t.data_ptr() for k, t in leaf.items()}
            for leaf in step._params]
    for leaf in step._params:
        for k in ("w", "b"):
            if k in leaf:
                leaf[k].fill_(float("nan"))
    rb.force_rollback()
    good = {f"forward.{i}.{a}": k for i in range(len(step._params))
            for a, k in (("weights", "w"), ("bias", "b"))}
    reading["restored_bit_equal"] = all(
        np.array_equal(step._params[int(key.split(".")[1])][k].cpu()
                       .numpy(), rb._good[key])
        for key, k in good.items())
    reading["same_leaves"] = [{k: t.data_ptr() for k, t in leaf.items()}
                              for leaf in step._params] == ptrs
    reading["rollbacks"] = rb.rollback_count
    return reading


def _zoo_schedule(device: str, with_schedule: bool = True) -> dict:
    """(b)'s run on ``device``; on the card, the graphs' identities and
    replays around the rollback."""
    def prepare(w):
        state = {}
        logged = w.decision.on_epoch_logged

        def on_epoch_logged():
            logged()
            if len(w.decision.metrics_history) == ZOO_ROLLBACK_EPOCH:
                state["rollback"] = _zoo_force_rollback(w)
        w.decision.on_epoch_logged = on_epoch_logged
        state["hyper_ptr"] = w.step._hyper_buf.data_ptr()
        return state
    run = _zoo_run(_zoo_schedule_make(with_schedule), device,
                   prepare=prepare)
    w = run["w"]
    state = run["extra"]
    state["hyper_ptr_kept"] = w.step._hyper_buf.data_ptr() == \
        state.pop("hyper_ptr")
    state["lr_final"] = float(w.gds[0].learning_rate)
    state["hyper_lr_final"] = float(w.step._hyper_device()[0]["lr"])
    if device != "cpu":
        rb = state["rollback"]
        rb["graphs_after"] = {str(k): id(g) for k, g in
                              w.step._graphs.items()}
        rb["no_recapture"] = rb["graphs_after"] == rb["graphs_before"]
        rb["replays_after"] = sum(replays_of(w.step).values())
    return run


def _zoo_lr_rollback() -> tuple:
    """(b) -> (reading, what failed)."""
    card, cpu = _zoo_schedule(DEVICE), _zoo_schedule("cpu")
    plain = _zoo_schedule("cpu", with_schedule=False)
    d = _zoo_distance(card, cpu)
    rb = card["extra"]["rollback"]
    out = {"epochs": ZOO_LR_EPOCHS, "gamma": ZOO_LR_GAMMA,
           "rollback_epoch": ZOO_ROLLBACK_EPOCH, "vs_cpu": d,
           "history": [{k: v for k, v in h.items()
                        if k.startswith("metric")}
                       for h in card["history"]],
           "schedule_moves_weights": max(
               float(np.abs(x - y).max()) for x, y in
               zip(cpu["final"], plain["final"])),
           "launches": card["launches"],
           "card": {k: v for k, v in card["extra"].items()
                    if k != "rollback"},
           "cpu": {k: v for k, v in cpu["extra"].items()
                   if k != "rollback"},
           "rollback": {k: v for k, v in rb.items()
                        if not k.startswith("graphs_")},
           "graphs": len(rb["graphs_after"])}
    bad = []
    if not _zoo_within({**d, "held_weight_err": d["final_weight_err"]},
                       False):
        bad.append(f"lr_rollback card vs cpu {d}")
    if not out["schedule_moves_weights"] > 100 * ZOO_WEIGHT_ATOL:
        bad.append("the schedule did not move the CPU run's weights")
    if not (rb["restored_bit_equal"] and rb["same_leaves"] and
            rb["no_recapture"] and rb["rollbacks"] == 1 and
            rb["replays_after"] > rb["replays_before"] and
            card["extra"]["hyper_ptr_kept"] and
            card["extra"]["lr_final"] == cpu["extra"]["lr_final"] and
            abs(card["extra"]["hyper_lr_final"] -
                card["extra"]["lr_final"]) <= 1e-7 *
            card["extra"]["lr_final"]):
        bad.append(f"lr_rollback: {out}")
    return out, bad


def _zoo_online_make(data, labels):
    def make():
        w = StandardWorkflow(
            name="Online", loss_function="softmax",
            layers=[{"type": "all2all_tanh",
                     "->": {"output_sample_shape": ZOO_ONLINE["hidden"]}},
                    {"type": "softmax",
                     "->": {"output_sample_shape": ZOO_ONLINE["classes"]}}],
            loader_name="interactive",
            loader_config={"sample_shape": (ZOO_ONLINE["features"],),
                           "n_classes": ZOO_ONLINE["classes"],
                           "capacity": ZOO_ONLINE["n"],
                           "minibatch_size": ZOO_ONLINE["minibatch"]},
            decision_config={"max_epochs": ZOO_ONLINE["epochs"]})
        w.loader.feed(data, labels)
        return w
    return make


def _zoo_online_serve(tmp: str) -> tuple:
    """(c): online training fed through ``InteractiveLoader.feed``, on
    the card against the CPU; the card's weights exported, loaded on the
    card in f32 and served by ``PredictionServer``, a few
    ``predict_remote`` calls held against the CPU forward of the same
    package -> (reading, what failed)."""
    from znicz_tpu_torch.loader.restful import (PredictionServer,
                                                predict_remote)
    from znicz_tpu_torch.utils.export import ExportedForward, export_forward

    rng = np.random.default_rng(SEED)
    n, f, c = ZOO_ONLINE["n"], ZOO_ONLINE["features"], ZOO_ONLINE["classes"]
    centers = rng.normal(0, 2.0, (c, f)).astype(np.float32)
    labels = rng.integers(0, c, n).astype(np.int32)
    data = centers[labels] + rng.normal(0, 0.3, (n, f)).astype(np.float32)
    make = _zoo_online_make(data, labels)
    card, cpu = _zoo_run(make, DEVICE), _zoo_run(make, "cpu")
    table = zoo_launch_table(card["w"])
    out = {"vs_cpu": _zoo_distance(card, cpu),
           "history": [h["metric_train"] for h in card["history"]],
           "launches": card["launches"],
           "expect": _per_class(table, card["classes"]),
           "pinned": card["w"].step._dataset_dev is not None,
           "ms_per_minibatch": card["ms_per_minibatch"],
           "steady_ms_per_minibatch": card["steady_ms_per_minibatch"]}
    bad = []
    if out["launches"] != out["expect"]:
        bad.append(f"online launches {out['launches']} != {out['expect']}")
    if not _zoo_within(out["vs_cpu"], False):
        bad.append(f"online card vs cpu {out['vs_cpu']}")
    pkg = os.path.join(tmp, "online.npz")
    export_forward(card["w"], pkg)
    precision = root.common.engine.get("precision", "bfloat16")
    root.common.engine.precision = "float32"
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        model = ExportedForward(pkg, device=DEVICE)
        host = ExportedForward(pkg, device="cpu")
        server = PredictionServer(model, max_batch=max(ZOO_SERVE_BATCHES))
        port = server.start()
        try:
            errs, t0 = [], time.perf_counter()
            for b in ZOO_SERVE_BATCHES:
                x = rng.normal(size=(b, f)).astype(np.float32)
                y = predict_remote(f"http://127.0.0.1:{port}", x)
                errs.append(float(np.abs(y - host(x)).max()))
            http_s = time.perf_counter() - t0
        finally:
            server.stop()
    finally:
        root.common.engine.precision = precision
        torch.backends.cuda.matmul.allow_tf32 = tf32
    out["serve"] = {"batches": list(ZOO_SERVE_BATCHES),
                    "max_abs_err": max(errs), "http_s": http_s,
                    "requests": server.n_requests,
                    "captures": model.captures,
                    "compile_count": server.engine.compile_count,
                    "compute_dtype": str(model.compute_dtype)}
    buckets = {server.engine.bucket_for(b) for b in ZOO_SERVE_BATCHES}
    if not (max(errs) <= ZOO_SERVE_ATOL and
            server.n_requests == len(ZOO_SERVE_BATCHES) and
            model.captures == len(buckets) ==
            server.engine.compile_count):
        bad.append(f"online serve {out['serve']}")
    return out, bad


def _zoo_cli_start() -> dict:
    """(d): ``python -m znicz_tpu_torch znicz_tpu_torch/models/wine.py``
    with no ``-d``, started at once in its own process; a thread collects
    its output and the seconds from its start to its exit."""
    cli = {"t0": time.perf_counter()}
    proc = cli["proc"] = subprocess.Popen(
        [sys.executable, "-m", "znicz_tpu_torch",
         "znicz_tpu_torch/models/wine.py"],
        cwd=os.path.dirname(os.path.abspath(__file__)),
        env={**os.environ, "ZNICZ_TPU_SITE_CONFIG": ""},
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)

    def collect():
        cli["log"] = proc.communicate()[0]
        cli["seconds"] = time.perf_counter() - cli["t0"]
    cli["thread"] = threading.Thread(target=collect, daemon=True)
    cli["thread"].start()
    return cli


def _zoo_cli_result(cli: dict) -> tuple:
    """The CLI's reading: its own seconds (start to exit) and the
    seconds until its result was collected, killed at ZOO_CLI_TIMEOUT."""
    proc, thread = cli["proc"], cli["thread"]
    thread.join(max(0.0, cli["t0"] + ZOO_CLI_TIMEOUT - time.perf_counter()))
    if thread.is_alive():
        proc.kill()
        thread.join()
    log = cli["log"]
    epochs = re.findall(r"DecisionGD: epoch (\d+):", log)
    out = {"rc": proc.returncode, "seconds": cli["seconds"],
           "collected_s": time.perf_counter() - cli["t0"],
           "on_cuda": "TorchDevice cuda" in log,
           "epochs_logged": len(epochs), "tail": log[-600:]}
    ok = out["rc"] == 0 and out["on_cuda"] and out["epochs_logged"] == 20
    return out, [] if ok else [f"wine CLI {out}"]


def phase_zoo() -> dict:
    """The rest of the zoo on the card (``--phase zoo``).  (a) Wine,
    Approximator (regression, and nearest-target eager and fused),
    SpamFilter, TvChannels (fused, and eager: the conv forward, weight-
    and input-gradient kernels behind a Cutter) and the CD-1 RBM at their
    build() defaults, f32, TF32 off, each on the card and on the CPU:
    every run's gemm_fc, act_backward, conv and SGD launches equal to
    ``zoo_launch_table``'s counts of its minibatches, n_err histories
    identical, MSE histories and weights within the ZOO bands, which
    must reject the same run with TF32 on (the eager Approximator, with
    no TF32-capable call, must not move); the RBM's h2v product (gemm_fc
    on the transposed shared weights) against its plain twin; and the
    RBM once more with its own draws, gated on the reference's property
    (``_zoo_rbm_own_draws``).  (b) a
    per-minibatch LearningRateAdjust on fused Wine with an NNRollback
    forced mid-run: card against the CPU, the restore bit-equal in the
    same leaves, no graph recaptured.  (c) online training from
    ``InteractiveLoader.feed``, exported and served by
    ``PredictionServer`` to ``predict_remote``, against the CPU forward.
    (d) the Wine CLI with no ``-d``, in its own process beside (a)'s CPU
    runs, timed from its start to its exit.  Every part runs before the first failure is raised."""
    t0 = time.perf_counter()
    cli = _zoo_cli_start()
    out, bad = {"phase": "zoo"}, []
    with tempfile.TemporaryDirectory() as tmp:
        # (a)'s CPU runs beside the CLI process; the card's runs after it
        # ended, so its work does not reach their times
        makes = _zoo_makes(tmp)
        cpu_runs = {name: _zoo_run(make, "cpu")
                    for name, make in makes.items()}
        out["cpu_s"] = time.perf_counter() - t0
        out["cli"], b = _zoo_cli_result(cli)
        bad += b
        for key, part in (("models", lambda: _zoo_models(makes, cpu_runs)),
                          ("rbm_own_draws", _zoo_rbm_own_draws),
                          ("lr_rollback", _zoo_lr_rollback),
                          ("online_serve", lambda: _zoo_online_serve(tmp))):
            t1 = time.perf_counter()
            out[key], b = part()
            out[key + "_s"] = time.perf_counter() - t1
            bad += b
    out["seconds"] = time.perf_counter() - t0
    if bad:
        fail(f"zoo: {bad}: {out}")
    return out


#: operations: (a)'s timed anatomy steps after one warm one, (b)'s LM
#: steps, the phase sum's band against the step wall
#: (tests/test_anatomy.py:140), (b)'s loss band against the plain step
#: (tests/test_anatomy.py:222's rtol)
OPS_ALEX_STEPS, OPS_LM_STEPS, OPS_RECONCILE, OPS_LM_RTOL = 5, 3, 0.10, 2e-4
#: (a): AlexNet's leaves and its LRN layers (launches a train step)
OPS_ALEX_SGD, OPS_ALEX_LRN = 16, 2
#: (d): minibatches an epoch and epochs; the NaN at the third publish
#: (one an epoch: the first captures a copy, the second certifies it)
OPS_HEALTH_MB, OPS_HEALTH_EPOCHS, OPS_HEALTH_NAN_AT = 4, 4, 3
#: (e): the drill's epochs and its seeded kill (tests/test_elastic.py:58)
OPS_DRILL_EPOCHS = 6
OPS_KILL_AT_HIT = int(np.random.default_rng(1234).integers(40, 70))
#: (c): the MNIST FC runs the CLI profiles (mnist_eager's widths), and
#: the kernels each launches: eager, the FC kernels; fused, the SGD
#: kernel (its matmuls are cuBLAS's under autograd)
OPS_FC_TRAIN, OPS_FC_VALID = 2 * FC_BATCH, FC_BATCH
OPS_PROFILED = {"eager": ("gemm_fc", "act_backward"), "fused": ("sgd",)}
#: the counters of (c) by the name their kernels carry in a trace
OPS_TRACE_KEYS = {"gemm_fc": "gemm_f32_kernel",
                  "act_backward": "act_backward_f32_kernel",
                  "sgd": "sgd_kernel"}
OPS_CLI_TIMEOUT = 300
OPS_FC_WORKFLOW = """
import json

from znicz_tpu_torch.core.config import root
from znicz_tpu_torch.kernels import gemm, optim
from znicz_tpu_torch.models import mnist_fc


def counts():
    return {"gemm_fc": gemm.gemm_launches, "act_backward": gemm.act_launches,
            "sgd": optim.sgd_launches}


def build():
    cfg = root.ops_profile
    make = mnist_fc.build_fused if cfg.fused else mnist_fc.build_eager
    return make(max_epochs=1, layers=tuple(cfg.layers),
                minibatch_size=cfg.batch, n_train=cfg.n_train,
                n_valid=cfg.n_valid)


def run(load, main):
    w, _ = load(build)
    initialize = w.initialize
    at_run = {}

    def initialized(**kwargs):
        initialize(**kwargs)
        at_run.update(counts())
    w.initialize = initialized
    main()
    with open(root.ops_profile.result_file, "w") as f:
        json.dump({"at_run": at_run, "at_end": counts(),
                   "history": w.decision.metrics_history}, f)
"""


def _anatomy_reading(plane: str) -> dict:
    """The plane's anatomy sums now: seconds a phase, the step walls,
    the step count and the MFU gauge (``observe/anatomy.py``)."""
    flat = tregistry.REGISTRY.snapshot_flat(skip_zero=False)
    out = {p: flat.get(f'znicz_anatomy_phase_seconds_sum{{plane="{plane}",'
                       f'phase="{p}"}}', 0.0) for p in TRAIN_PHASES}
    out["step"] = flat.get(
        f'znicz_anatomy_step_seconds_sum{{plane="{plane}"}}', 0.0)
    out["steps"] = flat.get(f'znicz_anatomy_steps_total{{plane="{plane}"}}',
                            0.0)
    out["mfu"] = flat.get(f'znicz_anatomy_mfu{{plane="{plane}"}}', 0.0)
    return out


def _anatomy_step_ms(before: dict, after: dict) -> dict:
    """One step's phases in ms between two readings, the phase sum's
    share of the step wall, and the MFU gauge after it."""
    ms = {p: (after[p] - before[p]) * 1e3 for p in TRAIN_PHASES}
    wall = (after["step"] - before["step"]) * 1e3
    return {**{f"{p}_ms": v for p, v in ms.items()}, "step_ms": wall,
            "phase_sum_ms": sum(ms.values()),
            "steps": after["steps"] - before["steps"], "mfu": after["mfu"]}


@contextlib.contextmanager
def _strict_f32():
    """TF32 off and deterministic cuDNN algorithms, restored after."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32,
             torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32,
         torch.backends.cudnn.deterministic,
         torch.backends.cudnn.benchmark) = saved


def _ops_alexnet_run(anatomy: bool) -> dict:
    """alexnet.build() at its defaults, fused, in f32, through its
    loader and step units minibatch by minibatch: one warm step, then
    OPS_ALEX_STEPS timed ones (wall ms around ``step.run`` with a sync,
    the anatomy's phases), the LRN and SGD counters set to 0 just before
    them and read just after; the weights after."""
    tprng.seed_all(SEED)
    w = talexnet.build(n_train=ALEX_BATCH * (1 + OPS_ALEX_STEPS),
                       n_valid=0, max_epochs=1)
    w.step.anatomy = anatomy
    w.initialize(device=TorchDevice(DEVICE, precision="float32"))
    step, loader = w.step, w.loader
    steps = []
    for i in range(1 + OPS_ALEX_STEPS):
        loader.run()
        if i == 1:
            _zero_lrn_sgd_counts()                   # 0 just before ...
        before = _anatomy_reading("fused")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step.run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        if i:
            steps.append({"wall_ms": wall_ms, **_anatomy_step_ms(
                before, _anatomy_reading("fused"))})
    launches = _lrn_sgd_counts()                     # ... read just after
    step.sync_to_units()
    out = {"steps": steps, "launches": launches,
           "weights": _conv_fc_weights(w),
           "graphs": None if step._graphs is None else len(step._graphs),
           "flops_per_step": 3.0 * _forward_flops(w)}
    del w, step, loader
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _ops_alexnet() -> tuple:
    """(a): the anatomy run, then the same steps replayed normally."""
    with _strict_f32():
        anat = _ops_alexnet_run(True)
        plain = _ops_alexnet_run(False)
    n = OPS_ALEX_STEPS
    expect = {"lrn_forward": OPS_ALEX_LRN * n, "lrn_backward":
              OPS_ALEX_LRN * n, "sgd_update": OPS_ALEX_SGD * n,
              "hand_conv": 0}
    diff = {name: max(float(np.max(np.abs(a - b))) for a, b in
                      zip(anat["weights"][name], plain["weights"][name]))
            for name in anat["weights"]}
    # the one-replay step from the third call on (eager, capture, replay)
    tail = slice(2, None)
    out = {"config": {"batch": ALEX_BATCH, "input": 227, "precision": "f32",
                      "tf32": False, "cudnn_deterministic": True,
                      "steps": n, "warm": 1},
           "route": "each phase eager with a sync at its seam (anatomy), "
                    "against the step's one graph replay",
           "anatomy_steps": anat["steps"],
           "replay_wall_ms": [r["wall_ms"] for r in plain["steps"]],
           "anatomy_ms_median": float(np.median(
               [r["wall_ms"] for r in anat["steps"][tail]])),
           "one_replay_ms_median": float(np.median(
               [r["wall_ms"] for r in plain["steps"][tail]])),
           "grad_ms_median": float(np.median(
               [r["grad_ms"] for r in anat["steps"]])),
           "update_ms_median": float(np.median(
               [r["update_ms"] for r in anat["steps"]])),
           "mfu_gauge": anat["steps"][-1]["mfu"],
           "mfu_note": "znicz_anatomy_mfu{plane=fused}: 3 x the conv and FC "
                       "forward flops over the step wall against 989 "
                       "TFLOP/s (the bf16 peak; this step runs f32)",
           "flops_per_step": anat["flops_per_step"],
           "launches": {"anatomy": anat["launches"],
                        "one_replay": plain["launches"], "expect": expect},
           "graphs": {"anatomy": anat["graphs"], "one_replay":
                      plain["graphs"]},
           "weights_max_abs_diff": diff}
    bad = []
    for r in anat["steps"]:
        if r["steps"] != 1 or not r["grad_ms"] > 0 or not r["update_ms"] > 0:
            bad.append(f"an anatomy step without its phases: {r}")
        if abs(r["phase_sum_ms"] - r["step_ms"]) > OPS_RECONCILE * \
                r["step_ms"]:
            bad.append(f"phase sum {r['phase_sum_ms']} vs step wall "
                       f"{r['step_ms']} ms")
    if anat["launches"] != expect or plain["launches"] != expect:
        bad.append(f"alexnet anatomy launches {out['launches']}")
    if any(v != 0.0 for v in diff.values()):
        bad.append(f"anatomy weights differ from the replayed steps' {diff}")
    if not out["mfu_gauge"] > 0:
        bad.append(f"no MFU gauge: {out['mfu_gauge']}")
    return out, bad


def _ops_lm() -> tuple:
    """(b): the LM step at ``train``'s width in f32, the plain graphed
    step and then its anatomy form from the same params, 3 steps each,
    the flash counters set to 0 just before each and read just after."""
    params = init_params(np.random.default_rng(SEED), N_LAYERS, D, HEADS,
                         FF, VOCAB)
    tokens, labels = _train_batch(SEED, TRAIN_B, TRAIN_T)
    runs = {}
    with _strict_f32():
        for anatomy in (False, True):
            step = make_train_step(None, N_LAYERS, D, HEADS, FF, VOCAB,
                                   lr=TRAIN_LR, loss_chunks=TRAIN_CHUNKS,
                                   compute_dtype=torch.float32,
                                   anatomy=anatomy, device=DEVICE)
            ps = params_from_numpy(params, DEVICE)
            torch.cuda.synchronize()
            kflash.fwd_launches = kflash.bwd_launches = 0   # 0 before ...
            losses, steps = [], []
            for _ in range(OPS_LM_STEPS):
                before = _anatomy_reading("transformer")
                t0 = time.perf_counter()
                ps, loss = step(ps, tokens, labels)
                losses.append(float(loss))
                wall_ms = (time.perf_counter() - t0) * 1e3
                steps.append({"wall_ms": wall_ms, **_anatomy_step_ms(
                    before, _anatomy_reading("transformer"))})
            runs[anatomy] = {"losses": losses, "steps": steps,
                             "flash": {"fwd": kflash.fwd_launches,
                                       "bwd": kflash.bwd_launches}}
            del step, ps
            gc.collect()
            torch.cuda.empty_cache()
    anat, plain = runs[True], runs[False]
    expect = {"fwd": N_LAYERS * OPS_LM_STEPS, "bwd": N_LAYERS * OPS_LM_STEPS}
    rel = [abs(a - b) / abs(b) for a, b in zip(anat["losses"],
                                                plain["losses"])]
    out = {"config": {"layers": N_LAYERS, "d": D, "heads": HEADS, "ff": FF,
                      "vocab": VOCAB, "batch": TRAIN_B, "t": TRAIN_T,
                      "loss_chunks": TRAIN_CHUNKS, "precision": "f32",
                      "steps": OPS_LM_STEPS},
           "losses": {"anatomy": anat["losses"], "plain": plain["losses"]},
           "loss_rel_diff": rel, "rtol": OPS_LM_RTOL,
           "anatomy_steps": anat["steps"],
           "plain_wall_ms": [r["wall_ms"] for r in plain["steps"]],
           "mfu_gauge": anat["steps"][-1]["mfu"],
           "mfu_note": "znicz_anatomy_mfu{plane=transformer}: 6 x matmul "
                       "params x tokens over the step wall against 989 "
                       "TFLOP/s",
           "flash": {"anatomy": anat["flash"], "plain": plain["flash"],
                     "expect": expect}}
    bad = []
    if anat["flash"] != expect:
        bad.append(f"LM anatomy flash launches {anat['flash']}, want "
                   f"{expect}")
    if not all(np.isfinite(anat["losses"])) or max(rel) > OPS_LM_RTOL:
        bad.append(f"LM anatomy losses {anat['losses']} vs plain "
                   f"{plain['losses']}")
    for r in anat["steps"]:
        if abs(r["phase_sum_ms"] - r["step_ms"]) > OPS_RECONCILE * \
                r["step_ms"] or not r["grad_ms"] > 0:
            bad.append(f"LM anatomy step {r}")
    return out, bad


def _ops_cli_start(tmp: str) -> dict:
    """(c): the MNIST FC workflow file, eager and fused, each through
    ``python -m znicz_tpu_torch --profile DIR`` with no ``-d``, both
    started at once, each in its own process."""
    wf = os.path.join(tmp, "ops_mnist_fc.py")
    with open(wf, "w") as f:
        f.write(OPS_FC_WORKFLOW)
    repo = os.path.dirname(os.path.abspath(__file__))
    clis = {"t0": time.perf_counter()}
    for mode in OPS_PROFILED:
        cli = clis[mode] = {"prof": os.path.join(tmp, f"prof_{mode}"),
                            "result": os.path.join(tmp, f"ops_{mode}.json")}
        cli["proc"] = subprocess.Popen(
            [sys.executable, "-m", "znicz_tpu_torch", wf, "--profile",
             cli["prof"], "-o",
             f"root.ops_profile.result_file={cli['result']}",
             "-o", f"root.ops_profile.fused={mode == 'fused'}",
             "-o", f"root.ops_profile.layers={list(FC_LAYERS)}",
             "-o", f"root.ops_profile.batch={FC_BATCH}",
             "-o", f"root.ops_profile.n_train={OPS_FC_TRAIN}",
             "-o", f"root.ops_profile.n_valid={OPS_FC_VALID}"],
            cwd=repo, env={**os.environ, "PYTHONPATH": repo,
                           "ZNICZ_TPU_SITE_CONFIG": ""},
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return clis


def _ops_cli_result(clis: dict) -> tuple:
    """(c)'s gates, each run: exit 0, the trace's kernels of its path
    named as many times as the counters grew over the run, the trace
    against itself all zeros."""
    out, bad = {}, []
    for mode, names in OPS_PROFILED.items():
        cli = clis[mode]
        log = cli["proc"].communicate(timeout=OPS_CLI_TIMEOUT)[0]
        run = out[mode] = {"rc": cli["proc"].returncode,
                           "seconds": time.perf_counter() - clis["t0"]}
        if run["rc"] != 0:
            bad.append(f"--profile {mode} CLI exited {run['rc']}: "
                       f"{log[-3000:]}")
            continue
        with open(cli["result"]) as f:
            res = json.load(f)
        counted = {k: res["at_end"][k] - res["at_run"][k]
                   for k in res["at_end"]}
        rows = tprofiling.summarize_trace(cli["prof"], top=None)
        traced = {k: sum(r["count"] for r in rows if key in r["op"])
                  for k, key in OPS_TRACE_KEYS.items()}
        deltas = tprofiling.compare_traces(cli["prof"], cli["prof"])
        run.update(counted=counted, traced=traced,
                   top=[{**r, "op": r["op"][:80]} for r in rows[:6]],
                   families=sorted({r["category"] for r in deltas}),
                   self_deltas=sorted({r["delta_ms"] for r in deltas}),
                   history=res["history"])
        if traced != counted or not all(counted[n] for n in names):
            bad.append(f"--profile {mode} trace counts {traced} vs "
                       f"counters {counted}")
        if run["self_deltas"] != [0.0]:
            bad.append(f"compare_traces of a trace with itself: {deltas}")
    return out, bad


def _ops_health() -> tuple:
    """(d): HealthGuard(mode="skip") on fused MNIST FC at full width in
    f32 with a NaN at the third ``step.loss`` publish."""
    from znicz_tpu_torch.units import nn_rollback

    hyper = {"learning_rate": 0.01, "gradient_moment": 0.9}
    layers = [{"type": "all2all_tanh", "->": {"output_sample_shape": n},
               "<-": dict(hyper)} for n in FC_LAYERS] + [
        {"type": "softmax", "->": {"output_sample_shape": FC_CLASSES},
         "<-": dict(hyper)}]
    tprng.seed_all(SEED)
    with _strict_f32():
        w = StandardWorkflow(
            name="OpsHealth", layers=layers, loss_function="softmax",
            loader_name="synthetic_classifier",
            loader_config={"n_classes": FC_CLASSES, "sample_shape": (28, 28),
                           "n_train": FC_BATCH * OPS_HEALTH_MB, "n_valid": 0,
                           "minibatch_size": FC_BATCH},
            decision_config={"max_epochs": OPS_HEALTH_EPOCHS},
            health_config={"mode": "skip"})
        w.initialize(device=TorchDevice(DEVICE, precision="float32"))
        step = w.step
        ptrs = [t.data_ptr() for leaf in step._params for t in leaf.values()]
        seen = {}
        real = nn_rollback.restore_params

        def restore(workflow, stored):
            real(workflow, stored)
            seen["graphs"] = {k: id(g) for k, g in step._graphs.items()}
            seen["replays"] = replays_of(step)
            seen["equal"] = all(
                np.array_equal(leaf[k].cpu().numpy(),
                               stored[f"forward.{i}.{name}"])
                for i, leaf in enumerate(step._params)
                for k, name in (("w", "weights"), ("b", "bias")))
            seen["ptrs"] = [t.data_ptr() for leaf in step._params
                            for t in leaf.values()]
            seen["restored"] = {k: v.copy() for k, v in stored.items()}

        nn_rollback.restore_params = restore
        plan = tfaults.FaultPlan().nan_at("step.loss",
                                          at_hit=OPS_HEALTH_NAN_AT)
        try:
            with tfaults.active(plan):
                w.run()
        finally:
            nn_rollback.restore_params = real
        step.sync_to_units()
        end = {f"forward.{i}.{a}": getattr(f, a).map_read().copy()
               for i, f in enumerate(w.forwards) for a in ("weights",
                                                           "bias")}
    guard = w.health_guard
    graphs_end = {k: id(g) for k, g in step._graphs.items()}
    replays_end = replays_of(step)
    moved = seen and all(not np.array_equal(end[k], seen["restored"][k])
                         for k in end)
    out = {"config": {"layers": [FC_IN, *FC_LAYERS, FC_CLASSES],
                      "batch": FC_BATCH, "minibatches": OPS_HEALTH_MB,
                      "epochs": OPS_HEALTH_EPOCHS,
                      "nan_at_publish": OPS_HEALTH_NAN_AT},
           "guard": guard.snapshot(), "fired": bool(plan.log),
           "restored_equal": seen.get("equal"),
           "same_tensors": seen.get("ptrs") == ptrs and [
               t.data_ptr() for leaf in step._params
               for t in leaf.values()] == ptrs,
           "recaptured": graphs_end != seen.get("graphs"),
           "replays_at_restore": seen.get("replays"),
           "replays_end": replays_end, "trained_after": bool(moved),
           "finite": all(np.isfinite(v).all() for v in end.values()),
           "history": w.decision.metrics_history}
    bad = []
    if not (out["fired"] and guard.nan_trips == 1 and
            guard.skipped_batches == 1):
        bad.append(f"health guard: {out['guard']}")
    if not (out["restored_equal"] and out["same_tensors"]) or \
            out["recaptured"] or not out["trained_after"] or \
            not out["finite"]:
        bad.append(f"health restore: {out}")
    if not replays_end.get("train", 0) > (seen.get("replays") or {}).get(
            "train", 0):
        bad.append(f"no replay after the restore: {seen.get('replays')} -> "
                   f"{replays_end}")
    del w, step
    gc.collect()
    torch.cuda.empty_cache()
    return out, bad


def _ops_elastic_start(tmp: str) -> dict:
    """(e): two supervisors at once, each ``python -m znicz_tpu_torch
    elastic --workers 1`` over the drill workflow with no ``-d``: one
    uninterrupted, one whose worker a seeded plan SIGKILLs."""
    repo = os.path.dirname(os.path.abspath(__file__))
    wf = os.path.join(repo, "znicz_tpu_torch", "models", "elastic_drill.py")
    plan = tfaults.FaultPlan(seed=1234).kill_at(
        "elastic.worker", at_hit=OPS_KILL_AT_HIT).to_env()
    env = {**os.environ, "PYTHONPATH": repo, "ZNICZ_TPU_SITE_CONFIG": "",
           "ZNICZ_TPU_ELASTIC_EPOCHS": str(OPS_DRILL_EPOCHS)}
    runs = {"t0": time.perf_counter()}
    for name, extra in (("base", []), ("drill", ["--fault-plan",
                                                 f"0={plan}"])):
        snap = os.path.join(tmp, name)
        runs[name] = {"snap": snap, "proc": subprocess.Popen(
            [sys.executable, "-m", "znicz_tpu_torch", "elastic",
             "--workers", "1", "--snap-dir", snap, "--max-restarts", "2",
             "--term-grace", "30", *extra, wf],
            cwd=repo, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)}
    return runs


def _ops_elastic_result(runs: dict) -> tuple:
    """(e)'s gates."""
    out, bad, hist = {}, [], {}
    repo = os.path.dirname(os.path.abspath(__file__))
    for name in ("base", "drill"):
        proc = runs[name]["proc"]
        stdout, stderr = proc.communicate(timeout=OPS_CLI_TIMEOUT)
        out[name] = {"rc": proc.returncode,
                     "seconds": time.perf_counter() - runs["t0"]}
        if proc.returncode != 0:
            bad.append(f"elastic {name} exited {proc.returncode}: "
                       f"{stderr[-3000:]}")
            continue
        report = json.loads(stdout.strip().splitlines()[-1])
        out[name].update({k: report[k] for k in (
            "completed", "restarts", "world_size", "flights",
            "resumed_from")})
        out[name]["deaths"] = [{k: d[k] for k in ("rank", "code", "cause")}
                               for d in report["worker_deaths"]]
        with open(os.path.join(runs[name]["snap"], "history_0.json")) as f:
            hist[name] = json.load(f)["history"]
    if bad:
        return out, bad
    drill = out["drill"]
    out["history"] = hist["base"]
    out["identical"] = hist["drill"] == hist["base"]
    if not (out["base"]["completed"] and out["base"]["restarts"] == 0):
        bad.append(f"uninterrupted elastic run: {out['base']}")
    if not (drill["completed"] and drill["restarts"] == 1 and
            any(d["code"] == -9 for d in drill["deaths"]) and
            len(drill["resumed_from"]) == 1 and len(drill["flights"]) == 1):
        bad.append(f"elastic drill: {drill}")
    if not out["identical"]:
        bad.append(f"resumed history {hist['drill']} vs {hist['base']}")
    if drill["flights"]:
        shown = subprocess.run(
            [sys.executable, "-m", "znicz_tpu_torch", "flight",
             drill["flights"][0]], cwd=repo, capture_output=True, text=True,
            env={**os.environ, "PYTHONPATH": repo}, timeout=OPS_CLI_TIMEOUT)
        out["flight_rc"] = shown.returncode
        out["flight_head"] = shown.stdout.splitlines()[:2]
        if shown.returncode != 0 or \
                "flight: elastic_restart" not in shown.stdout:
            bad.append(f"flight viewer: {shown.returncode} {shown.stdout} "
                       f"{shown.stderr[-2000:]}")
    path = os.path.join(runs["drill"]["snap"], "elastic",
                        "metrics_r1_w0.json")
    try:
        with open(path) as f:
            exported = json.load(f)
        families = tfederation.parse_prometheus(exported["prom"])
        out["metrics_export"] = {"rank": exported["rank"],
                                 "families": len(families)}
        if exported["rank"] != 0 or not families:
            bad.append(f"metrics export {out['metrics_export']}")
    except (OSError, ValueError, KeyError) as exc:
        bad.append(f"metrics export {path}: {exc!r}")
    return out, bad


def phase_operations() -> dict:
    """The operational planes on the card (``--phase operations``): the
    subprocess parts (c) and (e) start first and run beside (d), which
    times nothing; (a) and (b), which time steps, run after they ended.
    Every part runs before the first failure is raised."""
    t0 = time.perf_counter()
    out, bad = {"phase": "operations"}, []
    with tempfile.TemporaryDirectory() as tmp:
        cli = _ops_cli_start(tmp)
        elastic = _ops_elastic_start(tmp)
        try:
            t1 = time.perf_counter()
            out["health"], b = _ops_health()
            out["health_s"] = time.perf_counter() - t1
            bad += b
            out["profile_cli"], b = _ops_cli_result(cli)
            bad += b
            out["elastic"], b = _ops_elastic_result(elastic)
            bad += b
        finally:
            # no process of this phase outlives it
            for proc in (cli["eager"]["proc"], cli["fused"]["proc"],
                         elastic["base"]["proc"],
                         elastic["drill"]["proc"]):
                if proc.poll() is None:
                    proc.kill()
                    proc.communicate()
        out["subprocess_parts_s"] = time.perf_counter() - t0
    for key, part in (("alexnet_anatomy", _ops_alexnet),
                      ("lm_anatomy", _ops_lm)):
        t1 = time.perf_counter()
        out[key], b = part()
        out[key + "_s"] = time.perf_counter() - t1
        bad += b
    out["card"] = nvidia_smi()
    out["seconds"] = time.perf_counter() - t0
    if bad:
        fail(f"operations: {bad}: {json.dumps(out, default=str)[:6000]}")
    return out


#: fleet_learn (a): packages A and B are the serve phase's LM from two
#: seeds, served by FL_WORKERS spawned ``generate --serve`` workers with
#: the serve phase's slots, max len and page size, in bf16; FL_CLIENTS
#: client threads stream FL_TOKENS-token greedy requests of 4–40 ids
#: from the start; the rollout is posted once FL_WARM requests have
#: completed, and the clients stop FL_TAIL completions after it reports
#: done.  The victim (the second worker) is SIGKILLed at its
#: FL_KILL_AT_HIT-th decode step: the traffic before the rollout gives
#: it far fewer (FL_WARM requests of FL_TOKENS tokens, shared), the
#: rollout's drain of the first worker sends it all traffic, and at
#: ~17 steps a wave of FL_CLIENTS requests it reaches the hit within
#: seconds, inside the first replacement's boot
FL_SEEDS = (SEED + 301, SEED + 302)
FL_WORKERS, FL_CLIENTS, FL_TOKENS = 2, 4, 16
FL_WARM, FL_TAIL, FL_KILL_AT_HIT = 4, 8, 150
#: (b): prompt lengths routed, one at a time, to the adopted in-process
#: worker (then decoded directly by its batcher, one at a time)
FL_B_LENS = (17, 130, 511, 33)
#: (c): the learn loop over the char corpus's vocabulary at
#: bench_transformer's block widths: the trainer's window, minibatch,
#: records an epoch, epochs, publish cadence, plain-SGD learning rate
#: (char_lm's) and pipeline depth; the traffic's prompts (4 characters)
#: and new tokens: 4 + 61 = 65 ids, two windows of FL_SEQ + 1 a record,
#: so an epoch of FL_RECORDS records is 16 windows, 2 minibatches
FL_SEQ, FL_MB, FL_RECORDS, FL_EPOCHS, FL_EVERY = 32, 8, 8, 2, 2
FL_LR, FL_DEPTH, FL_C_CLIENTS = 1e-3, 2, 3
FL_C_PROMPTS, FL_C_TOKENS = ("1\tw0", "0\tw1", "1\tw2", "0\tw3"), 61
#: every wait of the phase (readiness, a rollout, the trainer)
FL_TIMEOUT = 300


def _fl_env() -> dict:
    repo = os.path.dirname(os.path.abspath(__file__))
    return {**os.environ, "PYTHONPATH": repo, "ZNICZ_TPU_SITE_CONFIG": ""}


def _fl_packages(tmp: str, pool) -> dict:
    """Packages A and B (the serve phase's LM from two seeds) and C (the
    char LM at bench_transformer's blocks over the corpus vocabulary),
    each written on a thread of ``pool`` (zlib's deflate releases the
    GIL): name -> future of its path, and the vocabulary."""
    _, vocab = _char_corpus(os.path.join(tmp, "corpus"))

    def export(name, seed, vocab_size, charmap):
        return export_lm(
            init_params(np.random.default_rng(seed), N_LAYERS, D, HEADS,
                        FF, vocab_size),
            os.path.join(tmp, f"lm_{name}.npz"), heads=HEADS,
            charmap=charmap, name=name)

    return {"a": pool.submit(export, "a", FL_SEEDS[0], VOCAB, None),
            "c": pool.submit(export, "c", SEED + 303, len(vocab), vocab),
            "b": pool.submit(export, "b", FL_SEEDS[1], VOCAB, None),
            "vocab": vocab}


def _fl_worker_args(*extra: str) -> list:
    return ["--slots", str(SLOTS), "--max-len", str(MAX_LEN),
            "--page-size", str(PAGE), "--device", DEVICE, *extra]


def _fl_client(base, body_of, stop, results, lock, cid) -> None:
    """Stream requests through the router until ``stop``: each outcome
    recorded — completed, errored (one terminal error line), rejected
    (503: never admitted), bad_terminal or broken (a lost request)."""
    rng = np.random.default_rng(SEED + 310 + cid)
    while not stop.is_set():
        req = urllib.request.Request(
            base + "/generate", data=json.dumps(body_of(rng)).encode(),
            headers={"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(req, timeout=FL_TIMEOUT) as r:
                lines = [json.loads(raw) for raw in r]
        except urllib.error.HTTPError as exc:
            exc.read()
            with lock:
                results.append(("rejected", exc.code))
            stop.wait(0.1)
            continue
        except Exception as exc:  # noqa: BLE001 — a lost request
            with lock:
                results.append(("broken", repr(exc)))
            continue
        terminals = [ln for ln in lines if ln.get("done")]
        with lock:
            if len(terminals) != 1 or lines[-1] is not terminals[0]:
                results.append(("bad_terminal", lines[-3:]))
            elif "error" in terminals[0]:
                results.append(("errored", terminals[0]["error"]))
            else:
                results.append(("completed", len(lines) - 1))


def _fl_kinds(results, lock) -> dict:
    with lock:
        return dict(collections.Counter(k for k, _ in results))


def _fl_wait(pred, what: str, timeout: float = FL_TIMEOUT) -> None:
    deadline = time.monotonic() + timeout
    while not pred():
        if time.monotonic() > deadline:
            fail(f"fleet_learn: timed out waiting for {what}")
        time.sleep(0.1)


def _fl_worker_stats(pool) -> list:
    """Each live worker's rank, package sha256 and decoder counters."""
    out = []
    for w in pool.workers():
        doc = json.loads(urllib.request.urlopen(
            w.base + "/metrics", timeout=30).read())["decoder"]
        out.append({"rank": w.rank, "sha256": (w.fingerprint or {}).get(
            "sha256", "")[:12], **{k: doc[k] for k in (
                "compile_count", "decode_steps", "prefill_count")}})
    return out


def _fl_steady(pool, warm_count: int) -> tuple:
    """Every live worker, after its share of the traffic: 3 more
    requests sent to it directly move its decode steps and leave its
    count of first-run shapes at the warmup's."""
    before = _fl_worker_stats(pool)
    for w in pool.workers():
        for n in (5, 60, 300):
            _stream(int(w.base.rsplit(":", 1)[1]),
                    [i % VOCAB for i in range(1, n + 1)], {}, FL_TOKENS)
    after = _fl_worker_stats(pool)
    bad = [f"worker {a['rank']}: {b} -> {a} (warmup {warm_count})"
           for b, a in zip(before, after)
           if not (a["compile_count"] == b["compile_count"] == warm_count
                   and a["decode_steps"] > b["decode_steps"] > 0)]
    return {"before": before, "after": after}, bad


def _fl_adopted(pkg: str, tmp: str) -> tuple:
    """(b): a GenerateServer in this process on a PagedKVDecoder, adopted
    into a pool (``WorkerPool.adopt``) behind a router; FL_B_LENS prompts
    routed one at a time with the launch counter set to 0 just before
    and read just after, then decoded by its batcher directly."""
    from znicz_tpu_torch.fleet import FleetRouter, WorkerPool

    params, meta = load_lm(pkg)
    server = start_generate_server(serve_args(pkg), params, meta)
    dec = server.decoder
    warm_count = dec.compile_count
    pool = WorkerPool(pkg, plane="generate",
                      run_dir=os.path.join(tmp, "fleet_b"))
    router = FleetRouter(pool)
    rng = np.random.default_rng(SEED + 320)
    prompts = [rng.integers(0, VOCAB, n).tolist() for n in FL_B_LENS]
    try:
        worker = pool.adopt(f"http://127.0.0.1:{server.port}")
        if not pool.wait_ready(worker, timeout_s=60):
            fail("fleet_learn (b): the adopted worker never read ready")
        port = router.start()
        steps0 = dec.decode_steps
        TRACER.clear()
        kdecode.launches = 0                     # 0 just before ...
        routed = []
        for ids in prompts:
            res = {}
            _stream(port, ids, res, FL_TOKENS)
            routed.append(res)
        launches = kdecode.launches              # ... and read after
        steps = dec.decode_steps - steps0
        step_ms = [e["dur"] / 1e3 for e in TRACER.tail(len(TRACER))
                   if e["name"] == "generate.decode_step"]
        ledger = router.snapshot()
        direct = [server.batcher.submit(
            ids, max_new_tokens=FL_TOKENS, temperature=0.0).result(
                timeout_s=FL_TIMEOUT) for ids in prompts]
    finally:
        router.stop()
        pool.stop()
        server.stop()
    streams = [[e["token"] for e in r.get("events", []) if "token" in e]
               for r in routed]
    out = {"prompt_lens": list(FL_B_LENS), "decode_steps": steps,
           "launches": launches, "warmup_count": warm_count,
           "decode_step_ms_p50": float(np.median(step_ms)),
           "decode_step_ms_max": float(np.max(step_ms)),
           "compile_count": dec.compile_count, "ledger": ledger,
           "streams_equal": streams == direct,
           "first_stream": streams[0][:8]}
    bad = []
    if not steps or launches != N_LAYERS * steps:
        bad.append(f"(b) paged_decode launched {launches} times over "
                   f"{steps} decode steps x {N_LAYERS} layers")
    if streams != direct or any(len(s) != FL_TOKENS for s in streams):
        bad.append(f"(b) routed streams {streams} != direct {direct}")
    if dec.compile_count != warm_count or \
            ledger["completed"] != len(prompts):
        bad.append(f"(b) count {warm_count} -> {dec.compile_count}, "
                   f"ledger {ledger}")
    return out, bad, warm_count


def _fl_spawn(pkg: str, tmp: str, name: str, worker_args: list,
              victim_plan=None):
    """A pool of FL_WORKERS spawned ``generate --serve`` workers, not
    waited for; the last one carries ``victim_plan`` in its env."""
    from znicz_tpu_torch.fleet import WorkerPool

    pool = WorkerPool(pkg, plane="generate", worker_args=worker_args,
                      env=_fl_env(), run_dir=os.path.join(tmp, name),
                      probe_interval_s=0.25, ready_timeout_s=FL_TIMEOUT)
    for i in range(FL_WORKERS):
        extra = {tfaults.PLAN_ENV_VAR: victim_plan} \
            if victim_plan and i == FL_WORKERS - 1 else None
        pool.spawn(env_extra=extra)
    return pool


def _fl_ledger_closed(router) -> bool:
    s = router.snapshot()
    return s["admitted"] == s["completed"] + s["failed"] + s["client_gone"]


def _fl_rollout(pool, pkg_b: str, warm_count: int) -> tuple:
    """(a): the fleet under traffic, the rollout of B posted to the
    router, the victim's seeded kill inside it."""
    from znicz_tpu_torch.fleet import FleetRouter, RollingUpdate
    from znicz_tpu_torch.utils.naming import package_fingerprint

    t0 = time.perf_counter()
    if not pool.wait_all_ready(timeout_s=FL_TIMEOUT):
        fail(f"fleet_learn (a): workers never ready: {pool.snapshot()}")
    ready_s = time.perf_counter() - t0
    pool.start_probes()
    router = FleetRouter(pool, max_retries=2)
    router.attach_rollout(RollingUpdate(pool,
                                        converge_timeout_s=FL_TIMEOUT))
    port = router.start()
    base = f"http://127.0.0.1:{port}"
    results, lock, stop = [], threading.Lock(), threading.Event()

    def body(rng):
        return {"tokens": rng.integers(0, VOCAB, int(rng.integers(
            4, 40))).tolist(), "max_tokens": FL_TOKENS,
            "temperature": 0.0, "timeout_s": FL_TIMEOUT}

    threads = [threading.Thread(target=_fl_client, args=(
        base, body, stop, results, lock, c), daemon=True)
        for c in range(FL_CLIENTS)]
    for t in threads:
        t.start()
    try:
        _fl_wait(lambda: _fl_kinds(results, lock).get("completed", 0)
                 >= FL_WARM, "(a) the warm requests")
        warm = _fl_kinds(results, lock)
        t1 = time.perf_counter()
        replaced_before = pool.replacements
        posted = _post_json(base + "/rollout", {"package": pkg_b})
        state = {}

        def rolled():
            state.update(json.loads(urllib.request.urlopen(
                base + "/rollout", timeout=30).read()))
            return state["state"] in ("done", "failed")
        _fl_wait(rolled, "(a) the rollout")
        rollout_s = time.perf_counter() - t1
        done_at = _fl_kinds(results, lock).get("completed", 0)
        _fl_wait(lambda: _fl_kinds(results, lock).get("completed", 0)
                 >= done_at + FL_TAIL, "(a) the post-rollout tail")
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=FL_TIMEOUT)
    _fl_wait(lambda: _fl_ledger_closed(router), "(a) the ledger")
    kinds = _fl_kinds(results, lock)
    fp_b = package_fingerprint(pkg_b)["sha256"]
    pool.probe_once()
    shas = sorted({(w.fingerprint or {}).get("sha256", "")
                   for w in pool.workers()})
    steady, bad = _fl_steady(pool, warm_count)
    out = {"ready_s": ready_s, "posted": posted.get("started"),
           "rollout_s": rollout_s, "rollout": {
               k: state.get(k) for k in ("state", "adopted", "duration_s",
                                         "error")},
           "steps": [s["outcome"] for s in state.get("steps", [])],
           "replacements": pool.replacements,
           "replacements_before_rollout": replaced_before, "warm": warm,
           "traffic": kinds, "ledger": router.snapshot(),
           "converged_on_b": shas == [fp_b], "workers": steady}
    router.stop()
    if state.get("state") != "done":
        bad.append(f"(a) rollout {state}")
    if kinds.get("broken") or kinds.get("bad_terminal") or \
            kinds.get("completed", 0) < FL_WARM + FL_TAIL:
        bad.append(f"(a) traffic {kinds}: "
                   f"{[r for r in results if r[0] != 'completed'][:4]}")
    if not _fl_ledger_closed(router):
        bad.append(f"(a) the router's ledger {out['ledger']}")
    if shas != [fp_b]:
        bad.append(f"(a) fleet on {shas}, not B's {fp_b[:12]}")
    # the kill lands inside the rollout: on the victim before its turn
    # (replaced by the probe loop on B) or while it drains (reaped)
    if replaced_before or not (pool.replacements >= 1 or
                               "killed" in out["steps"]):
        bad.append(f"(a) the seeded kill did not land inside the "
                   f"rollout: replacements {replaced_before} -> "
                   f"{pool.replacements}, steps {out['steps']}")
    return out, bad


def _fl_expected_minibatches(spool: str, vocab: list) -> int:
    """The train minibatches the trainer ran: its loader's epochs
    replayed over the spool it read (the same records from the same
    cursor: the spool's append order is fixed)."""
    from znicz_tpu_torch.learn.spool import initial_cursor
    from znicz_tpu_torch.loader.spool import SpoolSequenceLoader

    ld = SpoolSequenceLoader(None, spool_dir=spool, charmap=vocab,
                             seq_len=FL_SEQ, records_per_epoch=FL_RECORDS,
                             minibatch_size=FL_MB, publish_cursor=False)
    ld._cursor = initial_cursor(spool)
    n = 0
    for _ in range(FL_EPOCHS):
        ld._ingest(wait=False)
        n += -(-ld.class_lengths[TRAIN] // FL_MB)
    return n


def _fl_trainer_start(pkg: str, tmp: str, spool: str) -> dict:
    """(c)'s trainer, started as soon as its package exists: run_elastic
    (world 1, ``spmd=False``) over ``learn/trainer_workflow.py`` with
    ``--profile`` on a thread.  It boots beside the workers and waits in
    its first ingest for the spool's records."""
    from znicz_tpu_torch.resilience.elastic import run_elastic
    from znicz_tpu_torch.resilience.supervisor import SupervisorPolicy

    repo = os.path.dirname(os.path.abspath(__file__))
    trainer = {"pub": os.path.join(tmp, "publish"),
               "prof": os.path.join(tmp, "prof"), "box": {},
               "stop": threading.Event(), "t0": time.perf_counter()}
    argv = [os.path.join(repo, "znicz_tpu_torch", "learn",
                         "trainer_workflow.py"),
            "-o", f"root.learn.spool_dir={spool}",
            "-o", f"root.learn.package={pkg}",
            "-o", f"root.learn.publish_dir={trainer['pub']}",
            "-o", f"root.learn.publish_every={FL_EVERY}",
            "-o", f"root.learn.max_epochs={FL_EPOCHS}",
            "-o", f"root.learn.records_per_epoch={FL_RECORDS}",
            "-o", f"root.learn.seq_len={FL_SEQ}",
            "-o", f"root.learn.minibatch_size={FL_MB}",
            "-o", f"root.learn.lr={FL_LR}",
            "-o", f"root.learn.pipeline_depth={FL_DEPTH}",
            "-o", f"root.learn.wait_timeout_s={FL_TIMEOUT}",
            "--random-seed", str(SEED % 997), "-d", DEVICE,
            "--profile", trainer["prof"]]

    def train():
        try:
            trainer["box"]["report"] = run_elastic(
                argv, os.path.join(tmp, "snaps"), workers=1, spmd=False,
                env=_fl_env(), run_dir=os.path.join(tmp, "trainer"),
                policy=SupervisorPolicy(max_restarts=0),
                stop_event=trainer["stop"])
        except Exception as exc:  # noqa: BLE001 — judged in (c)
            trainer["box"]["error"] = exc

    trainer["thread"] = threading.Thread(target=train, daemon=True)
    trainer["thread"].start()
    return trainer


def _fl_learn(pool, trainer: dict, vocab: list, tmp: str,
              spool: str) -> tuple:
    """(c): the learn loop built from the API as ``learn --smoke-test``
    builds it: the fleet's workers append to the spool, the trainer
    (already booting) publishes, the bridge adopts."""
    from znicz_tpu_torch.fleet import FleetRouter, RollingUpdate
    from znicz_tpu_torch.learn.bridge import AdoptionBridge
    from znicz_tpu_torch.learn.publish import latest_manifest

    t0 = time.perf_counter()
    if not pool.wait_all_ready(timeout_s=FL_TIMEOUT):
        fail(f"fleet_learn (c): workers never ready: {pool.snapshot()}")
    ready_s = time.perf_counter() - t0
    pool.start_probes()
    router = FleetRouter(pool)
    rollout = RollingUpdate(pool, converge_timeout_s=FL_TIMEOUT)
    router.attach_rollout(rollout)
    base = f"http://127.0.0.1:{router.start()}"
    pub, prof, box = trainer["pub"], trainer["prof"], trainer["box"]
    bridge = AdoptionBridge(pub, pool, rollout, poll_s=0.25,
                            rollout_timeout_s=FL_TIMEOUT)
    pool.aggregator.register_status_provider("learn", bridge.status)
    bridge.start()
    results, lock, stop = [], threading.Lock(), threading.Event()

    def body(rng):
        return {"prompt": FL_C_PROMPTS[int(rng.integers(len(
            FL_C_PROMPTS)))], "max_tokens": FL_C_TOKENS,
            "temperature": 0.0, "timeout_s": FL_TIMEOUT}

    threads = [threading.Thread(target=_fl_client, args=(
        base, body, stop, results, lock, 10 + c), daemon=True)
        for c in range(FL_C_CLIENTS)]
    for t in threads:
        t.start()
    try:
        def adopted():
            if "error" in box:
                fail(f"fleet_learn (c): the trainer failed: "
                     f"{box['error']!r}")
            doc = latest_manifest(pub)
            return "report" in box and doc is not None and \
                bridge.adoptions >= 1 and not rollout.rolling and \
                (pool.expected_fingerprint or {}).get("sha256") == \
                doc["fingerprint"]["sha256"]
        _fl_wait(adopted, "(c) the trainer and the adoption")
        loop_s = time.perf_counter() - trainer["t0"]
    finally:
        stop.set()
        trainer["stop"].set()
        for t in threads:
            t.join(timeout=FL_TIMEOUT)
        trainer["thread"].join(timeout=FL_TIMEOUT)
        bridge.stop()
    _fl_wait(lambda: _fl_ledger_closed(router), "(c) the ledger")
    kinds = _fl_kinds(results, lock)
    report = box["report"]
    manifest = latest_manifest(pub)
    pool.probe_once()
    shas = sorted({(w.fingerprint or {}).get("sha256", "")
                   for w in pool.workers()})
    n_mb = _fl_expected_minibatches(spool, vocab)
    rows = tprofiling.summarize_trace(prof, top=None)
    traced = {k: sum(r["count"] for r in rows if re.search(
        rf"\b{REPLAYED_KERNELS[k][2]}", r["op"])) for k in (
            "flash_fwd", "flash_bwd")}
    with open(os.path.join(tmp, "snaps", "history_0.json")) as f:
        history = json.load(f)["history"]
    out = {"ready_s": ready_s, "loop_s": loop_s,
           "trainer": {k: report.as_dict()[k] for k in (
               "completed", "restarts", "world_size")},
           "history": history, "train_minibatches": n_mb,
           "eval_minibatches": 0, "trace": traced,
           "expected": {"flash_fwd": N_LAYERS * n_mb,
                        "flash_bwd": N_LAYERS * n_mb},
           "publishes": manifest and manifest["seq"],
           "adoptions": bridge.adoptions,
           "adoption_latency_s": bridge.last_adoption_s,
           "traffic": kinds, "ledger": router.snapshot(),
           "status": {k: v for k, v in
                      pool.aggregator.status_doc()["package"].items()
                      if k != "fingerprint"}}
    router.stop()
    bad = []
    if not (report.completed and report.restarts == 0):
        bad.append(f"(c) trainer {out['trainer']}")
    if bridge.adoptions < 1 or shas != [manifest["fingerprint"]["sha256"]]:
        bad.append(f"(c) adoptions {bridge.adoptions}, fleet on {shas}")
    if kinds.get("broken") or kinds.get("bad_terminal"):
        bad.append(f"(c) traffic {kinds}")
    if not _fl_ledger_closed(router):
        bad.append(f"(c) the router's ledger {out['ledger']}")
    if not n_mb or traced != out["expected"]:
        bad.append(f"(c) the trainer's trace counts {traced}, its "
                   f"{n_mb} train minibatches imply {out['expected']}")
    return out, bad


def _fl_cli_start(pkg: str, tmp: str) -> subprocess.Popen:
    """(d): ``python -m znicz_tpu_torch fleet <pkg> --smoke-test
    --workers 1 --port 0`` on the card (no device flag: the workers'
    default, cuda), in a session of its own: its worker is its child,
    and the phase's clean-up ends the whole group."""
    repo = os.path.dirname(os.path.abspath(__file__))
    return subprocess.Popen(
        [sys.executable, "-m", "znicz_tpu_torch", "fleet", pkg,
         "--smoke-test", "--workers", "1", "--port", "0", "--run-dir",
         os.path.join(tmp, "fleet_cli")], cwd=repo, env=_fl_env(),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        start_new_session=True)


def _fl_cli_result(proc, t0: float) -> tuple:
    stdout, stderr = proc.communicate(timeout=FL_TIMEOUT)
    out = {"rc": proc.returncode, "seconds": time.perf_counter() - t0}
    try:
        doc = json.loads(stdout.strip().splitlines()[-1])
        out.update(smoke=doc["smoke"], router=doc["router"])
    except (ValueError, IndexError, KeyError):
        doc = {}
    if proc.returncode != 0 or doc.get("smoke") != "ok":
        return out, [f"(d) fleet --smoke-test exited {proc.returncode}: "
                     f"{stdout[-1500:]} {stderr[-3000:]}"]
    return out, []


def phase_fleet_learn() -> dict:
    """The serving fleet and the learn plane on the card (``--phase
    fleet_learn``): the packages are written on threads, and each
    subprocess part starts as soon as its package is there, side by side
    — (d)'s CLI and (a)'s workers on A, (c)'s workers on C — and boots
    while (b) runs in this process on A and B is written; then (c)'s
    loop runs on a thread beside (a).  Every part runs before the first
    failure is raised, and no process of the phase outlives it."""
    from concurrent.futures import ThreadPoolExecutor

    gc.collect()                # the card is shared with the phase's
    torch.cuda.empty_cache()    # processes: hand back the cached blocks
    t0 = time.perf_counter()
    out, bad = {"phase": "fleet_learn"}, []
    pools, cli, trainer = [], None, None
    writers = ThreadPoolExecutor(3, thread_name_prefix="fl-export")
    with tempfile.TemporaryDirectory() as tmp:
        try:
            pk = _fl_packages(tmp, writers)
            pkg_a = pk["a"].result()
            out["package_a_s"] = time.perf_counter() - t0
            t1 = time.perf_counter()
            cli = _fl_cli_start(pkg_a, tmp)
            plan = tfaults.FaultPlan(seed=SEED).kill_at(
                "generate.step", at_hit=FL_KILL_AT_HIT).to_env()
            pool_a = _fl_spawn(pkg_a, tmp, "fleet_a", _fl_worker_args(),
                               victim_plan=plan)
            pools.append(pool_a)
            pkg_c = pk["c"].result()
            spool = os.path.join(tmp, "spool")
            pool_c = _fl_spawn(pkg_c, tmp, "fleet_c", _fl_worker_args(
                "--feedback-spool", spool))
            pools.append(pool_c)
            trainer = _fl_trainer_start(pkg_c, tmp, spool)
            t2 = time.perf_counter()
            out["b_adopted"], b, warm_count = _fl_adopted(pkg_a, tmp)
            out["b_adopted"]["seconds"] = time.perf_counter() - t2
            bad += b
            box = {}

            def learn():
                try:
                    box["out"] = _fl_learn(pool_c, trainer, pk["vocab"],
                                           tmp, spool)
                except Exception as exc:  # noqa: BLE001 — raised below
                    box["error"] = exc

            t3 = time.perf_counter()
            learner = threading.Thread(target=learn, daemon=True)
            learner.start()
            pkg_b = pk["b"].result()
            out["packages_s"] = time.perf_counter() - t0
            out["a_fleet"], b = _fl_rollout(pool_a, pkg_b, warm_count)
            out["a_fleet"]["seconds"] = time.perf_counter() - t3
            bad += b
            learner.join(timeout=3 * FL_TIMEOUT)
            if "error" in box or "out" not in box:
                bad.append(f"(c) {box.get('error')!r}")
            else:
                out["c_learn"], b = box["out"]
                out["c_learn"]["seconds"] = time.perf_counter() - t3
                bad += b
            out["d_cli"], b = _fl_cli_result(cli, t1)
            bad += b
        finally:
            writers.shutdown(wait=True)
            if trainer is not None:     # its worker torn down by
                trainer["stop"].set()   # run_elastic's stop event
                trainer["thread"].join(timeout=FL_TIMEOUT)
            for pool in pools:
                pool.stop(drain=not bad)
            if cli is not None:
                try:                    # the CLI and any worker it left
                    os.killpg(cli.pid, signal.SIGKILL)
                except ProcessLookupError:
                    pass
                cli.communicate()
    out["card"] = nvidia_smi()
    out["seconds"] = time.perf_counter() - t0
    if bad:
        fail(f"fleet_learn: {bad}: {json.dumps(out, default=str)[:6000]}")
    return out


#: services (a): --optimize over an lr Tune at bench_fc's widths (784-
#: 4096-4096-10, batch 1024, the synthetic_classifier loader, bf16
#: velocity) as a fused StandardWorkflow: SV_TRAIN_MB train minibatches
#: and one valid minibatch, one epoch; SV_POP individuals, SV_GENS
#: generations; the Tune's (default, min, max)
SV_TRAIN_MB, SV_POP, SV_GENS = 4, 4, 2
SV_LR = (0.05, 0.001, 0.5)
#: (a): the loader's class spread: bench_fc's 2.5 separates the classes
#: within 4 steps at any of the Tune's rates (every individual scored 0
#: errors on the H100), so the blobs overlap here and the fitness
#: depends on the rate
SV_SPREAD = 0.05
#: bench_fc's fused train step: one SGD launch a leaf, w and b of three
#: layers
SV_SGD_A_STEP = 6
#: (a): the structural Tune, Wine's hidden width (a sequential route at
#: Wine's build() widths), one generation
SV_HIDDEN = (10, 4, 16)
#: (b): --ensemble-train members, over eager Wine at its build() widths
#: for SV_WINE_EPOCHS epochs; the weights held to the zoo's band at the
#: end of epoch ZOO_HELD_EPOCH
SV_MEMBERS, SV_WINE_EPOCHS = 3, 4
#: (b): wine.build's split and batch: train and valid samples, batch
SV_WINE_TRAIN, SV_WINE_VALID, SV_WINE_BATCH = 150, 30, 10
#: (c): the forward package served twice: its first call materializes
#: the shape (the eager run, then the capture's replay), the second
#: replays: three forwards of AlexNet's two LRN layers
SV_LRN_LAUNCHES = 3 * 2
#: (d): fused Wine's epochs; the probe runs at the end of epoch
#: SV_PROBE_EPOCH
SV_STATUS_EPOCHS, SV_PROBE_EPOCH = 3, 2

#: (b): eager Wine as a workflow file; each member writes its weights at
#: the end of epoch ``held_epoch`` to ``out_dir/member_<k>.npz``
SV_ENSEMBLE_WORKFLOW = """
import os

import numpy as np

from znicz_tpu_torch.core.config import root
from znicz_tpu_torch.models import wine


def run(load, main):
    cfg = root.services_ens
    w, _ = load(wine.build, fused=False, max_epochs=cfg.max_epochs)
    held, logged = {}, w.decision.on_epoch_logged

    def on_epoch_logged():
        logged()
        if len(w.decision.metrics_history) == cfg.held_epoch:
            held.update({f"{f.name}.{a}": np.array(getattr(f, a).map_read())
                         for f in w.forwards for a in ("weights", "bias")})
    w.decision.on_epoch_logged = on_epoch_logged
    main()
    k = len(os.listdir(cfg.out_dir))
    np.savez(os.path.join(cfg.out_dir, f"member_{k}.npz"), **held)
"""

#: (d): fused Wine as a workflow file; ``root.services_status.probe(w)``
#: runs at each epoch's end, inside the run
SV_STATUS_WORKFLOW = """
from znicz_tpu_torch.core.config import root
from znicz_tpu_torch.models import wine


def run(load, main):
    w, _ = load(wine.build, max_epochs=root.services_status.max_epochs)
    logged = w.decision.on_epoch_logged

    def on_epoch_logged():
        logged()
        root.services_status.probe(w)
    w.decision.on_epoch_logged = on_epoch_logged
    main()
"""


class _SvModule:
    """A workflow module (``run(load, main)``) over ``build`` whose
    argument ``key`` is ``root.services.<key>``: what ``--optimize``
    drives."""

    def __init__(self, build, key: str, cast) -> None:
        self.build, self.key, self.cast = build, key, cast

    def run(self, load, main):
        value = self.cast(root.services.get(self.key))
        load(self.build, **{self.key: value})
        main()


def _sv_bench_fc(lr: float) -> StandardWorkflow:
    """bench_fc's model (bench.py:303-313) as a fused StandardWorkflow."""
    back = {"learning_rate": lr, "gradient_moment": 0.9}
    return StandardWorkflow(
        name="BenchFC", loss_function="softmax",
        layers=[{"type": "all2all_tanh", "->": {"output_sample_shape": n},
                 "<-": back} for n in FC_LAYERS] +
        [{"type": "softmax", "->": {"output_sample_shape": FC_CLASSES},
          "<-": back}],
        loader_name="synthetic_classifier",
        # the loader draws n // classes samples a class: round up, so
        # the train split holds SV_TRAIN_MB whole minibatches
        loader_config={"n_classes": FC_CLASSES, "sample_shape": (28, 28),
                       "n_train": -(-SV_TRAIN_MB * FC_BATCH // FC_CLASSES) *
                       FC_CLASSES,
                       "n_valid": FC_BATCH, "minibatch_size": FC_BATCH,
                       "spread": SV_SPREAD, "noise": 1.0},
        decision_config={"max_epochs": 1},
        optimizer_config={"state_dtype": "bfloat16"})


#: the gd units' attribute of each column of the step's hyper buffer
SV_GD_ATTRS = {"lr": "learning_rate", "wd": "weights_decay",
               "l1": "l1_vs_l2", "mom": "gradient_moment",
               "lr_b": "learning_rate_bias", "wd_b": "weights_decay_bias",
               "mom_b": "gradient_moment_bias"}


def _sv_sequential(step, rows: list, i: int, args: tuple, metric: str,
                   epochs: int, seed: int) -> float:
    """Individual ``i`` of an evaluator call replayed alone on the same
    step: the call's starting state, its hyperparameters set on the gd
    units (the step's usual buffer write), the generator re-keyed, the
    train steps, one eval step; the state and units restored after."""
    from znicz_tpu_torch.utils.genetics import individual_seed

    saved = [{k: v.clone() for k, v in leaf.items()}
             for leaf in step._params]
    units = [{a: getattr(gd, a) for a in SV_GD_ATTRS.values()}
             for gd in step.gds]
    try:
        for gd, row in zip(step.gds, rows):
            for k, attr in SV_GD_ATTRS.items():
                setattr(gd, attr, float(row[k]))
        step._gen.manual_seed(individual_seed(seed, i))
        xs, ys, ms = (torch.as_tensor(a).to(step._dev) for a in args[1:4])
        for _ in range(epochs):
            step.train_steps(xs, ys, ms)
        ev = (step._local_rows(torch.as_tensor(a).to(step._dev))
              for a in args[4:7])
        return float(step._dispatch("eval", step._eval_step, *ev)[metric])
    finally:
        step.place_params(saved)
        for gd, attrs in zip(step.gds, units):
            for attr, v in attrs.items():
                setattr(gd, attr, v)


def _sv_optimize(launcher) -> tuple:
    """(a): ``optimize`` as ``--optimize`` runs it, over the lr Tune at
    bench_fc's widths: the population route, its SGD launches exact, one
    capture of the train body and one of the eval body for the whole
    population, each individual's fitness equal bit for bit to its
    sequential replay, an lr-0 individual learning nothing; the seconds
    a generation beside the sequential route's on the same workflow;
    then Wine's hidden width, which must route sequentially."""
    from znicz_tpu_torch.core.config import Tune, set_by_path
    from znicz_tpu_torch.utils import genetics as tgenetics

    out, bad, made, calls = {}, [], {}, []
    real = tgenetics.make_population_evaluator

    def recording(step, metric="n_err", epochs=1):
        made.update(step=step, metric=metric, epochs=epochs)
        evaluate = real(step, metric=metric, epochs=epochs)

        def timed(*args):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fits = evaluate(*args)
            calls.append({"args": args, "fits": fits,
                          "s": time.perf_counter() - t0})
            return fits
        return timed

    module = _SvModule(_sv_bench_fc, "lr", float)
    set_by_path(root, "services.lr", Tune(*SV_LR))
    tgenetics.make_population_evaluator = recording
    try:
        koptim.sgd_launches = 0                      # 0 just before ...
        kgemm.gemm_launches = kgemm.act_launches = 0
        t0 = time.perf_counter()
        best = tgenetics.optimize(module, launcher, SV_GENS,
                                  population_size=SV_POP)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {"sgd_update": koptim.sgd_launches,   # ... read after
                    "gemm_fc": kgemm.gemm_launches,
                    "act_backward": kgemm.act_launches}
    finally:
        tgenetics.make_population_evaluator = real
    step, metric, epochs = made["step"], made["metric"], made["epochs"]
    n_steps = SV_POP * SV_GENS * epochs * SV_TRAIN_MB
    expect = {"sgd_update": SV_SGD_A_STEP * n_steps, "gemm_fc": 0,
              "act_backward": 0}
    graphs = [(k[0], g) for k, g in step._graphs.items() if g is not None]
    captures = collections.Counter(kind for kind, _ in graphs)
    replays = {kind: g.replays for kind, g in graphs}
    out["vmapped"] = {
        "best": best, "wall_s": wall, "launches": launches,
        "expect": expect, "captures": dict(captures), "replays": replays,
        "train_minibatches": [int(c["args"][1].shape[0]) for c in calls],
        "evaluator_s_per_generation": [c["s"] for c in calls],
        "fitness": [c["fits"].tolist() for c in calls]}
    if best.get("_evaluator") != "vmapped":
        bad.append(f"--optimize at bench_fc's widths routed "
                   f"{best.get('_evaluator')}")
    if launches != expect or \
            out["vmapped"]["train_minibatches"] != [SV_TRAIN_MB] * SV_GENS:
        bad.append(f"--optimize launches {launches} != {expect} "
                   f"({out['vmapped']['train_minibatches']} minibatches)")
    if dict(captures) != {"steps": 1, "eval": 1} or replays != {
            "steps": n_steps - 1, "eval": SV_POP * SV_GENS - 1}:
        bad.append(f"--optimize captures {dict(captures)}, replays "
                   f"{replays}: not one capture a body for the population")
    # each individual alone, bit for bit, on the same step and graphs
    seed = step._gen.initial_seed()
    mismatched = []
    for g, call in enumerate(calls):
        pop = call["args"][0]
        for i, fit in enumerate(call["fits"]):
            rows = [{k: v[i] for k, v in layer.items()} for layer in pop]
            seq = _sv_sequential(step, rows, i, call["args"], metric,
                                 epochs, seed)
            if np.float32(seq) != np.float32(fit):
                mismatched.append((g, i, seq, float(fit)))
    # an lr-0 individual learns nothing: the untrained step's error
    args = calls[0]["args"]
    ev = [step._local_rows(torch.as_tensor(a).to(step._dev))
          for a in args[4:7]]
    untrained = float(step._dispatch("eval", step._eval_step, *ev)[metric])
    pop0 = [{k: np.full(2, v, np.float32) for k, v in layer.items()}
            for layer in step.hyper_params()]
    for layer in pop0:
        layer["lr"] = layer["lr_b"] = np.float32([0.0, SV_LR[0]])
    lr0 = real(step, metric=metric, epochs=epochs)(pop0, *args[1:]).tolist()
    out["vmapped"].update(sequential_mismatches=mismatched,
                          untrained=untrained, lr0_and_default=lr0)
    if mismatched:
        bad.append(f"population vs sequential replay: {mismatched}")
    if lr0[0] != untrained or lr0[1] == untrained:
        bad.append(f"lr 0 -> {lr0[0]}, untrained {untrained}, default lr "
                   f"-> {lr0[1]}")
    after = collections.Counter(k[0] for k, g in step._graphs.items()
                                if g is not None)
    if len(set(f for c in calls for f in c["fits"].tolist())) < 2:
        bad.append("every individual scored the same: the bit-for-bit "
                   "check compares nothing")
    if after != captures:
        bad.append(f"the replays captured again: {dict(after)}")
    del step, made, calls
    gc.collect()
    # the sequential route on the same workflow: one generation (the
    # search left its last individual's value in root: the Tune again)
    set_by_path(root, "services.lr", Tune(*SV_LR))
    real_try = tgenetics._try_vmapped_evaluator

    def refuse(*_args, **_kw):
        raise tgenetics.NotVmappable("the sequential route, timed")
    tgenetics._try_vmapped_evaluator = refuse
    try:
        t0 = time.perf_counter()
        seq_best = tgenetics.optimize(module, launcher, 1,
                                      population_size=SV_POP)
        torch.cuda.synchronize()
        out["sequential"] = {"best": seq_best,
                             "s_per_generation": time.perf_counter() - t0}
    finally:
        tgenetics._try_vmapped_evaluator = real_try
        del root.services
    gc.collect()
    # a structural Tune: Wine's hidden width routes sequentially
    set_by_path(root, "services.hidden", Tune(*SV_HIDDEN))
    try:
        t0 = time.perf_counter()
        hidden = tgenetics.optimize(_SvModule(twine.build, "hidden", int),
                                    launcher, 1, population_size=SV_POP)
        out["structural"] = {"best": hidden, "s": time.perf_counter() - t0}
    finally:
        del root.services
    if hidden.get("_evaluator") != "sequential":
        bad.append(f"Wine's hidden Tune routed {hidden.get('_evaluator')}")
    gc.collect()
    return out, bad


def _sv_cli(argv: list, cwd: str) -> tuple:
    """``python -m znicz_tpu_torch *argv`` in this process, from ``cwd``
    -> (exit code, stdout, stderr)."""
    from znicz_tpu_torch.__main__ import main as cli_main

    out, err = io.StringIO(), io.StringIO()
    with contextlib.chdir(cwd), contextlib.redirect_stdout(out), \
            contextlib.redirect_stderr(err):
        rc = cli_main(argv)
    return rc, out.getvalue(), err.getvalue()


def _sv_ensemble_run(wf: str, tmp: str, name: str, device_args: list,
                     tf32: bool = False) -> dict:
    """``--ensemble-train SV_MEMBERS`` over eager Wine -> the summary and
    each member's weights at the held epoch."""
    held = os.path.join(tmp, name, "held")
    os.makedirs(held)
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        t0 = time.perf_counter()
        rc, _, err = _sv_cli(
            [wf, "--ensemble-train", str(SV_MEMBERS), "--random-seed",
             str(SEED), "-o", f"root.services_ens.out_dir={held}",
             "-o", f"root.services_ens.max_epochs={SV_WINE_EPOCHS}",
             "-o", f"root.services_ens.held_epoch={ZOO_HELD_EPOCH}",
             *device_args], os.path.join(tmp, name))
        seconds = time.perf_counter() - t0
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = flags
    if rc != 0:
        fail(f"services: --ensemble-train ({name}) exited {rc}: "
             f"{err[-3000:]}")
    with open(os.path.join(tmp, name, "ensemble_wine.json")) as f:
        summary = json.load(f)
    weights = []
    for k in range(SV_MEMBERS):
        with np.load(os.path.join(held, f"member_{k}.npz")) as z:
            weights.append({key: z[key] for key in z.files})
    return {"summary": summary, "held": weights, "s": seconds}


def _sv_ensemble(tmp: str) -> tuple:
    """(b): ``--ensemble-train`` by the CLI on eager Wine on the card,
    gemm_fc and act_backward counted exactly, each member against the
    CPU run in the zoo's band (identical histories, the weights at the
    held epoch within ZOO_WEIGHT_ATOL), which the card's TF32 run must
    fail; then the committee of fused Wine through
    ``Ensemble.test_classification``."""
    from znicz_tpu_torch.utils.ensemble import Ensemble

    wf = os.path.join(tmp, "wine_ensemble.py")
    with open(wf, "w") as f:
        f.write(SV_ENSEMBLE_WORKFLOW)
    bad = []
    kgemm.gemm_launches = kgemm.act_launches = 0     # 0 just before ...
    card = _sv_ensemble_run(wf, tmp, "card", [])
    launches = {"gemm_fc": kgemm.gemm_launches,      # ... read after
                "act_backward": kgemm.act_launches}
    tf32 = _sv_ensemble_run(wf, tmp, "tf32", [], tf32=True)
    cpu = _sv_ensemble_run(wf, tmp, "cpu", ["-d", "cpu"])
    table = zoo_launch_table(twine.build(fused=False))
    epochs = sum(len(m["history"]) for m in card["summary"]["members"])
    expect = {k: epochs * (SV_WINE_TRAIN // SV_WINE_BATCH *
                           table["train"][k] +
                           SV_WINE_VALID // SV_WINE_BATCH * table["eval"][k])
              for k in launches}

    def band(run):
        return {
            "histories_identical": [
                a["history"] == b["history"] for a, b in zip(
                    run["summary"]["members"], cpu["summary"]["members"],
                    strict=True)],
            "held_weight_err": max(
                float(np.abs(a[k] - b[k]).max())
                for a, b in zip(run["held"], cpu["held"], strict=True)
                for k in a)}

    out = {"members": SV_MEMBERS, "epochs": SV_WINE_EPOCHS,
           "launches": launches, "expect": expect,
           "summary": {k: card["summary"][k]
                       for k in ("workflow", "n_members", "best", "mean")},
           "seeds": [m["seed"] for m in card["summary"]["members"]],
           "vs_cpu": band(card), "tf32_vs_cpu": band(tf32),
           "card_s": card["s"], "tf32_s": tf32["s"], "cpu_s": cpu["s"]}

    def within(b):
        return all(b["histories_identical"]) and \
            b["held_weight_err"] <= ZOO_WEIGHT_ATOL
    if launches != expect:
        bad.append(f"--ensemble-train launches {launches} != {expect}")
    if not within(out["vs_cpu"]):
        bad.append(f"--ensemble-train card vs CPU {out['vs_cpu']}")
    if within(out["tf32_vs_cpu"]):
        bad.append(f"the ensemble band passes its TF32 run "
                   f"{out['tf32_vs_cpu']}")
    t0 = time.perf_counter()
    ens = Ensemble(twine.build, n_members=SV_MEMBERS,
                   base_seed=SEED).train(TorchDevice())
    out["committee"] = {**ens.test_classification(),
                        "s": time.perf_counter() - t0}
    c = out["committee"]
    if c["n"] != SV_WINE_VALID or \
            len(c["member_errs"]) != SV_MEMBERS or \
            c["committee_err"] > max(c["member_errs"]):
        bad.append(f"the fused Wine committee {c}")
    del ens
    gc.collect()
    return out, bad


def _sv_forge(pkg: str, tmp: str) -> tuple:
    """(c): the AlexNet forward package through the ``forge`` CLI
    (upload, list, fetch), served from the registry by ``forge_fetch``
    on the card (lrn_forward counted) bit-identical to the package loaded
    directly; a corrupted copy of the registry refused with exit 2."""
    from znicz_tpu_torch.utils.export import ExportedForward, forge_fetch

    reg, bad = os.path.join(tmp, "forge"), []
    t0 = time.perf_counter()
    runs = {"upload": _sv_cli(["forge", "--registry", reg, "upload", pkg,
                               "--name", "alexnet", "--version", "1.0"],
                              tmp),
            "list": _sv_cli(["forge", "--registry", reg, "list"], tmp),
            "fetch": _sv_cli(["forge", "--registry", reg, "fetch",
                              "alexnet"], tmp)}
    out = {"cli": {k: {"rc": r[0], "stdout": r[1].strip()}
                   for k, r in runs.items()},
           "cli_s": time.perf_counter() - t0}
    if any(r[0] != 0 for r in runs.values()) or \
            runs["list"][1] != "alexnet: 1.0\n" or \
            runs["fetch"][1].strip() != os.path.join(reg, "alexnet-1.0.npz"):
        bad.append(f"forge CLI: {out['cli']}")
    t0 = time.perf_counter()
    fetched = forge_fetch(reg, "alexnet")
    out["fetch_load_s"] = time.perf_counter() - t0
    direct = ExportedForward(pkg)
    x = np.random.default_rng(SEED + 41).normal(
        size=(SF_MAX_BATCH,) + fetched.input_shape).astype(np.float32)
    klrn.fwd_launches = 0                            # 0 just before ...
    rows = [fetched(x), fetched(x)]
    torch.cuda.synchronize()
    launches = klrn.fwd_launches                     # ... read after
    want = direct(x)
    out.update(lrn_forward_launches=launches, expect=SV_LRN_LAUNCHES,
               rows=list(rows[0].shape),
               identical=bool(all(np.array_equal(r, want) for r in rows)),
               finite=bool(np.isfinite(rows[0]).all()))
    if launches != SV_LRN_LAUNCHES:
        bad.append(f"the fetched package: {launches} lrn_forward "
                   f"launches, not {SV_LRN_LAUNCHES}")
    if not out["identical"] or not out["finite"]:
        bad.append(f"the fetched package's rows differ from the package "
                   f"loaded directly: {out}")
    del fetched, direct
    gc.collect()
    torch.cuda.empty_cache()
    corrupt = os.path.join(tmp, "forge_corrupt")
    shutil.copytree(reg, corrupt)
    path = os.path.join(corrupt, "alexnet-1.0.npz")
    with open(path, "r+b") as f:
        f.seek(os.path.getsize(path) // 2)
        byte = f.read(1)
        f.seek(-1, os.SEEK_CUR)
        f.write(bytes([byte[0] ^ 0xFF]))
    rc, _, err = _sv_cli(["forge", "--registry", corrupt, "fetch",
                          "alexnet"], tmp)
    out["corrupt"] = {"rc": rc, "stderr": err.strip()}
    if rc != 2 or err != "forge: forge package alexnet==1.0 is corrupt " \
            "(sha256 mismatch)\n":
        bad.append(f"the corrupted copy: {out['corrupt']}")
    return out, bad


def _sv_status(tmp: str) -> tuple:
    """(d): fused Wine through the CLI with ``--publish markdown`` and
    ``--manhole=PATH``; at the end of epoch SV_PROBE_EPOCH, inside the
    run, a manhole session reads the live workflow's epoch and a
    ``WebStatus`` serves ``/status.json`` (the workflow listed) and the
    other endpoints; the report names the card; the socket is gone
    after."""
    from znicz_tpu_torch.web_status import WebStatus

    wf = os.path.join(tmp, "wine_status.py")
    with open(wf, "w") as f:
        f.write(SV_STATUS_WORKFLOW)
    sock = os.path.join(tmp, "manhole.sock")
    seen = {}

    def probe(w):
        if len(w.decision.metrics_history) != SV_PROBE_EPOCH:
            return
        conn = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        conn.settimeout(10)
        conn.connect(sock)
        conn.sendall(b"int(wf.decision.epoch_number)\n")
        reply = ""
        while reply.count(">>> ") < 2:
            reply += conn.recv(65536).decode()
        conn.close()
        seen["manhole"] = reply.split(">>> ")[1].strip()
        ws = WebStatus(port=0).register(w)
        port = ws.start()
        try:
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{port}/status.json", timeout=10) as r:
                doc = json.loads(r.read())
            seen["status"] = [{k: v for k, v in d.items()
                               if k in ("name", "epoch", "complete")}
                              for d in doc["workflows"]]
            seen["endpoints"] = {}
            for path in ("/metrics", "/trace.json", "/timeseries.json"):
                with urllib.request.urlopen(
                        f"http://127.0.0.1:{port}{path}", timeout=10) as r:
                    seen["endpoints"][path] = r.status
        finally:
            ws.stop()

    root.services_status.max_epochs = SV_STATUS_EPOCHS
    root.services_status.probe = probe
    try:
        t0 = time.perf_counter()
        rc, _, err = _sv_cli([wf, "--publish", "markdown",
                              f"--manhole={sock}"], tmp)
        seconds = time.perf_counter() - t0
    finally:
        del root.services_status
    report = os.path.join(tmp, "wine_report.md")
    text = open(report).read() if os.path.exists(report) else ""
    card = torch.cuda.get_device_name(0)
    out = {"rc": rc, "s": seconds, **seen,
           "report_names_card": card in text,
           "report_device": next((ln for ln in text.splitlines()
                                  if ln.startswith("- device:")), None),
           "socket_removed": not os.path.exists(sock)}
    bad = []
    if rc != 0:
        bad.append(f"the Wine CLI with --publish and --manhole exited "
                   f"{rc}: {err[-2000:]}")
    if out.get("manhole") != str(SV_PROBE_EPOCH):
        bad.append(f"the manhole session read {out.get('manhole')!r}")
    if out.get("status") != [{"name": "Wine", "epoch": SV_PROBE_EPOCH,
                              "complete": False}] or \
            set(out.get("endpoints", {}).values()) != {200}:
        bad.append(f"the web status: {out.get('status')} "
                   f"{out.get('endpoints')}")
    if not out["report_names_card"] or not out["socket_removed"]:
        bad.append(f"the report or the socket: {out}")
    return out, bad


def phase_services(pkg=None) -> dict:
    """The last modules on the card (``--phase services``).  (a)
    ``--optimize`` at bench_fc's widths over an lr Tune: the population
    route, each replayed step's SGD launches exact, one capture a body
    for the whole population, every individual bit-identical to its
    sequential replay, an lr-0 individual learning nothing, the seconds a
    generation beside the sequential route's; Wine's hidden width routed
    sequentially.  (b) ``--ensemble-train`` on eager Wine, its FC kernels
    counted exactly and held to the CPU run in the zoo's band (a TF32
    control), the fused committee's errors.  (c) ``pkg``, AlexNet's
    forward package (serve_forward's; exported here when alone), through
    the forge: fetched and served, lrn_forward counted, bit-identical to
    the package loaded directly, a corrupted copy refused.  (d)
    ``--publish`` and ``--manhole`` on a fused Wine run, with the web
    status read inside the run.  Every part runs before the first
    failure is raised."""
    from znicz_tpu_torch.launcher import Launcher

    t0 = time.perf_counter()
    out, bad = {"phase": "services"}, []
    launcher = Launcher(device=TorchDevice())
    with tempfile.TemporaryDirectory() as tmp:
        if pkg is None:
            pkg = os.path.join(tmp, "alexnet.npz")
            out["export"] = sf_export_alexnet(pkg)
        for key, part in (("optimize", lambda: _sv_optimize(launcher)),
                          ("ensemble", lambda: _sv_ensemble(tmp)),
                          ("forge", lambda: _sv_forge(pkg, tmp)),
                          ("status", lambda: _sv_status(tmp))):
            t1 = time.perf_counter()
            out[key], b = part()
            out[key + "_s"] = time.perf_counter() - t1
            bad += b
    out["card"] = nvidia_smi()
    out["seconds"] = time.perf_counter() - t0
    if bad:
        fail(f"services: {bad}: {json.dumps(out, default=str)[:6000]}")
    return out


#: phases ``--phase`` may run alone (after the build), for iterating on
#: one kernel family; the smoke proper takes no arguments
PHASES_ALONE = {"kernel": lambda: phase_kernel(),
                "flash": lambda: phase_flash(),
                "gemm": lambda: phase_gemm(),
                "optim": lambda: phase_optim(),
                "mnist_fused": lambda: phase_mnist_fused(),
                "stochastic_pool": lambda: phase_stochastic_pool(),
                "pool_backward": lambda: phase_pool_backward(),
                "conv": lambda: phase_conv(),
                "alexnet_eager": lambda: phase_alexnet_eager(),
                "deconv": lambda: phase_deconv(),
                "waves": lambda: phase_waves(),
                "kohonen": lambda: phase_kohonen(),
                "lrn_dropout": lambda: phase_lrn_dropout(),
                "ae_fused": lambda: phase_ae_fused(),
                "alexnet_fused": lambda: phase_alexnet_fused(),
                "graph_parity": lambda: phase_graph_parity(),
                "fused_conv_parity": lambda: phase_fused_conv_parity(),
                "input_pipeline": lambda: phase_input_pipeline(),
                "image_files": lambda: phase_image_files(),
                "snapshot_resume": lambda: phase_snapshot_resume(),
                "data_parallel": lambda: phase_data_parallel(),
                "lm_axes": lambda: phase_lm_axes(),
                "pipe_expert": lambda: phase_pipe_expert(),
                "speculative": lambda: phase_speculative_alone(),
                "char_lm": lambda: phase_char_lm(),
                "train": lambda: phase_train(init_params(
                    np.random.default_rng(SEED), N_LAYERS, D, HEADS, FF,
                    VOCAB))[0],
                "fused_compare": lambda: phase_fused_compare(),
                "serve_forward": lambda: phase_serve_forward(),
                "act_compare": lambda: phase_act_compare(),
                "zoo": lambda: phase_zoo(),
                "operations": lambda: phase_operations(),
                "fleet_learn": lambda: phase_fleet_learn(),
                "services": lambda: phase_services()}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False — this "
              "smoke runs only on a CUDA device", file=sys.stderr)
        return 2
    emit(phase_build())
    if len(sys.argv) > 1:
        names = sys.argv[2::2] if sys.argv[1::2] == \
            ["--phase"] * len(sys.argv[1::2]) else None
        if not names or any(n not in PHASES_ALONE for n in names):
            print(f"usage: chip_smoke.py [--phase "
                  f"{{{','.join(PHASES_ALONE)}}}]...", file=sys.stderr)
            return 2
        for name in names:
            emit(PHASES_ALONE[name]())
        print(nvidia_smi(), flush=True)
        print(json.dumps({"ok": True, "phases": names}), flush=True)
        return 0
    kernel = phase_kernel()
    emit(kernel)
    flash = phase_flash()
    emit(flash)
    gemm = phase_gemm()
    emit(gemm)
    optim = phase_optim()
    emit(optim)
    params = init_params(np.random.default_rng(SEED), N_LAYERS, D, HEADS,
                         FF, VOCAB)
    train, trained = phase_train(params)
    emit(train)
    del params
    emit(phase_train_parity())
    # one package, of the trained weights: served, then handed off
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        pkg = export_lm(params_to_numpy(trained), os.path.join(tmp, "lm.npz"),
                        heads=HEADS)
        package_s = time.perf_counter() - t0
        del trained
        serve = phase_serve(pkg)
        streams = serve.pop("_streams")
        decoder = serve.pop("_decoder")
        serve["package_s"] = package_s
        emit(serve)
        spec = phase_speculative(pkg, serve, streams)
        emit(spec)
        lm_params, _ = load_lm(pkg)
    emit(phase_profile(decoder))
    del decoder
    emit(phase_parity(lm_params))
    emit(phase_handoff(lm_params))
    del lm_params
    char = phase_char_lm()
    emit(char)
    eager = phase_mnist_eager()
    emit(eager)
    fused = phase_mnist_fused()
    emit(fused)
    emit(phase_mnist_parity())
    conv = phase_conv()
    emit(conv)
    alexnet = phase_alexnet_eager()
    emit(alexnet)
    emit(phase_alexnet_parity())
    deconv = phase_deconv()
    emit(deconv)
    ae = phase_ae_eager()
    emit(ae)
    emit(phase_ae_parity())
    emit(phase_ae_fused())
    spool = phase_stochastic_pool()
    emit(spool)
    mcs = phase_mnist_conv_stochastic()
    emit(mcs)
    som = phase_kohonen()
    emit(som)
    lrn_drop = phase_lrn_dropout()
    emit(lrn_drop)
    alex_fused = phase_alexnet_fused()
    emit(alex_fused)
    emit(phase_graph_parity())
    emit(phase_fused_conv_parity())
    emit(phase_input_pipeline())
    emit(phase_image_files())
    dp_cpu = _dp_cpu_start()        # beside snapshot_resume's one core
    try:
        emit(phase_snapshot_resume())
        data_parallel = phase_data_parallel(dp_cpu)
    finally:
        _dp_cpu_stop(dp_cpu)
    emit(data_parallel)
    lm_axes = phase_lm_axes()
    emit(lm_axes)
    # serve_forward's AlexNet package, fetched through the forge by the
    # services phase
    package_dir = tempfile.TemporaryDirectory()
    serve_forward = phase_serve_forward(package_dir.name)
    emit(serve_forward)
    pipe_expert = phase_pipe_expert()
    emit(pipe_expert)
    zoo = phase_zoo()
    emit(zoo)
    emit(phase_operations())
    fleet = phase_fleet_learn()
    emit(fleet)
    services = phase_services(os.path.join(package_dir.name, "alexnet.npz"))
    emit(services)
    package_dir.cleanup()
    kernel_hw = phase_kernel_hw()
    emit(kernel_hw)
    emit({**kernel_line(kernel, flash, gemm, optim, serve, train, eager,
                        fused, conv, alexnet, deconv, ae, spool, mcs, som,
                        lrn_drop, alex_fused, kernel_hw, spec, char,
                        data_parallel, serve_forward, lm_axes,
                        pipe_expert, zoo, fleet, services),
          "first_stream": streams[0][:8],
          "seconds": time.perf_counter() - T_START})
    print(nvidia_smi(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
