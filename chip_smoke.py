#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (mxtpu_torch) once on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printed as one JSON object per line; any failure raises
and the script exits non-zero without a result line. Every device time
is ``mxtpu_torch.tools.timing.time_ms``'s: a window of back-to-back
calls queued behind a spin of the card, so the card's time and not the
host's cost of a call.

1. card: ``nvidia-smi`` name and power limit, TF32 settings, and the
   build of every CUDA kernel from ``mxtpu_torch/ops/csrc`` (seconds,
   and ptxas' register/spill report). For each Hopper kernel (the flash
   forward, dK/dV and dQ at d = 64 and 128; conv3x3 at each tile width
   BN in {64, 128} and split in {1, 2}): registers at launch, dynamic
   shared memory, and from its SASS the HGMMA (wgmma), UTMALDG and
   UTMASTG (TMA) instructions, the highest register its consumer
   warpgroups use and its spill stores; a kernel without HGMMA or
   UTMALDG, or a conv3x3 instantiation with a spill store, fails the
   run.
2. kernel: the flash-attention forward kernel against its plain version
   (``blockwise_attention`` in f32 on the same bf16 values) at the main
   path's shape (llama3_8b: b=1, hq=32, hkv=8, s=2048, d=128, causal), a
   ragged one (b=2, hq=hkv=4, sq=1000, skv=777, d=64, non-causal) and
   edge shapes (one of them a row and a key past the kernel's 128-row
   and 128-key tiles, one a strided d=64 view), within
   ``atol=rtol=2e-2`` (bf16 output rounding,
   about 2^-8 relative, plus a different summation order); and the row
   logsumexp it writes for training against the plain version's, within
   ``atol=rtol=1e-3`` (both f32). Times: the kernel,
   ``scaled_dot_product_attention`` as a yardstick only (the port never
   calls it), and the plain version; the bound is computed from the
   shapes, and TFLOP/s from the visible pairs; ``host_ms``, the host's
   cost of one ``flash_attention`` call (its checks and the
   ``mxtpu_torch::flash_attn_fwd`` operator's dispatch and launch).
3. kernel_bwd: the dK/dV and dQ backward kernels against their plain
   version (``flash_attention_bwd_plain`` in f32 on the same bf16 q, k,
   v, o, dO and the kernel's lse) at the same shapes, within
   ``atol=rtol=2e-2``: an emulation of the kernels' bf16 roundings on
   the CPU stays under 7e-3 while planted faults (mask dropped, wrong
   GQA head, ``- D`` dropped, scale twice, a query tile lost) give 0.7
   or more (``python -m mxtpu_torch.tools.bwd_tolerance``); and the
   D = rowsum(dO o) that the dQ kernel writes against the eager f32
   rowsum, within ``atol=rtol=1e-3`` (both f32); two calls give equal
   grads, bit for bit (no atomics). Times at the main and
   the ragged shape, each the median of 5 windows: each kernel, the
   pair (dQ with D, then dK/dV), with bounds, TFLOP/s and shares of
   bound, the host time of one pair call, the backward of
   ``scaled_dot_product_attention`` pinned to the flash backend (GQA
   native where flash takes it, else k and v repeated outside the timed
   call; the backend and the GQA route are reported) as a yardstick
   only, beside it the cuDNN and memory-efficient backends, which an
   unpinned call may pick, and the plain version.
4. rng: the Threefry chain of ``mxtpu_torch.prng`` on the card against
   the same calls on the CPU: ``PRNGKey`` of 0, 42 and 2^31 - 1, their
   ``split`` and ``fold_in`` of 0, 1 and 7, 32- and 64-bit
   ``random_bits`` at (7,), (3, 5, 11) and (4, 128256), f32 ``uniform``
   there and f32 and f64 ``uniform`` over [-3.3, 7.1) (the fused
   multiply-add), all bit for bit; ``gumbel`` at (4, 128256) within 2
   ulps of max(|g|, 1) (each ``log`` rounds within an ulp of its own
   result); ``categorical`` on seeded (4, 128256) logits with the CPU's
   tokens. One ``sample_logits`` call at (4, 128256), temperature 0.8,
   top_k 50, top_p 0.95, static and traced (equal tokens): device ms and
   host ms, no bound.
5. slice: ``CONFIGS["llama3_8b"]`` at bf16 params (8.03 B parameters,
   all 32 layers) with random weights from a seeded generator on the
   card. (a) ``forward`` on (1, 2048) tokens: finite f32 logits, 32
   kernel launches, and the relative distance to the same model's
   ``attn_impl="dense"`` logits within its bound. (a2) ``gluon_forward``:
   the same tree in ``gluon.model_zoo.GluonLlama`` (shapes from the meta
   device, the tensors shared, grad_req null): ``net(tokens)`` eagerly,
   then hybridized (the first call captures a CUDA graph after a
   warm-up run, later calls replay it), the logits of each bit for bit
   ``llama.forward``'s; eager, first hybridized and replay seconds;
   launches 32 eager, 64 at the capture call (its warm-up and the
   captured ones), none at a replay, and one capture (so 32 kernels a
   replay). (b) greedy
   ``generate`` answering 4 requests (prompt 128, 32 new tokens each),
   twice, with the same tokens both times. On the same weights, each
   with the launch counts set to 0 before and read after (the cached
   path's attention is inline, as in ``mxtpu``, so none launches a
   kernel): (c) ``generate_sampled``: the same prompts at temperature
   0.8, top_k 50, top_p 0.95, with the default key (``PRNGKey(0)``) and
   with ``PRNGKey(0)`` given (equal tokens), another key (other
   tokens), per-row tensors of the same knobs (the same tokens), and a
   mixed call whose row 0 has temperature 0 (greedy's row 0, the other
   rows the sampled ones); tok/s beside greedy's. (d)
   ``chunked_prefill``: a (1, 6000) prompt in chunks of 1024 (5 and a
   remainder of 880) against ``prefill(last_only=True)``: equal cache
   positions, last logits within 5e-2 relative, the same argmax; each
   one's peak GB. (e) ``generate_int8``: ``quantize_params_int8`` of
   the weights on the card (the tree's GB), the int8 prefill logits at
   the 4 prompts within 0.2 relative of the bf16 ones, greedy
   ``generate`` off the int8 tree twice with equal tokens; tok/s and
   peak GB. The two bounds come from bf16 on the CPU at 2-16 layers of
   a narrow llama3_8b: chunked 0-0.014 against planted faults (the past
   lost, the remainder dropped) of 0.95 or more; int8 0.043-0.058
   against faults (scales dropped, a neighbour layer's scales) of 0.56
   or more (``python -m mxtpu_torch.tools.serve_tolerance``). (f)
   ``serve_engine``: ``mxtpu_torch.serve.ServeEngine`` (16 slots,
   max_len 768, buckets from 64: a 1.61 GB bank) serving
   ``bench.py``'s ``bench_llama_serve`` stream at this width (48
   requests, prompts of 64-384 tokens, 8-256 new ones, seeded Poisson
   arrivals 4 steps apart on average, request i seeded i, every third
   one sampled with the knobs of (c)), every bucket warmed first: every
   request gets exactly its tokens, all in [0, V); at most buckets + 1
   programs with the decode step captured once as a CUDA graph; tok/s,
   p50 and p99 inter-token ms, the decode dispatch's host ms, peak KV
   occupancy and peak GB. A second engine, synchronous, with the
   requests submitted in reverse, gives every stream bit for bit. An
   engine over the first 4 layers in f32 (4 slots, max_len 256) serves
   2 greedy and 2 sampled requests (prompts 64 and 128, 32 new tokens)
   equal to batch-1 ``generate`` with ``PRNGKey(seed)``, but for a
   first difference at a near-tie of generate's decision values (gap at
   most 1e-5 of |max|, printed); the bf16 streams' agreement with
   ``generate`` over 32 tokens is printed only (the two attention
   formulations round differently in bf16). On the same f32 layers:
   the captured decode step equals eager ``decode_slots`` on a twin
   bank, tokens at each of 4 steps and the banks at the end, with the
   shared RoPE cache pushed past its size, emptied, and its memory
   freed and poisoned before every replay (``rope_evicted``); and two
   engines serving from ``run_forever`` threads at once, each capturing
   while the other works, give every stream of a synchronous engine's
   run, one capture each (``threaded_engines``). (g)
   ``paged_attention``: at 16 slots, hq 32, hkv 8, hd 128, max_len 768,
   a random bf16 bank paged into 16- and 64-token pages in shuffled
   order (two slots aliasing pages): ``paged_decode_attention`` equals
   ``slot_decode_attention`` on the bank bit for bit, with 1-D and
   per-query lengths, each timed as a captured graph; the int8 codes,
   scales and dequantised gather on the card equal the CPU's; its
   launches counted from zero. (h)
   ``paged_engine``: ``bench.py``'s ``bench_paged_kv`` (4 dense slots
   against 49 pages of 64 tokens, the same KV bytes, under a 16-slot
   ceiling; 32 requests of 96 + 96 tokens): peak active slots, their
   ratio (at least 3), tok/s and reserved GB; time to first token of a
   384 + 8 token prompt cold and warm (a prefix hit); the serve stream
   of (f) through 16-token pages (tok/s, p50, p99, peak pages, at most
   buckets + 2 programs, one capture, streams against the dense
   engine's printed) and through int8 pages twice (equal); at 4 layers
   in f32 the paged engine equals the dense one or parts at a near-tie.
   (i) ``spec_engine``: ``bench.py``'s ``bench_spec`` (k = 4 against
   k = 0, 2 slots, 16-token pages, max_len 256, 6 greedy requests of
   200 tokens): tok/s, accepted tokens a slot-step and the accept rate
   (reported, not checked: the weights are random), an oracle drafter
   reading the k = 0 streams and an adversarial one, each stream equal
   to k = 0's or parting first where the two tokens' decision values
   lie within 2^-6 of |max| (a bf16 near-tie); at 4 layers in f32 the n-gram, oracle and adversarial engines and a
   journaled resume after 5 tokens equal k = 0 or part at a near-tie,
   the oracle in fewer steps than tokens; at most buckets + 3 programs
   and one capture each of the paged and verify steps.
   (j) ``gateway``: the serving tier (``mxtpu_torch.serve.gateway``) on
   the same weights. ``bench.py``'s ``bench_gateway`` through the HTTP
   front door: two replicas of 8 slots, max_len 768, buckets from 64,
   every bucket warmed on both (untimed), then 32 requests on seeded
   exponential arrivals of mean 0.15 s, prompts max_len/12..max_len/2,
   8 to max_len/3 new tokens: tok/s, TTFT and inter-token p50/p99 at
   the client, beside the gateway's own TTFT and each engine's gaps at
   emission, builds and captures per replica; every request 200 with
   exactly its
   tokens, each stream equal to a synchronous engine's, at most buckets
   + 1 builds and one capture a replica. ``bench_disagg_stream``'s
   protocol through a ``DisaggBackend`` (one prefill worker, one paged
   decode replica of 64-token pages) over a socketpair throttled to an
   emulated 250 MB/s wire: prompts of 448 tokens, 4 new ones at
   temperature 0.7; one-shot without the wire (one warm-up and 5
   requests, for the wire's share), then a one-shot backend and a
   backend streaming 64-token chunks, both built before the first
   request, each with its own throttled wire, one warm-up each and 15
   timed requests interleaved (request i to both, which goes first
   alternating with i): each mode's median TTFT, the worker's span
   (median, min, max) and each stage's per request (streamed: its
   compute loop and the shipper's tail apart; the loop beside its
   517-565 ms before the chunk program was captured), bytes shipped,
   prefill programs; the paired differences (one-shot minus streamed) with
   their median and how many favour streamed; the first 5 requests'
   streams equal in the three modes, every streamed stream equal to the
   one-shot one or parting first at a near-tie (its two tokens' decision
   values within 2^-6 of |max|, as ``spec_engine``'s partings: the
   chunked prefill rounds unlike the one-shot one in bf16), the
   streamed median TTFT below the one-shot one. The streamed worker
   runs each bucket's chunk program as one CUDA graph (its position a
   device tensor, its cache reused across requests): the same program
   built apart and replayed over the warm-up request's 7 chunks gives
   each chunk's token, K/V and key bit for bit as the eager
   ``llama.prefill_detached_chunk`` with host positions on a fresh
   cache (``chunk_graph``, with a replay's device ms). At 4 layers in f32, the
   two-replica gateway, the disaggregated backend one-shot and streamed,
   and the gateway
   with replica 0 killed mid-stream by a ``ServeChaosPlan`` each equal
   ``generate`` or part at a near-tie, and the kill is counted and
   repaired. (k) ``fleet``: the fleet control plane
   (``mxtpu_torch.serve.fleet``) on the same weights, once the gateways
   are freed: model "llama" (these 32 layers, two replicas of the
   gateway's shape) beside "llama8" (the same widths at 8 layers, seed
   1, one replica of at most two), every bucket of every replica warmed.
   (a) ``bench_gateway``'s 32 requests through ``start_http``, each
   sent to a model by a seeded draw with a seeded priority class
   (interactive, batch or offline), 4 sessions of two requests each:
   tok/s and client TTFT p50/p99 per model, session-affinity hits and
   misses; (b) ``hot_swap("llama", params=v1)`` (a seeded tree made on
   the card) once half the requests are sent: every response a 200
   with exactly its tokens, on v0 or v1, and each stream equal to a
   synchronous engine's on the weights of the model and version its
   label names; the swap's seconds. (c) ``save_state`` of a seeded v2
   tree, then ``hot_swap("llama", path=...)``: the tree loaded once
   and shared by the new replicas, each leaf's sha256 equal to the
   saved tree's (digests taken here from host copies); save and load
   seconds and GB/s. (d) A ``ServeChaosPlan`` kills replica 0 of
   "llama" at its next step while a burst is in flight and
   ``hot_swap("llama", params=v1)`` runs: the kill fires once,
   ``gateway_redispatch_total{model}`` advances, every request
   completes on v2, the build that seated it, and each stream equals
   the fault-free one or (re-dispatched, resumed through a bf16 prefill
   of its prefix) parts first at a near-tie within 2^-6 of |max|. (e) A
   ``FleetArbiter`` over the live pools on an injected clock and
   scripted signals: "llama8" burns and is granted the free chip, then
   idles while "llama" burns, and one decision moves its replica to
   "llama" (``fleet_scale_events_total``). (f) At 4 layers in f32, a
   two-replica fleet with replica 0 killed during a hot swap: the kill
   re-dispatches at least one request, and each stream equals
   ``generate`` or parts at a near-tie (1e-5 of |max|).
   (g)-(k) print the card's name and power limit and launch none of
   the port's kernels.
6. train: ``CONFIGS["llama3_8b"]`` at full width and 4 layers, with the
   reference's training dtypes (f32 params, bf16 compute), remat and the
   8192-wide chunked cross-entropy. (a) The loss and the grads of
   ``layers.wq``, ``layers.wk`` and ``tok_embed`` on one seeded
   (1, 2048) batch against the same model's ``attn_impl="dense"``,
   within their bound. (b) ``make_train_step(loss_fn(cfg),
   adamw(3e-4))`` for 3 steps on that batch: finite losses, the first
   near ln(vocab), and the loss after the 3 steps below the first; per
   step 8 forward launches (4 layers and their 4 recomputations) and 4
   of each backward kernel. The loss need not fall at every step: at
   this lr without warmup the third step's loss rises above the first,
   with dense attention and f32 compute too
   (``python -m mxtpu_torch.tools.adam_dynamics``). (c) ``train_rng``:
   from the trained params, ``make_train_step(has_rng=True,
   grad_accum=2)`` with ``sgd(3e-4)`` over a loss whose target mask is
   ``prng.bernoulli(key, 0.9)``, on two (1, 2048) microbatches, 3 steps
   with step t keyed ``fold_in(PRNGKey(1), t)``, then again from the
   same params (equal losses), then with ``PRNGKey(2)`` (other losses):
   finite losses, and per step 16 forward launches and 8 of each
   backward kernel. (d) ``flywheel``: llama3_8b widths at 2 layers in
   the training dtypes, on batches drawn from a seeded Zipf unigram:
   ``CheckpointManager(async_save=True, max_to_keep=2)`` saves the
   params at each of 4 ``adamw(3e-6)`` steps and publishes steps 2 and
   4 into a two-replica bf16 fleet whose ``FlywheelController`` gates
   each candidate (restored onto the card) on a held-out loss, finite
   and below step 0's. Candidate 2 is canaried and promoted by the
   controller's own thread after a clean hold; candidate 4 passes the
   gate, its canary's decode is stalled 6 s (a wrapper of the canary
   engine's dispatch) past the 5 s TTFT target, and it is rolled back;
   a planted non-finite candidate is rejected at the gate; every stream
   equals a synchronous engine's on its version's weights. A latest
   step with a truncated leaf makes ``restore()`` fall back to step 4,
   counted once in ``checkpoint_total{kind="fallback"}``, and SIGTERM
   under ``PreemptionGuard`` forces one final save, read back bit for
   bit. Save, wait and restore seconds; launches exactly 4 steps' (2
   forward and 1 of each backward kernel a layer) plus 2 forward a
   held-out evaluation (step 0's and each gated candidate's).
   (e) ``mesh``, between ``train`` and ``flywheel`` (multi-device
   training, ROADMAP item 11a), with the launch counts set to 0 before
   each step or call and read after: (a) ``dist.initialize`` makes a
   one-rank NCCL group on the card (a ``file://`` store under
   ``build/``) and ``create_mesh(dp=-1)`` a DeviceMesh over it; the
   train phase's model, seed and batch through ``make_train_step(
   loss_fn(cfg, mesh), adamw(3e-4), mesh, sharding_rules(cfg))`` for 3
   steps, losses bit-equal to the unsharded step's on the same weights,
   8 forward and 4 of each backward flash launch a step, step seconds
   beside the unsharded ones (the train phase's steps: the same weights,
   batch and optimizer), and the collectives the port issued and DTensor
   ran (``CommDebugMode`` around the first step, which its hook slows):
   none at world size 1, so one card cannot show their cost. (b) The slice's
   bf16 weights at 32 layers, ``forward`` of its (1, 2048) tokens with
   ``attn_impl="ring"`` and ``"ulysses"`` on a one-rank sp mesh (plain
   attention, no kernel): logits within 5e-2 of the flash logits of the
   same weights. (c) ``GluonLlama`` at 4 layers ``shard``-ed on the mesh
   by the rules, ``make_fused_step``: one CUDA graph (the capture call
   launches twice a step's kernels, replays none), sgd losses within
   1e-4 of the classic Gluon step's. (d) 4 gloo ranks of this host's
   torch on its CPU (``CUDA_VISIBLE_DEVICES`` empty) run the tests'
   tiny Llama on dp=2 × tp=2: losses and every gradient within 1e-5 of
   the largest magnitude of the one-rank CPU run's.

7. kernel_conv: the conv3x3 implicit-GEMM kernel against its plain
   version (``conv3x3_plain`` in f32 on the same bf16 values) within
   ``atol=rtol=2e-2`` (the shape experiment's ``CONV_TOL``: bf16 output
   rounding, half an ulp of up to 3.1e-2 at the outputs' magnitudes of
   4-15, inside the relative part, plus a different summation order),
   at the ResNet shape experiment's
   (128, 14, 14, 256→256), ResNet-50's other 3×3 shapes at batch 32
   ((56, 64), (28, 128), (7, 512)) and a ragged (3, 5, 9, 64→72), with
   the tile plan (BN, split) the wrapper chose, and at edge shapes
   (one pixel; C and O under one 64-wide stage, or past one; a row
   wider than a tile; K split in uneven halves) that reach all four
   instantiations; two calls equal bit for bit at every shape; where
   the plan splits K, the unsplit plan on the same inputs within one
   bf16 ulp plus the f32 reordering bound (``split_vs_unsplit``); and a
   conv of 1.1e9 pixels, which the kernel takes in two launches, at the
   images around the boundary. Times at the five, each the median of 5
   windows: the kernel and ``F.conv2d`` on the
   channels-last view (cuDNN, a yardstick only), with TFLOP/s of the
   needed taps and share of bound; the host time of one kernel call; the
   plain version once.
8. resnet: ``CONFIGS["resnet50"]`` at full width (224×224, 1000
   classes) with seeded random weights, cuDNN TF32 off. (a) Eval
   ``forward`` at batch 256: finite f32 logits and img/s; the s2d stem
   against the std stem on the same params, relative distance of the
   logits within 2e-2 (the rewrite is exact, so only bf16 rounding
   differs: 1.9e-3 on the CPU at batch 4, where bf16 against f32 gives
   3.9e-3), with both stems' times, alone and in the forward. (b) 3
   steps of ``make_train_step(loss_fn, sgd(0.1, momentum=0.9),
   has_state=True)`` at batch 256: finite losses, the first within 1.0
   of ln 1000, every BN running mean moved; img/s and peak memory.
   The launch counts are set to 0 before (a) and read after (b):
   ResNet's convs are cuDNN's, as the reference's are XLA's, so the
   path launches none of the port's kernels.
9. experiment_probe2: the shape experiment's probe 2, untimed, with
   the launch counts set to 0 just before it and read just after: one
   launch of the conv3x3 kernel at (128, 14, 14, 256→256), checked
   against the plain version.
10. kernel_rtc: the two ``mx.rtc`` user kernels of
   ``mxtpu_torch/tools/rtc_kernels.py``, compiled by ``nvcc`` at their
   first launch, against their plain versions through
   ``CudaKernel.launch`` on NDArrays: ``scale_add`` (f32) exactly at
   (2, 128), (8192, 4096), a ragged (3, 1001) and a view 4 bytes off
   16-byte alignment; ``swiglu`` (bf16) within ``atol=rtol=1e-2`` (one
   bf16 rounding of silu(g)·u, half an ulp is 2^-9 relative, plus an
   f32 ulp or two of ``expf``) at llama3_8b's FFN activations (2048,
   14336), an odd (3, 7) and a misaligned view, each launched with the
   default grid and with ``rtc_kernels.grid`` (one thread a vector, as
   the main path launches them). An empty launch returns an empty array
   and launches nothing. Times at the main shapes, each the median of 5
   windows: the kernel at both grids,
   its plain version and, for ``scale_add``, ``torch.add(y, x,
   alpha=2)`` as a yardstick, with the bound by bytes, and the host time
   of one ``CudaKernel.launch``.
11. frontend: the imperative frontend at llama3_8b's FFN width (dim
   4096, hidden 14336, bf16, 2048 tokens, seeded weights), everything
   through ``mx.nd.array(..., ctx=mx.gpu())``, with the launch counts
   set to 0 just before (a0)+(a) and read just after. (a0) The
   reference's rtc test drive: ``scale_add`` on (2, 128) (3·x) and on
   (8192, 4096), both exact, at the default grid. (a) Serve-style
   forward, not recorded: ``swiglu.launch(x @ w_gate, x @ w_up,
   grid=rtc_kernels.grid(...)) @ w_down`` against the port's
   ``models.llama._ffn`` on the same weights, relative distance within
   2e-2 (bf16: ``_ffn`` rounds silu(g) and the product separately);
   launches 2 ``scale_add``, 1 ``swiglu``. (b) An imperative training
   step: the same FFN under ``autograd.record()`` with
   ``rtc.torch_kernel(F.silu)`` and ``y.backward(head)``; the grads of x
   and the three weights against ``torch.autograd`` on the same function
   within 1e-2 relative; step time and peak memory; no kernel launches.
   (c) The rtc launch under ``record()`` on arrays on the tape raises.
12. nd_random: ``mx.random.seed(0)``, then through ``mx.nd.random`` on
   the card: ``uniform``, ``normal``, ``randint`` (0, 128256),
   ``exponential`` and ``bernoulli`` (0.3) at llama3_8b's FFN weight
   shape (14336, 4096); ``gamma`` for alpha 0.3, 1 and 5 and
   ``poisson`` for lam 0, 0.5, 4, 9.99, 10, 40 and 1000 at 2^20
   elements and again at 2^16; ``multinomial`` over a seeded (32,
   128256) softmax table, 4 draws a row, with ``get_prob``; ``shuffle``
   of arange(3,000,000) (3 sort rounds). The CPU replays the same
   draws after the same seed at small shapes (a Threefry element
   depends on its index only, so the card's first 2^16 elements meet
   them): uniform, randint, bernoulli, multinomial (draws and log
   probabilities) and shuffle equal, normal within 2 ulps, exponential
   within 1, and gamma and poisson at 2^16 parting only where the
   CPU's margin at an accept test is within 4 ulps. Every draw's
   sample mean and variance within 6 standard errors of the
   distribution's (the multinomial's standardised per row), the
   shuffle a permutation. Device ms (queued window) and host ms of
   each draw at its size, ``torch.randn`` beside them as a yardstick
   only; launch counts from 0 (none: no hand kernel on this path).
13. serde: one llama3_8b layer's bf16 weights (9 arrays, 218 M
   parameters, seeded) saved from the card with ``mx.nd.save`` to a
   temporary file and loaded back to the card (as float32, since
   ``load`` makes float entries float32 as the reference's does): bit
   for bit once cast back to bf16; the file
   byte for byte a save of the same arrays from the CPU;
   ``tests/artifacts/r5/arrays.bin`` (written by the reference) loads
   on the card with its values and dtypes; seconds and GB/s of the
   save and the load; launch counts from 0 (none).
14. mixtral: ``CONFIGS["mixtral_8x7b"]`` at full width (dim 4096, hidden
   14336, 8 experts, top-2, hq 32, hkv 8, vocab 32,000, rope theta 1e6)
   and 4 of its 32 layers in bf16 (6.07 B parameters, 12.1 GB; 8
   layers until the script passed 870 s with the ``contrib`` phase), with
   seeded random weights, after the earlier phases freed theirs. (a)
   ``forward`` on (1, 2048): finite f32 logits, exactly 4 flash-forward
   launches; the choices dropped at capacity 1.25, by layer; at
   capacity E/K (C = T, nothing dropped) the logits with flash against
   ``attn_impl="dense"`` and the routed ``forward_hidden`` against the
   same model through ``moe_ffn_dense``, each within 0.3 relative and
   with a per-token median within 0.05 (a route that flips at a
   near-tie of its router takes other experts, so the global distance
   follows the few flipped tokens: bf16 on the CPU at 2-8 layers of a
   narrow Mixtral gives 0.04-0.14 and medians of 0.007-0.021, a lost
   expert 0.26-0.57 and medians from 0.46 at 4 layers, unrenormalised
   gates 0.54 and more; ``python -m mxtpu_torch.tools.moe_tolerance``),
   with the routes that differ by layer. (b) Greedy ``generate`` of 4 ×
   (128 + 32) twice, equal; ``chunked_prefill`` of (1, 4000) in chunks
   of 1024 against one shot (last logits within 5e-2, the same argmax).
   (c) ``bench_llama_serve``'s stream through the dense engine (16
   slots, max_len 768; every request exactly its tokens, at most
   buckets + 1 programs, one decode capture; tok/s, p50, p99, peak GB),
   a synchronous engine with the requests in reverse (every stream bit
   for bit: the serving mixture routes each token by itself), and
   16-token pages (streams against the dense engine's, printed; one
   capture). (d) One layer (1.71 B parameters) in the reference's
   training dtypes (f32 params, bf16 compute, remat, the chunked
   cross-entropy): at capacity E/K the loss and the grads of
   ``layers.moe_gate``, ``layers.w_gate`` and ``tok_embed``, flash
   against dense, within 0.25 (the CPU tool gives 0.009-0.093 there and
   up to 0.27 at capacity 1.25; planted backward faults 0.55 and more);
   then 3 ``adamw(3e-4)`` steps at capacity 1.25: finite losses, the
   first within 1.5 of ln 32000 + 0.01 (the aux at uniform routing),
   the loss after them below the first, 2 forward launches and one of
   each backward kernel a step; step seconds and peak GB. Launches
   (generate, chunked, engines) counted from 0: none.
15. bert: ``CONFIGS["bert_base"]`` (f32 params, bf16 compute) at
   ``bench.py``'s ``bench_bert`` shape (batch 128, seq 128, 20 MLM
   positions, NSP labels). (a) ``forward`` with the last 32 positions of
   every other row padded: finite, and ``seq_out`` within 3e-2 of f32
   compute on the same weights (the CPU tool: 0.0057-0.0096 at 2-8
   layers, the position embeddings lost 0.57 and more). (b) 3
   ``adamw(1e-4)`` steps: finite losses, the first within 1.0 of
   ln 30522 + ln 2, the last below the first; samples/s, model TFLOP/s
   (``bench_bert``'s count) and peak GB. Launches from 0: none, as the
   reference's BERT runs no Pallas.
16. telemetry: what the ``train`` and ``serve_engine`` phases left in
   ``mxtpu_torch.telemetry``'s registry, read right after each (no model
   of its own). The watched train step: ``program_flops{train_step}``,
   counted on its first call (the flash forward and backward kernels'
   own counts among them), equal to ``llama.train_step_flops`` within
   1e-6 relative; the live ``mfu{program="train_step"}`` within 10 % of
   those FLOPs over the phase's median step seconds at the card's peak;
   one ``compile_events_total{fn="train_step"}`` over the steps; the
   HBM ledger's total at or below ``torch.cuda.memory_allocated()`` and
   its headroom gauge the card's total memory (``mem_get_info``) less
   the ledger. The watched decode step: cataloged with bytes at or above
   the ledger's params plus the peak live KV bytes; no
   ``recompile_total`` over the stream; ``program_build_total`` over the
   engine's life equal to its ``compile_count``. A ``RegistryServer`` in
   this process scraped over loopback: ``parse_prometheus`` reads back
   the registry's gauges. Printed: each program's MFU, MBU and roofline
   class, and the host ms of the decode dispatch.

17. gluon: the classic Gluon path on the card, with the launch counts
   set to 0 before and read after. (a) ``GluonLlama`` at llama3_8b
   width and 4 layers in the training dtypes (f32 params, bf16
   compute), hybridized: ``autograd.record()``, ``net(tok, tok)``,
   ``backward()``, ``Trainer.step(1)`` on the train phase's seeded
   (1, 2048) batch. With ``Trainer("sgd", lr 3e-4)`` for 3 steps the
   losses within 1e-4 relative of ``make_train_step(loss_fn(cfg),
   sgd(3e-4))`` from the same seeded weights; with ``Trainer("adamw",
   lr 3e-6)`` for 3 steps finite losses, the third below the first.
   Each step 8 forward launches and 4 of each backward kernel; step
   seconds, tokens/s and peak GB. (b) ``get_model("resnet50_v1")``
   (1000 classes, f32, NCHW, ``Xavier(magnitude=2)``), hybridized, at
   batch 256 and 224²: the predict-mode call (a CUDA graph) gives
   finite f32 (256, 1000) logits, img/s over replays; then, cast to
   bf16 (f32 activations at this batch do not fit: the eager BatchNorm
   keeps several copies of each), 3 steps of ``Trainer("sgd", lr 0.1,
   momentum 0.9, multi_precision=True)`` under ``record()``: finite
   losses, the first within 1.0 of ln 1000, every BatchNorm running
   mean moved; img/s beside the functional ``resnet_train``'s (bf16
   compute too), peak GB; no port kernel launches (cuDNN's convs).
   (c) ``gluon_fused``: ``Trainer.make_fused_step`` on the same
   GluonLlama, weights and batch, the net sharded on
   ``create_mesh(dp=-1)``: one CUDA graph of forward, backward (the
   three flash kernels inside) and update. sgd (lr 3e-4) for 3 steps:
   the losses within 1e-4 relative of ``make_train_step``'s; adamw (lr
   3e-6, set to 6e-6 before step 3) for 4 steps: finite, the last below
   the first; ``num_compiles()`` 1 after every step. The first call
   launches twice one step's kernels (its step, run eagerly as the
   capture's warm-up, and the captured one: 8 forward, 4 of each
   backward kernel a step), a replay none.
   Step seconds (the first holds the capture), tokens/s and peak GB
   beside the classic path's. (d) ``gluon_fused_resnet``: the zoo's
   ResNet-50 behind a block that normalizes uint8 NHWC images on the
   card, bf16 on float32 masters (``multi_precision`` SGD, momentum
   0.9), ``make_fused_step(grad_accum=2)`` at batch 256, fed from an
   in-memory ``ArrayDataset`` of 512 seeded uint8 images through
   ``DataLoader(num_workers=4, pin_memory=True)`` and
   ``DevicePrefetcher(depth=2)`` for 2 epochs (4 steps; the first step
   waits for the workers' start): finite losses, one graph,
   every BatchNorm running mean moved, the first step held against the
   classic ``Trainer(multi_precision=True)`` from the same weights on
   the same batch (two microbatch backwards accumulated, one
   ``step(2)``): the losses within 2**-6, each float32 master's update
   and each BatchNorm statistic's change within 2**-3 and 2**-5 (L2)
   of the classic one's; img/s, the prefetcher's
   data-wait p50/p99 and peak GB; then, in float16 with dynamic
   AMP at batch 64 on freshly initialized weights, a step from a loss
   scale of 2**126 overflows: the trained parameters bit-equal, the
   scale 2**125, no applied update; from a scale of 1 the next
   applies. (e) ``gluon_rnn``: a hybridized word LM (Embedding 33278×650, 2-layer ``gluon.rnn.LSTM``
   650, Dense to the vocabulary), the WikiText-2 "medium" shape of
   MXNet's ``word_language_model`` example (bptt 35, batch 32), 3
   classic ``Trainer("sgd")`` steps on seeded tokens: finite losses, the
   first within 1.0 of ln 33278; step seconds. (d) and (e) launch none
   of the port's kernels.

18. symbol_module: the Symbol/Module frontend at ResNet-50 width, with
   the launch counts set to 0 before and read after (cuDNN's convs: no
   port kernel). (a) ``get_model("resnet50_v1")`` from ``mx.random.seed``
   (Xavier, f32) on the card, one eager call at batch 256 and 224²,
   then ``export``. (b) ``SymbolBlock.imports`` of the files on the
   card: eager, then hybridized (one CUDA graph, replayed): logits equal
   to the Gluon net's, bit for bit or within 1e-5 of max |logit|;
   replay img/s, one capture, peak GB. (c) ``mx.model.load_checkpoint``,
   a ``SoftmaxOutput(normalization="batch")`` head, ``mx.mod.Module``
   bound at batch 64, ``fit`` for 3 steps (sgd, lr 0.1, momentum 0.9)
   over an ``NDArrayIter`` of seeded images with ``Speedometer`` and
   ``do_checkpoint``: its first step against the classic
   ``Trainer("sgd")`` with ``SoftmaxCrossEntropyLoss`` on the same
   weights and batch, the loss within 1e-5 relative, the whole update
   within 5e-2 (L2) of the classic one, each parameter's within 1e-1,
   each BatchNorm statistic's change within 1e-3 (BatchNorm's backward
   carries rounding far: MODULE_* below); the checkpoint read back by
   ``load_checkpoint``
   bit for bit; ``score("acc")`` (a predict-mode executor graph); s a
   step, img/s, peak GB. (d) a ``BucketingModule`` over buckets of 20
   and 35 of an LSTM word LM (vocabulary 10000, embed and hidden 200,
   batch 32), one step each: finite losses. The files live under
   ``build/symbol_module`` and go at the end.

19. image_record: the image half of ``mx.io`` at ImageNet width, with
   the launch counts set to 0 before and read after (cuDNN's convs and
   the JPEG codec: no port kernel). (a) The host: ``g++``, libjpeg's
   and nvJPEG's files, ``nproc``, PIL, and the codec the native IO
   library was built with; its decodes of ``tests/data/jpeg``'s JPEGs
   (RGB and luma) against libjpeg's, bit-equal under libjpeg and within
   mean |Δ| < 2, max ≤ 16 under nvJPEG, and its quality-95 round trip
   of their sources losing at most 0.5 more (mean) than libjpeg's.
   (b) 2,048 photographic-like 500×375 JPEGs (``train_real_data.py``'s
   images, ``np.random.default_rng(0)``, labels ``i % 1000``) written
   by ``recordio.pack_img`` into an indexed ``.rec``; the raw pipe's
   decode img/s at 1, 2, 4 and ``nproc`` threads; one uint8 batch
   normalized on the card and the host, bit for bit, and the card's
   iterator (pinned buffers, its own stream) against the host's;
   ``ImageRecordIter(batch 256, 224², shuffle, nproc threads, mean and
   std)`` routed to ``NativeImageRecordIter``, its pure input img/s
   (fenced), then the zoo's ResNet-50 (1000 classes, bf16 on float32
   masters) through ``make_fused_step`` (sgd 0.05, momentum 0.9, wd
   1e-4) under ``DevicePrefetcher(depth=2)`` for 2 epochs of 8 steps:
   the second epoch's img/s, its data waits p50/p99, the same step fed
   from memory (the last batch, 4 steps), finite losses (the first
   within 1.0 of ln 1000), peak GB, and whether the input bounds
   the step (median wait at least a tenth of a step). (c)
   ``rand_crop``/``rand_mirror`` route to ``ImageIter`` under a
   ``PrefetchingIter``: img/s over 256 images at batch 64. (d) 256
   300×300 JPEGs with 1-5 boxes read by ``ImageDetIter`` (batch 32,
   ``rand_crop``, ``rand_mirror``): img/s; SSD300's 8,732 anchors from
   ``MultiBoxPrior`` over maps of 38, 19, 10, 5, 3 and 1; for 20
   classes (21 channels) ``MultiBoxTarget`` (batch 32, hard negatives
   3:1) and ``MultiBoxDetection`` (4 images, NMS 0.45) on the card
   against the CPU: class targets and masks equal, loc targets within
   1e-5 relative, the kept rows equal or the first difference in an
   image an IoU within 1e-4 of the threshold; each op's card ms. (e)
   64 of (b)'s images as ``.jpg`` files in 4 class folders, read by
   ``ImageFolderDataset`` under ``DataLoader(num_workers=2)``: worker
   threads under nvJPEG (a worker process hides the card), processes
   under libjpeg, the batches bit-equal to the loader's without
   workers; and a process with ``CUDA_VISIBLE_DEVICES=''`` that decodes
   one of them raises naming the cause under nvJPEG (decodes under
   libjpeg). The files live under ``build/image_record`` and go at the
   end.

20. op_set: the rest of the op set (ROADMAP item 10.4(b)) at published
   widths, with the launch counts set to 0 before and read after (plain
   PyTorch, cuBLAS and cuBLASLt: no port kernel). (a) The update ops
   (``sgd``, ``sgd_mom``, ``nag_mom``, ``adam``, ``adamw``, ``rmsprop``,
   ``ftrl``, ``signsgd``, ``mp_sgd`` with bf16 weights over f32 masters)
   over one llama3_8b layer's tree (9 arrays, 218 M parameters, f32),
   one call an array with ``out=weight`` as MXNet's optimizer makes
   them: device ms for the
   tree, GB/s and the share of the byte bound (each input read once,
   each output written once, at 3.35 TB/s); the first 2^16 elements of
   every updated weight and state within 1 ulp of the port's update on
   the CPU from the same inputs (bf16 weights equal); ``multi_all_finite``
   over the tree 1, and 0 with one ``inf`` planted. (b) Sparse at
   Avazu's shape as MXNet's ``example/sparse/linear_classification``
   reads it (batch 8,192 of 1,000,000 hashed features, 15 a row):
   ``dot(csr, w)``, ``dot(csr, g, transpose_a=True)`` (row-sparse),
   ``add`` and ``retain`` of two such gradients, and llama3_8b's
   embedding as a one-hot CSR (2,048 × 128,256) times the (128,256 ×
   4,096) table and its csrᵀ backward: against the CPU on the same
   inputs within the reassociation bound 2·n·2^-24 of the sum of |terms|
   (n the most terms an output sums; ``add``, ``retain`` and the
   one-hot product bit for bit), no dense form built, peak memory above
   the inputs at most 1 GB, a CSR and a row-sparse ``.params`` entry
   saved from the card byte-equal to the CPU's save, whether two calls
   of the transposed dots are bit-equal (``index_add_`` accumulates
   with atomics), and each op's ms. (c) A numpy softmax ``CustomOp``
   (MXNet's ``example/numpy-ops/custom_softmax.py``, backward
   y - onehot(label)) over (2,048, 128,256) f32 logits under
   ``autograd.record()``: output against ``mx.nd.softmax`` and gradient
   against ``SoftmaxOutput``'s within 1e-6 of their largest magnitude,
   forward and backward seconds and the bytes that crossed to the host
   and back; the same op in a hybridized block raises on the card,
   naming it. (d) ``quantize_net`` of the zoo's ResNet-50 (f32, NCHW,
   seeded Xavier weights), naive calibration over 4 batches of 64, then
   eval at batch 256 of 224²: int8 and f32 img/s (both replayed CUDA
   graphs), the logits' distance ``||int8 - f32|| / ||f32||`` within
   0.03 (0.0142-0.0144 on the CPU, ``python -m
   mxtpu_torch.tools.int8_tolerance``), and the stem's quantized conv,
   the first 3×3 one and the quantized FC on the first 4 images each
   bit-equal to the same op on the CPU. (e) ``Correlation`` at
   FlowNetC's setting ((8, 256, 48, 64), kernel 1, displacement 20,
   stride2 2, pad 20), ``GroupNorm`` with 32 groups at (32, 256, 56,
   56), ``DeformableConvolution`` 3×3 256→256 at (8, 256, 56, 56) with
   random offsets, and ``BilinearSampler`` on an affine grid at (32,
   256, 56, 56): forward and one backward each, image 0's output and
   input gradients against the CPU within 1e-4 of their largest
   magnitude, whether two backward calls are bit-equal, forward ms and
   forward-plus-backward ms (input copies included).

21. np_runtime (ROADMAP item 10.4(c)), in two parts. Its profiler part
   (``np_runtime_profiler``) runs inside ``slice`` after
   ``gluon_forward`` on the same 32-layer tree: ``GluonLlama`` eager on
   (1, 2,048) under ``mx.profiler`` (``set_config`` under
   ``build/np_profiler``, ``start``, ``stop``): the chrome trace must
   hold as many flash forward kernel events as the launch counter
   advanced (32), their summed device time beside 32 × the kernel
   table's 0.0806 ms; ``dumps(format="json")``'s counts must equal the
   dispatches counted by a wrapper of ``autograd.invoke``; a paused
   region (after a ``resume``, which starts a new trace) must add
   nothing; and the eager forward's host time with the aggregate's
   hook off and on (medians of 3, alternating). The rest runs after
   ``op_set`` with the launch counts set to 0 before and read after
   (none of the port's kernels): (a) llama3_8b's FFN (2,048 tokens,
   dim 4,096, hidden 14,336, bf16) written in ``mx.np`` calls only
   (``matmul``, silu from ``exp`` and ``reciprocal``) against
   ``llama._ffn`` within 2e-2 relative (bf16 roundings placed
   differently, as ``frontend``), timed beside the same function
   through ``mx.nd``; (b) one case a category on the card against the
   port on the CPU through ``test_utils.check_consistency`` over
   ``[mx.cpu(), mx.gpu()]`` at (4,096, 4,096) in f32 and f64: ``exp``,
   ``arctan2``, ``sum``/``std``, ``nanmean``/``nanmax``/``nanstd``
   with 1 % NaNs, ``sort``/``argsort``, ``unique`` (bit-equal, as are
   the masks' read and write), ``cumsum``, ``fft.rfft2`` and
   ``einsum`` within their bounds, and ``solve``, ``qr``, ``svd`` and
   ``eigh`` at 1,024 (the CPU's LAPACK at 4,096 alone would take most
   of the phase's minute) each held by its residual on both devices
   and the singular values and eigenvalues card against CPU; (c)
   ``mx.np.random`` after one seed: ``uniform`` and ``normal`` at the
   FFN weight's (14,336, 4,096) (first 2^16 elements against the CPU's:
   equal, normal within 2 ulps), ``shuffle`` of its rows (the
   permutation equal), ``beta(2, 5)`` at 2^20 for moments and at 2^16
   against the CPU (parting only at a gamma near-tie), ``choice`` of
   128,256 at 32 × 4 with and without a softmax row ``p`` (float64),
   with and without replacement, and ``multinomial(100, p)``, all equal;
   moments within 6 standard errors; (d) is the profiler part; (e) the
   NaN sanitizer on a hybridized bf16 ``Dense(14336, in_units=4096)``
   and a row normalisation, replayed as a CUDA graph: a clean replay
   passes, a zero row's 0/0 raises ``FloatingPointError`` naming
   ``broadcast_div`` (the eager re-run), the flag off lets it through,
   the flag's cost on a clean replay (medians of 10, off and on);
   ``Features()`` has CUDA, CUDNN and NCCL; ``num_gpus()`` is the
   device count; ``with mx.cpu():`` places ``mx.nd``, ``mx.np`` and
   ``mx.np.random`` arrays on the CPU and outside it they land on
   ``cuda:0``; ``mx.tpu()`` is the card; ``util.get_gpu_memory(0)``
   equals ``torch.cuda.mem_get_info``.
22. contrib (ROADMAP item 10.4(d)), after ``np_runtime``, with the
   launch counts set to 0 before and read after: (a) deploy:
   ``GluonLlama`` at llama3_8b width in bf16 with its depth cut to 4
   layers (random weights from SEED, an artifact of about 3.9 GB),
   ``export_stablehlo`` on (1, 2,048) tokens → ``contrib.deploy.load``
   → one call: the logits bit-equal to the eager Gluon forward's on the
   same weights, the graph holding 4 ``mxtpu_torch::flash_attn_fwd``
   nodes and a call launching the flash forward kernel exactly 4
   times; export s, archive GB, load s and the artifact's forward ms
   beside the Gluon forward's; (b) onnx: the zoo's ResNet-50 (f32
   NCHW, batch 256, 224²) exported from card weights with
   ``contrib.onnx.export_model``, then ``import_to_gluon(ctx=card)``
   hybridized (one CUDA graph): its logits within 1e-5 of max |logit|
   of the source net's (bit-equal reported), file MB, export and import
   s and the replay's img/s; (c) lockcheck: the ``serve_engine``
   phase's ``threaded_engines`` part (two engines on ``run_forever``
   threads, 4 layers in f32) under ``contrib.analysis.lockcheck``:
   no violation, the observed lock pairs reported. ``summary`` is held
   on the CPU only: the card's host has no tensorboardX.

Then the ``kernels`` line, the ``nvidia-smi`` line, and last
``{"ok": true, "device": {...}}``. Exits non-zero with no result when no
CUDA card is visible or when the package is not beside the script.
"""
import contextlib
import functools
import json
import math
import os
import shutil
import subprocess
import sys
import time
from dataclasses import replace

import numpy as np

TOL = 2e-2                 # kernel vs plain, atol = rtol, bf16 output
LSE_TOL = 1e-3             # forward lse vs plain, atol = rtol, both f32
BWD_TOL = 2e-2             # backward kernels vs plain, atol = rtol
LOGITS_REL_BOUND = 5e-2    # ||flash - dense|| / ||dense|| at full width
TRAIN_REL_BOUND = 5e-2     # flash vs dense loss and grads, 4 layers
TRAIN_LAYERS = 4
TRAIN_STEPS = 3
TRAIN_LR = 3e-4
FLOPS_REL_BOUND = 1e-6     # counted vs analytic train-step FLOPs
MFU_REL_BOUND = 0.10       # live mfu gauge vs FLOPs / (median step x peak)
STEM_REL_BOUND = 2e-2      # ||s2d - std|| / ||std||, ResNet-50 eval logits
RESNET_BATCH = 256
RESNET_STEPS = 3
RTC_TOL = 1e-2             # swiglu vs plain, atol = rtol (scale_add: exact)
FFN_TOKENS = 2048
FFN_REL_BOUND = 2e-2       # ||rtc path - llama._ffn|| / ||llama._ffn||, bf16
FFN_GRAD_REL_BOUND = 1e-2  # tape grads vs torch.autograd, bf16
# the serving paths' bounds (python -m mxtpu_torch.tools.serve_tolerance:
# bf16 on the CPU at 2-16 layers of a narrow llama3_8b, chunked 0-0.0136,
# faults >= 0.95; int8 0.043-0.058, faults >= 0.56)
CHUNK_REL_BOUND = 5e-2     # ||chunked - one shot|| / ||one shot||, last logits
INT8_REL_BOUND = 0.2       # ||int8 - bf16|| / ||bf16||, last prefill logits
CHUNK_PROMPT, CHUNK_SIZE = 6000, 1024
# the serve engine's traffic: bench.py's bench_llama_serve at llama3_8b
# width (48 requests, 16 slots, max_len 768, prompts max_len/12..max_len/2,
# 8-256 new tokens, seeded Poisson arrivals with a mean gap of 4 steps),
# every third request sampled with SAMPLING
SERVE_REQUESTS, SERVE_SLOTS, SERVE_MAX_LEN = 48, 16, 768
SERVE_PROMPTS = (64, 128, 256, 384)
SERVE_MEAN_GAP = 4.0
# engine vs batch-1 generate in f32 at 4 layers: a differing token is
# allowed only at a near-tie of generate's decision values
SERVE_LAYERS, SERVE_TIE_REL = 4, 1e-5
# the paged pool's admission test: bench.py's bench_paged_kv at its own
# parameters (4 dense slots against the same HBM in 64-token pages under a
# 16-slot ceiling; 32 requests of 96 + 96 tokens; max_len 768, buckets
# from 64), whose contract is a peak-slot ratio of 3 or more
PAGED_DENSE_SLOTS, PAGED_CEILING, PAGED_PAGE = 4, 16, 64
PAGED_REQUESTS, PAGED_PROMPT, PAGED_NEW = 32, 96, 96
PAGED_ADMIT_RATIO = 3
TTFT_SYSTEM, TTFT_SUFFIX = 384, 8   # bench_paged_kv's warm/cold prompt
# speculative decoding: bench.py's bench_spec (k = 4, 2 slots, pages of
# 16, max_len 256, 6 greedy requests of 200 new tokens on two prompts)
SPEC_K, SPEC_SLOTS, SPEC_MAX_LEN, SPEC_PAGE = 4, 2, 256, 16
SPEC_REQUESTS, SPEC_NEW = 6, 200
SPEC_PROMPTS = ([140, 141, 140], [175, 243, 166])
SPEC_F32_NEW, SPEC_RESUME_AT = 48, 5
# in bf16 at full width a speculative stream may part from k = 0 only at a
# near-tie: the two tokens' decision values within 2^-6 of |max|, eight
# bf16 half-ulps (each rounding of an activation moves it up to 2^-9 of
# itself), where a token from a faulty verify step lies about |max| below
SPEC_BF16_TIE_REL = 2 ** -6
# the serving tier: bench.py's bench_gateway at llama3_8b width (two
# replicas of 8 slots, max_len 768, buckets from max_len/12; 32 requests
# on seeded exponential arrivals of mean 0.15 s, prompts max_len/12 to
# max_len/2, 8 to max_len/3 new tokens) and bench_disagg_stream's protocol
# (prompts of 448 tokens, 4 new ones at temperature 0.7, one warm-up and 5
# timed requests, pages of 64, chunks of 64) over a 250 MB/s wire, where
# llama3_8b's 131 KB of K/V a token makes a 448-token handoff 58.7 MB
GATEWAY_REPLICAS, GATEWAY_SLOTS, GATEWAY_MAX_LEN = 2, 8, 768
GATEWAY_REQUESTS, GATEWAY_MEAN_GAP_S, GATEWAY_WARM_NEW = 32, 0.15, 8
DISAGG_PROMPT, DISAGG_NEW, DISAGG_TEMPERATURE, DISAGG_TIMED = 448, 4, 0.7, 15
DISAGG_NO_WIRE = 5
DISAGG_PAGE, DISAGG_CHUNK, DISAGG_MAX_LEN = 64, 64, 512
DISAGG_WIRE_MBPS = 250.0
# the streamed worker's compute loop before its chunk program was one
# CUDA graph (eager chunks; three whole runs of this script on an NVIDIA
# H100 80GB HBM3 at 700 W, PERF.md section 5)
DISAGG_LOOP_BEFORE_MS = (517, 565)
# supervision for the f32 replica kill: a tight heartbeat, short backoff
GATEWAY_SUPERVISION = dict(heartbeat_s=0.05, backoff_base_s=0.01,
                           backoff_max_s=0.05)
GATEWAY_KILL_STEP = 3
# the fleet: "llama" (the slice's 32 layers, two replicas of the gateway's
# shape) beside "llama8" (the same widths at 8 layers, seed 1, one
# replica, at most two); bench_gateway's 32 requests split between them,
# each with a seeded priority class, 4 sessions of two requests; the
# replica kill mid-swap: an anchor of 256 new tokens pinned to replica 1
# (about 21 ms a step keeps it a live old-build home for about 5 s), 6
# requests of 32, and replica 0 killed at its first step after the plan
# is attached (its ``steps_run`` then). A later step comes late:
# replica 0's eager admissions wait behind replica 1's steps on the card
# (measured on an H100 by
# ``python -m mxtpu_torch.tools.engine_contention``), so a kill 3 steps
# on fired only once replica 1 had drained, leaving the re-dispatch no
# old-build home
FLEET_SMALL_LAYERS = 8
FLEET_PRIORITIES = ("interactive", "batch", "offline")
FLEET_SESSIONS = 4
FLEET_ANCHOR_NEW = 256
# the flywheel: llama3_8b widths at 2 layers in the reference's training
# dtypes, 4 adamw steps each saved (async, the last 2 kept), candidates
# published at steps 2 and 4 into a two-replica bf16 fleet (4 slots,
# max_len 256) whose canary SLO is a 5 s TTFT; a 6 s decode stall on the
# second canary breaches it. Adam without warmup raises the loss at this
# width at larger rates, so the rate is one at which
# every step lowers the held-out loss the gate reads
FLYWHEEL_LAYERS, FLYWHEEL_STEPS, FLYWHEEL_LR = 2, 4, 3e-6
FLYWHEEL_SLOTS, FLYWHEEL_MAX_LEN, FLYWHEEL_NEW = 4, 256, 32
FLYWHEEL_TTFT_MS, FLYWHEEL_STALL_S, FLYWHEEL_POLL_S = 5000.0, 6.0, 0.2
GUMBEL_ULPS = 2            # card vs CPU, in ulps of max(|g|, 1)
RNG_SEEDS = (0, 42, 2 ** 31 - 1)
RNG_SHAPES = ((7,), (3, 5, 11), (4, 128256))
SAMPLING = {"temperature": 0.8, "top_k": 50, "top_p": 0.95}
RNG_MASK_P = 0.9           # the keyed train loss keeps a target with p
SEED = 0

# (name, b, hq, hkv, sq, skv, d, causal, strided)
KERNEL_SHAPES = [
    ("llama3_8b", 1, 32, 8, 2048, 2048, 128, True, False),
    ("ragged", 2, 4, 4, 1000, 777, 64, False, False),
    ("single", 1, 2, 1, 1, 1, 128, True, False),
    ("causal_sq<skv", 1, 4, 2, 65, 130, 64, True, False),
    ("causal_sq>skv", 1, 4, 4, 130, 65, 128, True, False),
    ("strided_bshd", 2, 8, 2, 100, 100, 128, True, True),
    ("short_q", 1, 2, 2, 3, 200, 64, False, False),
    ("tile_edge", 1, 4, 2, 129, 257, 128, True, False),
    ("bshd_d64", 2, 8, 2, 200, 333, 64, False, True),
]


# (kernel, name, shape, offset in elements from an aligned start)
RTC_SHAPES = [
    ("scale_add", "reference_test", (2, 128), 0),
    ("scale_add", "main", (8192, 4096), 0),
    ("scale_add", "ragged", (3, 1001), 0),
    ("scale_add", "misaligned", (4097,), 1),
    ("swiglu", "llama3_8b_ffn", (2048, 14336), 0),
    ("swiglu", "odd", (3, 7), 0),
    ("swiglu", "misaligned", (2, 4097), 1),
]


# (name, B, H, W, C, O)
CONV_SHAPES = [
    ("experiment", 128, 14, 14, 256, 256),
    ("resnet50_56", 32, 56, 56, 64, 64),
    ("resnet50_28", 32, 28, 28, 128, 128),
    ("resnet50_7", 32, 7, 7, 512, 512),
    ("ragged", 3, 5, 9, 64, 72),
]
# checked, not timed: (name, B, H, W, C, O), each plan (BN, split) at two
# or more, and the split ones also against the unsplit plan
CONV_EDGE_SHAPES = [
    ("one_pixel", 1, 1, 1, 8, 8),          # (64, 1)
    ("narrow", 2, 3, 5, 8, 16),            # (64, 1): C, O under a stage
    ("wide_row", 1, 2, 300, 16, 64),       # (64, 1): a row past a tile
    ("c72_o200", 2, 9, 11, 72, 200),       # (64, 1): C, O past a stage
    ("c24_o40", 8, 34, 34, 24, 40),        # (64, 1)
    ("c136_o40", 1, 7, 7, 136, 40),        # (64, 2): 27 stages, 13 + 14
    ("c200_o72", 2, 9, 11, 200, 72),       # (64, 2): 36 stages, 18 + 18
    ("c8_o136", 2, 60, 50, 8, 136),        # (128, 1): O past a tile
    ("c72_o136", 6, 40, 40, 72, 136),      # (128, 1)
    ("c136_o72", 3, 40, 50, 136, 72),      # (128, 2): 27 stages, 13 + 14
    ("c200_o136", 3, 36, 36, 200, 136),    # (128, 2): 36 stages, 18 + 18
]
# one launch covers at most 2^30 pixels (TMA's int32 row coordinates), so
# this conv (1.1e9 pixels, 35 GB of x and y) takes two: checked at the
# images around the boundary, which falls inside image 1073
CONV_CHUNKED = (1100, 1000, 1000, 8, 8)


def emit(obj):
    print(json.dumps(obj), flush=True)


def nvidia_smi():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def sdpa_call(q, k, v, causal, scale):
    """One PyTorch call computing the same function, as a yardstick."""
    import torch.nn.functional as F
    kw = {"enable_gqa": True} if q.shape[1] != k.shape[1] else {}
    return lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=causal, scale=scale, **kw)


def shape_inputs(gen, b, hq, hkv, sq, skv, d, strided):
    """Seeded bf16 q, k, v and dO, as (b, s, h, d) storage seen through
    a transpose when ``strided`` (the model's layout)."""
    import torch

    def rand(h, s):
        shape = (b, s, h, d) if strided else (b, h, s, d)
        t = torch.randn(shape, generator=gen, device="cuda",
                        dtype=torch.bfloat16)
        return t.transpose(1, 2) if strided else t
    return rand(hq, sq), rand(hkv, skv), rand(hkv, skv), rand(hq, sq)


def kernel_phase():
    import torch
    from mxtpu_torch.ops import attention as A
    from mxtpu_torch.tools.timing import host_ms, time_ms
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    rows = []
    for name, b, hq, hkv, sq, skv, d, causal, strided in KERNEL_SHAPES:
        q, k, v, _ = shape_inputs(gen, b, hq, hkv, sq, skv, d, strided)
        scale = 1.0 / math.sqrt(d)
        out = A.flash_attention(q, k, v, causal=causal)
        out_l, lse = A.flash_attention_fwd(q, k, v, causal=causal,
                                           return_lse=True)
        torch.cuda.synchronize()
        ref, ref_lse = A.blockwise_attention(
            q.float(), k.float(), v.float(), causal=causal, return_lse=True)
        err = (out.float() - ref).abs().max().item()
        lse_err = (lse - ref_lse).abs().max().item()
        ok = (torch.allclose(out.float(), ref, atol=TOL, rtol=TOL)
              and torch.equal(out, out_l)
              and torch.allclose(lse, ref_lse, atol=LSE_TOL, rtol=LSE_TOL))
        row = {"phase": "kernel", "kernel": "flash_attention_fwd",
               "shape": name, "b": b, "hq": hq, "hkv": hkv, "sq": sq,
               "skv": skv, "d": d, "causal": causal, "strided": strided,
               "max_abs_err": err, "tol": TOL, "lse_max_abs_err": lse_err,
               "lse_tol": LSE_TOL, "ok": ok}
        if name in ("llama3_8b", "ragged"):
            bound, bound_by = A.attention_bound_ms(b, hq, hkv, sq, skv, d,
                                                   causal)
            row.update(
                kernel_ms=time_ms(lambda: A.flash_attention(
                    q, k, v, causal=causal), reps=50),
                kernel_lse_ms=time_ms(lambda: A.flash_attention_fwd(
                    q, k, v, causal=causal, return_lse=True), reps=50),
                library_ms=time_ms(sdpa_call(q, k, v, causal, scale),
                                   reps=50),
                plain_ms=time_ms(lambda: A.blockwise_attention(
                    q, k, v, causal=causal), reps=3, warmup=1),
                host_ms=host_ms(lambda: A.flash_attention(
                    q, k, v, causal=causal), reps=50),
                bound_ms=bound, bound_by=bound_by)
            row["bound_share"] = row["bound_ms"] / row["kernel_ms"]
            row["tflops"] = (A.attention_cost(b, hq, hkv, sq, skv, d,
                                              causal)[0]
                             / row["kernel_ms"] / 1e9)
        emit(row)
        if not (ok and math.isfinite(err) and math.isfinite(lse_err)):
            raise AssertionError(f"flash kernel disagrees with its plain "
                                 f"version at {name}: max err {err}, lse "
                                 f"{lse_err}")
        rows.append(row)
    return rows


def kernel_bwd_phase():
    """The backward kernels against their plain version at every kernel
    shape; times at the main shape."""
    import torch
    from mxtpu_torch.ops import attention as A
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    rows = []
    for name, b, hq, hkv, sq, skv, d, causal, strided in KERNEL_SHAPES:
        q, k, v, do = shape_inputs(gen, b, hq, hkv, sq, skv, d, strided)
        o, lse = A.flash_attention_fwd(q, k, v, causal=causal,
                                       return_lse=True)
        got = A.flash_attention_bwd(q, k, v, o, lse, do, causal=causal)
        again = A.flash_attention_bwd(q, k, v, o, lse, do, causal=causal)
        _, delta = A.flash_attention_bwd_dq(q, k, v, do, lse, o,
                                            causal=causal)
        torch.cuda.synchronize()
        deterministic = all(map(torch.equal, got, again))
        want = A.flash_attention_bwd_plain(q.float(), k.float(), v.float(),
                                           o, lse, do, causal=causal)
        want_delta = (do.float() * o.float()).sum(dim=-1)
        errs = {n: (g.float() - w).abs().max().item()
                for n, g, w in zip(("dq", "dk", "dv"), got, want)}
        delta_err = (delta - want_delta).abs().max().item()
        ok = (all(torch.allclose(g.float(), w, atol=BWD_TOL, rtol=BWD_TOL)
                  for g, w in zip(got, want))
              and torch.allclose(delta, want_delta, atol=LSE_TOL,
                                 rtol=LSE_TOL) and deterministic)
        row = {"phase": "kernel_bwd", "shape": name, "b": b, "hq": hq,
               "hkv": hkv, "sq": sq, "skv": skv, "d": d, "causal": causal,
               "strided": strided, "max_abs_err": errs, "tol": BWD_TOL,
               "delta_max_abs_err": delta_err, "delta_tol": LSE_TOL,
               "deterministic": deterministic, "ok": ok}
        if name in ("llama3_8b", "ragged"):
            row.update(bwd_times(q, k, v, o, lse, do, causal))
        emit(row)
        if not (ok and all(map(math.isfinite, errs.values()))
                and math.isfinite(delta_err)):
            raise AssertionError(f"flash backward kernels disagree with "
                                 f"their plain version at {name}: {errs}, "
                                 f"D {delta_err}, two calls equal: "
                                 f"{deterministic}")
        rows.append(row)
    return rows


def bwd_times(q, k, v, o, lse, do, causal):
    """Device times of the backward at one shape, each the median of 5
    windows: each kernel alone, the pair (dQ with D, then dK/dV), SDPA's
    backward (a yardstick, its backend pinned) and the plain version;
    bounds, TFLOP/s and shares of bound; the host time of one pair call
    (wrapper checks, tensor-map encodings, launches)."""
    from mxtpu_torch.ops import attention as A
    from mxtpu_torch.tools.timing import host_ms, median_ms, time_ms
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    _, delta = A.flash_attention_bwd_dq(q, k, v, do, lse, o, causal=causal)
    calls = {
        "dkv": lambda: A.flash_attention_bwd_dkv(q, k, v, do, lse, delta,
                                                 causal=causal),
        "dq": lambda: A.flash_attention_bwd_dq(q, k, v, do, lse, o,
                                               causal=causal),
        "pair": lambda: A.flash_attention_bwd(q, k, v, o, lse, do,
                                              causal=causal)}
    pairs = A.visible_pairs(sq, skv, causal)
    out = {}
    for name, fn in calls.items():
        matmuls, reads, writes = A.BWD_WORK[name]
        bound, bound_by = A.bwd_bound_ms(b, hq, hkv, sq, skv, d, causal,
                                         matmuls, reads, writes)
        ms = median_ms(fn, reps=20)
        out.update({f"{name}_ms": ms, f"{name}_bound_ms": bound,
                    f"{name}_bound_by": bound_by,
                    f"{name}_bound_share": bound / ms,
                    f"{name}_tflops": 2 * matmuls * d * hq * b * pairs
                    / ms / 1e9})
    out["pair_host_ms"] = host_ms(calls["pair"])
    # SDPA's backward, pinned to the flash backend for library_ms; the
    # others that take these inputs beside it, since an unpinned call
    # may pick any of them
    by_backend = {}
    for backend in SDPA_BACKENDS:
        timed = sdpa_backward(q, k, v, do, causal, backend)
        if timed is not None:
            grad, node, gqa = timed
            by_backend[backend] = {"ms": median_ms(grad, reps=20),
                                   "node": node, "gqa": gqa}
            del grad
    flash = by_backend["FLASH_ATTENTION"]
    out.update(library_ms=flash["ms"], library_backend=flash["node"],
               library_gqa=flash["gqa"], library_by_backend=by_backend,
               plain_ms=time_ms(lambda: A.flash_attention_bwd_plain(
                   q, k, v, o, lse, do, causal=causal), reps=3, warmup=1))
    return out


SDPA_BACKENDS = ("FLASH_ATTENTION", "CUDNN_ATTENTION", "EFFICIENT_ATTENTION")


def sdpa_backward(q, k, v, do, causal, backend):
    """SDPA's backward on the same inputs as a yardstick (the port never
    calls it), pinned to ``backend`` (an ``SDPBackend`` name): (the timed
    call, the backward node's name, how GQA was taken), or None if the
    backend takes these inputs neither way. Where it refuses
    ``enable_gqa``, k and v are repeated to hq heads outside the timed
    call."""
    import warnings
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel
    rep = q.shape[1] // k.shape[1]
    tries = [("native" if rep > 1 else "none (hq == hkv)", 1)]
    if rep > 1:
        tries.append(("k and v repeated outside the timed call", rep))
    for gqa, r in tries:
        leaves = [q.detach().requires_grad_()] + [
            (t.repeat_interleave(r, dim=1) if r > 1 else t).detach()
            .requires_grad_() for t in (k, v)]
        try:
            with sdpa_kernel([getattr(SDPBackend, backend)]), \
                    warnings.catch_warnings():
                warnings.simplefilter("ignore")
                out = F.scaled_dot_product_attention(
                    *leaves, is_causal=causal,
                    enable_gqa=leaves[1].shape[1] != q.shape[1])
                torch.autograd.grad(out, leaves, do, retain_graph=True)
        except RuntimeError:
            continue
        return (lambda: torch.autograd.grad(out, leaves, do,
                                            retain_graph=True),
                out.grad_fn.name(), gqa)
    return None


def slice_phase():
    import torch
    from mxtpu_torch.models import llama
    from mxtpu_torch.ops import attention as A
    cfg = replace(llama.CONFIGS["llama3_8b"], param_dtype=torch.bfloat16)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    t0 = time.perf_counter()
    params = llama.init_params(cfg, gen, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in params["layers"].values()) + sum(
        p.numel() for k, p in params.items() if k != "layers")
    emit({"phase": "init", "config": "llama3_8b", "params": n_params,
          "param_dtype": "bfloat16", "n_layers": cfg.n_layers,
          "seconds": time.perf_counter() - t0})

    with torch.inference_mode():
        tokens = torch.randint(0, cfg.vocab_size, (1, 2048), generator=gen,
                               device="cuda")
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        t0 = time.perf_counter()
        logits = llama.forward(cfg, params, tokens)
        torch.cuda.synchronize()
        fwd_s = [time.perf_counter() - t0]
        launches = read_launches()
        t0 = time.perf_counter()        # again, with cuBLAS warm
        llama.forward(cfg, params, tokens)
        torch.cuda.synchronize()
        fwd_s.append(time.perf_counter() - t0)
        dense = llama.forward(replace(cfg, attn_impl="dense"), params,
                              tokens)
        torch.cuda.synchronize()
        finite = bool(torch.isfinite(logits).all())
        rel = ((logits - dense).norm() / dense.norm()).item()
        agree = (logits.argmax(-1) == dense.argmax(-1)).float().mean().item()
        emit({"phase": "forward", "tokens": list(tokens.shape),
              "logits": list(logits.shape), "dtype": str(logits.dtype),
              "finite": finite, "launches": launches,
              "seconds": fwd_s, "rel_err_vs_dense": rel,
              "rel_err_bound": LOGITS_REL_BOUND, "argmax_agree": agree,
              "peak_gb": torch.cuda.max_memory_allocated() / 1e9})
        if not (finite and logits.dtype == torch.float32
                and tuple(logits.shape) == (1, 2048, cfg.vocab_size)):
            raise AssertionError("forward logits are not finite f32 "
                                 "(1, 2048, vocab)")
        if launches != only(flash_attention_fwd=cfg.n_layers):
            raise AssertionError(f"forward launched {launches}, not "
                                 f"{cfg.n_layers} forward kernels")
        if not rel <= LOGITS_REL_BOUND:
            raise AssertionError(f"flash vs dense logits {rel} > "
                                 f"{LOGITS_REL_BOUND}")
        del dense
        gluon_launches = gluon_forward_phase(cfg, params, tokens, logits)
        del logits
        profiler_launches = np_profiler_phase(cfg, params, tokens)
        torch.cuda.empty_cache()

        prompts = torch.randint(0, cfg.vocab_size, (4, 128), generator=gen,
                                device="cuda")
        runs = []
        for _ in range(2):
            torch.cuda.synchronize()  # mxlint: disable=MXL004 — timed from an idle card
            t0 = time.perf_counter()
            out = llama.generate(cfg, params, prompts, 32)
            torch.cuda.synchronize()  # mxlint: disable=MXL004 — timed from an idle card
            runs.append((out, time.perf_counter() - t0))
        (out, t1), (out2, t2) = runs
        new = out[:, 128:]
        emit({"phase": "generate", "requests": 4, "prompt_len": 128,
              "new_tokens": 32, "seconds": [t1, t2],
              "tok_per_s": [4 * 32 / t1, 4 * 32 / t2],
              "reproducible": bool(torch.equal(out, out2)),
              "first_tokens": new[:, :8].tolist()})
        if not (tuple(out.shape) == (4, 160)
                and torch.equal(out[:, :128], prompts)
                and bool(((new >= 0) & (new < cfg.vocab_size)).all())):
            raise AssertionError("generate returned malformed tokens")
        if not torch.equal(out, out2):
            raise AssertionError("greedy generate is not reproducible")

        engine_launches, dense_streams = serve_engine_phase(cfg, params)
        serve = [sampled_phase(cfg, params, prompts, out, min(t1, t2)),
                 chunked_phase(cfg, params, gen),
                 int8_phase(cfg, params, prompts), engine_launches,
                 paged_attention_phase(),
                 paged_engine_phase(cfg, params, dense_streams),
                 spec_engine_phase(cfg, params),
                 gateway_phase(cfg, params),
                 fleet_phase(cfg, params), gluon_launches,
                 profiler_launches]
    return {k: launches[k] + sum(n[k] for n in serve)
            for k in LAUNCH_COUNTERS}


def gluon_forward_phase(cfg, params, tokens, want):
    """(a2) in the docstring: ``GluonLlama`` over the slice's tree, eager
    then hybridized, each call's logits against ``want``
    (``llama.forward``'s on the same tokens), bit for bit."""
    import torch
    import mxtpu_torch as mx
    from mxtpu_torch.gluon.model_zoo import GluonLlama
    net = GluonLlama(cfg)
    net.collect_params().setattr("grad_req", "null")
    net.load_pytree(params)
    tok = mx.nd.NDArray(tokens)
    shared = net.as_pytree()["layers"]["wq"] is params["layers"]["wq"]
    rows, launches = {}, {}

    def call(name):
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = net(tok)._data
        torch.cuda.synchronize()
        rows[name] = {"seconds": time.perf_counter() - t0,
                      "bit_equal": bool(torch.equal(out, want)),
                      "launches": read_launches()}
        launches[name] = rows[name]["launches"]
    call("eager")
    net.hybridize()
    call("capture")
    call("replay")
    call("replay_again")
    emit({"phase": "gluon_forward", "card": nvidia_smi(),
          "config": "llama3_8b", "n_layers": cfg.n_layers,
          "tokens": list(tokens.shape), "params_shared": shared,
          "captures": net.captures, **rows})
    n = cfg.n_layers
    want_launches = {"eager": only(flash_attention_fwd=n),
                     "capture": only(flash_attention_fwd=2 * n),
                     "replay": only(), "replay_again": only()}
    if not shared:
        raise AssertionError("GluonLlama copied the slice's tree")
    bad = [k for k, r in rows.items() if not r["bit_equal"]]
    if bad:
        raise AssertionError(f"GluonLlama logits differ from "
                             f"llama.forward's: {bad}")
    if launches != want_launches or net.captures != 1:
        raise AssertionError(f"GluonLlama launched {launches} with "
                             f"{net.captures} captures, not "
                             f"{want_launches} and one")
    del net
    return {k: sum(v[k] for v in launches.values())
            for k in LAUNCH_COUNTERS}


def ulps_of_max1(got, want):
    """|got - want| in f32 ulps of max(|want|, 1): the Gumbel noise's
    measure, where each ``log`` rounds within an ulp of its own result
    and the inner one's ulp reaches the outer result as one ulp of 1."""
    import torch
    scale = torch.maximum(want.abs(), torch.ones_like(want))
    ulp = torch.nextafter(scale, torch.full_like(scale, math.inf)) - scale
    return ((got.double() - want.double()).abs() / ulp.double()).max().item()


def rng_phase():
    """The Threefry chain on the card against the same calls on the
    CPU: keys, splits, fold_in, 32- and 64-bit bits and uniforms bit for
    bit, gumbel within GUMBEL_ULPS, categorical tokens equal; then one
    ``sample_logits`` call at (4, vocab) timed, static and traced."""
    import torch
    from mxtpu_torch import prng
    from mxtpu_torch.models import llama
    from mxtpu_torch.tools.timing import host_ms, time_ms
    calls = {}
    for seed in RNG_SEEDS:
        def key(dev, seed=seed):
            return prng.PRNGKey(seed, device=dev) # noqa: MXL301 — a check's seeded chain root, compared with the engine's
        calls[f"PRNGKey({seed})"] = key
        calls[f"split({seed}, 3)"] = lambda dev, key=key: prng.split( # noqa: MXL301 — a check's seeded chain root, compared with the engine's
            key(dev), 3)
        for d in (0, 1, 7):
            calls[f"fold_in({seed}, {d})"] = \
                lambda dev, key=key, d=d: prng.fold_in(key(dev), d)
        for shape in RNG_SHAPES:
            for width in (32, 64):
                calls[f"bits{width}({seed}, {shape})"] = \
                    lambda dev, key=key, w=width, sh=shape: \
                    prng.random_bits(key(dev), w, sh)
        calls[f"uniform_f32({seed})"] = lambda dev, key=key: \
            prng.uniform(key(dev), RNG_SHAPES[-1]).view(torch.int32)
        for dt, it in ((torch.float32, torch.int32),
                       (torch.float64, torch.int64)):
            calls[f"uniform_{dt}({seed}, -3.3, 7.1)"] = \
                lambda dev, key=key, dt=dt, it=it: prng.uniform(
                    key(dev), (3, 5, 11), dt, -3.3, 7.1).view(it)
    differ = [name for name, f in calls.items()
              if not torch.equal(f("cuda").cpu(), f("cpu"))]
    key_c, key_h = prng.PRNGKey(SEED, "cuda"), prng.PRNGKey(SEED, "cpu") # noqa: MXL301 — a check's seeded chain root, compared with the engine's
    g_ulps = ulps_of_max1(prng.gumbel(key_c, RNG_SHAPES[-1]).cpu(),
                          prng.gumbel(key_h, RNG_SHAPES[-1]))
    gen = torch.Generator().manual_seed(SEED)
    lg_h = torch.randn(RNG_SHAPES[-1], generator=gen) * 3
    lg = lg_h.to("cuda")
    tok_c = prng.categorical(key_c, lg).cpu()
    tok_h = prng.categorical(key_h, lg_h)
    b = lg.shape[0]
    knobs = {k: torch.full((b,), v, device="cuda")
             for k, v in SAMPLING.items()}

    def static():
        return llama.sample_logits(key_c, lg, **SAMPLING)

    def traced():
        return llama.sample_logits(key_c, lg, **knobs)
    same_modes = bool(torch.equal(static(), traced()))
    times = {name: {"ms": time_ms(f, 20), "host_ms": host_ms(f)}
             for name, f in (("static", static), ("traced", traced))}
    emit({"phase": "rng", "bit_exact_calls": len(calls),
          "differ": differ, "gumbel_max_ulps": g_ulps,
          "gumbel_bound_ulps": GUMBEL_ULPS,
          "categorical_tokens": tok_c.tolist(),
          "categorical_equal": bool(torch.equal(tok_c, tok_h)),
          "sample_logits": {"shape": list(lg.shape), **SAMPLING, **times,
                            "static_equals_traced": same_modes}})
    if differ:
        raise AssertionError(f"the chain on the card differs from the "
                             f"CPU's at {differ}")
    if not g_ulps <= GUMBEL_ULPS:
        raise AssertionError(f"gumbel card vs CPU {g_ulps} ulps")
    if not torch.equal(tok_c, tok_h):
        raise AssertionError(f"categorical drew {tok_c} on the card, "
                             f"{tok_h} on the CPU")
    if not same_modes:
        raise AssertionError("static and traced sample_logits differ")


def sampled_phase(cfg, params, prompts, greedy, greedy_s):
    """Sampled ``generate`` (SAMPLING) on the slice's weights and
    prompts: the default key twice (PRNGKey(0), given the second time),
    another key, per-row tensors of the same knobs, and a mixed call
    whose row 0 is greedy."""
    import torch
    from mxtpu_torch import prng
    from mxtpu_torch.models import llama
    b, s0 = prompts.shape
    n_new = greedy.shape[1] - s0

    def run(rng=None, **knobs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = llama.generate(cfg, params, prompts, n_new, rng=rng,
                             **(knobs or SAMPLING))
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    def col(*vals):
        return torch.tensor(vals, device="cuda")
    reset_launches()
    out, t1 = run()
    out2, t2 = run(prng.PRNGKey(0, "cuda")) # noqa: MXL301 — a check's seeded chain root, compared with the engine's
    other, _ = run(prng.PRNGKey(1, "cuda")) # noqa: MXL301 — a check's seeded chain root, compared with the engine's
    traced, _ = run(prng.PRNGKey(0, "cuda"), **{ # noqa: MXL301 — a check's seeded chain root, compared with the engine's
        k: col(*[v] * b) for k, v in SAMPLING.items()})
    mixed, _ = run(prng.PRNGKey(0, "cuda"), **{ # noqa: MXL301 — a check's seeded chain root, compared with the engine's
        k: col(*([0.0 if k == "temperature" else v] + [v] * (b - 1)))
        for k, v in SAMPLING.items()})
    launches = read_launches()
    checks = {"reproducible": bool(torch.equal(out, out2)),
              "other_key_differs": not torch.equal(out, other),
              "traced_equals_static": bool(torch.equal(traced, out)),
              "mixed_row0_is_greedy": bool(torch.equal(mixed[0], greedy[0])),
              "mixed_rows_sampled": bool(torch.equal(mixed[1:], out[1:]))}
    new = out[:, s0:]
    emit({"phase": "generate_sampled", "requests": b, "prompt_len": s0,
          "new_tokens": n_new, **SAMPLING, "seconds": [t1, t2],
          "tok_per_s": [b * n_new / t1, b * n_new / t2],
          "greedy_tok_per_s": b * n_new / greedy_s,
          "first_tokens": new[:, :8].tolist(), **checks,
          "launches": launches})
    if not (tuple(out.shape) == tuple(greedy.shape)
            and torch.equal(out[:, :s0], prompts)
            and bool(((new >= 0) & (new < cfg.vocab_size)).all())):
        raise AssertionError("sampled generate returned malformed tokens")
    failed = [k for k, v in checks.items() if not v]
    if failed:
        raise AssertionError(f"sampled generate failed {failed}")
    if launches != only():
        raise AssertionError(f"sampled generate launched {launches}")
    return launches


def chunked_phase(cfg, params, gen, prompt_len=CHUNK_PROMPT,
                  chunk=CHUNK_SIZE, phase="chunked_prefill"):
    """``chunked_prefill`` of a (1, prompt_len) prompt in chunks of
    ``chunk`` against ``prefill(last_only=True)``, with each one's peak
    memory."""
    import torch
    from mxtpu_torch.models import llama
    prompt = torch.randint(0, cfg.vocab_size, (1, prompt_len),
                           generator=gen, device="cuda")
    reset_launches()
    found = {}
    for name in ("chunked", "one_shot"):
        cache = llama.init_cache(cfg, 1, prompt_len, device="cuda")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        if name == "chunked":
            lg, cache = llama.chunked_prefill(cfg, params, prompt, cache,
                                              chunk)
        else:
            lg, cache = llama.prefill(cfg, params, prompt, cache,
                                      last_only=True)
        torch.cuda.synchronize()
        found[name] = (lg, cache["pos"], time.perf_counter() - t0,
                       torch.cuda.max_memory_allocated() / 1e9,
                       (torch.cuda.max_memory_allocated() - before) / 1e9)
        del cache
    launches = read_launches()
    (lc, pc, tc, gc, dc), (l1, p1, t1, g1, d1) = found.values()
    rel = rel_dist(lc, l1)
    same_argmax = bool(torch.equal(lc.argmax(-1), l1.argmax(-1)))
    emit({"phase": phase, "prompt_len": prompt_len,
          "chunk": chunk, "passes": -(-prompt_len // chunk),
          "logits": list(lc.shape), "pos": [pc, p1],
          "seconds": {"chunked": tc, "one_shot": t1},
          "peak_gb": {"chunked": gc, "one_shot": g1},
          "peak_gb_above_start": {"chunked": dc, "one_shot": d1},
          "rel_err": rel, "rel_err_bound": CHUNK_REL_BOUND,
          "argmax_equal": same_argmax, "launches": launches})
    if not (pc == p1 == prompt_len and lc.shape == l1.shape
            and bool(torch.isfinite(lc).all())):
        raise AssertionError("chunked prefill: cache positions or logits")
    if not (rel <= CHUNK_REL_BOUND and same_argmax):
        raise AssertionError(f"chunked vs one-shot logits {rel} > "
                             f"{CHUNK_REL_BOUND} or another argmax")
    if launches != only():
        raise AssertionError(f"chunked prefill launched {launches}")
    return launches


def int8_phase(cfg, params, prompts):
    """``quantize_params_int8`` of the slice's weights on the card; the
    int8 prefill logits against the bf16 ones; greedy ``generate`` off
    the int8 tree twice."""
    import torch
    from mxtpu_torch.models import llama
    b, s0 = prompts.shape
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    q = llama.quantize_params_int8(cfg, params)
    torch.cuda.synchronize()
    quant_s = time.perf_counter() - t0
    int8_gb = sum(t.numel() * t.element_size()
                  for _, t in _leaves_with_keys(q)) / 1e9

    def last_logits(tree):
        lg, _ = llama.prefill(cfg, tree, prompts,
                              llama.init_cache(cfg, b, s0, device="cuda"),
                              last_only=True)
        return lg
    rel = rel_dist(last_logits(q), last_logits(params))
    torch.cuda.reset_peak_memory_stats()
    runs = []
    for _ in range(2):
        torch.cuda.synchronize()  # mxlint: disable=MXL004 — timed from an idle card
        t0 = time.perf_counter()
        out = llama.generate(cfg, q, prompts, 32)
        torch.cuda.synchronize()  # mxlint: disable=MXL004 — timed from an idle card
        runs.append((out, time.perf_counter() - t0))
    launches = read_launches()
    (out, t1), (out2, t2) = runs
    new = out[:, s0:]
    emit({"phase": "generate_int8", "int8_tree_gb": int8_gb,
          "quantize_seconds": quant_s, "rel_err_vs_bf16": rel,
          "rel_err_bound": INT8_REL_BOUND, "requests": b,
          "prompt_len": s0, "new_tokens": 32, "seconds": [t1, t2],
          "tok_per_s": [b * 32 / t1, b * 32 / t2],
          "reproducible": bool(torch.equal(out, out2)),
          "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
          "first_tokens": new[:, :8].tolist(), "launches": launches})
    if not rel <= INT8_REL_BOUND:
        raise AssertionError(f"int8 vs bf16 logits {rel} > "
                             f"{INT8_REL_BOUND}")
    if not (torch.equal(out, out2) and torch.equal(out[:, :s0], prompts)
            and bool(((new >= 0) & (new < cfg.vocab_size)).all())):
        raise AssertionError("int8 generate: malformed or not reproducible")
    if launches != only():
        raise AssertionError(f"int8 serving launched {launches}")
    return launches


def serve_requests(cfg):
    """``bench_llama_serve``'s stream at SERVE_MAX_LEN: (prompt,
    max_new_tokens, arrival step) from a seeded generator; request i is
    seeded i, and every third one is sampled."""
    from mxtpu_torch.serve import Request
    rng = np.random.default_rng(SEED)
    reqs, arrival = [], 0.0
    for i in range(SERVE_REQUESTS):
        plen = int(rng.choice(SERVE_PROMPTS))
        mnew = int(rng.integers(8, SERVE_MAX_LEN // 3 + 1))
        knobs = SAMPLING if i % 3 == 2 else {}
        reqs.append(Request(prompt=rng.integers(0, cfg.vocab_size, plen),
                            max_new_tokens=mnew, seed=i,
                            arrival_step=int(arrival), **knobs))
        arrival += rng.exponential(SERVE_MEAN_GAP)
    return reqs


def serve_stream(engine, reqs, order, on_token=None):
    """Submit ``reqs`` in ``order`` and drain: {request index: tokens}."""
    rids = {}
    for i in order:
        r = reqs[i]
        rids[i] = engine.submit(replace(r, on_token=on_token))
    res = engine.run()
    return {i: res[rid] for i, rid in rids.items()}


def generate_one(cfg, params, req, n_new):
    """Batch-1 ``generate`` of a request, as ``llama_refs.reference`` is
    for the reference: its key is ``PRNGKey(seed)``."""
    import torch
    from mxtpu_torch import prng
    from mxtpu_torch.models import llama
    prompt = torch.as_tensor(np.asarray(req.prompt), device="cuda")[None]
    out = llama.generate(cfg, params, prompt, n_new,
                         temperature=req.temperature, top_k=req.top_k,
                         top_p=req.top_p,
                         rng=prng.PRNGKey(req.seed, "cuda")) # noqa: MXL301 — a check's seeded chain root, compared with the engine's
    return out[0, prompt.shape[1]:].cpu().numpy()


def decision_values(cfg, params, req, toks, j):
    """At generated position j, where ``generate`` chose ``toks[j]``:
    every token's decision value (V,), from a batch-1 prefill of the
    prompt and ``toks[:j]``. The decision values are the logits (greedy)
    or the sampler's perturbed ones: the Gumbel noise of emission j's
    subkey plus the scaled, top-k and nucleus masked logits."""
    import torch
    from mxtpu_torch import prng
    from mxtpu_torch.models import llama
    from mxtpu_torch.serve import resume_key
    seq = np.concatenate([np.asarray(req.prompt), toks[:j]])
    seq = torch.as_tensor(seq, device="cuda")[None]
    lg, _ = llama.prefill(cfg, params, seq,
                          llama.init_cache(cfg, 1, seq.shape[1],
                                           device="cuda"), last_only=True)
    val = lg[0, 0]
    if req.temperature:
        key = prng.key_from_numpy(resume_key(req.seed, j), "cuda")
        sub = prng.split(key)[1] # noqa: MXL301 — a check's seeded chain root, compared with the engine's
        val = val / torch.tensor(req.temperature, device="cuda")
        if req.top_k is not None:
            kth = torch.topk(val, req.top_k).values[-1]
            val = torch.where(val < kth, -math.inf, val)
        if req.top_p is not None:
            val = llama._nucleus_mask(val[None], torch.tensor(
                [[req.top_p]], device="cuda"))[0]
        val = val + prng.gumbel(sub, (1, val.shape[0]))[0]
    return val


def dense_serve_run(cfg, params, reqs, readings=None):
    """``reqs`` through the dense engine (SERVE_SLOTS slots, max_len
    SERVE_MAX_LEN, buckets from SERVE_PROMPTS[0]), every bucket warmed
    first, with the launch counts set to 0 just before the timed run and
    read just after it; then the same requests through a second engine,
    synchronous and submitted in reverse. Returns (its numbers, whether
    every stream of the two runs is bit-equal among them, the streams).
    With ``readings``, the telemetry of the timed engine is kept in
    READINGS under that name."""
    import torch
    from mxtpu_torch import telemetry
    from mxtpu_torch.serve import Request, ServeEngine
    n_tok = sum(r.max_new_tokens for r in reqs)
    builds = telemetry_value("program_build_total")
    engine = ServeEngine(cfg, params, max_slots=SERVE_SLOTS,
                         max_len=SERVE_MAX_LEN,
                         min_bucket=SERVE_PROMPTS[0], device="cuda")
    rng = np.random.default_rng(SEED + 1)
    for j, plen in enumerate(SERVE_PROMPTS):
        engine.submit(Request(prompt=rng.integers(0, cfg.vocab_size, plen),
                              max_new_tokens=2, seed=j))
    engine.run()
    engine.reset_stats()
    dispatch = telemetry.registry().get("span_serve_decode_dispatch_ms")
    before = dispatch.snapshot()
    rebuilt = telemetry_value("recompile_total", fn="serve_decode")
    peak_occ = [0.0]

    def watch_occupancy(rid, tok):
        peak_occ[0] = max(peak_occ[0],
                          engine.kv_cache_stats()["occupancy"])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    steps0 = engine.steps_run
    t0 = time.perf_counter()
    first = serve_stream(engine, reqs, range(len(reqs)), watch_occupancy)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = read_launches()
    after = dispatch.snapshot()
    n_disp = after[2] - before[2]
    lat = engine.latency_stats()
    row = {"seconds": seconds, "tok_per_s": n_tok / seconds,
           "p50_token_ms": lat["p50_token_ms"],
           "p99_token_ms": lat["p99_token_ms"],
           "decode_dispatch_host_ms": {
               "mean": (after[1] - before[1]) / max(n_disp, 1),
               "p50": dispatch.interval_percentile(before[0], after[0], 50),
               "p99": dispatch.interval_percentile(before[0], after[0], 99),
               "dispatches": n_disp},
           "compile_count": engine.compile_count,
           "n_buckets": engine.n_buckets,
           "decode_captures": engine._decode.captures,
           "steps": engine.steps_run - steps0,
           "kv_reserved_gb": engine.kv_cache_stats()["reserved_bytes"]
           / 1e9, "peak_kv_occupancy": peak_occ[0],
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
           "launches": launches}
    if readings:
        READINGS[readings] = decode_readings(engine, builds, rebuilt,
                                             peak_occ[0], row)
    del engine
    torch.cuda.empty_cache()
    sync = ServeEngine(cfg, params, max_slots=SERVE_SLOTS,
                       max_len=SERVE_MAX_LEN, min_bucket=SERVE_PROMPTS[0],
                       overlap=False, device="cuda")
    second = serve_stream(sync, reqs, reversed(range(len(reqs))))
    invariant = all(np.array_equal(first[i], second[i]) for i in first)
    del sync
    torch.cuda.empty_cache()
    return row, invariant, first


def check_dense_serve(name, cfg, reqs, row, invariant, streams):
    """Raise unless every request got exactly its tokens, all in [0, V),
    the engine built at most its buckets + 1 programs and captured its
    decode step once, no kernel launched, and the reversed synchronous
    engine gave every stream bit for bit."""
    malformed = [i for i, r in enumerate(reqs)
                 if not (len(streams[i]) == r.max_new_tokens
                         and ((streams[i] >= 0)
                              & (streams[i] < cfg.vocab_size)).all())]
    if malformed:
        raise AssertionError(f"{name}: requests {malformed} returned the "
                             "wrong count of tokens or a bad token")
    if not (row["compile_count"] <= row["n_buckets"] + 1
            and row["decode_captures"] == 1):
        raise AssertionError(f"{name} built more than its buckets and one "
                             f"decode capture: {row}")
    if not invariant:
        raise AssertionError(f"{name}: another schedule changed a stream")
    if row["launches"] != only():
        raise AssertionError(f"{name} launched {row['launches']}")


def serve_engine_phase(cfg, params):
    """The continuous-batching ``ServeEngine`` on the slice's weights:
    bench_llama_serve's stream (SERVE_*) through :func:`dense_serve_run`
    (the timed run, then a synchronous engine in reverse: equal
    streams); then 4 requests through an
    engine over the first SERVE_LAYERS layers in f32 against batch-1
    ``generate``, and the bf16 streams' agreement with it printed; on
    the same f32 layers, the captured step against the eager one with
    the RoPE cache emptied, and two engines on threads."""
    import torch
    reqs = serve_requests(cfg)
    n_tok = sum(r.max_new_tokens for r in reqs)
    row, invariant, first = dense_serve_run(cfg, params, reqs,
                                            readings="serve_decode")

    # the bf16 streams beside batch-1 generate: agreement only, printed
    agree = {}
    for i in (0, 1, 2, 5):
        n = min(reqs[i].max_new_tokens, 32)
        g = generate_one(cfg, params, reqs[i], n)
        same = np.flatnonzero(g != first[i][:n])
        # mxlint: disable=MXL004 — same is host numpy
        first_diff = int(same[0]) if same.size else n
        agree[i] = {"tokens": n, "equal_prefix": first_diff}

    cfg4, p4 = f32_layers(cfg, params)
    f32 = f32_engine_vs_generate(cfg4, p4)
    owned = decode_graph_owns_its_tables(cfg4, p4)
    threaded = engines_on_threads(cfg4, p4)
    del p4
    torch.cuda.empty_cache()
    emit({"phase": "serve_engine", "config": "llama3_8b",
          "n_layers": cfg.n_layers, "requests": len(reqs),
          "max_slots": SERVE_SLOTS, "max_len": SERVE_MAX_LEN,
          "min_bucket": SERVE_PROMPTS[0], "sampled_requests":
          sum(1 for r in reqs if r.temperature), "generated_tokens": n_tok,
          **row, "scheduling_invariant": invariant,
          "bf16_vs_generate": agree, "f32_vs_generate": f32,
          "rope_evicted": owned, "threaded_engines": threaded})
    check_dense_serve("serve_engine", cfg, reqs, row, invariant, first)
    if not f32["ok"]:
        raise AssertionError(f"serve_engine in f32 differs from generate "
                             f"away from a near-tie: {f32}")
    if not owned["ok"]:
        raise AssertionError(f"the captured decode step differs from the "
                             f"eager one once the RoPE cache is emptied: "
                             f"{owned}")
    if not threaded["ok"]:
        raise AssertionError(f"engines on threads differ from their "
                             f"synchronous runs or failed: {threaded}")
    return row["launches"], first


def f32_layers(cfg, params):
    """The first SERVE_LAYERS layers of the slice's weights, in f32."""
    import torch
    cfg4 = replace(cfg, n_layers=SERVE_LAYERS, dtype=torch.float32,
                   param_dtype=torch.float32)
    p4 = {k: v.float() for k, v in params.items() if k != "layers"}
    p4["layers"] = {k: v[:SERVE_LAYERS].float()
                    for k, v in params["layers"].items()}
    return cfg4, p4


def f32_engine_vs_generate(cfg4, p4):
    """The f32 layers through an engine (4 slots, max_len 256): 2 greedy
    and 2 sampled requests, prompts 64 and 128, 32 new tokens each,
    against batch-1 ``generate``. Tokens must be equal up to the first
    difference, and there generate's decision gap at most SERVE_TIE_REL
    of |max| (a near-tie)."""
    import torch
    from mxtpu_torch.serve import ServeEngine
    reqs = f32_requests(cfg4)
    engine = ServeEngine(cfg4, p4, max_slots=4, max_len=256, min_bucket=64,
                         device="cuda")
    got = serve_stream(engine, reqs, range(len(reqs)))
    want = {i: generate_one(cfg4, p4, r, r.max_new_tokens)
            for i, r in enumerate(reqs)}
    rows, ok = near_tie_rows(cfg4, p4, reqs, want, got)
    del engine
    torch.cuda.empty_cache()
    return {"layers": SERVE_LAYERS, "rows": rows, "ok": ok}


def f32_requests(cfg4):
    """``f32_engine_vs_generate``'s requests: 2 greedy and 2 sampled,
    prompts 64 and 128, 32 new tokens each."""
    from mxtpu_torch.serve import Request
    rng = np.random.default_rng(SEED + 2)
    return [Request(prompt=rng.integers(0, cfg4.vocab_size, plen),
                    max_new_tokens=32, seed=100 + i,
                    **(SAMPLING if i >= 2 else {}))
            for i, plen in enumerate((64, 128, 64, 128))]


def near_tie_rows(cfg4, p4, reqs, want, got):
    """Streams ``got`` against ``want`` ({index: tokens}): each equal, or
    parting first at a near-tie of ``want``'s decision values (the gap
    between the best two at most SERVE_TIE_REL of |max|). Returns (rows,
    ok)."""
    return parting_rows(cfg4, p4, reqs, want, got,
                        lambda gap, pair, top: gap <= SERVE_TIE_REL * top)


def parting_rows(cfg, params, reqs, want, got, near):
    """Streams ``got`` against ``want`` ({index: tokens}), each equal or
    parting first at a position j where ``near(gap, pair, top)`` holds
    on ``want``'s decision values there (``decision_values``): gap is
    the best one's lead over the second, pair the value of ``want``'s
    token less that of ``got``'s, top |max|. Returns (rows, ok)."""
    rows, ok = [], True
    for i, r in enumerate(reqs):
        a, b = np.asarray(want[i]), np.asarray(got[i])
        diff = np.flatnonzero(a != b)
        row = {"sampled": bool(r.temperature), "equal": not diff.size}
        if diff.size:
            j = int(diff[0])
            val = decision_values(cfg, params, r, a, j)
            top2 = val.topk(2).values
            gap, top = (top2[0] - top2[1]).item(), top2[0].abs().item()
            pair = (val[int(a[j])] - val[int(b[j])]).item()
            row.update(first_difference=j, gap=gap, pair_gap=pair,
                       max_abs=top, near_tie=bool(near(gap, pair, top)))
            ok = ok and row["near_tie"]
        rows.append(row)
    return rows, ok


def decode_graph_owns_its_tables(cfg4, p4, steps=4):
    """The captured decode step against eager ``decode_slots`` on a twin
    bank (4 slots, max_len 256, prompts of 37-128 tokens, half of them
    sampled). After the capture, before every replay, the shared RoPE
    cache is pushed past its 16 entries and emptied, the allocator's
    cache released (``empty_cache``) and 256 MB of NaNs allocated: a
    graph that read the cache's tables would read freed or poisoned
    memory. Tokens must be equal at every step, the banks and slot
    vectors at the end (the warm-up writes K/V one entry ahead, which
    the next step writes again)."""
    import gc
    import torch
    from mxtpu_torch import prng
    from mxtpu_torch.models import llama
    from mxtpu_torch.serve.engine import _DecodeGraph
    slots, max_len, dev = 4, 256, torch.device("cuda")
    rng = np.random.default_rng(SEED + 3)
    prompts = [rng.integers(0, cfg4.vocab_size, n) for n in (64, 100, 128, 37)]
    knobs = [SAMPLING if i % 2 else {"temperature": 0.0, "top_k": None,
                                     "top_p": None} for i in range(slots)]
    banks = []
    for _ in range(2):
        st = llama.init_slot_cache(cfg4, slots, max_len, device=dev)
        kv = {n: st[n] for n in ("k", "v")}
        sv = {n: st[n] for n in ("lengths", "tokens", "rngs")}
        for slot, (p, kn) in enumerate(zip(prompts, knobs)):
            pad = torch.zeros((1, 128), dtype=torch.int32, device=dev)
            pad[0, :len(p)] = torch.as_tensor(p, device=dev)
            with torch.no_grad():
                llama.prefill_slot(cfg4, p4, pad, len(p), slot, kv, sv,
                                   prng.PRNGKey(300 + slot, dev), # noqa: MXL301 — a check's seeded chain root, compared with the engine's
                                   kn["temperature"], kn["top_k"],
                                   kn["top_p"])
        banks.append((kv, sv))
    host = (np.ones(slots, bool),
            np.array([k["temperature"] for k in knobs], np.float32),
            np.array([k["top_k"] or cfg4.vocab_size for k in knobs],
                     np.int32),
            np.array([k["top_p"] or 1.0 for k in knobs], np.float32))
    dev_knobs = [torch.from_numpy(k).to(dev) for k in host]
    step = _DecodeGraph(cfg4, p4, *banks[0])
    equal = []
    for i in range(steps):
        junk = None
        if i:
            for m in range(max_len + 1, max_len + 21):
                llama._rope_cached(cfg4, m, dev)
            llama._rope_cached.cache_clear()
            gc.collect()
            torch.cuda.empty_cache()
            junk = torch.full((64 << 20,), float("nan"), device=dev)
        got = step(*host)
        with torch.no_grad():
            want, _, _ = llama.decode_slots(cfg4, p4, *banks[1], *dev_knobs)
        equal.append(bool(torch.equal(got, want)))
        del junk
    torch.cuda.synchronize()
    same_bank = all(torch.equal(banks[0][j][n], banks[1][j][n])
                    for j, names in ((0, ("k", "v")),
                                     (1, ("lengths", "tokens", "rngs")))
                    for n in names)
    out = {"steps": steps, "tokens_equal": equal, "bank_equal": same_bank,
           "captures": step.captures}
    out["ok"] = all(equal) and same_bank and step.captures == 1
    del step, banks
    torch.cuda.empty_cache()
    return out


def engines_on_threads(cfg4, p4):
    """Two engines (4 slots, max_len 256) serving from ``run_forever``
    threads at once, so one captures its decode step while the other
    prefills, reads back or captures. Engine 1's prompts are longer, so
    its admissions run while engine 0 reaches its first step. Each
    stream must equal a synchronous engine's run of the same requests,
    and each engine must have captured once."""
    import threading
    import torch
    from mxtpu_torch.serve import Request, ServeEngine
    rng = np.random.default_rng(SEED + 4)
    sets = [[Request(prompt=rng.integers(0, cfg4.vocab_size, plen),
                     max_new_tokens=int(rng.integers(16, 49)),
                     seed=400 + 10 * e + i,
                     **(SAMPLING if i % 2 else {}))
             for i, plen in enumerate(plens)]
            for e, plens in enumerate(((40, 60, 33, 64, 50, 20),
                                       (128, 120, 100, 128, 90, 70)))]
    shape = dict(max_slots=4, max_len=256, min_bucket=64, device="cuda")
    want = []
    for reqs in sets:
        sync = ServeEngine(cfg4, p4, overlap=False, **shape)
        want.append(serve_stream(sync, reqs, range(len(reqs))))
        del sync
    engines = [ServeEngine(cfg4, p4, **shape) for _ in sets]
    rids = [[eng.submit(r) for r in reqs]
            for eng, reqs in zip(engines, sets)]
    stop, errors = threading.Event(), []

    def serve(eng):
        try:
            eng.run_forever(stop)
        except BaseException as e:          # reported, and fails the check
            errors.append(repr(e))
    threads = [threading.Thread(target=serve, args=(eng,))
               for eng in engines]
    for t in threads:
        t.start()
    stop.set()
    for eng in engines:
        eng.wake()
    for t in threads:
        t.join(300)
    alive = sum(t.is_alive() for t in threads)
    equal = [sum(np.array_equal(np.asarray(eng._results[rid], np.int32),
                                want[e][i])
                 for i, rid in enumerate(rids[e]))
             for e, eng in enumerate(engines)] if not alive else []
    out = {"engines": len(engines), "requests": [len(r) for r in sets],
           "streams_equal": equal, "errors": errors, "alive": alive,
           "captures": [eng._decode.captures for eng in engines]}
    out["ok"] = (not errors and not alive and out["captures"] == [1, 1]
                 and equal == out["requests"])
    if not alive:
        del engines
        torch.cuda.empty_cache()
    return out


def paged_attention_phase():
    """``paged_decode_attention`` against ``slot_decode_attention`` on the
    dense bank it was paged from: llama3_8b's attention widths (hq 32,
    hkv 8, hd 128), 16 slots at max_len 768, a random bf16 bank paged
    into 16- and 64-token pages in shuffled order, slot 1's first 256
    positions aliasing slot 0's pages. Bit for bit with 1-D lengths and
    with per-query ones (5 queries a slot, the verify step's mask); the
    device time of each, captured as a graph (a layer's attention at the
    engine's decode shape), beside the live K/V's byte bound. Then
    the int8 pool: ``_q8_token`` of the 64-token pages on the card and on
    the CPU, and the dequantised gather of every slot's row, bit for
    bit."""
    import torch
    from mxtpu_torch.models import llama
    from mxtpu_torch.ops.attention import (gather_pages,
                                           paged_decode_attention,
                                           slot_decode_attention)
    from mxtpu_torch.telemetry import perfscope
    from mxtpu_torch.tools.timing import graphed, time_ms
    reset_launches()
    S, hq, hkv, hd, L, alias = SERVE_SLOTS, 32, 8, 128, SERVE_MAX_LEN, 256
    bf = dict(device="cuda", dtype=torch.bfloat16)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 5)
    k = torch.randn((S, hkv, L, hd), generator=gen, **bf)
    v = torch.randn((S, hkv, L, hd), generator=gen, **bf)
    k[1, :, :alias], v[1, :, :alias] = k[0, :, :alias], v[0, :, :alias]
    q1 = torch.randn((S, hq, 1, hd), generator=gen, **bf)
    q5 = torch.randn((S, hq, 5, hd), generator=gen, **bf)
    lengths = torch.randint(1, L - 4, (S,), generator=gen, device="cuda",
                            dtype=torch.int32)
    lengths[:2] = torch.tensor([L - 5, alias], dtype=torch.int32)
    per_query = lengths[:, None] + torch.arange(1, 6, device="cuda",
                                                dtype=torch.int32)
    live_bytes = 2 * hkv * hd * 2 * int(lengths.sum())
    rows, pools = [], {}
    with torch.no_grad():
        for ps in (16, 64):
            n = L // ps
            table = (torch.randperm(S * n, generator=gen, device="cuda")
                     + 1).reshape(S, n)
            table[1, :alias // ps] = table[0, :alias // ps]
            pool = {}
            for name, bank in (("k", k), ("v", v)):
                pool[name] = torch.zeros((1 + S * n, hkv, ps, hd), **bf)
                pool[name].index_copy_(
                    0, table.reshape(-1), bank.reshape(S, hkv, n, ps, hd)
                    .transpose(1, 2).reshape(S * n, hkv, ps, hd))
            table = table.int()
            pools[ps] = (pool, table)
            row = {"page_size": ps}
            for tag, q, lim in (("1d", q1, lengths), ("2d", q5, per_query)):
                dense = slot_decode_attention(q, k, v, lim)
                paged = paged_decode_attention(q, pool["k"], pool["v"],
                                               table, lim)
                row[f"equal_{tag}"] = bool(torch.equal(dense, paged))
            # device times: each call captured as a graph (eager calls
            # cost the host more than a window's spin)
            row["paged_ms"] = time_ms(graphed(lambda: paged_decode_attention(
                q1, pool["k"], pool["v"], table, lengths)), 10)
            row["slot_ms"] = time_ms(graphed(
                lambda: slot_decode_attention(q1, k, v, lengths)), 10)
            row["live_kv_bound_ms"] = perfscope.bound_ms(0, live_bytes)[0]
            rows.append(row)
        pool, table = pools[64]
        codes, scales = llama._q8_token(pool["k"])
        c_cpu, s_cpu = llama._q8_token(pool["k"].cpu())
        q8_equal = bool(torch.equal(codes.cpu(), c_cpu)
                        and torch.equal(scales.cpu(), s_cpu))
        got = gather_pages(codes, table, 0, L, scales, torch.bfloat16)
        want = gather_pages(c_cpu, table.cpu(), 0, L, s_cpu, torch.bfloat16)
        gather_equal = bool(torch.equal(got.cpu(), want))
    launches = read_launches()
    out = {"phase": "paged_attention", "card": nvidia_smi(), "slots": S,
           "hq": hq, "hkv": hkv, "hd": hd, "max_len": L,
           "aliased_positions": alias, "rows": rows,
           "int8_q8_token_card_vs_cpu_equal": q8_equal,
           "int8_gather_card_vs_cpu_equal": gather_equal,
           "launches": launches}
    emit(out)
    bad = [r for r in rows if not (r["equal_1d"] and r["equal_2d"])]
    if bad:
        raise AssertionError(f"paged attention differs from slot attention "
                             f"on the bank it was paged from: {bad}")
    if not (q8_equal and gather_equal):
        raise AssertionError("the int8 pool's codes, scales or dequantised "
                             "gather differ between the card and the CPU")
    if launches != only():
        raise AssertionError(f"paged_attention launched {launches}")
    return launches


def admission_run(cfg, params, paged):
    """bench_paged_kv's ``one_mode``: the dense bank (PAGED_DENSE_SLOTS
    slots) or the pool of the same bytes (PAGED_CEILING slots), one
    warm-up request, then PAGED_REQUESTS requests of PAGED_PROMPT +
    PAGED_NEW tokens at once. Returns the row and the streams."""
    import torch
    from mxtpu_torch.serve import Request, ServeEngine
    n_pages = PAGED_DENSE_SLOTS * (SERVE_MAX_LEN // PAGED_PAGE) + 1
    engine = ServeEngine(
        cfg, params, max_len=SERVE_MAX_LEN, min_bucket=SERVE_PROMPTS[0],
        max_slots=PAGED_CEILING if paged else PAGED_DENSE_SLOTS,
        paged=paged, page_size=PAGED_PAGE if paged else None,
        n_pages=n_pages if paged else None, device="cuda")
    rng = np.random.default_rng(SEED)
    engine.submit(Request(prompt=rng.integers(0, cfg.vocab_size,
                                              PAGED_PROMPT),
                          max_new_tokens=2))
    engine.run()
    engine.reset_stats()
    reqs = [Request(prompt=rng.integers(0, cfg.vocab_size, PAGED_PROMPT),
                    max_new_tokens=PAGED_NEW)
            for _ in range(PAGED_REQUESTS)]
    peak = [0]

    def watch(rid, tok):
        peak[0] = max(peak[0], engine.load()["active"])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = serve_stream(engine, reqs, range(len(reqs)), watch)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    n_tok = PAGED_REQUESTS * PAGED_NEW
    row = {"slots": engine.max_slots, "peak_active_slots": peak[0],
           "seconds": seconds, "tok_per_s": n_tok / seconds,
           "kv_reserved_gb": engine.kv_cache_stats()["reserved_bytes"] / 1e9,
           "exact_counts": all(len(t) == PAGED_NEW
                               and ((t >= 0) & (t < cfg.vocab_size)).all()
                               for t in got.values())}
    del engine
    torch.cuda.empty_cache()
    return row


def ttft_cold_warm(cfg, params):
    """bench_paged_kv's time to first token on a fresh paged engine (4
    slots, 64-token pages): a TTFT_SYSTEM-token system prompt plus
    TTFT_SUFFIX tokens, cold (the prompt registers), then warm (only the
    suffix's bucket is prefilled over the shared pages), after the same
    pair on a throw-away prefix."""
    from mxtpu_torch.serve import Request, ServeEngine
    engine = ServeEngine(cfg, params, max_len=SERVE_MAX_LEN,
                         min_bucket=SERVE_PROMPTS[0], max_slots=4,
                         paged=True, page_size=PAGED_PAGE, device="cuda")
    rng = np.random.default_rng(SEED + 1)

    def timed(prompt):
        stamp = {}
        engine.submit(Request(prompt=prompt, max_new_tokens=2,
                              on_token=lambda rid, tok:
                              stamp.setdefault("t", time.perf_counter())))
        t0 = time.perf_counter()
        engine.run()
        return 1e3 * (stamp["t"] - t0)

    def prompt(prefix):
        return np.concatenate([prefix, rng.integers(0, cfg.vocab_size,
                                                    TTFT_SUFFIX)])
    warm_up = rng.integers(0, cfg.vocab_size, TTFT_SYSTEM)
    timed(prompt(warm_up))
    timed(prompt(warm_up))
    system = rng.integers(0, cfg.vocab_size, TTFT_SYSTEM)
    cold, warm = timed(prompt(system)), timed(prompt(system))
    st = engine.kv_cache_stats()
    return {"ttft_cold_ms": cold, "ttft_warm_ms": warm,
            "prefix_hits": st["prefix_hits"], "cow_forks": st["cow_forks"]}


def paged_serve_run(cfg, params, reqs, **kw):
    """The serve stream through a paged engine (16 slots, max_len 768,
    buckets from 64, the default pool of 16-token pages), every bucket
    warmed first: streams, and its numbers."""
    import torch
    from mxtpu_torch.serve import Request, ServeEngine
    engine = ServeEngine(cfg, params, max_slots=SERVE_SLOTS,
                         max_len=SERVE_MAX_LEN, min_bucket=SERVE_PROMPTS[0],
                         paged=True, device="cuda", **kw)
    rng = np.random.default_rng(SEED + 1)
    for j, plen in enumerate(SERVE_PROMPTS):
        engine.submit(Request(prompt=rng.integers(0, cfg.vocab_size, plen),
                              max_new_tokens=2, seed=j))
    engine.run()
    engine.reset_stats()
    peak = [0]

    def watch(rid, tok):
        peak[0] = max(peak[0], engine._pages.used_pages)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = serve_stream(engine, reqs, range(len(reqs)), watch)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    lat = engine.latency_stats()
    st = engine.kv_cache_stats()
    n_tok = sum(r.max_new_tokens for r in reqs)
    row = {"seconds": seconds, "tok_per_s": n_tok / seconds,
           "p50_token_ms": lat["p50_token_ms"],
           "p99_token_ms": lat["p99_token_ms"], "page_size": st["page_size"],
           "pages_total": st["pages_total"], "peak_pages_used": peak[0],
           "kv_reserved_gb": st["reserved_bytes"] / 1e9,
           "prefix_hits": st["prefix_hits"],
           "compile_count": engine.compile_count,
           "n_buckets": engine.n_buckets,
           "decode_captures": engine._decode.captures,
           "exact_counts": all(len(got[i]) == r.max_new_tokens
                               and ((got[i] >= 0)
                                    & (got[i] < cfg.vocab_size)).all()
                               for i, r in enumerate(reqs))}
    del engine
    torch.cuda.empty_cache()
    return row, got


def shared_tokens(a, b):
    """Per stream, how many leading tokens two runs share."""
    out = []
    for i in sorted(a):
        diff = np.flatnonzero(np.asarray(a[i]) != np.asarray(b[i]))
        out.append(int(diff[0]) if diff.size else len(a[i]))
    return out


def paged_engine_phase(cfg, params, dense_streams):
    """The paged engine on the slice's weights (32 layers, bf16): (a)
    bench_paged_kv's admission test, dense against paged at the same KV
    bytes: peak active slots, their ratio (at least PAGED_ADMIT_RATIO),
    tok/s, reserved GB, every request exactly its tokens; (b) time to
    first token, cold and warm (at least one prefix hit); (c) the
    ``serve_engine`` stream through a paged engine of 16-token pages:
    tok/s, p50 and p99, peak pages used, at most buckets + 2 programs,
    one capture of the paged step, and how many tokens each stream
    shares with the dense engine's (printed); at 4 layers in f32 the
    dense and paged engines equal on ``f32_requests``, or parting at a
    near-tie; (d) the stream over int8 pages, twice, equal, and its
    agreement with the bf16 pool (printed); (e) no kernel launches."""
    import torch
    from mxtpu_torch.serve import ServeEngine
    reset_launches()
    admit = {"dense": admission_run(cfg, params, False),
             "paged": admission_run(cfg, params, True)}
    ratio = (admit["paged"]["peak_active_slots"]
             / max(1, admit["dense"]["peak_active_slots"]))
    ttft = ttft_cold_warm(cfg, params)
    reqs = serve_requests(cfg)
    stream, paged = paged_serve_run(cfg, params, reqs, page_size=16)
    # stream: the run's numbers; paged: its tokens
    int8_runs = [paged_serve_run(cfg, params, reqs, page_size=16,
                                 int8_pages=True) for _ in range(2)]
    int8_equal = all(np.array_equal(int8_runs[0][1][i], int8_runs[1][1][i])
                     for i in range(len(reqs)))
    cfg4, p4 = f32_layers(cfg, params)
    f32_reqs = f32_requests(cfg4)
    f32_runs = []
    for kw in ({}, {"paged": True, "page_size": 16}):
        engine = ServeEngine(cfg4, p4, max_slots=4, max_len=256,
                             min_bucket=64, device="cuda", **kw)
        f32_runs.append(serve_stream(engine, f32_reqs, range(len(f32_reqs))))
        del engine
    f32_rows, f32_ok = near_tie_rows(cfg4, p4, f32_reqs, *f32_runs)
    del p4
    torch.cuda.empty_cache()
    launches = read_launches()
    emit({"phase": "paged_engine", "card": nvidia_smi(),
          "config": "llama3_8b", "n_layers": cfg.n_layers,
          "admission": {**admit, "peak_slot_ratio": ratio,
                        "pages": PAGED_DENSE_SLOTS
                        * (SERVE_MAX_LEN // PAGED_PAGE) + 1,
                        "page_size": PAGED_PAGE,
                        "requests": PAGED_REQUESTS,
                        "prompt": PAGED_PROMPT, "new": PAGED_NEW},
          "ttft": ttft, "serve_stream": stream,
          "bf16_streams_equal_to_dense": sum(
              np.array_equal(dense_streams[i], paged[i]) for i in paged),
          "bf16_tokens_shared_with_dense": shared_tokens(dense_streams,
                                                         paged),
          "int8": {**int8_runs[0][0], "repeat_equal": int8_equal,
                   "tokens_shared_with_bf16_pool": shared_tokens(
                       paged, int8_runs[0][1])},
          "f32_paged_vs_dense": {"layers": SERVE_LAYERS, "rows": f32_rows,
                                 "ok": f32_ok},
          "launches": launches})
    if not (admit["dense"]["exact_counts"] and admit["paged"]["exact_counts"]
            and stream["exact_counts"] and int8_runs[0][0]["exact_counts"]):
        raise AssertionError("paged_engine: a request got the wrong count "
                             "of tokens or a bad token")
    if not ratio >= PAGED_ADMIT_RATIO:
        raise AssertionError(f"paged admission ran {ratio} times the dense "
                             f"bank's slots, under {PAGED_ADMIT_RATIO}")
    if not ttft["prefix_hits"] >= 1:
        raise AssertionError(f"the warm admission missed its prefix: {ttft}")
    if not (stream["compile_count"] <= stream["n_buckets"] + 2
            and stream["decode_captures"] == 1):
        raise AssertionError(f"the paged engine built more than its buckets "
                             f"+ 2 programs or captured its step other than "
                             f"once: {stream}")
    if not int8_equal:
        raise AssertionError("the int8 pool served another stream the "
                             "second time")
    if not f32_ok:
        raise AssertionError(f"paged and dense engines in f32 part away "
                             f"from a near-tie: {f32_rows}")
    if launches != only():
        raise AssertionError(f"paged_engine launched {launches}")
    return launches


def spec_run(cfg, params, reqs, k, drafter=None, warm_up=True):
    """bench_spec's ``one_mode``: a paged engine (SPEC_SLOTS slots,
    max_len SPEC_MAX_LEN, pages of SPEC_PAGE, buckets from 8) with
    ``speculate_k=k``, a warm-up request long enough to draft, then the
    requests: streams, and the run's numbers."""
    import torch
    from mxtpu_torch.serve import Request, ServeEngine
    engine = ServeEngine(cfg, params, max_slots=SPEC_SLOTS,
                         max_len=SPEC_MAX_LEN, min_bucket=8, paged=True,
                         page_size=SPEC_PAGE, speculate_k=k,
                         drafter=drafter, device="cuda")
    if warm_up:
        engine.submit(Request(prompt=np.asarray(SPEC_PROMPTS[0], np.int32),
                              max_new_tokens=16))
        engine.run()
        engine.reset_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = serve_stream(engine, reqs, range(len(reqs)))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    n_tok = sum(r.max_new_tokens for r in reqs)
    lat, st = engine.latency_stats(), engine.kv_cache_stats()
    row = {"speculate_k": k, "seconds": seconds,
           "tok_per_s": n_tok / seconds, "steps": engine.steps_run,
           "accepted_tok_per_slot_step":
           n_tok / max(1, engine.steps_run) / SPEC_SLOTS,
           "p50_token_ms": lat["p50_token_ms"],
           "p99_token_ms": lat["p99_token_ms"],
           "accept_rate": st.get("spec_accept_rate", 0.0),
           "spec_steps": st.get("spec_steps", 0),
           "compile_count": engine.compile_count,
           "n_buckets": engine.n_buckets,
           "step_captures": engine._decode.captures,
           "verify_captures": (engine._spec_decode.captures
                               if engine._spec_decode else 0)}
    del engine
    torch.cuda.empty_cache()
    return row, got


def oracle_drafter(reqs, streams):
    """A drafter that reads ``streams``: the history's prompt names the
    request (equal prompts have equal greedy streams)."""
    by_prompt = {tuple(int(t) for t in r.prompt): np.asarray(streams[i])
                 for i, r in enumerate(reqs)}

    def draft(hist, k):
        for p, s in by_prompt.items():
            if tuple(hist[:len(p)]) == p:
                n = len(hist) - len(p)
                return s[n:n + k].astype(np.int32)
        return np.empty(0, np.int32)
    return draft


def spec_engine_phase(cfg, params):
    """Speculative decoding on the slice's weights, bench_spec's protocol
    (SPEC_*): k = SPEC_K against k = 0 on 6 greedy requests: tok/s,
    accepted tokens a slot-step, the accept rate (random weights, so
    reported only), the agreement of the streams (in bf16 the verify
    step's products have S·W rows where the plain step's have S, and may
    round otherwise); an oracle drafter reading the k = 0 streams and an
    adversarial one (a constant token). Each of the three streams equals
    k = 0's or parts first at a bf16 near-tie of k = 0's decision values
    (the two tokens within SPEC_BF16_TIE_REL of |max|). At 4 layers in
    f32 (SPEC_F32_NEW new tokens): the n-gram, oracle and adversarial
    engines equal the k = 0 streams, or part at a near-tie; the oracle in fewer steps than tokens; and a request
    resumed after SPEC_RESUME_AT tokens through ``submit_prefilled``
    with ``resume_key`` on a fresh speculative engine continues the
    stream. At most buckets + 3 programs, one capture each of the paged
    and the verify step; no kernel launches."""
    import torch
    from mxtpu_torch import prng
    from mxtpu_torch.models import llama
    from mxtpu_torch.serve import KVHandoff, Request, ServeEngine, resume_key
    reset_launches()

    def requests(n, mnew):
        return [Request(prompt=np.asarray(SPEC_PROMPTS[i % 2], np.int32),
                        max_new_tokens=mnew) for i in range(n)]
    reqs = requests(SPEC_REQUESTS, SPEC_NEW)
    base, base_got = spec_run(cfg, params, reqs, 0)
    spec, spec_got = spec_run(cfg, params, reqs, SPEC_K)
    oracle, oracle_got = spec_run(cfg, params, reqs, SPEC_K,
                                  oracle_drafter(reqs, base_got))
    adv, adv_got = spec_run(cfg, params, reqs, SPEC_K,
                            lambda h, k: np.full(k, 3, np.int32))
    full = {"k0": base, f"k{SPEC_K}": spec, "oracle": oracle,
            "adversarial": adv,
            "tokens_shared_with_k0": {
                f"k{SPEC_K}": shared_tokens(base_got, spec_got),
                "oracle": shared_tokens(base_got, oracle_got),
                "adversarial": shared_tokens(base_got, adv_got)}}
    full["partings"] = {}
    for name, got in ((f"k{SPEC_K}", spec_got), ("oracle", oracle_got),
                      ("adversarial", adv_got)):
        rows, ok = parting_rows(
            cfg, params, reqs, base_got, got,
            lambda gap, pair, top: abs(pair) <= SPEC_BF16_TIE_REL * top)
        full["partings"][name] = {"rows": rows, "ok": ok}

    cfg4, p4 = f32_layers(cfg, params)
    reqs4 = requests(2, SPEC_F32_NEW)
    _, want = spec_run(cfg4, p4, reqs4, 0, warm_up=False)
    f32 = {}
    for name, drafter in (("ngram", None),
                          ("oracle", oracle_drafter(reqs4, want)),
                          ("adversarial",
                           lambda h, k: np.full(k, 3, np.int32))):
        row, got = spec_run(cfg4, p4, reqs4, SPEC_K, drafter, warm_up=False)
        rows, ok = near_tie_rows(cfg4, p4, reqs4, want, got)
        f32[name] = {"steps": row["steps"], "spec_steps": row["spec_steps"],
                     "rows": rows, "ok": ok}
    # the journaled resume: request 0's prompt prefilled alone, seated
    # after SPEC_RESUME_AT emitted tokens with the chain fast-forwarded
    r0, n = reqs4[0], SPEC_RESUME_AT
    prompt = torch.zeros((1, 8), dtype=torch.int32, device="cuda")
    prompt[0, :len(r0.prompt)] = torch.as_tensor(r0.prompt)
    with torch.no_grad():
        tok, kb, vb, key = llama.prefill_detached(
            cfg4, p4, prompt, len(r0.prompt), prng.PRNGKey(0, "cuda"), 0.0, # noqa: MXL301 — a check's seeded chain root, compared with the engine's
            None, None)
    h = KVHandoff(k=kb.cpu(), v=vb.cpu(), true_len=len(r0.prompt),
                  token=int(tok[0]), rng=prng.key_to_numpy(key))
    resumed = Request(prompt=np.concatenate([r0.prompt, want[0][:n]]),
                      max_new_tokens=r0.max_new_tokens - n,
                      rng=resume_key(0, n))
    engine = ServeEngine(cfg4, p4, max_slots=SPEC_SLOTS,
                         max_len=SPEC_MAX_LEN, min_bucket=8, paged=True,
                         page_size=SPEC_PAGE, speculate_k=SPEC_K,
                         drafter=oracle_drafter(reqs4, want), device="cuda")
    rid = engine.submit_prefilled(h, resumed)
    tail = engine.run()[rid]
    resume_rows, resume_ok = near_tie_rows(
        cfg4, p4, [r0], {0: want[0]},
        {0: np.concatenate([want[0][:n], tail])})
    f32["resume"] = {"after": n,
                     "first_token_equal": bool(h.token == want[0][0]),
                     "rows": resume_rows, "ok": resume_ok}
    del engine, p4
    torch.cuda.empty_cache()
    launches = read_launches()
    emit({"phase": "spec_engine", "card": nvidia_smi(),
          "config": "llama3_8b", "n_layers": cfg.n_layers,
          "slots": SPEC_SLOTS, "max_len": SPEC_MAX_LEN,
          "page_size": SPEC_PAGE, "requests": SPEC_REQUESTS,
          "new_tokens": SPEC_NEW, "full_width_bf16": full,
          "f32": {"layers": SERVE_LAYERS, "new_tokens": SPEC_F32_NEW, **f32},
          "launches": launches})
    runs = (base, spec, oracle, adv)
    if not all(r["compile_count"] <= r["n_buckets"] + 3 for r in runs):
        raise AssertionError(f"a speculative engine built more than its "
                             f"buckets + 3 programs: {runs}")
    if not (oracle["step_captures"] == 1 and oracle["verify_captures"] == 1):
        raise AssertionError(f"the oracle engine captured its paged or "
                             f"verify step other than once: {oracle}")
    bad = {k: v for k, v in full["partings"].items() if not v["ok"]}
    if bad:
        raise AssertionError(f"speculative streams in bf16 part from k = 0 "
                             f"away from a near-tie: {bad}")
    bad = {k: v for k, v in f32.items() if not v["ok"]}
    if bad:
        raise AssertionError(f"speculative streams in f32 part from k = 0 "
                             f"away from a near-tie: {bad}")
    if not f32["oracle"]["steps"] < SPEC_F32_NEW:
        raise AssertionError(f"the oracle drafter took {f32['oracle']} "
                             f"steps for {SPEC_F32_NEW} tokens a slot")
    if not f32["resume"]["first_token_equal"]:
        raise AssertionError("the detached prefill's first token differs")
    if launches != only():
        raise AssertionError(f"spec_engine launched {launches}")
    return launches


class ThrottledKVTx:
    """An emulated cross-host wire for the disaggregated TTFT comparison,
    as ``bench.py``'s ``_ThrottledKVTx`` (whose module imports jax): the
    sender is held nbytes / rate before each frame enters the in-process
    socketpair, while compute on other threads runs on."""

    def __init__(self, tx, mbps):
        self._tx = tx
        self._s_per_b = 1.0 / (mbps * 1e6)

    def send_handoff(self, msg):
        nb = sum(a.nbytes for a in msg if isinstance(a, np.ndarray))
        if nb:
            time.sleep(nb * self._s_per_b)
        return self._tx.send_handoff(msg)

    def __getattr__(self, name):
        return getattr(self._tx, name)


def _pct(xs, q):
    """bench.py's percentile: the sorted sample at q% (0 when empty)."""
    xs = sorted(xs)
    return float(xs[min(len(xs) - 1, int(q / 100 * len(xs)))]) if xs \
        else 0.0


def _release_gateway():
    """Free what a closed gateway held: its engines sit in reference
    cycles (requests' callbacks reach the gateway that reaches the
    engines), which only the cycle collector frees, so their banks,
    graph pools and the weights they hold stay on the card until then.
    A hybridized Gluon block does too (its cached call reaches it)."""
    import gc
    import torch
    gc.collect()
    torch.cuda.empty_cache()


def _join_all(threads, timeout=600):
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout)
    return sum(t.is_alive() for t in threads)


def gateway_http_run(cfg, params):
    """``bench_gateway`` through the HTTP front door at GATEWAY_*: two
    replicas (engines on their threads), every bucket warmed on both by
    concurrent requests, then the timed open-loop stream. The same
    requests then go through one synchronous engine of the same shape.
    Returns (numbers, each stream equal to the synchronous one's,
    malformed request indices)."""
    import threading
    import torch
    from mxtpu_torch import telemetry
    from mxtpu_torch.serve import Request, ServeEngine
    from mxtpu_torch.serve.gateway import Gateway, GatewayClient
    shape = dict(max_slots=GATEWAY_SLOTS, max_len=GATEWAY_MAX_LEN,
                 min_bucket=GATEWAY_MAX_LEN // 12, device="cuda")
    plens = [GATEWAY_MAX_LEN // d for d in (12, 6, 3, 2)]
    rng = np.random.default_rng(SEED + 5)
    gw = Gateway(lambda: ServeEngine(cfg, params, **shape),
                 n_replicas=GATEWAY_REPLICAS,
                 queue_max=max(64, GATEWAY_REQUESTS))
    try:
        port = gw.start_http(port=0)
        warm = []
        for b, plen in enumerate(plens):
            # concurrent: while one replica holds a slot, the router
            # sends the next request to a cold one
            prompts = [rng.integers(0, cfg.vocab_size, plen)
                       for _ in range(GATEWAY_REPLICAS)]
            threads = [threading.Thread(
                target=lambda p, j: warm.append(GatewayClient(
                    "127.0.0.1", port).generate(p, GATEWAY_WARM_NEW,
                                                seed=j)),
                args=(p, b * GATEWAY_REPLICAS + k))
                for k, p in enumerate(prompts)]
            if _join_all(threads):
                raise AssertionError("gateway warm-up requests hung")
        if not all(w["status"] == 200 for w in warm):
            raise AssertionError(f"gateway warm-up failed: {warm}")
        # the split of the client's numbers: the gateway's own TTFT
        # (submission to the engine's first token) and each engine's
        # inter-token gaps at emission, both over the timed run only
        for r in gw.backend.replicas():
            r.engine.reset_stats()
        ttft_hist = telemetry.registry().get("gateway_ttft_ms")
        ttft_before = ttft_hist.snapshot()[0]
        jobs, at = [], 0.0
        for i in range(GATEWAY_REQUESTS):
            jobs.append(dict(
                prompt=rng.integers(0, cfg.vocab_size,
                                    int(rng.choice(plens))),
                mnew=int(rng.integers(8, GATEWAY_MAX_LEN // 3 + 1)), at=at))
            at += float(rng.exponential(GATEWAY_MEAN_GAP_S))
        results = [None] * len(jobs)

        def fire(i, job):
            delay = t0 + job["at"] - time.perf_counter()
            if delay > 0:
                time.sleep(delay)
            results[i] = GatewayClient("127.0.0.1", port).generate(
                job["prompt"], job["mnew"], seed=i)

        threads = [threading.Thread(target=fire, args=(i, j))
                   for i, j in enumerate(jobs)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        hung = _join_all(threads)
        seconds = time.perf_counter() - t0
        replicas = [{"name": r.name,
                     "compile_count": r.engine.compile_count,
                     "n_buckets": r.engine.n_buckets,
                     "decode_captures": r.engine._decode.captures,
                     "steps": r.engine.steps_run,
                     **r.engine.latency_stats()}
                    for r in gw.backend.replicas()]
        ttft_after = ttft_hist.snapshot()[0]
    finally:
        gw.close()
        del gw
        _release_gateway()
    if hung:
        raise AssertionError(f"{hung} gateway clients hung")
    ok = [r for r in results if r["status"] == 200]
    n_tok = sum(len(r["tokens"]) for r in ok)
    ttfts = [1e3 * (r["times"][0] - r["t0"]) for r in ok if r["times"]]
    gaps = [g for r in ok for g in 1e3 * np.diff(r["times"])]
    malformed = [i for i, (r, j) in enumerate(zip(results, jobs))
                 if not (r["status"] == 200 and r["reason"] == "complete"
                         and len(r["tokens"]) == j["mnew"]
                         and all(0 <= t < cfg.vocab_size
                                 for t in r["tokens"]))]
    sync = ServeEngine(cfg, params, overlap=False, **shape)
    want = serve_stream(sync, [Request(prompt=j["prompt"],
                                       max_new_tokens=j["mnew"], seed=i)
                               for i, j in enumerate(jobs)],
                        range(len(jobs)))
    del sync
    torch.cuda.empty_cache()
    equal = sum(r["status"] == 200
                and np.array_equal(np.asarray(r["tokens"]), want[i])
                for i, r in enumerate(results))
    row = {"replicas": GATEWAY_REPLICAS, "max_slots": GATEWAY_SLOTS,
           "max_len": GATEWAY_MAX_LEN, "min_bucket": shape["min_bucket"],
           "requests": len(jobs), "ok": len(ok), "generated_tokens": n_tok,
           "seconds": seconds, "tok_per_s": n_tok / seconds,
           "ttft_p50_ms": _pct(ttfts, 50), "ttft_p99_ms": _pct(ttfts, 99),
           "p50_token_ms": _pct(gaps, 50), "p99_token_ms": _pct(gaps, 99),
           "gateway_ttft_p50_ms": ttft_hist.interval_percentile(
               ttft_before, ttft_after, 50),
           "gateway_ttft_p99_ms": ttft_hist.interval_percentile(
               ttft_before, ttft_after, 99),
           "per_replica": replicas, "equal_to_sync_engine": int(equal)}
    return row, equal == len(jobs), malformed


def disagg_stages(trace_ids):
    """Where each disaggregated request's TTFT went, from the trace events
    its trace_id tags (the gateway's and the engine's own spans and
    instants), in ms, one list entry per request: queued for the
    worker, the worker's span (the prefill program; streamed, every
    chunk with its pages shipped), split when streamed into its compute
    loop and the shipper's tail after it (the host copies and the wire
    of the last chunks), from its end to the feeder's receipt of the
    closing frame (the host copy, encoding, the wire and the
    reassembly; streamed, the closing frame alone), waiting for the
    engine's admission, the inject program, and from its end to the
    first token (the first decode step and its readback)."""
    from mxtpu_torch import telemetry
    events = telemetry.trace_events()
    stages = {}
    for tid in trace_ids:
        first = {}
        for e in events:
            args = e.get("args") or {}
            if args.get("trace_id") == tid:
                key = e["name"] + ("/inject" if args.get("inject") else "")
                first.setdefault(key, e)
        pre, inj = first["gateway.prefill"], first["serve.prefill/inject"]
        marks = {
            "queued": pre["ts"] - first["gateway.submit"]["ts"],
            "worker_span": pre["dur"],
            "to_handoff_recv": first["gateway.handoff_recv"]["ts"]
            - (pre["ts"] + pre["dur"]),
            "to_seat": first["serve.seat"]["ts"]
            - first["gateway.handoff_recv"]["ts"],
            "inject": inj["dur"],
            "to_first_token": first["gateway.first_token"]["ts"]
            - (inj["ts"] + inj["dur"])}
        done = first.get("gateway.prefill_computed")
        if done is not None:
            marks["compute_loop"] = done["ts"] - pre["ts"]
            marks["ship_tail"] = pre["ts"] + pre["dur"] - done["ts"]
        for k, us in marks.items():
            stages.setdefault(k, []).append(us / 1e3)
    return stages


def disagg_requests(cfg):
    """The warm-up request, then the timed ones, of the disaggregated
    TTFT comparison (seeded prompts, request i seeded i)."""
    from mxtpu_torch.serve import Request
    rng = np.random.default_rng(SEED + 6)
    return [Request(prompt=rng.integers(0, cfg.vocab_size, DISAGG_PROMPT),
                    max_new_tokens=DISAGG_NEW,
                    temperature=DISAGG_TEMPERATURE, seed=i)
            for i in range(1 + DISAGG_TIMED)]


def _spread(xs):
    """Median, min and max of a list (for the printed rows)."""
    return {"median": _pct(xs, 50), "min": min(xs), "max": max(xs)}


def disagg_mode(cfg, params, reqs, modes, max_slots, max_len, warm=None):
    """``reqs`` through one Gateway per mode, over a ``DisaggBackend``
    each (one prefill worker, one paged decode replica, DISAGG_PAGE-token
    pages, buckets from 64), all built before the first request over the
    same ``params``. ``modes`` maps a name to (stream_chunk, wire): the
    request chunk, 0 for one-shot, and the MB/s its socketpair is
    throttled to, None for none. The requests interleave: request i goes
    to every mode in turn, the first mode rotating with i, so each mode
    sees the same requests on the same card in the same moments. ``warm``,
    a request, goes first to each, untimed. Returns {name: (streams,
    TTFT ms each, the numbers)}."""
    from mxtpu_torch import telemetry
    from mxtpu_torch.serve.gateway import DisaggBackend, Gateway, KVChannel
    gws = {}

    def one(gw, r):
        h = gw.submit(r.prompt, r.max_new_tokens, temperature=r.temperature,
                      top_k=r.top_k, top_p=r.top_p, seed=r.seed)
        toks = h.result(timeout=600)
        if h.reason != "complete" or len(toks) != r.max_new_tokens:
            raise AssertionError(f"disagg request ended {h.reason} with "
                                 f"{len(toks)} tokens")
        return toks, 1e3 * (h._first_at - h._submitted_at), h.trace_id
    try:
        for name, (chunk, wire) in modes.items():
            tx, rx = KVChannel.pair()
            if wire:
                tx = ThrottledKVTx(tx, wire)
            be = DisaggBackend(cfg, params, n_prefill=1, n_decode=1,
                               max_slots=max_slots, max_len=max_len,
                               min_bucket=64, paged=True,
                               page_size=DISAGG_PAGE, stream_chunk=chunk,
                               channel=(tx, rx), device="cuda")
            gws[name] = (Gateway(backend=be, queue_max=16), be)
        shipped = telemetry.registry().get("gateway_kv_handoff_bytes")
        if warm is not None:
            for gw, _ in gws.values():
                one(gw, warm)
        got = {name: ({}, [], [], [0, 0]) for name in modes}
        order = list(modes)
        for i, r in enumerate(reqs):
            for name in order[i % len(order):] + order[:i % len(order)]:
                streams, ttfts, traces, sent = got[name]
                before = shipped.snapshot()
                streams[i], ttft, trace = one(gws[name][0], r)
                after = shipped.snapshot()
                ttfts.append(ttft)
                traces.append(trace)
                sent[0] += after[1] - before[1]
                sent[1] += after[2] - before[2]
        out = {}
        for name, (streams, ttfts, traces, sent) in got.items():
            be = gws[name][1]
            eng = be.decode.replicas()[0].engine
            stages = disagg_stages(traces)
            out[name] = (streams, ttfts, {
                "stream_chunk": be.prefill[0].stream_chunk,
                "wire_mbps": modes[name][1], "ttft_ms": ttfts,
                "median_ttft_ms": _pct(ttfts, 50),
                "bytes_shipped": sent[0], "frames": sent[1],
                "worker_span_ms": _spread(stages["worker_span"]),
                "stages_ms": stages,
                "stages_median_ms": {k: _pct(v, 50)
                                     for k, v in stages.items()},
                "prefill_programs": be.prefill[0].compile_count,
                "decode_compile_count": eng.compile_count,
                "decode_captures": eng._decode.captures})
            eng = None
    finally:
        for gw, _ in gws.values():
            gw.close()
        gws.clear()
        _release_gateway()
    return out


def disagg_chunk_graph(cfg, params, req):
    """The streamed prefill's chunk program as the prefill worker runs
    it (one CUDA graph for ``req``'s bucket) against the eager
    ``llama.prefill_detached_chunk`` with host-int positions on a fresh
    cache, chunk by chunk over the pages the request fills: token, K/V
    and key bit for bit; a replay's device ms."""
    import torch
    from mxtpu_torch import prng
    from mxtpu_torch.models import llama
    from mxtpu_torch.serve import bucket_for
    from mxtpu_torch.serve.gateway.disagg import _ChunkProgram
    from mxtpu_torch.tools.timing import time_ms
    n = len(req.prompt)
    bucket = bucket_for(n, 64, DISAGG_MAX_LEN)
    dev = torch.device("cuda")
    padded = torch.zeros((1, bucket), dtype=torch.int32, device=dev)
    padded[0, :n] = torch.from_numpy(np.asarray(req.prompt, np.int32)).to(dev)
    key = prng.PRNGKey(req.seed, device=dev) # noqa: MXL301 — a check's seeded chain root, compared with the engine's
    knobs = (req.temperature, req.top_k, req.top_p)
    prog = _ChunkProgram(cfg, params, bucket, DISAGG_CHUNK, dev,
                         "disagg_chunk_check")
    cache = llama.init_cache(cfg, 1, bucket, device=dev)
    equal = []
    with torch.no_grad():
        for pos in range(0, min(bucket, -(-n // DISAGG_PAGE) * DISAGG_PAGE),
                         DISAGG_CHUNK):
            got = prog(padded, pos, n, key, *knobs)
            want = llama.prefill_detached_chunk(
                cfg, params, padded[:, pos:pos + DISAGG_CHUNK], cache, n,
                key, *knobs)
            cache = want[4]
            equal.append(all(a.dtype == b.dtype and torch.equal(a, b)
                             for a, b in zip(got, want[:4])))
        replay_ms = time_ms(prog._graph.replay, reps=10)
    out = {"bucket": bucket, "chunk": DISAGG_CHUNK, "chunks": len(equal),
           "bit_equal": equal, "captures": prog.captures,
           "replay_ms": replay_ms}
    del prog, cache
    torch.cuda.empty_cache()
    return out


def disagg_pairs(one_shot, streamed):
    """The interleaved modes' paired comparison: each request's one-shot
    TTFT minus its streamed TTFT (the two ran back to back), their
    median, and how many pairs favour streamed."""
    diffs = [a - b for a, b in zip(one_shot, streamed)]
    return {"median_diff_ms": _pct(diffs, 50), "pairs": len(diffs),
            "streamed_faster": sum(d > 0 for d in diffs)}


def gateway_f32(cfg, params):
    """At SERVE_LAYERS layers in f32, f32_requests through the
    two-replica gateway, the disaggregated backend one-shot and
    streamed, and the gateway again with replica 0 killed by a
    ``ServeChaosPlan`` at its step GATEWAY_KILL_STEP: each stream
    against batch-1 ``generate`` under the near-tie rule."""
    import torch
    from mxtpu_torch.contrib.chaos import ServeChaosPlan, attach_serve
    from mxtpu_torch.serve import ServeEngine
    from mxtpu_torch.serve.gateway import Gateway
    cfg4, p4 = f32_layers(cfg, params)
    reqs = f32_requests(cfg4)
    want = {i: generate_one(cfg4, p4, r, r.max_new_tokens)
            for i, r in enumerate(reqs)}

    def through(gw):
        hs = [gw.submit(r.prompt, r.max_new_tokens,
                        temperature=r.temperature, top_k=r.top_k,
                        top_p=r.top_p, seed=r.seed) for r in reqs]
        out = {i: h.result(timeout=600) for i, h in enumerate(hs)}
        if any(h.reason != "complete" for h in hs):
            raise AssertionError(
                f"f32 gateway requests ended {[h.reason for h in hs]}")
        return out

    def factory():
        return ServeEngine(cfg4, p4, max_slots=2, max_len=256,
                           min_bucket=64, device="cuda")
    out = {}
    gw = Gateway(factory, n_replicas=GATEWAY_REPLICAS, queue_max=64)
    try:
        got = through(gw)
    finally:
        gw.close()
        del gw
        _release_gateway()
    out["gateway"] = near_tie_rows(cfg4, p4, reqs, want, got)
    runs = disagg_mode(cfg4, p4, reqs, {"disagg_one_shot": (0, None),
                                        "disagg_streamed": (DISAGG_CHUNK,
                                                            None)},
                       max_slots=4, max_len=256)
    for name, (got, _, _) in runs.items():
        out[name] = near_tie_rows(cfg4, p4, reqs, want, got)
    restarts = telemetry_value("gateway_replica_restarts_total",
                               reason="died")
    gw = Gateway(factory, n_replicas=GATEWAY_REPLICAS, queue_max=64,
                 supervisor_opts=GATEWAY_SUPERVISION)
    plan = attach_serve(gw, ServeChaosPlan(
        seed=SEED, kill_replica={0: GATEWAY_KILL_STEP}))
    injected = plan.injected        # read after the gateway is freed
    try:
        got = through(gw)
        sup = gw.supervisor.describe()
    finally:
        gw.close()
        del gw, plan
        _release_gateway()
    out["replica_kill"] = near_tie_rows(cfg4, p4, reqs, want, got)
    kill = {"injected": injected["replica_kill"],
            "restarts_counted": telemetry_value(
                "gateway_replica_restarts_total", reason="died") - restarts,
            "supervisor_restarts": sup["restarts"]}
    del p4
    torch.cuda.empty_cache()
    rows = {k: {"rows": v[0], "ok": v[1]} for k, v in out.items()}
    return rows, kill


def gateway_phase(cfg, params):
    """(j) in the docstring: the serving tier on the slice's weights.
    The launch counts are set to 0 at its start and read at its end."""
    import torch
    reset_launches()
    http, http_equal, malformed = gateway_http_run(cfg, params)
    dreqs = disagg_requests(cfg)
    # the one-shot path without the emulated wire, a shorter run that
    # gates nothing: what the wire adds to TTFT, and what the host and
    # the card take without it
    modes = disagg_mode(cfg, params, dreqs[1:1 + DISAGG_NO_WIRE],
                        {"one_shot_no_wire": (0, None)}, max_slots=2,
                        max_len=DISAGG_MAX_LEN, warm=dreqs[0])
    torch.cuda.empty_cache()
    modes.update(disagg_mode(
        cfg, params, dreqs[1:], {"one_shot": (0, DISAGG_WIRE_MBPS),
                                 "streamed": (DISAGG_CHUNK,
                                              DISAGG_WIRE_MBPS)},
        max_slots=2, max_len=DISAGG_MAX_LEN, warm=dreqs[0]))
    torch.cuda.empty_cache()
    # the first DISAGG_NO_WIRE requests (the 5 the check always ran) bit
    # for bit in the three modes; every streamed stream equal to the
    # one-shot one or parting first at a bf16 near-tie: the chunked
    # prefill rounds unlike the one-shot one, so over 15 sampled
    # requests a near-tie flips a token (2 of 15 at 1.3e-3 and 4.3e-3 of
    # |max| in sequential runs too), as the speculative phase allows
    same_streams = all(
        np.array_equal(modes["one_shot"][0][i], modes[m][0][i])
        for m in ("one_shot_no_wire", "streamed")
        for i in range(DISAGG_NO_WIRE))
    partings, near_ok = parting_rows(
        cfg, params, dreqs[1:], modes["one_shot"][0], modes["streamed"][0],
        lambda gap, pair, top: abs(pair) <= SPEC_BF16_TIE_REL * top)
    chunk_graph = disagg_chunk_graph(cfg, params, dreqs[0])
    f32, kill = gateway_f32(cfg, params)
    launches = read_launches()
    one_ms = modes["one_shot"][2]["median_ttft_ms"]
    streamed_ms = modes["streamed"][2]["median_ttft_ms"]
    pairs = disagg_pairs(modes["one_shot"][1], modes["streamed"][1])
    emit({"phase": "gateway", "card": nvidia_smi(), "config": "llama3_8b",
          "n_layers": cfg.n_layers, "http": http,
          "disagg": {"prompt_len": DISAGG_PROMPT, "new_tokens": DISAGG_NEW,
                     "page_size": DISAGG_PAGE,
                     "wire_mbps": DISAGG_WIRE_MBPS,
                     "interleaved": True,
                     "one_shot_no_wire": modes["one_shot_no_wire"][2],
                     "one_shot": modes["one_shot"][2],
                     "streamed": modes["streamed"][2],
                     "paired": pairs,
                     "compute_loop_ms": {
                         "before_capture": list(DISAGG_LOOP_BEFORE_MS),
                         "now": _spread(modes["streamed"][2]["stages_ms"]
                                        ["compute_loop"])},
                     "chunk_graph": chunk_graph,
                     "ttft_drop": 1.0 - streamed_ms / one_ms,
                     "streams_equal": same_streams,
                     "streamed_partings": [r for r in partings
                                           if not r["equal"]],
                     "partings_near_tie": near_ok},
          "f32_vs_generate": f32, "replica_kill": kill,
          "launches": launches})
    if malformed:
        raise AssertionError(f"gateway: requests {malformed} did not "
                             "return 200 with exactly their tokens")
    if not http_equal:
        raise AssertionError("gateway: a stream differs from the "
                             "synchronous engine's")
    for r in http["per_replica"]:
        if not (r["compile_count"] <= r["n_buckets"] + 1
                and r["decode_captures"] == 1):
            raise AssertionError(f"gateway replica {r['name']} built more "
                                 f"than its buckets and one capture: {r}")
    if not same_streams:
        raise AssertionError("disagg: the streamed and one-shot streams "
                             "differ")
    if not (all(chunk_graph["bit_equal"]) and chunk_graph["captures"] == 1):
        raise AssertionError(f"disagg: the captured chunk program differs "
                             f"from the eager chunk: {chunk_graph}")
    workers = [modes["streamed"][2]["prefill_programs"]]
    if workers != [1]:
        raise AssertionError(f"disagg: the streamed worker built {workers} "
                             "programs for one bucket, not one")
    if not near_ok:
        raise AssertionError(f"disagg: a streamed stream parts from the "
                             f"one-shot one away from a near-tie: "
                             f"{partings}")
    if not streamed_ms < one_ms:
        raise AssertionError(f"disagg: streamed median TTFT {streamed_ms} "
                             f"ms is not below one-shot {one_ms} ms "
                             f"(paired: {pairs})")
    bad = [k for k, v in f32.items() if not v["ok"]]
    if bad:
        raise AssertionError(f"gateway in f32 differs from generate away "
                             f"from a near-tie: {bad} {f32}")
    if not (kill["injected"] >= 1 and kill["restarts_counted"] >= 1):
        raise AssertionError(f"the replica kill did not fire or was not "
                             f"counted: {kill}")
    if launches != only():
        raise AssertionError(f"gateway launched {launches}")
    return launches


def build_dir():
    """``build/`` beside this script (ignored by git): where the fleet and
    flywheel phases write their checkpoints."""
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.makedirs(path, exist_ok=True)
    return path


def fleet_jobs(cfg):
    """``bench_gateway``'s 32 requests for the fleet: its prompts, new
    tokens and exponential arrivals, each sent to "llama" or "llama8"
    by a seeded draw, with a seeded priority class, and FLEET_SESSIONS
    sessions of two requests each (the second a returning one)."""
    rng = np.random.default_rng(SEED + 7)
    plens = [GATEWAY_MAX_LEN // d for d in (12, 6, 3, 2)]
    jobs, at = [], 0.0
    for i in range(GATEWAY_REQUESTS):
        jobs.append(dict(
            prompt=rng.integers(0, cfg.vocab_size, int(rng.choice(plens))),
            mnew=int(rng.integers(8, GATEWAY_MAX_LEN // 3 + 1)), at=at,
            model=str(rng.choice(("llama", "llama8"))),
            priority=str(rng.choice(FLEET_PRIORITIES))))
        at += float(rng.exponential(GATEWAY_MEAN_GAP_S))
    for s in range(FLEET_SESSIONS):
        first, second = (int(i) for i in rng.choice(
            [i for i, j in enumerate(jobs) if "session_id" not in j
             and j["model"] == ("llama", "llama8")[s % 2]], 2,
            replace=False))
        for i in (first, second):
            jobs[i]["session_id"] = f"session-{s}"
    return jobs


def fleet_warm(fleet, cfg):
    """Every bucket of every replica, warmed by requests pinned to it
    (untimed)."""
    rng = np.random.default_rng(SEED + 8)
    hs = []
    for name in fleet.models():
        for r in fleet.pool(name).replicas():
            for plen in (GATEWAY_MAX_LEN // d for d in (12, 6, 3, 2)):
                hs.append(fleet.gateway(name).submit(
                    rng.integers(0, cfg.vocab_size, plen), GATEWAY_WARM_NEW,
                    prefer_replica=r.name))
    for h in hs:
        h.result(timeout=600)
        if h.reason != "complete":
            raise AssertionError(f"fleet warm-up ended {h.reason}")


def sync_streams(cfg, weights, reqs):
    """``reqs`` ({key: Request}) through one synchronous engine of the
    fleet's shape on ``weights``: {key: tokens}."""
    import torch
    from mxtpu_torch.serve import ServeEngine
    if not reqs:
        return {}
    keys = list(reqs)
    eng = ServeEngine(cfg, weights, overlap=False, max_slots=GATEWAY_SLOTS,
                      max_len=GATEWAY_MAX_LEN,
                      min_bucket=GATEWAY_MAX_LEN // 12, device="cuda")
    out = serve_stream(eng, [reqs[k] for k in keys], range(len(keys)))
    del eng
    torch.cuda.empty_cache()
    return {k: out[i] for i, k in enumerate(keys)}


def tree_digests(tree):
    """sha256 of every leaf's bytes, computed from a host copy here (not
    by the checkpoint's own code), a few leaves at a time."""
    import hashlib
    from concurrent.futures import ThreadPoolExecutor
    import torch
    leaves = dict(_leaves_with_keys(tree))

    def one(t):
        host = t.detach().to("cpu").contiguous()
        return hashlib.sha256(memoryview(
            host.reshape(-1).view(torch.uint8).numpy())).hexdigest()
    with ThreadPoolExecutor(8) as pool:
        return dict(zip(leaves, pool.map(one, leaves.values())))


def fleet_http_swap(fleet, cfg, v1):
    """(a) and (b): the fleet's 32 requests through ``start_http``, and
    ``hot_swap("llama", params=v1)`` once half of them have been sent.
    Returns (jobs, records, numbers)."""
    import threading
    import torch
    from mxtpu_torch import telemetry
    from mxtpu_torch.serve.gateway import GatewayClient
    jobs = fleet_jobs(cfg)
    reg = telemetry.registry()
    aff0 = {k: reg.value("fleet_session_affinity_total", result=k)
            for k in ("hit", "miss", "prefix")}
    port = fleet.start_http(port=0)
    results = [None] * len(jobs)
    swap = {}
    half = len(jobs) // 2

    def fire(i, job):
        delay = t0 + job["at"] - time.perf_counter()
        if delay > 0:
            time.sleep(delay)
        extra = ({"session_id": job["session_id"]}
                 if "session_id" in job else {})
        results[i] = GatewayClient("127.0.0.1", port).generate(
            job["prompt"], job["mnew"], seed=i, model=job["model"],
            priority=job["priority"], **extra)

    def swapper():
        delay = t0 + jobs[half]["at"] - time.perf_counter()
        if delay > 0:
            time.sleep(delay)
        s0 = time.perf_counter()
        swap["result"] = fleet.hot_swap("llama", params=v1,
                                        drain_timeout_s=600)
        swap["seconds"] = time.perf_counter() - s0

    threads = [threading.Thread(target=fire, args=(i, j))
               for i, j in enumerate(jobs)]
    threads.append(threading.Thread(target=swapper))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    hung = _join_all(threads)
    seconds = time.perf_counter() - t0
    if hung:
        raise AssertionError(f"{hung} fleet clients or the swap hung")
    per_model = {}
    for name in ("llama", "llama8"):
        ok = [r for r, j in zip(results, jobs)
              if j["model"] == name and r["status"] == 200]
        ttfts = [1e3 * (r["times"][0] - r["t0"]) for r in ok if r["times"]]
        n_tok = sum(len(r["tokens"]) for r in ok)
        per_model[name] = {
            "requests": sum(j["model"] == name for j in jobs),
            "generated_tokens": n_tok, "tok_per_s": n_tok / seconds,
            "ttft_p50_ms": _pct(ttfts, 50), "ttft_p99_ms": _pct(ttfts, 99),
            "versions": sorted({r.get("version") for r in ok})}
    row = {"requests": len(jobs), "seconds": seconds,
           "per_model": per_model,
           "priorities": {p: sum(j["priority"] == p for j in jobs)
                          for p in FLEET_PRIORITIES},
           "session_affinity": {
               k: reg.value("fleet_session_affinity_total", result=k)
               - v for k, v in aff0.items()},
           "session_requests": sum("session_id" in j for j in jobs),
           "swap": dict(swap["result"], seconds=swap["seconds"])}
    return jobs, results, row


def fleet_stream_check(cfg, cfg8, weights, jobs, results):
    """Every response a 200 with exactly its tokens, on a version of its
    model, and each stream equal to a synchronous engine's on the
    weights of the version its label names. Returns (bad indices,
    streams equal)."""
    from mxtpu_torch.serve import Request
    bad = [i for i, (r, j) in enumerate(zip(results, jobs))
           if not (r["status"] == 200 and r["reason"] == "complete"
                   and len(r["tokens"]) == j["mnew"]
                   and r.get("model") == j["model"]
                   and (j["model"], r.get("version")) in weights
                   and all(0 <= t < cfg.vocab_size for t in r["tokens"]))]
    groups = {}
    for i, (r, j) in enumerate(zip(results, jobs)):
        if i not in bad:
            groups.setdefault((j["model"], r["version"]), {})[i] = Request(
                prompt=j["prompt"], max_new_tokens=j["mnew"], seed=i)
    equal = 0
    for key, reqs in groups.items():
        want = sync_streams(cfg8 if key[0] == "llama8" else cfg,
                            weights[key], reqs)
        equal += sum(np.array_equal(np.asarray(results[i]["tokens"]),
                                    want[i]) for i in reqs)
    return bad, equal == len(jobs) and not bad


def fleet_path_swap(fleet, cfg, directory):
    """(c): ``save_state`` of a seeded v2 tree made on the card, then
    ``hot_swap("llama", path=...)``, the load inside it timed; the
    served tree's leaf digests against the saved tree's; then the two
    parts of a save of the largest leaf, its copy to the host and the
    sha256 of its bytes, each timed alone. Returns (the loaded tree,
    numbers)."""
    import hashlib
    import torch
    from mxtpu_torch import checkpoint
    from mxtpu_torch.models import llama
    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    v2 = llama.init_params(cfg, gen, device="cuda")
    gb = sum(t.numel() * t.element_size()
             for _, t in _leaves_with_keys(v2)) / 1e9
    want = tree_digests(v2)
    path = os.path.join(directory, "v2")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    checkpoint.save_state(path, v2)
    save_s = time.perf_counter() - t0
    big = max((t for _, t in _leaves_with_keys(v2)), key=torch.Tensor.numel)
    t0 = time.perf_counter()
    host = big.to("cpu")
    t1 = time.perf_counter()
    hashlib.sha256(memoryview(host.reshape(-1).view(torch.uint8).numpy()))
    leaf = {"gb": big.numel() * big.element_size() / 1e9,
            "to_host_s": t1 - t0, "sha256_s": time.perf_counter() - t1}
    del v2, big, host
    torch.cuda.empty_cache()
    load, timed = checkpoint.load_state, {}

    def timed_load(*args, **kw):
        t0 = time.perf_counter()
        out = load(*args, **kw)
        torch.cuda.synchronize()
        timed.setdefault("load_s", []).append(time.perf_counter() - t0)
        return out

    checkpoint.load_state = timed_load
    try:
        t0 = time.perf_counter()
        res = fleet.hot_swap("llama", path=path, drain_timeout_s=600)
        swap_s = time.perf_counter() - t0
    finally:
        checkpoint.load_state = load
    loaded = fleet.pool("llama").replicas()[0].engine.params
    shared = all(r.engine.params is loaded
                 for r in fleet.pool("llama").replicas())
    got = tree_digests(loaded)
    load_s = timed["load_s"]
    return loaded, {"gb": gb, "save_s": save_s, "save_gbps": gb / save_s,
                    "load_s": load_s[0], "load_gbps": gb / load_s[0],
                    "loads": len(load_s), "swap_s": swap_s, "swap": res,
                    "largest_leaf": leaf, "bit_equal": got == want,
                    "one_tree_shared": shared}


def fleet_kill_mid_swap(fleet, cfg, v1):
    """(d): a burst on "llama" with one request pinned to replica 1 for
    long enough to stay a live old-build home, a ``ServeChaosPlan``
    killing replica 0 at its next step, then ``hot_swap("llama",
    params=v1)``. Returns (requests, handles, numbers)."""
    from mxtpu_torch import telemetry
    from mxtpu_torch.contrib.chaos import ServeChaosPlan, attach_serve
    from mxtpu_torch.serve import Request
    rng = np.random.default_rng(SEED + 9)
    reg = telemetry.registry()
    rd0 = reg.value("gateway_redispatch_total", model="llama")
    pool, gw = fleet.pool("llama"), fleet.gateway("llama")
    reps = pool.replicas()
    reqs = [Request(prompt=rng.integers(0, cfg.vocab_size, 64),
                    max_new_tokens=n, seed=1000 + i)
            for i, n in enumerate([FLEET_ANCHOR_NEW] + [32] * 6)]
    hs = [gw.submit(reqs[0].prompt, reqs[0].max_new_tokens,
                    seed=reqs[0].seed, prefer_replica=reps[1].name)]
    hs += [gw.submit(r.prompt, r.max_new_tokens, seed=r.seed)
           for r in reqs[1:]]
    first = [h.ticket.replica.name for h in hs]
    plan = attach_serve(pool, ServeChaosPlan(
        seed=SEED, kill_replica={0: reps[0].engine.steps_run}))
    t0 = time.perf_counter()
    res = fleet.hot_swap("llama", params=v1, drain_timeout_s=600)
    swap_s = time.perf_counter() - t0
    for h in hs:
        h.result(timeout=600)
    return reqs, hs, {
        "swap": res, "seconds": swap_s,
        "killed": reps[0].name, "first_replica": first,
        "served_by": [(h.version, getattr(h.ticket.replica, "name", None))
                      for h in hs],
        "injected": plan.injected["replica_kill"],
        "redispatched": reg.value("gateway_redispatch_total",
                                  model="llama") - rd0,
        "reasons": sorted({h.reason for h in hs}),
        "versions": sorted({h.version for h in hs})}


def fleet_arbiter(fleet):
    """(e): a FleetArbiter over the fleet's live pools on an injected
    clock and scripted signals: "llama8" burns first and is granted the
    free chip, then idles while "llama" burns, and the arbiter moves
    "llama8"'s replica to "llama"."""
    from mxtpu_torch import telemetry
    from mxtpu_torch.serve.fleet import ArbiterPolicy, FleetArbiter
    reg = telemetry.registry()
    ev0 = {(m, d): reg.value("fleet_scale_events_total", model=m,
                             direction=d)
           for m in ("llama", "llama8") for d in ("up", "down")}
    now = [0.0]
    hot = {"pressure": 5.0, "occupancy": 1.0, "burn": 2.0, "queued": 10.0}
    idle = {"pressure": 0.0, "occupancy": 0.0, "burn": 0.0, "queued": 0.0}
    script = [(0.0, {"llama8": hot, "llama": idle}),
              (0.5, {"llama8": idle, "llama": idle}),
              (3.0, {"llama8": idle, "llama": hot})]
    sig = {}
    arb = FleetArbiter(
        fleet._models,
        ArbiterPolicy(chip_budget=4, cooldown_s=1.0, idle_s=1.0,
                      pressure_high=2.0, burn_high=1.0),
        clock=lambda: now[0],
        signals=lambda n, e: dict(sig[n], size=float(e.pool.size)))
    decisions = []
    for t, s in script:
        now[0] = t
        sig.clear()
        sig.update(s)
        decisions.append([(d["model"], d["direction"], d["reason"],
                           d["from"], d["to"]) for d in arb.tick()])
    return {"decisions": decisions,
            "sizes": {m: fleet.pool(m).size for m in fleet.models()},
            "scale_events": {f"{m}/{d}": reg.value(
                "fleet_scale_events_total", model=m, direction=d) - v
                for (m, d), v in ev0.items()},
            "chips_in_use": {m: reg.value("fleet_chips_in_use", model=m)
                             for m in fleet.models()},
            "chips_free": reg.value("fleet_chips_free")}


def fleet_f32(cfg, params):
    """(f): at SERVE_LAYERS layers in f32, ``f32_requests`` through a
    two-replica fleet whose replica 0 a ``ServeChaosPlan`` kills
    GATEWAY_KILL_STEP steps on, during a hot swap (to the same weights,
    so every version's reference is one ``generate``), against batch-1
    ``generate`` under the near-tie rule."""
    import torch
    from mxtpu_torch import telemetry
    from mxtpu_torch.contrib.chaos import ServeChaosPlan, attach_serve
    from mxtpu_torch.serve import ServeEngine
    from mxtpu_torch.serve.fleet import FleetGateway, ModelSpec
    reg = telemetry.registry()
    rd0 = reg.value("gateway_redispatch_total", model="llama")
    cfg4, p4 = f32_layers(cfg, params)
    reqs = f32_requests(cfg4)
    want = {i: generate_one(cfg4, p4, r, r.max_new_tokens)
            for i, r in enumerate(reqs)}
    fleet = FleetGateway([ModelSpec(
        "llama", lambda params=p4: ServeEngine(
            cfg4, params, max_slots=2, max_len=256, min_bucket=64,
            device="cuda"), replicas=2, max_replicas=2)], queue_max=64,
        supervisor_opts=GATEWAY_SUPERVISION)
    try:
        plan = attach_serve(fleet.pool("llama"), ServeChaosPlan(
            seed=SEED, kill_replica={0: GATEWAY_KILL_STEP}))
        hs = [fleet.submit(r.prompt, r.max_new_tokens, model="llama",
                           temperature=r.temperature, top_k=r.top_k,
                           top_p=r.top_p, seed=r.seed) for r in reqs]
        swap = fleet.hot_swap("llama", params=p4, drain_timeout_s=600)
        got = {i: h.result(timeout=600) for i, h in enumerate(hs)}
        if any(h.reason != "complete" for h in hs):
            raise AssertionError(
                f"f32 fleet requests ended {[h.reason for h in hs]}")
        injected = plan.injected["replica_kill"]
        redispatched = reg.value("gateway_redispatch_total",
                                 model="llama") - rd0
    finally:
        fleet.close()
        del fleet
        _release_gateway()
    rows, ok = near_tie_rows(cfg4, p4, reqs, want, got)
    del p4
    torch.cuda.empty_cache()
    # the kill must strand requests, so that the rows hold resumed
    # streams to generate
    return {"layers": SERVE_LAYERS, "rows": rows, "swap": swap,
            "replica_kill": injected, "redispatched": redispatched,
            "ok": ok and injected == 1 and redispatched >= 1}


def fleet_run(cfg, params):
    """(a)-(e) of ``fleet_phase`` on one fleet; returns their rows only,
    so nothing that reaches the fleet's engines outlives the call."""
    import shutil
    import tempfile
    import torch
    from mxtpu_torch.models import llama
    from mxtpu_torch.serve import ServeEngine
    from mxtpu_torch.serve.fleet import FleetGateway, ModelSpec
    cfg8 = replace(cfg, n_layers=FLEET_SMALL_LAYERS)
    p8 = llama.init_params(cfg8, torch.Generator(device="cuda").manual_seed(
        SEED + 1), device="cuda")
    v1 = llama.init_params(cfg, torch.Generator(device="cuda").manual_seed(
        SEED + 2), device="cuda")
    shape = dict(max_slots=GATEWAY_SLOTS, max_len=GATEWAY_MAX_LEN,
                 min_bucket=GATEWAY_MAX_LEN // 12, device="cuda")

    def factory(c, p):
        return lambda params=p: ServeEngine(c, params, **shape)

    directory = tempfile.mkdtemp(prefix="fleet-", dir=build_dir())
    fleet = FleetGateway(
        [ModelSpec("llama", factory(cfg, params), replicas=2,
                   max_replicas=3),
         ModelSpec("llama8", factory(cfg8, p8), replicas=1,
                   max_replicas=2)],
        queue_max=256, supervisor_opts=GATEWAY_SUPERVISION)
    try:
        fleet_warm(fleet, cfg)
        jobs, results, http = fleet_http_swap(fleet, cfg, v1)
        weights = {("llama", "v0"): params, ("llama", "v1"): v1,
                   ("llama8", "v0"): p8}
        malformed, http_equal = fleet_stream_check(cfg, cfg8, weights,
                                                   jobs, results)
        v2, path_row = fleet_path_swap(fleet, cfg, directory)
        kreqs, khs, kill = fleet_kill_mid_swap(fleet, cfg, v1)
        # every request finishes on the build that seated it (v2). A
        # stream that never left its replica equals the fault-free one
        # bit for bit; a re-dispatched one resumes through a bf16
        # prefill of its prefix, which rounds unlike the decode steps,
        # so it equals the fault-free one or parts first at a near-tie
        # within SPEC_BF16_TIE_REL of |max| (the f32 check (f) holds
        # resumed streams to generate at 1e-5)
        if kill["versions"] == ["v2"]:
            got = {i: h.result(timeout=1) for i, h in enumerate(khs)}
            want = sync_streams(cfg, v2, dict(enumerate(kreqs)))
            kill["rows"], kill["resumed_ok"] = parting_rows(
                cfg, v2, kreqs, want, got,
                lambda gap, pair, top: gap <= SPEC_BF16_TIE_REL * top)
            kill["stayed_equal"] = [
                bool(np.array_equal(got[i], want[i]))
                for i, name in enumerate(kill["first_replica"])
                if name != kill["killed"]]
        # a supervisor respawn racing (d)'s swap can leave a third
        # replica; the arbiter starts from the allocation of two
        fleet.pool("llama").scale_to(2)
        arbiter = fleet_arbiter(fleet)
        versions = {m: st["version"]
                    for m, st in fleet.state()["models"].items()}
    finally:
        fleet.close()
        shutil.rmtree(directory, ignore_errors=True)
    return dict(malformed=malformed, http=http, http_equal=http_equal,
                path_row=path_row, kill=kill, arbiter=arbiter,
                versions=versions)


def fleet_phase(cfg, params):
    """(k) in the docstring: the fleet control plane on the slice's
    weights. The launch counts are set to 0 at its start and read at its
    end."""
    import torch
    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    rows = fleet_run(cfg, params)
    _release_gateway()
    malformed, http, http_equal = (rows["malformed"], rows["http"],
                                   rows["http_equal"])
    path_row, kill, arbiter = rows["path_row"], rows["kill"], rows["arbiter"]
    versions = rows["versions"]
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    f32 = fleet_f32(cfg, params)
    _release_gateway()
    launches = read_launches()
    emit({"phase": "fleet", "card": nvidia_smi(), "config": "llama3_8b",
          "models": {"llama": cfg.n_layers, "llama8": FLEET_SMALL_LAYERS},
          "http": http, "stream_equal_to_sync_engines": http_equal,
          "path_swap": path_row, "replica_kill_mid_swap": kill,
          "arbiter": arbiter, "versions": versions, "f32_vs_generate": f32,
          "peak_gb": peak_gb, "launches": launches})
    if malformed:
        raise AssertionError(f"fleet: requests {malformed} did not return "
                             "200 with exactly their tokens")
    if not http_equal:
        raise AssertionError("fleet: a stream differs from the synchronous "
                             "engine of its model and version")
    if http["swap"]["still_draining"] or http["swap"]["version"] != "v1":
        raise AssertionError(f"fleet: the live swap {http['swap']}")
    if not (path_row["bit_equal"] and path_row["one_tree_shared"]
            and path_row["loads"] == 1):
        raise AssertionError(f"fleet: the path swap's tree {path_row}")
    if not (kill["injected"] == 1 and kill["redispatched"] >= 1
            and kill["reasons"] == ["complete"]
            and kill["versions"] == ["v2"] and kill["resumed_ok"]
            and kill["stayed_equal"] and all(kill["stayed_equal"])):
        raise AssertionError(f"fleet: the replica kill mid-swap {kill}")
    want = [[("llama8", "up", "hot", 1, 2)], [],
            [("llama8", "down", "yield->llama", 2, 1),
             ("llama", "up", "hot", 2, 3)]]
    if arbiter["decisions"] != want or \
            arbiter["scale_events"] != {"llama/up": 1, "llama/down": 0,
                                        "llama8/up": 1, "llama8/down": 1}:
        raise AssertionError(f"fleet: the arbiter decided {arbiter}")
    if not f32["ok"]:
        raise AssertionError(f"fleet in f32: no request re-dispatched, or "
                             f"a stream differs from generate away from a "
                             f"near-tie: {f32}")
    if launches != only():
        raise AssertionError(f"fleet launched {launches}")
    return launches


def flywheel_phase():
    """6 (d) in the docstring: the train→serve flywheel at llama3_8b
    widths and FLYWHEEL_LAYERS layers. The launch counts are set to 0 at
    its start and read at its end."""
    import shutil
    import signal
    import tempfile
    import warnings
    import torch
    from mxtpu_torch import checkpoint, telemetry
    from mxtpu_torch.models import llama
    from mxtpu_torch.parallel import optim, step as pstep
    from mxtpu_torch.parallel._tree import tree_map
    from mxtpu_torch.serve import Request, ServeEngine
    from mxtpu_torch.serve.fleet import (FleetGateway, FlywheelController,
                                         ModelSpec)
    cfg = replace(llama.CONFIGS["llama3_8b"], n_layers=FLYWHEEL_LAYERS)
    scfg = replace(cfg, param_dtype=torch.bfloat16)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 4)
    params = llama.init_params(cfg, gen, device="cuda")
    gb = sum(t.numel() * t.element_size()
             for _, t in _leaves_with_keys(params)) / 1e9
    # text-like data: tokens from a seeded Zipf unigram, so a few steps
    # on one batch lower the loss of another batch of the same draw
    rng = np.random.default_rng(SEED + 10)
    zipf = 1.0 / np.arange(1, cfg.vocab_size + 1) ** 1.1
    zipf = rng.permutation(zipf / zipf.sum())
    batch, held = ({"tokens": torch.as_tensor(rng.choice(
        cfg.vocab_size, (1, 2048), p=zipf), device="cuda")}
        for _ in range(2))
    reg = telemetry.registry()
    fb0 = reg.value("checkpoint_total", kind="fallback")
    reset_launches()
    evaluate = pstep.make_eval_step(llama.loss_fn(cfg))
    served = {"v0": tree_map(torch.Tensor.bfloat16, params)}
    loss0 = evaluate(served["v0"], held).item()
    tx = optim.adamw(FLYWHEEL_LR)
    state = pstep.init_state(params, tx)
    del params
    train = pstep.make_train_step(llama.loss_fn(cfg), tx)
    directory = tempfile.mkdtemp(prefix="flywheel-", dir=build_dir())
    mgr = checkpoint.CheckpointManager(directory, max_to_keep=2,
                                       async_save=True)
    io = {"save_dispatch_s": [], "save_wait_s": [], "restore_s": []}
    losses, gates, cands = [], {}, {}

    def save(step, tree):
        t0 = time.perf_counter()
        mgr.wait_until_finished()
        t1 = time.perf_counter()
        mgr.save(step, tree)
        io["save_wait_s"].append(t1 - t0)
        io["save_dispatch_s"].append(time.perf_counter() - t1)

    def steps(first, last):
        nonlocal state
        for i in range(first, last + 1):
            state, loss = train(state, batch)
            losses.append(loss.item())
            save(i, state.params)

    def load(ptr):
        t0 = time.perf_counter()
        tree = mgr.restore(int(ptr["step"]), device="cuda")
        torch.cuda.synchronize()
        io["restore_s"].append(time.perf_counter() - t0)
        cands[int(ptr["step"])] = out = tree_map(torch.Tensor.bfloat16, tree)
        del tree
        return out

    def gate(ptr, cand):
        loss = evaluate(cand, held).item()
        gates[int(ptr["step"])] = loss
        return math.isfinite(loss) and loss < loss0

    def engine(params, overlap=None):
        return ServeEngine(scfg, params, max_slots=FLYWHEEL_SLOTS,
                           max_len=FLYWHEEL_MAX_LEN, min_bucket=64,
                           overlap=overlap, device="cuda")

    reqs, handles = [], []

    def traffic(n, **kw):
        for _ in range(n):
            r = Request(prompt=rng.integers(0, cfg.vocab_size, 64),
                        max_new_tokens=FLYWHEEL_NEW, seed=len(reqs))
            reqs.append(r)
            handles.append(gw.submit(r.prompt, r.max_new_tokens,
                                     seed=r.seed, **kw))

    fleet = FleetGateway([ModelSpec(
        "llama", lambda params=served["v0"]: engine(params), replicas=2,
        max_replicas=2, slo={"ttft_ms": FLYWHEEL_TTFT_MS})], queue_max=64)
    gw = fleet.gateway("llama")
    fly = FlywheelController(
        fleet, "llama", directory, load_candidate=load, eval_gate=gate,
        canary_fraction=0.5, hold_ticks=2, burn_high=1.0,
        max_rollbacks=2, anomaly_budget=10 ** 6,
        poll_s=FLYWHEEL_POLL_S)
    canary = stalled = dispatch = None
    try:
        traffic(2)
        steps(1, 2)
        mgr.publish(2)
        # candidate 2 on the controller's own thread: canary, a clean
        # hold, promote
        fly.start()
        deadline = time.monotonic() + 120
        for action, after in (("canary", 0.01), ("promote", 0.05)):
            while not any(h["action"] == action for h in fly.history) \
                    and time.monotonic() < deadline:
                time.sleep(after)
            if action == "canary":
                traffic(4)
        fly.close()
        promoted = fleet.pool("llama").version
        # candidate 4 passes the gate, then its canary stalls: rollback
        steps(3, 4)
        mgr.publish(4)
        fly.tick()
        canary = [r for r in fleet.pool("llama").replicas()
                  if r.version == "v2"]
        stalled = canary[0].engine if canary else None
        if stalled is not None:
            dispatch = stalled._dispatch

            def stall(firsts):
                stalled._dispatch = dispatch     # once
                time.sleep(FLYWHEEL_STALL_S)
                return dispatch(firsts)

            stalled._dispatch = stall
            traffic(1, prefer_replica=canary[0].name)
            handles[-1].result(timeout=600)
        fly.tick()
        after_rollback = fleet.pool("llama").version
        traffic(2)
        # a planted non-finite candidate: rejected at the gate
        bad = dict(state.params)
        bad["final_norm"] = torch.full_like(bad["final_norm"], math.nan)
        save(5, bad)
        mgr.publish(5)
        fly.tick()
        del bad
        cands.pop(5, None)
        after_bad = fleet.pool("llama").version
        for h in handles:
            h.result(timeout=600)
        decisions = [(h["action"], h.get("step"), h.get("version"),
                      h.get("reason")) for h in fly.history]
        # the streams on each version against a synchronous engine on
        # the candidate its canary served
        served.update({h["version"]: cands[h["step"]] for h in fly.history
                       if h["action"] == "canary"})
        equal = True
        for ver, tree in served.items():
            idx = [i for i, h in enumerate(handles) if h.version == ver]
            if not idx:
                continue
            eng = engine(tree, overlap=False)
            want = serve_stream(eng, reqs, idx)
            del eng
            equal = equal and all(
                h.reason == "complete" and np.array_equal(
                    np.asarray(handles[i].result(timeout=1)), want[i])
                for i, h in ((i, handles[i]) for i in idx))
        versions_served = sorted({h.version for h in handles})
    finally:
        fly.close()
        fleet.close()
        handles.clear()
        # every name that reaches an engine, so the collector frees the
        # fleet's engines and the trees they serve now
        canary = stalled = dispatch = None
        del fleet, gw, fly
        _release_gateway()
    try:
        # a torn latest step (one leaf file truncated): restore() falls
        # back one step, counted
        mgr.wait_until_finished()
        with open(os.path.join(mgr.step_path(5), "leaf_0.bin"), "r+b") as f:
            f.truncate(4096)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            back = mgr.restore(device="cuda")
        fell_back = tree_map(torch.Tensor.bfloat16, back)
        torn_ok = 4 in cands and all(
            torch.equal(a, b) for (_, a), (_, b) in zip(
                _leaves_with_keys(fell_back), _leaves_with_keys(cands[4])))
        del back, fell_back
        fallbacks = reg.value("checkpoint_total", kind="fallback") - fb0
        # SIGTERM under the guard: one final save
        with checkpoint.PreemptionGuard(mgr) as guard:
            os.kill(os.getpid(), signal.SIGTERM)
            deadline = time.monotonic() + 60
            while not guard.preempted and time.monotonic() < deadline:
                time.sleep(0.01)
            t0 = time.perf_counter()
            guard.save_now(FLYWHEEL_STEPS + 2, state.params)
            final_s = time.perf_counter() - t0
        final = mgr.restore(FLYWHEEL_STEPS + 2, device="cuda")
        final_ok = all(torch.equal(a, b) for (_, a), (_, b) in zip(
            _leaves_with_keys(final), _leaves_with_keys(state.params)))
        steps_kept = mgr.all_steps()
        del final
        mgr.close()
    finally:
        shutil.rmtree(directory, ignore_errors=True)
    del state, served, cands
    _release_gateway()
    launches = read_launches()
    evals = 1 + len(gates)
    want = only(flash_attention_fwd=FLYWHEEL_STEPS * 2 * cfg.n_layers
                + evals * cfg.n_layers,
                flash_attention_bwd_dkv=FLYWHEEL_STEPS * cfg.n_layers,
                flash_attention_bwd_dq=FLYWHEEL_STEPS * cfg.n_layers)
    emit({"phase": "flywheel", "card": nvidia_smi(), "config": "llama3_8b",
          "n_layers": cfg.n_layers, "lr": FLYWHEEL_LR, "losses": losses,
          "held_out_loss0": loss0, "gate_losses": gates,
          "decisions": decisions, "promoted": promoted,
          "after_rollback": after_rollback, "after_bad": after_bad,
          "versions_served": versions_served, "streams_equal": equal,
          "checkpoint_gb": gb, **io,
          "torn_fallbacks": fallbacks,
          "torn_warnings": [str(w.message)[:160] for w in caught],
          "torn_fell_back_to_4": torn_ok,
          "preempted_signum": guard.signum, "final_save_s": final_s,
          "final_equal": final_ok, "steps_kept": steps_kept,
          "launches": launches, "want_launches": want})
    actions = [d[0] for d in decisions]
    if actions != ["canary", "promote", "canary", "rollback",
                   "candidate_rejected"] or decisions[3][3] != "slo_burn" \
            or decisions[4][3] != "gate":
        raise AssertionError(f"flywheel decisions {decisions}")
    if (promoted, after_rollback, after_bad) != ("v1", "v1", "v1"):
        raise AssertionError(f"flywheel pool versions {promoted}, "
                             f"{after_rollback}, {after_bad}")
    if not (equal and versions_served == ["v0", "v1", "v2"]):
        raise AssertionError(f"flywheel streams: equal {equal}, versions "
                             f"{versions_served}")
    if not (torn_ok and fallbacks == 1):
        raise AssertionError(f"torn step: fell back to 4 {torn_ok}, "
                             f"{fallbacks} fallbacks counted")
    if not (guard.signum == signal.SIGTERM and final_ok
            and steps_kept == [5, FLYWHEEL_STEPS + 2]):
        raise AssertionError(f"the preemption save: {guard.signum}, "
                             f"{final_ok}, {steps_kept}")
    if launches != want:
        raise AssertionError(f"flywheel launched {launches}, not {want}")
    return launches


def _counted():
    """Every kernel wrapper that counts its launches, by name."""
    from mxtpu_torch.ops import attention as A, conv as C
    return {fn: getattr(mod, fn) for mod, fns in
            ((A, ATTENTION_COUNTERS), (C, ("conv3x3_kernel",)))
            for fn in fns}


def reset_launches():
    from mxtpu_torch import rtc
    for wrapper in _counted().values():
        wrapper.launches = 0
    rtc.launches.clear()


def read_launches():
    from mxtpu_torch import rtc
    out = {fn: wrapper.launches for fn, wrapper in _counted().items()}
    out.update({f"rtc_{k}": rtc.launches[k] for k in RTC_KERNELS})
    return out


ATTENTION_COUNTERS = ("flash_attention_fwd", "flash_attention_bwd_dkv",
                      "flash_attention_bwd_dq")
RTC_KERNELS = ("scale_add", "swiglu")
LAUNCH_COUNTERS = ATTENTION_COUNTERS + ("conv3x3_kernel", "rtc_scale_add",
                                        "rtc_swiglu")


def only(**counts):
    """The launch counts of a path that launches ``counts`` and nothing
    else."""
    want = {k: 0 for k in LAUNCH_COUNTERS}
    want.update(counts)
    return want


def rel_dist(a, b):
    return ((a.float() - b.float()).norm() / b.float().norm()).item()


# what the train and serve_engine phases read from the telemetry
# registry right after their runs, for the telemetry phase
READINGS = {}


def telemetry_value(name, **labels):
    from mxtpu_torch import telemetry
    return telemetry.registry().value(name, **labels)


def program_row(name):
    """A cataloged program's counted cost and live gauges."""
    from mxtpu_torch.telemetry import perfscope
    cost = perfscope.catalog()[name]
    return {"program": name, "flops": cost.flops,
            "bytes_accessed": cost.bytes_accessed,
            "intensity": cost.intensity, "roofline": cost.klass,
            "knee": cost.spec.knee,
            "peak_hbm_gb": (cost.peak_hbm_bytes or 0) / 1e9,
            "mfu": telemetry_value("mfu", program=name),
            "hbm_bw_util": telemetry_value("hbm_bw_util", program=name)}


def ledger_readings():
    """The HBM ledger against the card: its total and breakdown, the
    allocator's bytes, and the headroom gauge against mem_get_info."""
    import gc
    import torch
    from mxtpu_torch.telemetry import perfscope
    gc.collect()               # engines gone by now release their entries
    led = perfscope.ledger()
    total = led.total()
    return {"ledger": led.breakdown(), "ledger_total": total,
            "memory_allocated": torch.cuda.memory_allocated(),
            "headroom": telemetry_value("hbm_headroom_bytes"),
            "mem_total": torch.cuda.mem_get_info()[1]}


def train_readings(cfg, tokens, seconds, builds):
    from mxtpu_torch.models import llama
    from mxtpu_torch.telemetry import perfscope
    row = program_row("train_step")
    median = sorted(seconds)[len(seconds) // 2]
    analytic = llama.train_step_flops(cfg, *tokens.shape)
    row.update(analytic_flops=analytic,
               flops_rel=abs(row["flops"] - analytic) / analytic,
               median_step_s=median,
               mfu_of_median_step=perfscope.mfu(row["flops"], median),
               compile_events=telemetry_value(
                   "compile_events_total", fn="train_step") - builds,
               **ledger_readings())
    return row


def decode_readings(engine, builds, rebuilt, peak_occ, serve_row):
    row = program_row("serve_decode")
    stats = engine.kv_cache_stats()
    ledger = ledger_readings()
    row.update(ledger, params_bytes=ledger["ledger"]["params"],
               peak_live_kv_bytes=peak_occ * stats["reserved_bytes"],
               recompiles=telemetry_value("recompile_total",
                                          fn="serve_decode") - rebuilt,
               program_builds=telemetry_value("program_build_total")
               - builds, compile_count=engine.compile_count,
               decode_dispatch_host_ms=serve_row["decode_dispatch_host_ms"])
    return row


def telemetry_phase():
    """Check and print what the train and serve_engine phases read from
    the registry, and scrape this process's registry over loopback."""
    from mxtpu_torch import telemetry
    from mxtpu_torch.telemetry import distributed as dist
    train, decode = READINGS["train"], READINGS["serve_decode"]
    srv = telemetry.RegistryServer(port=0, process="chip_smoke", secret=b"")
    try:
        proc, _ = dist.scrape_peer("127.0.0.1", srv.port, secret=b"")
        text = dist.federate_text(telemetry.MetricsRegistry(),
                                  [("127.0.0.1", srv.port)],
                                  process="reader", secret=b"")
    finally:
        srv.close()
    samples = telemetry.parse_prometheus(text)["samples"]
    gauges = {}
    for name, program in (("mfu", "train_step"), ("mfu", "serve_decode"),
                          ("hbm_bw_util", "serve_decode"),
                          ("program_flops", "train_step")):
        key = (f"mxtpu_{name}", (("process", "chip_smoke"),
                                 ("program", program)))
        gauges[f"{name}{{{program}}}"] = (samples.get(key), telemetry_value(
            name, program=program))
    programs = [program_row(name) for name in
                sorted(telemetry.perfscope.catalog())]
    emit({"phase": "telemetry", "train_step": train, "serve_decode": decode,
          "programs": programs, "scraped_process": proc,
          "scraped_gauges": gauges})
    failed = []
    if not train["flops_rel"] <= FLOPS_REL_BOUND:
        failed.append(f"train_step FLOPs {train['flops']} against the "
                      f"analytic {train['analytic_flops']}")
    if not abs(train["mfu"] / train["mfu_of_median_step"] - 1) \
            <= MFU_REL_BOUND:
        failed.append(f"live mfu {train['mfu']} against "
                      f"{train['mfu_of_median_step']} of the median step")
    if train["compile_events"] != 1:
        failed.append(f"{train['compile_events']} train_step builds")
    for r in (train, decode):
        if not (r["ledger_total"] <= r["memory_allocated"]
                and r["headroom"] == r["mem_total"] - r["ledger_total"]):
            failed.append(f"the ledger {r['ledger']} against the card")
    if not decode["bytes_accessed"] >= decode["params_bytes"] \
            + decode["peak_live_kv_bytes"]:
        failed.append(f"serve_decode bytes {decode['bytes_accessed']}")
    if decode["recompiles"] or \
            decode["program_builds"] != decode["compile_count"]:
        failed.append(f"serve_decode rebuilt: {decode}")
    if proc != "chip_smoke" or any(a != b for a, b in gauges.values()):
        failed.append(f"the scrape read back {gauges}")
    if failed:
        raise AssertionError("telemetry: " + "; ".join(failed))


def train_phase():
    """Full-width llama3_8b at TRAIN_LAYERS layers: flash vs dense grads,
    then TRAIN_STEPS adamw steps through make_train_step."""
    import torch
    from mxtpu_torch.models import llama
    from mxtpu_torch.parallel import optim, step as pstep
    cfg = replace(llama.CONFIGS["llama3_8b"], n_layers=TRAIN_LAYERS)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    t0 = time.perf_counter()
    params = llama.init_params(cfg, gen, device="cuda")
    tokens = torch.randint(0, cfg.vocab_size, (1, 2048), generator=gen,
                           device="cuda")
    batch = {"tokens": tokens}
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in params["layers"].values()) + sum(
        p.numel() for k, p in params.items() if k != "layers")
    emit({"phase": "train_init", "config": "llama3_8b",
          "n_layers": cfg.n_layers, "params": n_params,
          "param_dtype": str(cfg.param_dtype), "dtype": str(cfg.dtype),
          "remat": cfg.remat, "ce_chunk": llama._resolve_ce_chunk(cfg),
          "seconds": time.perf_counter() - t0})

    # (a) flash vs dense on the initial weights
    picked = (("layers.wq", lambda t: t["layers"]["wq"]),
              ("layers.wk", lambda t: t["layers"]["wk"]),
              ("tok_embed", lambda t: t["tok_embed"]))
    found = {}
    for impl in ("flash", "dense"):
        live = {k: ({lk: lv.detach().requires_grad_()
                     for lk, lv in v.items()} if k == "layers"
                    else v.detach().requires_grad_())
                for k, v in params.items()}
        loss = llama.loss_fn(replace(cfg, attn_impl=impl))(live, batch)
        grads = torch.autograd.grad(loss, [f(live) for _, f in picked])
        found[impl] = (loss.detach(), grads)
        del live, loss, grads
    (lf, gf), (ld, gd) = found["flash"], found["dense"]
    rels = {"loss": abs(lf.item() - ld.item()) / abs(ld.item())}
    rels.update({n: rel_dist(a, b) for (n, _), a, b in zip(picked, gf, gd)})
    emit({"phase": "train_vs_dense", "loss_flash": lf.item(),
          "loss_dense": ld.item(), "rel": rels, "bound": TRAIN_REL_BOUND})
    if not all(math.isfinite(r) and r <= TRAIN_REL_BOUND
               for r in rels.values()):
        raise AssertionError(f"flash vs dense loss/grads {rels} > "
                             f"{TRAIN_REL_BOUND}")
    del found, gf, gd
    torch.cuda.empty_cache()

    # (b) the training step
    tx = optim.adamw(TRAIN_LR)
    state = pstep.init_state(params, tx)
    del params
    step = pstep.make_train_step(llama.loss_fn(cfg), tx)
    builds = telemetry_value("compile_events_total", fn="train_step")
    torch.cuda.reset_peak_memory_stats()
    losses, seconds, launches = [], [], []
    for _ in range(TRAIN_STEPS):
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        state, loss = step(state, batch)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
        launches.append(read_launches())
        losses.append(loss.item())
    ntok = tokens.numel()
    READINGS["train"] = train_readings(cfg, tokens, seconds, builds)
    READINGS["train_steps"] = (losses, seconds)      # for the mesh phase
    final = pstep.make_eval_step(llama.loss_fn(cfg))(state.params,
                                                     batch).item()
    emit({"phase": "train", "steps": TRAIN_STEPS, "lr": TRAIN_LR,
          "tokens_per_step": ntok, "losses": losses, "loss_after": final,
          "ln_vocab": math.log(cfg.vocab_size), "step_seconds": seconds,
          "tokens_per_s": [ntok / t for t in seconds],
          "launches": launches, "step": int(state.step),
          "peak_gb": torch.cuda.max_memory_allocated() / 1e9})
    want = only(flash_attention_fwd=2 * cfg.n_layers,
                flash_attention_bwd_dkv=cfg.n_layers,
                flash_attention_bwd_dq=cfg.n_layers)
    if any(n != want for n in launches):
        raise AssertionError(f"a train step launched {launches}, not {want}")
    if not all(map(math.isfinite, losses + [final])):
        raise AssertionError(f"non-finite training loss: {losses}, {final}")
    if abs(losses[0] - math.log(cfg.vocab_size)) > 1.5:
        raise AssertionError(f"first loss {losses[0]} is not near "
                             f"ln(vocab) = {math.log(cfg.vocab_size)}")
    if not final < losses[0]:
        raise AssertionError(f"loss did not fall over {TRAIN_STEPS} steps: "
                             f"{losses} then {final}")
    if int(state.step) != TRAIN_STEPS:
        raise AssertionError(f"step count {int(state.step)}")
    total = {k: sum(n[k] for n in launches) for k in want}
    params = state.params
    del state, step     # the adamw moments go; the trained params stay
    torch.cuda.empty_cache()
    keyed = train_rng_phase(cfg, params, tokens, gen)
    del params
    torch.cuda.empty_cache()
    return {k: total[k] + keyed[k] for k in want}


MESH_CPU_RANKS = 4          # (d): gloo ranks on the host's CPU
MESH_CPU_AXES = {"dp": 2, "tp": 2}
MESH_CPU_TOL = 1e-5         # (d) vs the one-rank run, of the largest |x|
MESH_CPU_TIMEOUT = 300


def _tiny_mesh_run(mesh):
    """The tests' tiny Llama (f32) on seeded numpy weights and tokens:
    the loss gradients (whole, by leaf) and TRAIN_STEPS sgd losses
    through ``make_train_step``, on ``mesh`` (None: one rank)."""
    import torch
    from mxtpu_torch.models import llama
    from mxtpu_torch.parallel import optim, sharding as S, step as pstep
    from mxtpu_torch.parallel._tree import path_str, tree_flatten_with_path
    cfg = replace(llama.CONFIGS["tiny"], dtype=torch.float32, remat=False)
    rng = np.random.default_rng(SEED)
    shapes = llama.init_params(cfg, torch.Generator(), device="meta")
    tree = llama.params_to_numpy({
        k: ({kk: torch.from_numpy(rng.standard_normal(tuple(vv.shape))
                                  .astype(np.float32) * 0.1)
             for kk, vv in v.items()} if isinstance(v, dict) else
            torch.from_numpy(rng.standard_normal(tuple(v.shape))
                             .astype(np.float32) * 0.1))
        for k, v in shapes.items()})
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (4, 16)))
    rules = None if mesh is None else llama.sharding_rules(cfg)
    params = llama.params_from_numpy(tree, device="cpu")
    if mesh is not None:
        params = S.shard_pytree(params, mesh, rules)
    leaves = [t.requires_grad_() for _, t in tree_flatten_with_path(params)]
    names = [path_str(q) for q, _ in tree_flatten_with_path(params)]
    with S.spmd(mesh):
        loss = llama.loss_fn(cfg, mesh)(params, {
            "tokens": tokens if mesh is None else S.mcon(mesh, tokens,
                                                         ("dp", "fsdp"))})
        loss = loss if mesh is None else S.mcon(mesh, loss)
        grads = torch.autograd.grad(loss, leaves)
    grads = {n: S.to_full(g).detach().numpy() for n, g in zip(names, grads)}
    tx = optim.sgd(0.1)
    state = pstep.init_state(llama.params_from_numpy(tree, device="cpu"), tx,
                             mesh, rules)
    step = pstep.make_train_step(llama.loss_fn(cfg, mesh), tx, mesh, rules)
    losses = []
    for _ in range(TRAIN_STEPS):
        state, loss = step(state, {"tokens": tokens})
        losses.append(float(loss))
    return losses, grads


def mesh_cpu_rank(rank, world, store, out):
    """One gloo rank of (d): the tiny Llama on MESH_CPU_AXES; rank 0
    writes the results to ``out``."""
    import pickle
    import torch
    from mxtpu_torch.parallel import dist
    from mxtpu_torch.parallel.mesh import create_mesh
    torch.set_num_threads(1)
    dist.initialize(num_processes=world, process_id=rank, device="cpu",
                    init_method=f"file://{store}", timeout=MESH_CPU_TIMEOUT)
    res = _tiny_mesh_run(create_mesh(**MESH_CPU_AXES))
    if rank == 0:
        with open(out, "wb") as f:
            pickle.dump((res, torch.__version__), f)
    dist.shutdown()


def mesh_cpu_ranks():
    """(d): MESH_CPU_RANKS gloo ranks of this host's torch on its CPU
    against the one-rank CPU run: the largest difference of the losses
    and of each gradient, over the largest magnitude."""
    import pickle
    here = os.path.dirname(os.path.abspath(__file__))
    work = os.path.join(build_dir(), "mesh_cpu")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    store, out = os.path.join(work, "store"), os.path.join(work, "out.pkl")
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1")
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, "-c",
         f"import chip_smoke as c; c.mesh_cpu_rank({r}, {MESH_CPU_RANKS}, "
         f"{store!r}, {out!r})"], cwd=here, env=env)
        for r in range(MESH_CPU_RANKS)]
    try:
        codes = [p.wait(timeout=MESH_CPU_TIMEOUT) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)
    seconds = time.perf_counter() - t0
    if any(codes):
        raise AssertionError(f"the CPU ranks exited with {codes}")
    with open(out, "rb") as f:
        (losses, grads), torch_version = pickle.load(f)
    shutil.rmtree(work, ignore_errors=True)
    want_losses, want_grads = _tiny_mesh_run(None)

    def rel(a, b):
        return float(np.abs(np.asarray(a) - np.asarray(b)).max()
                     / max(np.abs(np.asarray(b)).max(), 1e-30))
    rels = {"losses": rel(losses, want_losses)}
    rels.update({n: rel(grads[n], want_grads[n]) for n in want_grads})
    return {"ranks": MESH_CPU_RANKS, "mesh": MESH_CPU_AXES,
            "backend": "gloo", "torch": torch_version, "losses": losses,
            "one_rank_losses": want_losses, "rel": rels,
            "bound": MESH_CPU_TOL, "seconds": seconds}


def _mesh_steps(cfg, params, tx, batch, mesh=None, rules=None):
    """TRAIN_STEPS steps of ``make_train_step`` from ``params`` (on
    ``mesh`` by ``rules``): losses, step seconds, launches, the
    collectives the port issued in each step and those DTensor ran in
    the first (counted by ``CommDebugMode``, whose dispatch hook slows
    the step it watches)."""
    import torch
    from torch.distributed.tensor.debug import CommDebugMode
    from mxtpu_torch.models import llama
    from mxtpu_torch.parallel import collectives, step as pstep
    state = pstep.init_state(params, tx, mesh, rules)
    step = pstep.make_train_step(llama.loss_fn(cfg, mesh), tx, mesh, rules)
    losses, seconds, launches, issued, dtensor = [], [], [], [], []
    for _ in range(TRAIN_STEPS):
        torch.cuda.synchronize()
        reset_launches()
        before = sum(collectives.issued.values())
        comm = CommDebugMode() if not dtensor else contextlib.nullcontext()
        t0 = time.perf_counter()
        with comm:
            state, loss = step(state, batch)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
        launches.append(read_launches())
        issued.append(sum(collectives.issued.values()) - before)
        if not dtensor:
            dtensor.append(comm.get_total_counts())
        losses.append(loss.item())
    del state, step
    torch.cuda.empty_cache()
    return losses, seconds, launches, issued, dtensor


def mesh_phase():
    """(a)-(d) of ``mesh``: the train step on a one-rank NCCL mesh
    against the unsharded one, ring and Ulysses forwards on a one-rank
    sp mesh, the fused Gluon step on the mesh, and the multi-rank
    parity on the host's CPU."""
    import torch
    from mxtpu_torch.models import llama
    from mxtpu_torch.parallel import dist, optim
    from mxtpu_torch.parallel.mesh import create_mesh
    from mxtpu_torch.parallel.sharding import shard_pytree, to_full
    t_phase = time.perf_counter()
    work = os.path.join(build_dir(), "mesh_nccl")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    dist.initialize(num_processes=1, process_id=0, device="cuda:0",
                    init_method=f"file://{os.path.join(work, 'store')}",
                    timeout=MESH_CPU_TIMEOUT)
    try:
        mesh = create_mesh(dp=-1)
        backend = torch.distributed.get_backend()
        if not mesh.distributed or backend != "nccl":
            raise AssertionError(f"the mesh is not a NCCL group: {backend}")
        # (a) the train phase's model, seed and tokens
        cfg = replace(llama.CONFIGS["llama3_8b"], n_layers=TRAIN_LAYERS)
        gen = torch.Generator(device="cuda").manual_seed(SEED)
        params = llama.init_params(cfg, gen, device="cuda")
        tokens = torch.randint(0, cfg.vocab_size, (1, 2048), generator=gen,
                               device="cuda")
        batch = {"tokens": tokens}
        # the unsharded step on these weights and batch: the train
        # phase's, or run here when this phase runs alone
        one = READINGS.get("train_steps") or \
            _mesh_steps(cfg, params, optim.adamw(TRAIN_LR), batch)[:2]
        sharded = _mesh_steps(cfg, params, optim.adamw(TRAIN_LR), batch,
                              mesh, llama.sharding_rules(cfg))
        del params
        torch.cuda.empty_cache()
        per_step = only(flash_attention_fwd=2 * cfg.n_layers,
                        flash_attention_bwd_dkv=cfg.n_layers,
                        flash_attention_bwd_dq=cfg.n_layers)
        row_a = {"config": "llama3_8b", "n_layers": cfg.n_layers,
                 "world_size": dist.process_count(), "backend": backend,
                 "losses": sharded[0], "unsharded_losses": one[0],
                 "bit_equal": sharded[0] == one[0],
                 "step_seconds": sharded[1],
                 "unsharded_step_seconds": one[1], "launches": sharded[2],
                 "port_collectives": sharded[3],
                 "dtensor_collectives_first_step": sharded[4][0],
                 "note": "world size 1: the collectives move nothing; one "
                         "card cannot show their cost"}
        if sharded[0] != one[0]:
            raise AssertionError(f"sharded losses {sharded[0]} != unsharded "
                                 f"{one[0]}")
        if any(n != per_step for n in sharded[2]):
            raise AssertionError(f"a sharded step launched {sharded[2]}, "
                                 f"not {per_step}")

        # (b) ring and Ulysses at full width: the forward phase's weights
        fcfg = replace(llama.CONFIGS["llama3_8b"], param_dtype=torch.bfloat16)
        gen = torch.Generator(device="cuda").manual_seed(SEED)
        params = llama.init_params(fcfg, gen, device="cuda")
        tokens = torch.randint(0, fcfg.vocab_size, (1, 2048), generator=gen,
                               device="cuda")
        with torch.no_grad():
            flash = llama.forward(fcfg, params, tokens)
        sp_mesh = create_mesh(dp=1, sp=-1)
        placed = shard_pytree(params, sp_mesh, llama.sharding_rules(fcfg))
        del params
        row_b = {}
        for impl in ("ring", "ulysses"):
            reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with torch.no_grad():
                got = to_full(llama.forward(replace(fcfg, attn_impl=impl),
                                            placed, tokens, sp_mesh))
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            rel = rel_dist(got, flash)
            row_b[impl] = {"rel_vs_flash": rel, "seconds": secs,
                           "finite": bool(torch.isfinite(got).all()),
                           "launches": read_launches()}
            del got
            if not (row_b[impl]["finite"] and rel <= LOGITS_REL_BOUND):
                raise AssertionError(f"{impl} logits {rel} from flash's "
                                     f"(bound {LOGITS_REL_BOUND})")
            if row_b[impl]["launches"] != only():
                raise AssertionError(f"{impl} launched kernels: "
                                     f"{row_b[impl]['launches']}")
        del placed, flash
        torch.cuda.empty_cache()

        # (c) the fused Gluon step on the mesh, against the classic step
        tokens = batch["tokens"]
        classic = gluon_llama_steps(cfg, tokens, "sgd", GLUON_SGD_LR)
        fused = gluon_fused_steps(cfg, tokens, "sgd", GLUON_SGD_LR,
                                  TRAIN_STEPS, mesh=mesh,
                                  rules=llama.sharding_rules(cfg))
        at_capture = {k: 2 * v for k, v in per_step.items()}
        row_c = {"losses": fused[0], "classic_losses": classic[0],
                 "bit_equal": fused[0] == classic[0],
                 "step_seconds": fused[1], "classic_step_seconds": classic[1],
                 "launches": fused[2], "num_compiles": fused[3],
                 "peak_gb": fused[4]}
        if fused[2][0] != at_capture or any(n != only()
                                            for n in fused[2][1:]):
            raise AssertionError(f"mesh fused launched {fused[2]}")
        if any(c != 1 for c in fused[3]):
            raise AssertionError(f"mesh fused built {fused[3]} variants")
        # at world size 1 the mesh changes no op: bit for bit
        if fused[0] != classic[0]:
            raise AssertionError(f"mesh fused losses {fused[0]} != classic "
                                 f"{classic[0]}")
    finally:
        dist.shutdown()
        shutil.rmtree(work, ignore_errors=True)

    # (d) multi-rank parity on the host's own torch
    row_d = mesh_cpu_ranks()
    if not all(r <= MESH_CPU_TOL for r in row_d["rel"].values()):
        raise AssertionError(f"CPU ranks vs one rank: {row_d['rel']}")
    emit({"phase": "mesh", "card": nvidia_smi(), "train": row_a,
          "ring_ulysses": row_b, "gluon_fused": row_c, "cpu_ranks": row_d,
          "seconds": time.perf_counter() - t_phase})
    runs = sharded[2] + classic[2] + fused[2]
    return {k: sum(n[k] for n in runs) for k in LAUNCH_COUNTERS}


def train_rng_phase(cfg, params, tokens, gen):
    """``make_train_step(has_rng=True, grad_accum=2)`` over a loss whose
    target mask is ``prng.bernoulli(key, RNG_MASK_P)``: TRAIN_STEPS sgd
    steps from ``params`` with step t keyed ``fold_in(PRNGKey(seed),
    t)``, twice with one seed, then with another."""
    import torch
    from mxtpu_torch import prng
    from mxtpu_torch.models import llama
    from mxtpu_torch.parallel import optim, step as pstep
    base = llama.loss_fn(cfg)

    def keyed_loss(p, batch, rng):
        mask = prng.bernoulli(rng, RNG_MASK_P, batch["tokens"].shape)
        return base(p, {"tokens": batch["tokens"], "mask": mask})
    second = torch.randint(0, cfg.vocab_size, tokens.shape, generator=gen,
                           device="cuda")
    batch = {"tokens": torch.stack([tokens, second])}   # 2 microbatches
    tx = optim.sgd(TRAIN_LR)
    step = pstep.make_train_step(keyed_loss, tx, has_rng=True, grad_accum=2)
    torch.cuda.reset_peak_memory_stats()
    runs = {}
    for name, seed in (("first", SEED + 1), ("again", SEED + 1),
                       ("other_key", SEED + 2)):
        state = None
        state = pstep.init_state(params, tx)
        losses, seconds, launches = [], [], []
        for t in range(TRAIN_STEPS):
            key = prng.fold_in(prng.PRNGKey(seed, "cuda"), t) # noqa: MXL301 — a check's seeded chain root, compared with the engine's
            torch.cuda.synchronize()
            reset_launches()
            t0 = time.perf_counter()
            state, loss = step(state, batch, key)
            torch.cuda.synchronize()
            seconds.append(time.perf_counter() - t0)
            launches.append(read_launches())
            losses.append(loss.item())
        runs[name] = (losses, seconds, launches)
    del state
    ntok = batch["tokens"].numel()
    emit({"phase": "train_rng", "steps": TRAIN_STEPS, "grad_accum": 2,
          "optimizer": f"sgd({TRAIN_LR})", "mask_p": RNG_MASK_P,
          "tokens_per_step": ntok,
          "losses": {k: v[0] for k, v in runs.items()},
          "step_seconds": {k: v[1] for k, v in runs.items()},
          "tokens_per_s": [ntok / t for t in runs["first"][1]],
          "launches": runs["first"][2],
          "peak_gb": torch.cuda.max_memory_allocated() / 1e9})
    want = only(flash_attention_fwd=4 * cfg.n_layers,
                flash_attention_bwd_dkv=2 * cfg.n_layers,
                flash_attention_bwd_dq=2 * cfg.n_layers)
    every = [n for _, _, ls in runs.values() for n in ls]
    if any(n != want for n in every):
        raise AssertionError(f"a keyed step launched {every}, not {want}")
    losses = [x for ls, _, _ in runs.values() for x in ls]
    if not all(map(math.isfinite, losses)):
        raise AssertionError(f"non-finite keyed losses: {runs}")
    if runs["first"][0] != runs["again"][0]:
        raise AssertionError("the same keys gave other losses: "
                             f"{runs['first'][0]}, {runs['again'][0]}")
    if runs["first"][0] == runs["other_key"][0]:
        raise AssertionError("another key gave the same losses")
    return {k: sum(n[k] for n in every) for k in want}


GLUON_SGD_LR, GLUON_ADAMW_LR = TRAIN_LR, 3e-6
GLUON_LOSS_REL = 1e-4      # Gluon sgd losses vs make_train_step's


def gluon_llama_steps(cfg, tokens, opt, lr):
    """GluonLlama over freshly seeded weights (the train phase's),
    hybridized, TRAIN_STEPS classic steps of ``Trainer(opt, lr)``: the
    losses, step seconds and launches of each step."""
    import torch
    import mxtpu_torch as mx
    from mxtpu_torch.gluon import Trainer
    from mxtpu_torch.gluon.model_zoo import GluonLlama
    from mxtpu_torch.models import llama
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    net = GluonLlama(cfg)
    net.load_pytree(llama.init_params(cfg, gen, device="cuda"))
    net.hybridize()
    trainer = Trainer(net.collect_params(), opt, {"learning_rate": lr})
    tok = mx.nd.NDArray(tokens)
    losses, seconds, launches = [], [], []
    for _ in range(TRAIN_STEPS):
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        with mx.autograd.record():
            loss = net(tok, tok)
        loss.backward()
        trainer.step(1)
        losses.append(float(loss.asscalar()))
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
        launches.append(read_launches())
    del net, trainer, loss
    _release_gateway()      # a hybridized block's cached call cycles to it
    return losses, seconds, launches


def gluon_phase():
    """17 in the docstring: GluonLlama training through the classic
    Trainer at llama3_8b width, then the model zoo's ResNet-50."""
    import torch
    from mxtpu_torch.models import llama
    from mxtpu_torch.parallel import optim, step as pstep
    cfg = replace(llama.CONFIGS["llama3_8b"], n_layers=TRAIN_LAYERS)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    llama.init_params(cfg, gen, device="cuda")     # the train phase's draws
    tokens = torch.randint(0, cfg.vocab_size, (1, 2048), generator=gen,
                           device="cuda")
    # the functional reference: make_train_step's sgd on the same weights
    ref = pstep.init_state(llama.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(SEED),
        device="cuda"), optim.sgd(GLUON_SGD_LR))
    step = pstep.make_train_step(llama.loss_fn(cfg), optim.sgd(GLUON_SGD_LR))
    want = []
    for _ in range(TRAIN_STEPS):
        ref, loss = step(ref, {"tokens": tokens})
        want.append(loss.item())
    del ref, step, loss
    _release_gateway()
    torch.cuda.reset_peak_memory_stats()
    sgd = gluon_llama_steps(cfg, tokens, "sgd", GLUON_SGD_LR)
    sgd_peak = torch.cuda.max_memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    adamw = gluon_llama_steps(cfg, tokens, "adamw", GLUON_ADAMW_LR)
    adamw_peak = torch.cuda.max_memory_allocated() / 1e9
    ntok = tokens.numel()
    rel = [abs(a - b) / abs(b) for a, b in zip(sgd[0], want)]
    emit({"phase": "gluon_train", "card": nvidia_smi(),
          "config": "llama3_8b", "n_layers": cfg.n_layers,
          "tokens_per_step": ntok,
          "sgd": {"lr": GLUON_SGD_LR, "losses": sgd[0],
                  "make_train_step_losses": want, "rel": rel,
                  "bound": GLUON_LOSS_REL, "step_seconds": sgd[1],
                  "tokens_per_s": [ntok / t for t in sgd[1]],
                  "launches": sgd[2], "peak_gb": sgd_peak},
          "adamw": {"lr": GLUON_ADAMW_LR, "losses": adamw[0],
                    "step_seconds": adamw[1],
                    "tokens_per_s": [ntok / t for t in adamw[1]],
                    "launches": adamw[2], "peak_gb": adamw_peak}})
    per_step = only(flash_attention_fwd=2 * cfg.n_layers,
                    flash_attention_bwd_dkv=cfg.n_layers,
                    flash_attention_bwd_dq=cfg.n_layers)
    every = sgd[2] + adamw[2]
    if any(n != per_step for n in every):
        raise AssertionError(f"a Gluon step launched {every}, not "
                             f"{per_step}")
    if not all(r <= GLUON_LOSS_REL for r in rel):
        raise AssertionError(f"Gluon sgd losses {sgd[0]} are not within "
                             f"{GLUON_LOSS_REL} of make_train_step's {want}")
    losses = adamw[0]
    if not (all(map(math.isfinite, losses)) and losses[-1] < losses[0]):
        raise AssertionError(f"Gluon adamw losses {losses} are not finite "
                             "and falling")
    fused = gluon_fused_run(cfg, tokens, want,
                            {"sgd": sgd[1], "adamw": adamw[1]})
    del tokens
    torch.cuda.empty_cache()
    resnet = gluon_resnet_run()
    fused_resnet = gluon_fused_resnet_run()
    rnn = gluon_rnn_run()
    return {k: sum(n[k] for n in every) + resnet[k] + fused[k]
            + fused_resnet[k] + rnn[k] for k in LAUNCH_COUNTERS}


def gluon_resnet_run():
    """(b) of ``gluon``: the model zoo's ResNet-50, eval as a CUDA graph
    and 3 Trainer steps, all at batch 256."""
    import torch
    import mxtpu_torch as mx
    from mxtpu_torch.tools.timing import time_ms
    n = RESNET_BATCH
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    images = mx.nd.NDArray(torch.randn((n, 3, 224, 224), generator=gen,
                                       device="cuda"))
    labels = mx.nd.NDArray(torch.randint(0, 1000, (n,), generator=gen,
                                         device="cuda").float())
    mx.random.seed(SEED)
    net = mx.gluon.model_zoo.vision.get_model("resnet50_v1")
    net.initialize(mx.initializer.Xavier(magnitude=2), ctx=mx.gpu())
    net.hybridize()
    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    net(images)                     # eager: resolves the deferred shapes
    logits = net(images)._data      # the capture, then its replay
    torch.cuda.synchronize()
    finite = bool(torch.isfinite(logits).all())
    eval_dtype, eval_shape = str(logits.dtype), list(logits.shape)
    eval_ms = time_ms(lambda: net(images), reps=5, warmup=1)
    eval_peak = torch.cuda.max_memory_allocated() / 1e9
    captures = net.captures
    # f32 activations at batch 256 do not fit beside the saved graph
    # (the eager BatchNorm keeps several copies of each): train in bf16
    # on float32 master weights, MXNet's mixed-precision recipe (the
    # functional resnet_train computes in bf16 too); the cast drops the
    # eval graph
    del logits
    net.cast("bfloat16")
    images = images.astype("bfloat16")
    trainer = mx.gluon.Trainer(net.collect_params(), "sgd",
                               {"learning_rate": 0.1, "momentum": 0.9,
                                "multi_precision": True})
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    _release_gateway()
    torch.cuda.reset_peak_memory_stats()
    losses, seconds = [], []
    for _ in range(RESNET_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with mx.autograd.record():
            loss = loss_fn(net(images), labels)
        loss.backward()
        trainer.step(n)
        losses.append(float(loss.mean().asscalar()))
        seconds.append(time.perf_counter() - t0)
    train_peak = torch.cuda.max_memory_allocated() / 1e9
    means = [p.data()._data for name, p in net.collect_params().items()
             if name.endswith("running_mean")]
    moved = sum(bool((m != 0).any()) for m in means)
    launches = read_launches()
    # the fused run prints this beside its own
    READINGS["gluon_resnet_img_per_s"] = [n / t for t in seconds]
    emit({"phase": "gluon_resnet", "card": nvidia_smi(),
          "config": "resnet50_v1", "batch": n, "image": [3, 224, 224],
          "eval_dtype": eval_dtype, "logits": eval_shape,
          "train_dtype": "bfloat16 (float32 master weights)",
          "finite": finite, "captures": captures,
          "eval_ms": eval_ms, "eval_img_per_s": n / (eval_ms / 1e3),
          "eval_peak_gb": eval_peak, "losses": losses,
          "ln_classes": math.log(1000), "step_seconds": seconds,
          "img_per_s": READINGS["gluon_resnet_img_per_s"],
          "bn_means_moved": moved, "bn_layers": len(means),
          "peak_gb": train_peak, "launches": launches})
    if not (finite and eval_shape == [n, 1000]
            and eval_dtype == "torch.float32"):
        raise AssertionError("Gluon ResNet-50 eval logits are not finite "
                             f"f32 ({n}, 1000)")
    if captures != 1:
        raise AssertionError(f"Gluon ResNet-50 eval captured {captures} "
                             "graphs, not one")
    if not all(map(math.isfinite, losses)):
        raise AssertionError(f"non-finite Gluon ResNet-50 loss: {losses}")
    if abs(losses[0] - math.log(1000)) > 1.0:
        raise AssertionError(f"first Gluon ResNet-50 loss {losses[0]} is "
                             f"not within 1.0 of ln 1000")
    if moved != len(means) or not means:
        raise AssertionError(f"{len(means) - moved} of {len(means)} "
                             f"BatchNorm running means did not move")
    if launches != only():
        raise AssertionError(f"the Gluon ResNet path launched {launches}")
    del net, trainer, images, loss
    _release_gateway()
    return launches


GLUON_FUSED_STEPS = 4          # adamw: an lr edit before step 3
FUSED_RESNET_STEPS = 4
FUSED_RESNET_WORKERS = 4
FUSED_RESNET_IMAGE = 224
FUSED_AMP_BATCH = 64
# the fused step's first step against the classic Trainer's on the same
# weights and batch (bf16 compute): the losses within one bf16 rounding
# of each other and a few roundings' slack; the float32 masters' update
# and the BatchNorm statistics' change, each tensor's within this share
# (L2) of its own, against the classic path's
FUSED_CLASSIC_LOSS_REL = 2.0 ** -6
FUSED_CLASSIC_UPDATE_REL = 2.0 ** -3
FUSED_CLASSIC_STATS_REL = 2.0 ** -5
RNN_VOCAB, RNN_EMBED, RNN_HIDDEN, RNN_LAYERS = 33278, 650, 650, 2
RNN_BPTT, RNN_BATCH, RNN_STEPS = 35, 32, 3


def _fused_net(cfg, mesh=None, rules=None):
    """GluonLlama over the train phase's seeded weights, hybridized and
    sharded on ``mesh`` by ``rules`` (default: the one-device mesh
    ``make_fused_step`` takes, everything replicated)."""
    import torch
    from mxtpu_torch.gluon.model_zoo import GluonLlama
    from mxtpu_torch.models import llama
    from mxtpu_torch.parallel.mesh import create_mesh
    from mxtpu_torch.parallel.sharding import P, ShardingRules
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    net = GluonLlama(cfg)
    net.load_pytree(llama.init_params(cfg, gen, device="cuda"))
    net.hybridize()
    net.shard(mesh or create_mesh(dp=-1),
              rules or ShardingRules([(r".*", P())]))
    return net


def gluon_fused_steps(cfg, tokens, opt, lr, steps, edit_at=None, mesh=None,
                      rules=None):
    """``Trainer.make_fused_step`` on GluonLlama (sharded on ``mesh`` by
    ``rules``, default the one-device mesh): the losses, step seconds
    and launches of each step, the captures, and the peak GB. With
    ``edit_at``, ``trainer.set_learning_rate(2 lr)`` before that
    step."""
    import torch
    import mxtpu_torch as mx
    from mxtpu_torch.gluon import Trainer
    torch.cuda.reset_peak_memory_stats()
    net = _fused_net(cfg, mesh, rules)
    trainer = Trainer(net.collect_params(), opt, {"learning_rate": lr})
    step = trainer.make_fused_step(net)      # net(tokens, tokens) -> loss
    tok = mx.nd.NDArray(tokens)
    losses, seconds, launches, compiles = [], [], [], []
    for i in range(steps):
        if i == edit_at:
            trainer.set_learning_rate(2 * lr)
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        losses.append(float(step(tok, tok).asscalar()))
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
        launches.append(read_launches())
        compiles.append(step.num_compiles())
    peak = torch.cuda.max_memory_allocated() / 1e9
    del net, trainer, step, tok
    _release_gateway()
    return losses, seconds, launches, compiles, peak


def gluon_fused_run(cfg, tokens, want, classic_seconds):
    """(c) of ``gluon``: the one-program step (one CUDA graph) at the
    classic run's width, weights and batch; ``classic_seconds`` are
    the classic steps' seconds of this run, printed beside."""
    import torch
    sgd = gluon_fused_steps(cfg, tokens, "sgd", GLUON_SGD_LR, TRAIN_STEPS)
    adamw = gluon_fused_steps(cfg, tokens, "adamw", GLUON_ADAMW_LR,
                              GLUON_FUSED_STEPS, edit_at=2)
    ntok = tokens.numel()
    rel = [abs(a - b) / abs(b) for a, b in zip(sgd[0], want)]
    per_step = only(flash_attention_fwd=2 * cfg.n_layers,
                    flash_attention_bwd_dkv=cfg.n_layers,
                    flash_attention_bwd_dq=cfg.n_layers)
    at_capture = {k: 2 * v for k, v in per_step.items()}
    emit({"phase": "gluon_fused", "card": nvidia_smi(),
          "config": "llama3_8b", "n_layers": cfg.n_layers,
          "tokens_per_step": ntok,
          "sgd": {"lr": GLUON_SGD_LR, "losses": sgd[0],
                  "make_train_step_losses": want, "rel": rel,
                  "bound": GLUON_LOSS_REL, "step_seconds": sgd[1],
                  "tokens_per_s": [ntok / t for t in sgd[1]],
                  "launches": sgd[2], "num_compiles": sgd[3],
                  "peak_gb": sgd[4]},
          "adamw": {"lr": GLUON_ADAMW_LR, "lr_edit": [2, 2 * GLUON_ADAMW_LR],
                    "losses": adamw[0], "step_seconds": adamw[1],
                    "tokens_per_s": [ntok / t for t in adamw[1]],
                    "launches": adamw[2], "num_compiles": adamw[3],
                    "peak_gb": adamw[4]},
          "launches_at_capture": at_capture,
          "classic_step_seconds": classic_seconds})
    for name, run in (("sgd", sgd), ("adamw", adamw)):
        if run[2][0] != at_capture or any(n != only() for n in run[2][1:]):
            raise AssertionError(f"fused {name} launched {run[2]}: the "
                                 f"capture call {at_capture}, replays none")
        if any(c != 1 for c in run[3]):
            raise AssertionError(f"fused {name} built {run[3]} variants, "
                                 "not one CUDA graph")
    if not all(r <= GLUON_LOSS_REL for r in rel):
        raise AssertionError(f"fused sgd losses {sgd[0]} are not within "
                             f"{GLUON_LOSS_REL} of make_train_step's {want}")
    losses = adamw[0]
    if not (all(map(math.isfinite, losses)) and losses[-1] < losses[0]):
        raise AssertionError(f"fused adamw losses {losses} are not finite "
                             "and falling")
    torch.cuda.empty_cache()
    return {k: sum(n[k] for n in sgd[2] + adamw[2])
            for k in LAUNCH_COUNTERS}


def _preprocess_block():
    """uint8 NHWC images to normalized NCHW in the block's ``dtype``,
    inside the step (the class is made here: it needs the port)."""
    import mxtpu_torch as mx

    class Preprocess(mx.gluon.HybridBlock):
        dtype = "float32"

        def hybrid_forward(self, F, x):
            x = x.astype("float32") / 255.0 - 0.45
            return x.transpose((0, 3, 1, 2)).astype(self.dtype) / 0.225

    return Preprocess(prefix="pre_")


def _zoo_resnet50(n_probe=2):
    """``get_model("resnet50_v1")`` behind the preprocessing block,
    initialized and its shapes resolved, in f32."""
    import torch
    import mxtpu_torch as mx
    mx.random.seed(SEED)
    body = mx.gluon.model_zoo.vision.get_model("resnet50_v1")
    body.initialize(mx.initializer.Xavier(magnitude=2), ctx="cuda")
    with mx.autograd.predict_mode():
        body(mx.nd.NDArray(torch.zeros(
            (n_probe, 3, FUSED_RESNET_IMAGE, FUSED_RESNET_IMAGE),
            device="cuda")))
    pre = _preprocess_block()
    net = mx.gluon.nn.HybridSequential(prefix="fr_")
    net.add(pre, body)
    return net, pre


def _fused_resnet_step(net, pre, dtype, batch_args, **trainer_kw):
    import mxtpu_torch as mx
    from mxtpu_torch.parallel.mesh import create_mesh
    from mxtpu_torch.parallel.sharding import P, ShardingRules
    net.cast(dtype)
    pre.dtype = dtype
    net.hybridize()
    net.shard(create_mesh(dp=-1), ShardingRules([(r".*", P())]))
    trainer = mx.gluon.Trainer(net.collect_params(), "sgd",
                               {"learning_rate": 0.1, "momentum": 0.9,
                                "multi_precision": True})
    amp = trainer_kw.pop("amp", None)
    if amp is not None:
        mx.amp.init(amp)
        mx.amp.init_trainer(trainer)
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    step = trainer.make_fused_step(
        net, loss_fn=lambda out, y: loss_fn(out, y).mean(), loss_args=1,
        **batch_args)
    return trainer, step


def _fused_vs_classic_resnet(first, names, w0, stat_names):
    """The classic ``Trainer(multi_precision=True)`` from the fused
    run's starting weights (the same seed; checked bit for bit) on its
    first batch: two microbatch backwards accumulated
    (``grad_req="add"``), one ``step(2)``; its loss, float32 masters
    and BatchNorm statistics against the fused step's after that step."""
    import torch
    import mxtpu_torch as mx
    net, pre = _zoo_resnet50()
    net.cast("bfloat16")
    pre.dtype = "bfloat16"
    net.hybridize()
    params = net.collect_params()
    # a second build numbers its blocks anew: match by position
    live = [p for p in params.values() if p.grad_req != "null"]
    stats = [p for name, p in params.items()
             if name.endswith(("running_mean", "running_var"))]
    same_start = len(live) == len(w0) and len(stats) == len(stat_names) \
        and all(torch.equal(p.data()._data, w) for p, w in zip(live, w0))
    stats0 = [p.data()._data.float().clone() for p in stats]
    for p in live:
        p.grad_req = "add"
    trainer = mx.gluon.Trainer(params, "sgd",
                               {"learning_rate": 0.1, "momentum": 0.9,
                                "multi_precision": True})
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    x, y = mx.nd.NDArray(first["x"]), mx.nd.NDArray(first["y"])
    half = x.shape[0] // 2
    total = None
    for i in range(2):
        with mx.autograd.record():
            loss = loss_fn(net(x[i * half:(i + 1) * half]),
                           y[i * half:(i + 1) * half]).mean()
        loss.backward()
        total = loss if total is None else total + loss
    trainer.step(2)
    classic_loss = float((total / 2).asscalar())
    index = {p.name: i for i, p in enumerate(trainer._params)}
    states = trainer._updaters[0].states

    def rel(got, want, base):
        d = (want - base).float()
        return float((got - want).float().norm() / d.norm().clamp_min(1e-30))

    update_rel = [rel(m, states[index[p.name]][0]._data, w.float())
                  for p, m, w in zip(live, first["masters"], w0)]
    stats_rel = [rel(f.float(), p.data()._data.float(), s0)
                 for p, f, s0 in zip(stats, first["stats"], stats0)]
    loss_rel = abs(first["loss"] - classic_loss) / abs(classic_loss)
    worst = max(range(len(update_rel)), key=update_rel.__getitem__)
    row = {"same_start": same_start, "fused_loss": first["loss"],
           "classic_loss": classic_loss, "loss_rel": loss_rel,
           "loss_bound": FUSED_CLASSIC_LOSS_REL,
           "master_update_rel_max": update_rel[worst],
           "master_update_rel_worst": names[worst],
           "master_update_rel_median": sorted(update_rel)[
               len(update_rel) // 2],
           "update_bound": FUSED_CLASSIC_UPDATE_REL,
           "bn_stats_rel_max": max(stats_rel),
           "stats_bound": FUSED_CLASSIC_STATS_REL,
           "tensors": [len(names), len(stat_names)]}
    row["held"] = bool(same_start and loss_rel <= FUSED_CLASSIC_LOSS_REL
                       and max(update_rel) <= FUSED_CLASSIC_UPDATE_REL
                       and max(stats_rel) <= FUSED_CLASSIC_STATS_REL)
    del net, pre, trainer, params, live, stats, states, x, y, total, loss
    return row


def gluon_fused_resnet_run():
    """(d) of ``gluon``: ResNet-50 through ``make_fused_step``
    (grad_accum 2, bf16 on float32 masters), fed by a 4-worker
    DataLoader and the DevicePrefetcher; then one float16 dynamic-AMP
    step from a scale that overflows."""
    import numpy as onp
    import torch
    import mxtpu_torch as mx
    from mxtpu_torch.gluon import data as gdata
    n = RESNET_BATCH
    rng = onp.random.default_rng(SEED)
    side = FUSED_RESNET_IMAGE
    # two batches, two epochs over one worker pool: each worker receives
    # the dataset once, pickled, at its start
    images = rng.integers(0, 256, (2 * n, side, side, 3), dtype=onp.uint8)
    labels = rng.integers(0, 1000, 2 * n).astype("float32")
    loader = gdata.DataLoader(gdata.ArrayDataset(images, labels),
                              batch_size=n, num_workers=FUSED_RESNET_WORKERS,
                              pin_memory=True, timeout=600)
    net, pre = _zoo_resnet50()
    torch.cuda.reset_peak_memory_stats()
    trainer, step = _fused_resnet_step(net, pre, "bfloat16",
                                       {"grad_accum": 2})
    means = [p for name, p in net.collect_params().items()
             if name.endswith("running_mean")]
    before = [m.data()._data.clone() for m in means]
    # what the classic Trainer is held to after the first step
    names = [name for name, p in net.collect_params().items()
             if p.grad_req != "null"]
    stat_names = [name for name, p in net.collect_params().items()
                  if name.endswith(("running_mean", "running_var"))]
    w0 = [t.clone() for t in step._static.live]
    first = {}
    losses, seconds = [], []
    from mxtpu_torch import telemetry
    wait = telemetry.histogram("train_data_wait_ms")
    counts0 = wait.snapshot()[2]
    reset_launches()
    with gdata.DevicePrefetcher(loader, depth=2, device="cuda") as batches:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(FUSED_RESNET_STEPS // 2):
            for x, y in batches:
                losses.append(float(step(x, y).asscalar()))
                if not first:
                    params = net.collect_params()
                    first.update(
                        x=x._data.clone(), y=y._data.clone(),
                        loss=losses[0],
                        masters=[s[0].clone() for s in step._opt_states],
                        stats=[params[k].data()._data.clone()
                               for k in stat_names])
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                seconds.append(t1 - t0)
                t0 = t1
            batches.reset()
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated() / 1e9
    moved = sum(bool((m.data()._data != b).any())
                for m, b in zip(means, before))
    waits = {"count": wait.snapshot()[2] - counts0,
             "p50_ms": wait.percentile(50), "p99_ms": wait.percentile(99)}
    compiles = step.num_compiles()
    del step, trainer, before, batches, loader
    _release_gateway()
    del net, pre
    _release_gateway()
    vs_classic = _fused_vs_classic_resnet(first, names, w0, stat_names)
    del first, w0
    _release_gateway()
    # float16 dynamic AMP on fresh weights: a step from 2**126 overflows,
    # is skipped and halves the scale; from 1 the next applies.
    # BatchNorm's running statistics move in a skipped step too (the
    # forward ran), as in the reference, so "untouched" is the trained
    # parameters
    net, pre = _zoo_resnet50()
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    x16 = mx.nd.NDArray(torch.randint(0, 256,
                                      (FUSED_AMP_BATCH, side, side, 3),
                                      generator=gen, device="cuda",
                                      dtype=torch.uint8))
    y16 = mx.nd.NDArray(torch.randint(0, 1000, (FUSED_AMP_BATCH,),
                                      generator=gen, device="cuda").float())
    trainer, step = _fused_resnet_step(net, pre, "float16", {},
                                       amp="float16")
    trainer._amp_loss_scaler.loss_scale = 2.0 ** 126
    params = [p for p in net.collect_params().values()
              if p.grad_req != "null"]
    w0 = [p.data()._data.clone() for p in params]
    reset_launches()
    step(x16, y16)
    torch.cuda.synchronize()
    skipped = all(torch.equal(p.data()._data, w) for p, w in zip(params, w0))
    amp_row = {"batch": FUSED_AMP_BATCH, "init_scale": 2.0 ** 126,
               "trained_params_bit_equal_after_skip": skipped,
               "scale_after_skip": step.loss_scale(),
               "applied_after_skip": step.applied_updates()}
    trainer._amp_loss_scaler.loss_scale = 1.0
    amp_loss = float(step(x16, y16).asscalar())
    amp_row.update(applied_after_clean=step.applied_updates(),
                   scale_after_clean=step.loss_scale(), loss=amp_loss,
                   moved=any(not torch.equal(p.data()._data, w)
                             for p, w in zip(params, w0)),
                   num_compiles=step.num_compiles())
    amp_launches = read_launches()
    emit({"phase": "gluon_fused_resnet", "card": nvidia_smi(),
          "config": "resnet50_v1", "batch": n, "grad_accum": 2,
          "train_dtype": "bfloat16 (float32 master weights)",
          "loader": {"num_workers": FUSED_RESNET_WORKERS,
                     "pin_memory": True, "prefetch_depth": 2},
          "losses": losses, "step_seconds": seconds,
          "img_per_s": [n / t for t in seconds],
          "classic_img_per_s": READINGS.get("gluon_resnet_img_per_s"),
          "num_compiles": compiles,
          "bn_means_moved": moved, "bn_layers": len(means),
          "data_wait": waits, "peak_gb": peak, "launches": launches,
          "vs_classic": vs_classic, "amp_float16": amp_row})
    if not (len(losses) == FUSED_RESNET_STEPS
            and all(map(math.isfinite, losses))):
        raise AssertionError(f"fused ResNet-50 losses {losses}")
    if compiles != 1:
        raise AssertionError(f"fused ResNet-50 built {compiles} variants")
    if moved != len(means) or not means:
        raise AssertionError(f"{len(means) - moved} of {len(means)} "
                             "BatchNorm running means did not move")
    if not vs_classic["held"]:
        raise AssertionError(f"the fused step's first step is not the "
                             f"classic Trainer's: {vs_classic}")
    if not (skipped and amp_row["scale_after_skip"] == 2.0 ** 125
            and amp_row["applied_after_skip"] == 0
            and amp_row["applied_after_clean"] == 1 and amp_row["moved"]
            and math.isfinite(amp_loss)):
        raise AssertionError(f"the float16 AMP steps: {amp_row}")
    if launches != only() or amp_launches != only():
        raise AssertionError(f"the fused ResNet path launched {launches}, "
                             f"{amp_launches}")
    del net, step, trainer, x16, y16, w0
    _release_gateway()
    return launches


def gluon_rnn_run():
    """(e) of ``gluon``: a hybridized 2-layer ``gluon.rnn.LSTM`` word LM
    at the WikiText-2 "medium" shape of MXNet's ``word_language_model``
    example, 3 classic Trainer steps."""
    import torch
    import mxtpu_torch as mx
    nn = mx.gluon.nn

    class WordLM(mx.gluon.HybridBlock):
        def __init__(self, **kw):
            super().__init__(**kw)
            with self.name_scope():
                self.embedding = nn.Embedding(RNN_VOCAB, RNN_EMBED)
                self.rnn = mx.gluon.rnn.LSTM(RNN_HIDDEN, RNN_LAYERS,
                                             input_size=RNN_EMBED)
                self.decoder = nn.Dense(RNN_VOCAB, flatten=False,
                                        in_units=RNN_HIDDEN)

        def hybrid_forward(self, F, x):
            return self.decoder(self.rnn(self.embedding(x)))

    mx.random.seed(SEED)
    net = WordLM(prefix="lm_")
    net.initialize(mx.initializer.Uniform(0.1), ctx="cuda")
    net.hybridize()
    trainer = mx.gluon.Trainer(net.collect_params(), "sgd",
                               {"learning_rate": 1.0})
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    seq = torch.randint(0, RNN_VOCAB, (RNN_BPTT + 1, RNN_BATCH),
                        generator=gen, device="cuda")
    data = mx.nd.NDArray(seq[:-1].float())
    target = mx.nd.NDArray(seq[1:].reshape(-1).float())
    losses, seconds = [], []
    reset_launches()
    for _ in range(RNN_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with mx.autograd.record():
            out = net(data)
            loss = loss_fn(out.reshape((-1, RNN_VOCAB)), target).mean()
        loss.backward()
        trainer.step(1)
        losses.append(float(loss.asscalar()))
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
    launches = read_launches()
    ln_v = math.log(RNN_VOCAB)
    emit({"phase": "gluon_rnn", "card": nvidia_smi(),
          "model": "word LM: Embedding, 2-layer LSTM, Dense",
          "vocab": RNN_VOCAB, "embed": RNN_EMBED, "hidden": RNN_HIDDEN,
          "bptt": RNN_BPTT, "batch": RNN_BATCH, "losses": losses,
          "ln_vocab": ln_v, "step_seconds": seconds,
          "tokens_per_s": [RNN_BPTT * RNN_BATCH / t for t in seconds],
          "launches": launches})
    if not all(map(math.isfinite, losses)):
        raise AssertionError(f"non-finite word-LM losses {losses}")
    if abs(losses[0] - ln_v) > 1.0:
        raise AssertionError(f"first word-LM loss {losses[0]} is not "
                             f"within 1.0 of ln {RNN_VOCAB}")
    if launches != only():
        raise AssertionError(f"the word LM launched {launches}")
    del net, trainer, out, loss
    _release_gateway()
    return launches


SYMBOL_BATCH = 256            # SymbolBlock against the Gluon net
MODULE_BATCH = 64             # Module.fit's batch
MODULE_STEPS = 3
MODULE_LR, MODULE_MOMENTUM = 0.1, 0.9
# the SymbolBlock interprets the exported graph through the same registry
# ops on the same weights as the Gluon net, so its logits are the net's
# bits; a captured call may get another cuDNN algorithm, so the bound
# allows the f32 rounding of the convolutions' sums in another order
SYMBOL_LOGITS_REL = 1e-5      # of max |logit|
# Module's first step against the classic Trainer's on the same weights
# and batch. The two compute the same function in another order: the
# training BatchNorm reduces the batch inside the op where the Gluon
# layer hands the op statistics it reduced itself, the head's gradient
# is softmax - onehot against exp(log_softmax) - onehot, and cuDNN's
# weight gradients may sum in another order. The loss agrees to f32
# rounding; BatchNorm's backward (a difference of terms of the same
# size) amplifies the rounding of the activations into the gradients
# layer by layer. ``python -m mxtpu_torch.tools.module_tolerance`` (batch
# 16, 64², on the CPU) measures it: the Module's update parts from the
# Trainer's by 1.4e-2 (L2), a parameter's by at most 1.9e-2, a BatchNorm
# statistic's change by 5e-5, where the Trainer's own update moves by
# 2.1e-2 (3.0e-2 at most for a parameter, 8e-5 for a statistic) when its
# images are scaled by one f32 ulp: the rounding's reach, not a fault. A
# fault moves the update by its own size: an lr 10 % off by 0.10,
# SoftmaxOutput's batch normalization dropped by 15 (batch - 1). A conv
# bias that feeds a BatchNorm has no gradient in exact arithmetic (the
# normalization subtracts it): its rounding noise is left out. Momentum
# plays no part in a first step (its buffer starts at zero): only the
# CPU test tests/test_torch_module.py's trajectory against mxtpu holds
# it.
MODULE_LOSS_REL = 1e-5
MODULE_UPDATE_REL = 5e-2      # L2, the whole update
MODULE_PARAM_REL = 1e-1       # L2, each parameter's update
MODULE_BN_REL = 1e-3          # L2, each BatchNorm statistic's change
BUCKET_KEYS, BUCKET_BATCH = (20, 35), 32
BUCKET_VOCAB, BUCKET_EMBED, BUCKET_HIDDEN = 10000, 200, 200


def _same_bits(a, b):
    """Bit equality (NaN payloads too) of two float32 tensors."""
    import torch
    return a.dtype == b.dtype == torch.float32 and a.shape == b.shape \
        and torch.equal(a.view(torch.int32), b.view(torch.int32))


def symbol_module_phase():
    """18 in the docstring: the Symbol/Module frontend at ResNet-50
    width: export, SymbolBlock, a Module fine-tune step against the
    classic Trainer, the checkpoint round trip, a BucketingModule."""
    import torch
    import mxtpu_torch as mx
    from mxtpu_torch.tools.timing import time_ms
    reset_launches()
    out_dir = os.path.join(build_dir(), "symbol_module")
    os.makedirs(out_dir, exist_ok=True)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    images = mx.nd.NDArray(torch.randn((SYMBOL_BATCH, 3, 224, 224),
                                       generator=gen, device="cuda"))
    # (a) the zoo's ResNet-50, exported from the card
    mx.random.seed(SEED)
    net = mx.gluon.model_zoo.vision.get_model("resnet50_v1")
    net.initialize(mx.initializer.Xavier(magnitude=2), ctx=mx.gpu())
    want = net(images)._data              # eager: resolves the shapes
    prefix = os.path.join(out_dir, "resnet50_v1")
    t0 = time.perf_counter()
    net.export(prefix, epoch=0)
    export_s = time.perf_counter() - t0
    # (b) SymbolBlock.imports on the card: eager, then captured
    sb = mx.gluon.SymbolBlock.imports(prefix + "-symbol.json", ["data"],
                                      prefix + "-0000.params", ctx=mx.gpu())
    eager = sb(images)._data
    sb.hybridize()
    torch.cuda.reset_peak_memory_stats()
    sb(images)                            # the capture, then its replay
    replay = sb(images)._data
    torch.cuda.synchronize()
    top = float(want.abs().max())
    rels = [float((x - want).abs().max()) / top for x in (eager, replay)]
    sb_ms = time_ms(lambda: sb(images), reps=5, warmup=1)
    sb_row = {"batch": SYMBOL_BATCH, "export_s": export_s,
              "bit_equal": [bool(torch.equal(x, want))
                            for x in (eager, replay)],
              "rel_max": rels, "bound": SYMBOL_LOGITS_REL,
              "captures": sb.captures, "replay_ms": sb_ms,
              "img_per_s": SYMBOL_BATCH / (sb_ms / 1e3),
              "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
    del sb, eager, replay, want, images
    _release_gateway()
    module_row, ckpt = _module_fine_tune(mx, net, prefix, out_dir)
    del net
    _release_gateway()
    bucket_row = _bucketing_word_lm(mx)
    launches = read_launches()
    emit({"phase": "symbol_module", "card": nvidia_smi(),
          "config": "resnet50_v1", "symbol_block": sb_row,
          "module": module_row, "checkpoint": ckpt,
          "bucketing": bucket_row, "launches": launches})
    if not all(r <= SYMBOL_LOGITS_REL for r in rels):
        raise AssertionError(f"SymbolBlock logits off the Gluon net's: "
                             f"{sb_row}")
    if sb_row["captures"] != 1:
        raise AssertionError(f"the SymbolBlock captured {sb_row['captures']}"
                             " graphs, not one")
    if not (module_row["loss_rel"] <= MODULE_LOSS_REL
            and module_row["update_rel"] <= MODULE_UPDATE_REL
            and module_row["param_rel_max"] <= MODULE_PARAM_REL
            and module_row["bn_change_rel_max"] <= MODULE_BN_REL):
        raise AssertionError(f"the Module's first step is off the classic "
                             f"Trainer's: {module_row}")
    if not (math.isfinite(module_row["losses"][0])
            and module_row["score"][0][0] == "accuracy"
            and module_row["score_captures"] == 1):
        raise AssertionError(f"Module.fit or score failed: {module_row}")
    if not (ckpt["bit_equal"] and ckpt["json_equal"]):
        raise AssertionError(f"do_checkpoint did not round-trip: {ckpt}")
    if not (all(map(math.isfinite, bucket_row["losses"]))
            and bucket_row["buckets"] == sorted(BUCKET_KEYS)):
        raise AssertionError(f"the BucketingModule failed: {bucket_row}")
    if launches != only():
        raise AssertionError(f"symbol_module launched {launches}")
    shutil.rmtree(out_dir, ignore_errors=True)
    return launches


def _module_fine_tune(mx, net, prefix, out_dir):
    """(c) of ``symbol_module``: ``load_checkpoint`` of the export, a
    ``SoftmaxOutput`` head, ``Module.fit`` for MODULE_STEPS sgd steps
    over an ``NDArrayIter`` of seeded images with ``Speedometer`` and
    ``do_checkpoint``; its first step against the classic Trainer's on
    the same weights and batch; the checkpoint read back; ``score``."""
    import torch
    from mxtpu_torch.tools.module_tolerance import classic_step, compare
    n, steps = MODULE_BATCH, MODULE_STEPS
    rng = np.random.default_rng(SEED + 18)
    data = rng.standard_normal((n * steps, 3, 224, 224)).astype(np.float32)
    labels = rng.integers(0, 1000, n * steps).astype(np.float32)
    sym, args, auxs = mx.model.load_checkpoint(prefix, 0, ctx=mx.gpu())
    head = mx.sym.SoftmaxOutput(sym, name="softmax", normalization="batch")
    # the classic Trainer's first step on the same weights and batch
    x0 = mx.nd.array(data[:n], ctx=mx.gpu())
    y0 = mx.nd.array(labels[:n], ctx=mx.gpu())
    gluon_loss, gluon_delta = classic_step(mx, net, x0, y0, MODULE_LR,
                                           MODULE_MOMENTUM)
    del x0, y0
    _release_gateway()
    # the Module: fit over the iterator, the first step's state kept
    mod = mx.mod.Module(head, context=mx.gpu())
    it = mx.io.NDArrayIter(data, labels, batch_size=n, ctx=mx.gpu())
    ck_prefix = os.path.join(out_dir, "finetune")
    first, losses, stamps = {}, [], []

    def batch_end(param):
        prob = mod.get_outputs()[0]._data
        lab = param.locals["data_batch"].label[0]._data.long()
        losses.append(float(-prob.gather(1, lab[:, None]).log().mean()))
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())
        if param.nbatch == 0:
            for part in mod.get_params():
                first.update(part)
    torch.cuda.reset_peak_memory_stats()
    mod.bind(data_shapes=it.provide_data, label_shapes=it.provide_label)
    mod.init_params(arg_params=args, aux_params=auxs)
    torch.cuda.synchronize()
    stamps.append(time.perf_counter())
    mod.fit(it, optimizer="sgd", optimizer_params=(
        ("learning_rate", MODULE_LR), ("momentum", MODULE_MOMENTUM)),
        eval_metric="acc", num_epoch=1,
        batch_end_callback=[mx.callback.Speedometer(n, 1), batch_end],
        epoch_end_callback=mx.callback.do_checkpoint(ck_prefix))
    peak = torch.cuda.max_memory_allocated() / 1e9
    seconds = [b - a for a, b in zip(stamps, stamps[1:])]
    start = {**args, **auxs}
    dist = compare({k: first[k]._data - start[k]._data for k in gluon_delta},
                   gluon_delta, sym)
    score = mod.score(it, "acc")
    # do_checkpoint → load_checkpoint, bit for bit
    arg_now, aux_now = mod.get_params()
    sym2, arg2, aux2 = mx.model.load_checkpoint(ck_prefix, 1, ctx=mx.gpu())
    ckpt = {"json_equal": sym2.tojson() == head.tojson(),
            "bit_equal": all(_same_bits(a[k]._data, b[k]._data)
                             for a, b in ((arg_now, arg2), (aux_now, aux2))
                             for k in a) and set(arg_now) == set(arg2)
            and set(aux_now) == set(aux2),
            "arrays": len(arg2) + len(aux2)}
    row = {"batch": n, "steps": steps, "losses": losses,
           "gluon_first_loss": gluon_loss,
           "loss_rel": abs(losses[0] - gluon_loss) / abs(gluon_loss),
           "loss_bound": MODULE_LOSS_REL,
           **dist, "update_bound": MODULE_UPDATE_REL,
           "param_bound": MODULE_PARAM_REL, "bn_bound": MODULE_BN_REL,
           "step_seconds": seconds, "img_per_s": [n / t for t in seconds],
           "peak_gb": peak, "score": score,
           "score_captures": mod._exec.captures}
    del mod, it, first
    return row, ckpt


def _bucketing_word_lm(mx):
    """(d) of ``symbol_module``: a ``BucketingModule`` over two bucket
    lengths of an LSTM word LM (``example/rnn/bucketing``'s symbol at
    BUCKET_* widths: Embedding, fused LSTM with learned initial states,
    FC to the vocabulary at every step), one sgd step each."""
    import torch
    sym = mx.sym
    B, V, E, H = BUCKET_BATCH, BUCKET_VOCAB, BUCKET_EMBED, BUCKET_HIDDEN
    _, total = mx.nd.ops.rnn_param_layout("lstm", E, H, 1, False)

    def sym_gen(seq_len):
        emb = sym.Embedding(sym.var("data"), input_dim=V, output_dim=E,
                            name="embed")
        out = sym.RNN(sym.transpose(emb, axes=(1, 0, 2)),
                      sym.var("lstm_parameters", shape=(total,)),
                      sym.var("lstm_h0", shape=(1, B, H)),
                      state_cell=sym.var("lstm_c0", shape=(1, B, H)),
                      state_size=H, num_layers=1, mode="lstm", name="lstm")
        pred = sym.FullyConnected(sym.reshape(out, shape=(-1, H)),
                                  num_hidden=V, name="pred")
        label = sym.reshape(sym.transpose(sym.var("softmax_label")),
                            shape=(-1,))
        return sym.SoftmaxOutput(pred, label, name="softmax",
                                 normalization="batch"), ("data",), \
            ("softmax_label",)

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    mx.random.seed(SEED)
    mod = mx.mod.BucketingModule(sym_gen, default_bucket_key=BUCKET_KEYS[0],
                                 context=mx.gpu())
    mod.bind(data_shapes=[("data", (B, BUCKET_KEYS[0]))],
             label_shapes=[("softmax_label", (B, BUCKET_KEYS[0]))])
    mod.init_params(initializer=mx.initializer.Uniform(0.1))
    mod.init_optimizer(optimizer="sgd",
                       optimizer_params=(("learning_rate", 1.0),))
    losses, seconds = [], []
    for k in BUCKET_KEYS:
        seq = torch.randint(0, V, (B, k + 1), generator=gen, device="cuda")
        batch = mx.io.DataBatch(
            data=[mx.nd.NDArray(seq[:, :-1].float())],
            label=[mx.nd.NDArray(seq[:, 1:].float())], bucket_key=k,
            provide_data=[mx.io.DataDesc("data", (B, k))],
            provide_label=[mx.io.DataDesc("softmax_label", (B, k))])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mod.forward(batch, is_train=True)
        mod.backward()
        mod.update()
        prob = mod.get_outputs()[0]._data
        lab = seq[:, 1:].t().reshape(-1, 1)
        losses.append(float(-prob.gather(1, lab).log().mean()))
        seconds.append(time.perf_counter() - t0)
    return {"vocab": V, "embed": E, "hidden": H, "batch": B,
            "buckets": sorted(mod._buckets), "losses": losses,
            "ln_vocab": math.log(V), "step_seconds": seconds}


def split_vs_unsplit(x, w, y, y1):
    """The split kernel's ``y`` against the unsplit one's ``y1`` on the
    same inputs: the largest |y - y1| over its allowance, one bf16 ulp of
    the larger magnitude plus twice the f32 reordering bound
    9C·2^-23·Σ|x·w| (both add the same f32 products in another order;
    2^-23, not 2^-24, a term, since a tensor core's add may truncate).
    At most 1 when the leader added its partner's partial tile once."""
    import torch
    from mxtpu_torch.ops import conv
    a, b = y.float(), y1.float()
    mag = torch.maximum(a.abs(), b.abs())
    ulp = torch.where(mag > 0, torch.exp2(torch.floor(torch.log2(mag)) - 7),
                      torch.zeros_like(mag))
    reorder = 9 * x.shape[-1] * 2.0 ** -23 * conv.conv3x3_plain(
        x.float().abs(), w.float().abs())
    return ((a - b).abs() / (ulp + 2 * reorder + 1e-30)).max().item()


def kernel_conv_phase():
    """The conv3x3 kernel against its plain version at every conv
    shape, with times."""
    import torch
    from mxtpu_torch.ops import conv
    from mxtpu_torch.tools import resnet_shape_experiment as exp
    from mxtpu_torch.tools.timing import host_ms, median_ms, time_ms
    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    rows = []
    for name, *shape in CONV_SHAPES + CONV_EDGE_SHAPES:
        x, w = exp.conv_inputs(shape, gen)
        y = conv.conv3x3(x, w)
        again = conv.conv3x3(x, w)
        torch.cuda.synchronize()
        bound, bound_by = conv.conv_bound_ms(*shape)
        plan = conv._conv_plan(*shape)
        row = {"phase": "kernel_conv", "shape": name, "bhwco": shape,
               "bn": plan.bn, "split": plan.split,
               **exp.check_conv(x, w, y), "bit_equal": torch.equal(y, again),
               "bound_ms": bound, "bound_by": bound_by}
        row["ok"] = row["ok"] and row["bit_equal"]
        if plan.split > 1:
            row["split_vs_unsplit"] = split_vs_unsplit(
                x, w, y, conv._launch(x, w, plan._replace(split=1)))
            row["ok"] = row["ok"] and row["split_vs_unsplit"] <= 1
        if row["ok"] and (name, *shape) in CONV_SHAPES:
            flops = conv.conv_flops(*shape)
            row.update(
                kernel_ms=median_ms(lambda: conv.conv3x3(x, w), reps=20),
                library_ms=median_ms(exp.cudnn_conv3x3(x, w), reps=20),
                plain_ms=time_ms(lambda: conv.conv3x3_plain(x, w), reps=3,
                                 warmup=1),
                host_ms=host_ms(lambda: conv.conv3x3(x, w)))
            row.update(kernel_tflops=flops / row["kernel_ms"] / 1e9,
                       library_tflops=flops / row["library_ms"] / 1e9,
                       bound_share=bound / row["kernel_ms"])
        emit(row)
        if not row["ok"]:
            raise AssertionError(f"conv3x3 kernel disagrees with its plain "
                                 f"version, or with itself, at {name}: max "
                                 f"err {row['max_abs_err']}, bit equal "
                                 f"{row['bit_equal']}, split against "
                                 f"unsplit {row.get('split_vs_unsplit')}")
        rows.append(row)
    x, w = exp.conv_inputs(CONV_CHUNKED, gen)
    y = conv.conv3x3(x, w)
    torch.cuda.synchronize()
    b, h, wd, _, _ = CONV_CHUNKED
    lo = (1 << 30) // (h * wd) - 1
    row = {"phase": "kernel_conv", "shape": "chunked",
           "bhwco": list(CONV_CHUNKED), "images_checked": [lo, lo + 3],
           **exp.check_conv(x[lo:lo + 3], w, y[lo:lo + 3])}
    emit(row)
    del x, w, y
    torch.cuda.empty_cache()
    if not row["ok"]:
        raise AssertionError(f"conv3x3 kernel disagrees with its plain "
                             f"version across its launch boundary: max err "
                             f"{row['max_abs_err']}")
    return rows


def resnet_phase():
    """ResNet-50 at full width: eval forward with both stems and 3 train
    steps. Its convs are cuDNN's, so it launches none of the port's
    kernels."""
    import torch
    from mxtpu_torch.models import resnet
    from mxtpu_torch.parallel import optim, step as pstep
    from mxtpu_torch.parallel._tree import tree_leaves
    from mxtpu_torch.tools.timing import time_ms
    cfg = resnet.CONFIGS["resnet50"]
    n = RESNET_BATCH
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    params = resnet.init_params(cfg, gen, device="cuda")
    images = torch.randn((n, 224, 224, 3), generator=gen, device="cuda",
                         dtype=torch.bfloat16)
    labels = torch.randint(0, cfg.num_classes, (n,), generator=gen,
                           device="cuda")
    n_params = sum(p.numel() for p in tree_leaves(params))
    emit({"phase": "resnet_init", "config": "resnet50", "params": n_params,
          "batch": n, "image": [224, 224, 3], "stem": cfg.stem,
          "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32})
    reset_launches()

    # (a) eval forward, std and s2d stems
    s2d = replace(cfg, stem="s2d")
    out, times = {}, {}
    with torch.inference_mode():
        state = resnet.init_state(cfg, "cuda")
        for c in (cfg, s2d):
            out[c.stem] = resnet.forward(c, params, images, state)
            times[c.stem + "_forward_ms"] = time_ms(
                lambda: resnet.forward(c, params, images, state), reps=5,
                warmup=1)
            x = images.to(cfg.dtype)
            times[c.stem + "_stem_ms"] = time_ms(
                lambda: resnet._stem(c, x, params["stem_conv"]), reps=20)
    logits = out["std"]
    finite = bool(torch.isfinite(logits).all())
    rel = rel_dist(out["s2d"], logits)
    emit({"phase": "resnet_eval", "batch": n, "logits": list(logits.shape),
          "dtype": str(logits.dtype), "finite": finite,
          "img_per_s": {k.split("_")[0]: n / (v / 1e3)
                        for k, v in times.items() if k.endswith("forward_ms")},
          **times, "s2d_vs_std_rel": rel, "s2d_vs_std_bound": STEM_REL_BOUND,
          "argmax_agree": (out["s2d"].argmax(-1) == logits.argmax(-1))
          .float().mean().item()})
    if not (finite and logits.dtype == torch.float32
            and tuple(logits.shape) == (n, cfg.num_classes)):
        raise AssertionError("ResNet-50 eval logits are not finite f32 "
                             f"({n}, {cfg.num_classes})")
    if not rel <= STEM_REL_BOUND:
        raise AssertionError(f"s2d vs std logits {rel} > {STEM_REL_BOUND}")
    del out, logits

    # (b) the training step
    tx = optim.sgd(0.1, momentum=0.9)
    tstate = pstep.init_state(params, tx,
                              model_state=resnet.init_state(cfg, "cuda"))
    del params
    step = pstep.make_train_step(resnet.loss_fn(cfg), tx, has_state=True)
    batch = {"image": images, "label": labels}
    torch.cuda.reset_peak_memory_stats()
    losses, seconds = [], []
    for _ in range(RESNET_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tstate, loss = step(tstate, batch)
        losses.append(loss.item())
        seconds.append(time.perf_counter() - t0)
    means = [v for k, v in _leaves_with_keys(tstate.model_state)
             if k == "mean"]
    moved = sum(bool((m != 0).any()) for m in means)
    emit({"phase": "resnet_train", "batch": n, "steps": RESNET_STEPS,
          "losses": losses, "ln_classes": math.log(cfg.num_classes),
          "step_seconds": seconds, "img_per_s": [n / t for t in seconds],
          "bn_means_moved": moved, "bn_layers": len(means),
          "step": int(tstate.step),
          "peak_gb": torch.cuda.max_memory_allocated() / 1e9})
    if not all(map(math.isfinite, losses)):
        raise AssertionError(f"non-finite ResNet-50 loss: {losses}")
    if abs(losses[0] - math.log(cfg.num_classes)) > 1.0:
        raise AssertionError(f"first loss {losses[0]} is not within 1.0 of "
                             f"ln {cfg.num_classes}")
    if moved != len(means) or int(tstate.step) != RESNET_STEPS:
        raise AssertionError(f"{len(means) - moved} BN running means did "
                             f"not move; step {int(tstate.step)}")
    launches = read_launches()
    emit({"phase": "resnet_launches", "launches": launches})
    if any(launches.values()):
        raise AssertionError(f"the ResNet path launched {launches}, not "
                             f"none of the port's kernels")
    del tstate, step, batch, images
    torch.cuda.empty_cache()
    return launches


def experiment_probe2_phase():
    """The shape experiment's probe 2 (``probe_conv``), untimed: one
    launch of the conv3x3 kernel at the experiment's shape, checked
    against the plain version."""
    from mxtpu_torch.tools import resnet_shape_experiment as exp
    reset_launches()
    row = exp.probe_conv(reps=0)
    launches = read_launches()
    emit({"phase": "experiment_probe2", **row, "launches": launches})
    want = only(conv3x3_kernel=1)
    if launches != want:
        raise AssertionError(f"probe 2 launched {launches}, not {want}")
    return launches


def rtc_inputs(gen, kernel, shape, offset):
    """Two seeded inputs of ``shape`` as NDArrays over views that start
    ``offset`` elements into their storage (f32 for scale_add, bf16 with
    values up to about ±12 for swiglu)."""
    import torch
    import mxtpu_torch as mx
    n = math.prod(shape)
    dt = torch.float32 if kernel == "scale_add" else torch.bfloat16
    scale = 1.0 if kernel == "scale_add" else 3.0

    def one():
        t = torch.randn(n + offset, generator=gen, device="cuda") * scale
        return mx.nd.NDArray(t.to(dt)[offset:].view(shape))
    return one(), one()


def kernel_rtc_phase():
    """The rtc kernels against their plain versions at every RTC shape,
    with times at the main shapes."""
    import torch
    import mxtpu_torch as mx
    from mxtpu_torch import rtc
    from mxtpu_torch.tools import rtc_kernels as rk
    from mxtpu_torch.tools.timing import host_ms, median_ms
    mod = rk.module()
    kerns = {k: mod.get_kernel(k) for k in rk.KERNELS}
    plain = {"scale_add": rk.scale_add_plain, "swiglu": rk.swiglu_plain}
    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    rows = []
    for kernel, name, shape, offset in RTC_SHAPES:
        a, b = rtc_inputs(gen, kernel, shape, offset)
        blocks = rk.grid(kernel, math.prod(shape))
        outs = (kerns[kernel].launch(a, b),        # the default grid
                kerns[kernel].launch(a, b, grid=blocks))
        torch.cuda.synchronize()
        want = plain[kernel](a._data, b._data)
        err = max((o._data.float() - want.float()).abs().max().item()
                  for o in outs)
        ok = all(tuple(o.shape) == shape and o.dtype == want.dtype
                 and (torch.equal(o._data, want) if kernel == "scale_add"
                      else torch.allclose(o._data.float(), want.float(),
                                          atol=RTC_TOL, rtol=RTC_TOL))
                 for o in outs)
        row = {"phase": "kernel_rtc", "kernel": kernel, "shape": name,
               "dims": list(shape), "misaligned": bool(offset),
               "grid": blocks, "max_abs_err": err,
               "tol": "exact" if kernel == "scale_add" else RTC_TOL,
               "ok": ok}
        if name in ("main", "llama3_8b_ffn"):
            bound, bound_by = rk.rtc_bound_ms(kernel, math.prod(shape))
            x, y = a._data, b._data
            launch = functools.partial(kerns[kernel].launch, a, b,
                                       grid=blocks)
            row.update(
                ms=median_ms(launch, reps=20),
                default_grid_ms=median_ms(lambda: kerns[kernel].launch(a, b),
                                          reps=20),
                plain_ms=median_ms(lambda: plain[kernel](x, y), reps=20),
                library_ms=(median_ms(lambda: rk.scale_add_library(x, y),
                                      reps=20)
                            if kernel == "scale_add" else None),
                host_ms=host_ms(launch),
                bound_ms=bound, bound_by=bound_by)
            row["bound_share"] = bound / row["ms"]
        emit(row)
        if not (ok and math.isfinite(err)):
            raise AssertionError(f"rtc {kernel} disagrees with its plain "
                                 f"version at {name}: max err {err}")
        rows.append(row)
    before = dict(rtc.launches)
    e = mx.nd.NDArray(torch.empty((0, 4), device="cuda"))
    empty = kerns["scale_add"].launch(e, e)
    info = mod.build_info
    emit({"phase": "rtc_build", "built": info["built"],
          "seconds": info["seconds"], "path": info["path"],
          "ptxas": [ln.strip() for ln in str(info["nvcc"]).splitlines()
                    if any(w in ln for w in ("entry function", "registers",
                                             "spill"))],
          "empty_launch_shape": list(empty.shape)})
    if empty.shape != (0, 4) or dict(rtc.launches) != before:
        raise AssertionError("an empty rtc launch did not return an empty "
                             "array without launching")
    return rows


def rtc_kernel_rows(rows, launches):
    """The ``kernels`` line's rows of the rtc kernels: errors over every
    shape, times at the main one, launches of the main path."""
    out = []
    for kernel, main in (("scale_add", "main"), ("swiglu", "llama3_8b_ffn")):
        row = rows[kernel, main]
        out.append({
            "name": f"rtc_{kernel}", "route": "cuda",
            "source": "mxtpu_torch/tools/rtc_kernels.py",
            "replaces": "mxtpu/rtc.py:80",
            "launches": launches[f"rtc_{kernel}"],
            "max_abs_err": max(r["max_abs_err"] for (k, _), r in rows.items()
                               if k == kernel),
            **{f: row[f] for f in ("ms", "plain_ms", "bound_ms", "bound_by",
                                   "library_ms")}})
    return out


def frontend_phase():
    """llama3_8b's FFN through mx.nd, mx.rtc and mx.autograd."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    import mxtpu_torch as mx
    from mxtpu_torch import autograd as ag, rtc
    from mxtpu_torch.models import llama
    from mxtpu_torch.tools import rtc_kernels as rk
    cfg = llama.CONFIGS["llama3_8b"]
    dim, hidden, n = cfg.dim, cfg.hidden_dim, FFN_TOKENS
    gen = torch.Generator(device="cuda").manual_seed(SEED + 4)

    def rand(*shape, scale=1.0):
        t = torch.randn(shape, generator=gen, device="cuda") * scale
        return mx.nd.array(t.to(torch.bfloat16), ctx=mx.gpu())
    x = rand(n, dim)
    wg, wu = rand(dim, hidden, scale=dim ** -0.5), rand(dim, hidden,
                                                       scale=dim ** -0.5)
    wd = rand(hidden, dim, scale=hidden ** -0.5)
    head = rand(n, dim)
    rs = np.random.default_rng(SEED)
    small = np.arange(256, dtype=np.float32).reshape(2, 128)
    big_x, big_y = (rs.standard_normal((8192, 4096), dtype=np.float32)
                    for _ in range(2))
    mod = rk.module()
    sa, sw = mod.get_kernel("scale_add"), mod.get_kernel("swiglu")
    torch.cuda.synchronize()

    # (a0) + (a): the launch counts cover exactly these
    reset_launches()
    t0 = time.perf_counter()
    s = mx.nd.array(small, ctx=mx.gpu())
    tripled = sa.launch(s, s).asnumpy()
    big = sa.launch(mx.nd.array(big_x, ctx=mx.gpu()),
                    mx.nd.array(big_y, ctx=mx.gpu())).asnumpy()
    a0_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    blocks = rk.grid("swiglu", n * hidden)
    y = sw.launch(x @ wg, x @ wu, grid=blocks) @ wd
    y.wait_to_read()
    fwd_s = [time.perf_counter() - t0]
    launches = read_launches()
    for _ in range(2):
        t0 = time.perf_counter()
        (sw.launch(x @ wg, x @ wu, grid=blocks) @ wd).wait_to_read()
        fwd_s.append(time.perf_counter() - t0)
    lp = {"w_gate": wg._data, "w_up": wu._data, "w_down": wd._data}
    ref = llama._ffn(cfg, lp, x._data)[0]
    rel = rel_dist(y._data, ref)
    finite = bool(torch.isfinite(y._data).all())
    exact = (np.array_equal(tripled, 3 * small)
             and np.array_equal(big, big_x * 2 + big_y))
    emit({"phase": "frontend_forward", "tokens": n, "dim": dim,
          "hidden": hidden, "dtype": str(y.dtype), "shape": list(y.shape),
          "finite": finite, "scale_add_exact": exact, "a0_seconds": a0_s,
          "seconds": fwd_s, "rel_vs_llama_ffn": rel,
          "rel_bound": FFN_REL_BOUND, "launches": launches})
    if not (finite and y.shape == (n, dim) and y.dtype == torch.bfloat16):
        raise AssertionError("the rtc FFN output is not finite bf16 "
                             f"({n}, {dim})")
    if not exact:
        raise AssertionError("scale_add on mx.nd arrays is not x*2 + y")
    if not rel <= FFN_REL_BOUND:
        raise AssertionError(f"rtc FFN vs llama._ffn {rel} > "
                             f"{FFN_REL_BOUND}")
    if launches != only(rtc_scale_add=2, rtc_swiglu=1):
        raise AssertionError(f"the forward launched {launches}, not 2 "
                             f"scale_add and 1 swiglu")
    del y, ref

    # (b) an imperative training step with torch_kernel(silu)
    silu = rtc.torch_kernel(F.silu, name="silu")
    for w in (x, wg, wu, wd):
        w.attach_grad()
    step_s, step_launches = [], []
    torch.cuda.reset_peak_memory_stats()
    for _ in range(2):
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with ag.record():
            out = (silu(x @ wg) * (x @ wu)) @ wd
        out.backward(head)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        step_launches.append(read_launches())
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    leaves = [w._data.detach().requires_grad_() for w in (x, wg, wu, wd)]
    tx, tg, tu, td = leaves
    want = torch.autograd.grad((F.silu(tx @ tg) * (tx @ tu)) @ td, leaves,
                               head._data)
    rels = {k: rel_dist(w.grad._data, g) for k, w, g in
            zip(("x", "w_gate", "w_up", "w_down"), (x, wg, wu, wd), want)}
    emit({"phase": "frontend_train_step", "step_seconds": step_s,
          "peak_gb": peak_gb, "grad_rel_vs_torch": rels,
          "rel_bound": FFN_GRAD_REL_BOUND, "launches": step_launches})
    if not all(math.isfinite(r) and r <= FFN_GRAD_REL_BOUND
               for r in rels.values()):
        raise AssertionError(f"tape grads vs torch.autograd {rels} > "
                             f"{FFN_GRAD_REL_BOUND}")
    if any(c != only() for c in step_launches):
        raise AssertionError(f"the train step launched {step_launches}")

    # (c) no rtc kernel under record() on arrays on the tape
    before = read_launches()
    with ag.record():
        g, u = x @ wg, x @ wu
        try:
            sw.launch(g, u, grid=blocks)
            refused = None
        except mx.MXNetError as e:
            refused = str(e)
    emit({"phase": "frontend_no_grad_rule", "raised": refused})
    if refused is None or "no gradient" not in refused \
            or read_launches() != before:
        raise AssertionError(f"a recorded rtc launch did not raise: "
                             f"{refused}")
    del x, wg, wu, wd, head, out, g, u, leaves, want
    torch.cuda.empty_cache()
    return launches


# nd_random: llama3_8b's FFN weight shape, the gamma/poisson size and
# parameters, the multinomial table, the shuffle length
RANDOM_SHAPE = (14336, 4096)
RANDOM_CHECK = 2 ** 16        # elements held against the CPU per draw
RANDOM_LOOP_N = 2 ** 20
GAMMA_ALPHAS = (0.3, 1.0, 5.0)
POISSON_LAMS = (0.0, 0.5, 4.0, 9.99, 10.0, 40.0, 1000.0)
RANDINT_HIGH = 128256
BERNOULLI_P = 0.3
MULTINOMIAL_TABLE = (32, 128256)
MULTINOMIAL_DRAWS = 4
SHUFFLE_N = 3_000_000
STAT_SE = 6                   # sample moments within 6 standard errors
NEAR_TIE_ULPS = 4


def _f32_ulps(got, want):
    import torch
    return (got.view(torch.int32).long()
            - want.view(torch.int32).long()).abs()


def _moments_ok(x, mean, var, mu4):
    """Sample mean and variance of ``x`` (on the card, in f64) against
    the distribution's mean, variance and fourth central moment: each
    within STAT_SE standard errors (sqrt(var/n), sqrt((mu4 - var^2)/n))."""
    x = x.double().reshape(-1)
    n = x.numel()
    m, v = x.mean().item(), x.var(unbiased=False).item()
    se_m = math.sqrt(var / n)
    se_v = math.sqrt(max(mu4 - var * var, 0.0) / n)
    z_m = abs(m - mean) / se_m if se_m else (0.0 if m == mean else math.inf)
    z_v = abs(v - var) / se_v if se_v else (0.0 if v == var else math.inf)
    return {"mean": m, "var": v, "want_mean": mean, "want_var": var,
            "z_mean": z_m, "z_var": z_v,
            "ok": z_m <= STAT_SE and z_v <= STAT_SE}


def _random_draws(mx, ctx, big, loop_n, probs):
    """The phase's draws in order through ``mx.nd.random`` on ``ctx``:
    uniform, normal, randint, exponential and bernoulli at ``big``;
    gamma per alpha and poisson per lam at ``loop_n`` and then at
    RANDOM_CHECK; multinomial of ``probs``; shuffle of
    arange(SHUFFLE_N). The key chain advances once a draw, so the CPU
    replays it at small shapes and meets the card's keys."""
    r = mx.nd.random
    out = {"uniform": r.uniform(shape=big, ctx=ctx),
           "normal": r.normal(shape=big, ctx=ctx),
           "randint": r.randint(0, RANDINT_HIGH, shape=big, ctx=ctx),
           "exponential": r.exponential(shape=big, ctx=ctx),
           "bernoulli": r.bernoulli(BERNOULLI_P, shape=big, ctx=ctx)}
    for a in GAMMA_ALPHAS:
        out[f"gamma_{a}"] = r.gamma(a, shape=(loop_n,), ctx=ctx)
        out[f"gamma_{a}_check"] = r.gamma(a, shape=(RANDOM_CHECK,), ctx=ctx)
    for lam in POISSON_LAMS:
        out[f"poisson_{lam}"] = r.poisson(lam, shape=(loop_n,), ctx=ctx)
        out[f"poisson_{lam}_check"] = r.poisson(lam, shape=(RANDOM_CHECK,),
                                                ctx=ctx)
    out["multinomial"], out["multinomial_logp"] = r.multinomial(
        probs, shape=MULTINOMIAL_DRAWS, get_prob=True)
    out["shuffle"] = r.shuffle(mx.nd.arange(SHUFFLE_N, ctx=ctx,
                                            dtype="int64"))
    return {k: v._data for k, v in out.items()}


def _random_stats(draws, probs):
    """(b) for every draw: moments against the distribution's, and the
    shuffle a permutation."""
    import torch
    n_hi = RANDINT_HIGH
    p = BERNOULLI_P
    stats = {
        "uniform": _moments_ok(draws["uniform"], 0.5, 1 / 12, 1 / 80),
        "normal": _moments_ok(draws["normal"], 0.0, 1.0, 3.0),
        "randint": _moments_ok(draws["randint"], (n_hi - 1) / 2,
                               (n_hi ** 2 - 1) / 12,
                               (n_hi ** 2 - 1) * (3 * n_hi ** 2 - 7) / 240),
        "exponential": _moments_ok(draws["exponential"], 1.0, 1.0, 9.0),
        "bernoulli": _moments_ok(draws["bernoulli"], p, p * (1 - p),
                                 p * (1 - p) * (1 - 3 * p + 3 * p * p))}
    for a in GAMMA_ALPHAS:
        stats[f"gamma_{a}"] = _moments_ok(draws[f"gamma_{a}"], a, a,
                                          3 * a * a + 6 * a)
    for lam in POISSON_LAMS:
        stats[f"poisson_{lam}"] = _moments_ok(draws[f"poisson_{lam}"], lam,
                                              lam, lam * (1 + 3 * lam))
    # multinomial: the drawn indices against each row's own distribution
    pr = probs._data.double()
    idx = torch.arange(pr.shape[-1], device=pr.device, dtype=torch.float64)
    e = (pr * idx).sum(-1, keepdim=True)
    var = (pr * (idx - e) ** 2).sum(-1)
    mu4 = (pr * (idx - e) ** 4).sum(-1)
    res = draws["multinomial"].double() - e
    stats["multinomial"] = _moments_ok(
        res / var.sqrt()[:, None], 0.0, 1.0,
        (mu4 / var ** 2).mean().item())
    sh = draws["shuffle"]
    stats["shuffle"] = {"ok": bool(torch.equal(
        torch.sort(sh).values, torch.arange(SHUFFLE_N, device=sh.device)))}
    return stats


def _random_vs_cpu(card, cpu, order):
    """(a) the card's first RANDOM_CHECK elements against the CPU's
    (``order``: the draws' names in the order they took their keys)."""
    import torch
    from mxtpu_torch import prng
    out = {}
    for name in ("uniform", "randint", "bernoulli"):
        got = card[name].reshape(-1)[:RANDOM_CHECK].cpu()
        out[name] = {"equal": bool(torch.equal(got, cpu[name]))}
    for name, bound in (("normal", 2), ("exponential", 1)):
        u = _f32_ulps(card[name].reshape(-1)[:RANDOM_CHECK].cpu(), cpu[name])
        out[name] = {"max_ulps": u.max().item(), "bound_ulps": bound,
                     "bit_equal_share": (u == 0).double().mean().item(),
                     "ok": u.max().item() <= bound}
    # gamma and poisson at RANDOM_CHECK on both sides; an element that
    # parts must sit at a near-tie of its accept tests (the CPU's margin)
    for name in [f"gamma_{a}" for a in GAMMA_ALPHAS] + \
            [f"poisson_{lam}" for lam in POISSON_LAMS]:
        got, want = card[name + "_check"].cpu(), cpu[name + "_check"]
        dist, par = name.split("_")
        draw = prng.gamma if dist == "gamma" else prng.poisson
        _, margin = draw(_chain_key(order, name + "_check"), float(par),
                         (RANDOM_CHECK,), margins=True)
        far = (_f32_ulps(got, want) > 2) if dist == "gamma" else got != want
        out[name] = {"parted": int(far.sum()),
                     "margins": margin[far].tolist()[:8],
                     "ok": bool((margin[far] <= NEAR_TIE_ULPS).all())}
    for name in ("multinomial", "multinomial_logp"):
        out[name] = {"equal": bool(torch.equal(card[name].cpu(),
                                               cpu[name]))}
    out["shuffle"] = {"equal": bool(torch.equal(
        card["shuffle"][:RANDOM_CHECK].cpu(), cpu["shuffle"][:RANDOM_CHECK]))}
    for r in out.values():
        r.setdefault("ok", r.get("equal", False))
    return out


def _chain_key(order, name):
    """The subkey the draw ``name`` took after seed(SEED)."""
    from mxtpu_torch import prng
    key = prng.PRNGKey(SEED, "cpu") # noqa: MXL301 — a check's seeded chain root, compared with the engine's
    for n in order:
        key, sub = prng.split(key) # noqa: MXL301 — a check's seeded chain root, compared with the engine's
        if n == name:
            return sub
    raise KeyError(name)


def nd_random_phase():
    """mx.random on the card at the sizes users draw, each draw (a)
    against the port on the CPU for the same seed, (b) its moments
    against the distribution's, (c) timed."""
    import torch
    import mxtpu_torch as mx
    from mxtpu_torch.tools.timing import host_ms, time_ms
    gen = torch.Generator(device="cuda").manual_seed(SEED + 5)
    probs = torch.softmax(torch.randn(MULTINOMIAL_TABLE, generator=gen,
                                      device="cuda") * 2, dim=-1)
    probs_c = mx.nd.array(probs, ctx=mx.gpu())
    probs_h = mx.nd.array(probs, ctx="cpu")
    torch.cuda.synchronize()
    reset_launches()
    mx.random.seed(SEED)
    t0 = time.perf_counter()
    card = _random_draws(mx, mx.gpu(), RANDOM_SHAPE, RANDOM_LOOP_N, probs_c)
    torch.cuda.synchronize()
    draw_s = time.perf_counter() - t0
    launches = read_launches()
    mx.random.seed(SEED)
    cpu = _random_draws(mx, "cpu", (RANDOM_CHECK,), 1, probs_h)
    stats = _random_stats(card, probs_c)
    vs_cpu = _random_vs_cpu(card, cpu, [k for k in card
                                        if k != "multinomial_logp"])
    del card
    torch.cuda.empty_cache()

    # (c) each draw at its size, device ms (queued window) and host ms
    r = mx.nd.random
    big, gpu = RANDOM_SHAPE, mx.gpu()
    calls = {"uniform": lambda: r.uniform(shape=big, ctx=gpu),
             "normal": lambda: r.normal(shape=big, ctx=gpu),
             "randint": lambda: r.randint(0, RANDINT_HIGH, shape=big,
                                          ctx=gpu),
             "exponential": lambda: r.exponential(shape=big, ctx=gpu),
             "bernoulli": lambda: r.bernoulli(BERNOULLI_P, shape=big,
                                              ctx=gpu),
             "gamma_1.0": lambda: r.gamma(1.0, shape=(RANDOM_LOOP_N,),
                                          ctx=gpu),
             "poisson_4.0": lambda: r.poisson(4.0, shape=(RANDOM_LOOP_N,),
                                              ctx=gpu),
             "poisson_1000.0": lambda: r.poisson(1000.0,
                                                 shape=(RANDOM_LOOP_N,),
                                                 ctx=gpu),
             "multinomial": lambda: r.multinomial(probs_c,
                                                  shape=MULTINOMIAL_DRAWS),
             "shuffle": lambda: r.shuffle(mx.nd.arange(
                 SHUFFLE_N, ctx=gpu, dtype="int64")),
             "torch_randn": lambda: torch.randn(big, device="cuda")}
    times = {name: {"ms": time_ms(f, 3, warmup=1), "host_ms": host_ms(f, 3)}
             for name, f in calls.items()}
    bad = [k for k, v in stats.items() if not v["ok"]] + \
        [k for k, v in vs_cpu.items() if not v["ok"]]
    emit({"phase": "nd_random", "shape": list(RANDOM_SHAPE),
          "loop_n": RANDOM_LOOP_N, "check_n": RANDOM_CHECK,
          "first_pass_seconds": draw_s, "stats": stats, "vs_cpu": vs_cpu,
          "times": times, "launches": launches,
          "nvidia_smi": nvidia_smi()})
    if bad:
        raise AssertionError(f"nd_random: {bad} failed their checks")
    if launches != only():
        raise AssertionError(f"nd_random launched {launches}")
    return launches


def serde_phase():
    """One llama3_8b layer's bf16 weights saved from the card and loaded
    back (float32, bit for bit once cast back to bf16), the file against
    a save of the same arrays from the CPU (byte for byte), and the
    round-5 artifact loaded on the card."""
    import os
    import tempfile
    import torch
    import mxtpu_torch as mx
    from mxtpu_torch.models import llama
    cfg = llama.CONFIGS["llama3_8b"]
    d, h, kv = cfg.dim, cfg.hidden_dim, cfg.n_kv_heads * cfg.head_dim
    shapes = {"wq": (d, d), "wk": (d, kv), "wv": (d, kv), "wo": (d, d),
              "w_gate": (d, h), "w_up": (d, h), "w_down": (h, d),
              "attn_norm": (d,), "ffn_norm": (d,)}
    gen = torch.Generator(device="cuda").manual_seed(SEED + 6)
    layer = {k: mx.nd.array(torch.randn(s, generator=gen, device="cuda")
                            .to(torch.bfloat16), ctx=mx.gpu())
             for k, s in shapes.items()}
    n_params = sum(math.prod(s) for s in shapes.values())
    nbytes = 2 * n_params
    torch.cuda.synchronize()
    reset_launches()
    with tempfile.TemporaryDirectory() as tmp:
        path, path_h = (os.path.join(tmp, f) for f in ("card.params",
                                                       "cpu.params"))
        t0 = time.perf_counter()
        mx.nd.save(path, layer)
        save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        back = mx.nd.load(path, ctx=mx.gpu())
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        launches = read_launches()
        # load makes float entries float32, as the reference's does;
        # bf16 -> f32 -> bf16 is exact, so the bits must come back
        equal = sorted(back) == sorted(layer) and all(
            back[k].dtype == torch.float32 and torch.equal(
                back[k]._data.to(torch.bfloat16).view(torch.int16),
                layer[k]._data.view(torch.int16)) for k in layer)
        mx.nd.save(path_h, {k: mx.nd.array(v, ctx="cpu")
                            for k, v in layer.items()})
        size = os.path.getsize(path)
        with open(path, "rb") as f1, open(path_h, "rb") as f2:
            same_bytes = f1.read() == f2.read()
    r5 = mx.nd.load(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                 "tests", "artifacts", "r5", "arrays.bin"),
                    ctx=mx.gpu())
    r5_ok = (r5["w"].dtype == torch.float32 and r5["idx"].dtype == torch.int32
             and r5["w"].context.type == "cuda"
             and np.array_equal(r5["w"].asnumpy(),
                                np.arange(12, dtype=np.float32).reshape(3, 4))
             and np.array_equal(r5["idx"].asnumpy(),
                                np.arange(5, dtype=np.int32)))
    emit({"phase": "serde", "arrays": len(layer), "params": n_params,
          "file_bytes": size, "save_seconds": save_s,
          "save_gb_per_s": nbytes / save_s / 1e9, "load_seconds": load_s,
          "load_gb_per_s": nbytes / load_s / 1e9, "round_trip_equal": equal,
          "bytes_equal_cpu_save": same_bytes, "r5_loads": r5_ok,
          "launches": launches, "nvidia_smi": nvidia_smi()})
    if not (equal and same_bytes and r5_ok):
        raise AssertionError(f"serde: round trip {equal}, bytes equal to "
                             f"the CPU's {same_bytes}, r5 {r5_ok}")
    if launches != only():
        raise AssertionError(f"serde launched {launches}")
    del layer, back
    torch.cuda.empty_cache()
    return launches


# mixtral: Mistral AI's Mixtral-8x7B widths (CONFIGS["mixtral_8x7b"]) at
# MIXTRAL_LAYERS of its 32 layers in bf16 for serving, and one layer in
# the reference's training dtypes. The bounds come from bf16 on the CPU
# at 2-8 layers of a narrow Mixtral (python -m
# mxtpu_torch.tools.moe_tolerance): a route that flips at a near-tie of
# its router takes other experts, so the global distance follows the few
# flipped tokens (clean 0.04-0.14) and the per-token median the rest
# (clean 0.007-0.021); a lost expert reaches 0.26-0.57 globally and a
# median of 0.46 and more from 4 layers, unrenormalised gates 0.54 and
# more in both. At one layer the flash and dense grads part by
# 0.009-0.093 at capacity E/K and up to 0.27 at 1.25, where a flipped
# route also moves the slots of later tokens; planted backward faults
# reach 0.55 and more (python -m mxtpu_torch.tools.bwd_tolerance --train).
MIXTRAL_LAYERS = 4
MOE_REL_BOUND = 0.3        # ||a - b|| / ||b||, flash/dense, routed/mixture
MOE_TOKEN_P50_BOUND = 0.05  # the per-token median of the same distances
MOE_TRAIN_REL_BOUND = 0.25  # flash vs dense loss and grads, 1 layer, no drops
MIXTRAL_CHUNK_PROMPT = 4000
MIXTRAL_TRAIN_LAYERS = 1
MOE_AUX_LOSS = 0.01        # moe_aux_weight × aux at uniform routing
# bert: bench.py's bench_bert at BERT-base's widths; bf16 against f32
# compute on the CPU at 2-8 layers of a narrow BERT 0.0057-0.0096, the
# position embeddings lost 0.57 and more; an erf GELU or a dropped mask
# stay at the clean distance at random init (the CPU parity tests hold
# them at 1e-5)
BERT_BATCH, BERT_SEQ, BERT_MLM, BERT_PAD = 128, 128, 20, 32
BERT_REL_BOUND = 3e-2      # ||bf16 - f32 compute|| / ||f32||, seq_out
BERT_STEPS, BERT_LR = 3, 1e-4


def _moe_checked(name, rel, tq):
    if not (math.isfinite(rel) and rel <= MOE_REL_BOUND
            and tq["p50"] <= MOE_TOKEN_P50_BOUND):
        raise AssertionError(f"{name}: {rel} > {MOE_REL_BOUND} or a "
                             f"per-token median {tq['p50']} > "
                             f"{MOE_TOKEN_P50_BOUND}")


def mixtral_phase():
    """Mixtral-8x7B at full width and MIXTRAL_LAYERS layers in bf16:
    (a) forward, its drops, flash vs dense and routed vs mixture; (b)
    greedy generate and chunked prefill; (c) the dense, reversed and
    paged engines; then (d) one layer trained."""
    import torch
    from mxtpu_torch.models import llama
    from mxtpu_torch.parallel import moe
    from mxtpu_torch.tools import moe_tolerance as mt
    cfg = replace(llama.CONFIGS["mixtral_8x7b"], n_layers=MIXTRAL_LAYERS,
                  param_dtype=torch.bfloat16)
    E, K = cfg.moe_experts, cfg.moe_top_k
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    t0 = time.perf_counter()
    params = llama.init_params(cfg, gen, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(p.numel() for _, p in _leaves_with_keys(params))
    emit({"phase": "mixtral_init", "config": "mixtral_8x7b",
          "n_layers": cfg.n_layers, "params": n_params,
          "param_dtype": "bfloat16", "gb": 2 * n_params / 1e9,
          "experts": E, "top_k": K, "seconds": time.perf_counter() - t0,
          "nvidia_smi": nvidia_smi()})
    with torch.inference_mode():
        tokens = torch.randint(0, cfg.vocab_size, (1, 2048), generator=gen,
                               device="cuda")
        torch.cuda.reset_peak_memory_stats()
        fwd_s = []
        for _ in range(2):             # the second with cuBLAS warm
            reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits = llama.forward(cfg, params, tokens)
            torch.cuda.synchronize()
            fwd_s.append(time.perf_counter() - t0)
            launches = read_launches()
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        finite = bool(torch.isfinite(logits).all())
        drops = mt.dropped_by_layer(cfg, params, tokens)
        del logits
        nodrop = replace(cfg, moe_capacity=E / K)
        routes = {"flash": [], "dense": []}
        found = {}
        for impl in ("flash", "dense"):
            with mt.patched(llama, moe_ffn=mt.recording_routes(
                    moe.moe_ffn, routes[impl])):
                found[impl] = llama.forward(
                    replace(nodrop, attn_impl=impl), params, tokens)
        rel_fd = rel_dist(found["flash"], found["dense"])
        tq_fd = mt.token_rel(found["flash"], found["dense"])
        del found
        routed = llama.forward_hidden(nodrop, params, tokens)
        with mt.patched(llama, moe_ffn=mt._mixture):
            mixture = llama.forward_hidden(nodrop, params, tokens)
        rel_rm = rel_dist(routed, mixture)
        tq_rm = mt.token_rel(routed, mixture)
        del routed, mixture
        emit({"phase": "mixtral_forward", "tokens": [1, 2048],
              "logits": [1, 2048, cfg.vocab_size], "finite": finite,
              "seconds": fwd_s, "tok_per_s": [2048 / t for t in fwd_s],
              "peak_gb": peak_gb, "launches": launches,
              "capacity": cfg.moe_capacity,
              "capacity_slots": math.ceil(2048 * K / E * cfg.moe_capacity),
              "dropped_by_layer": drops, "choices": 2048 * K,
              "flash_vs_dense": {"rel": rel_fd, "token_rel": tq_fd,
                                 "routes_changed": mt.routes_changed(
                                     routes["flash"], routes["dense"])},
              "routed_vs_mixture": {"rel": rel_rm, "token_rel": tq_rm},
              "rel_bound": MOE_REL_BOUND,
              "token_p50_bound": MOE_TOKEN_P50_BOUND,
              "nvidia_smi": nvidia_smi()})
        if not finite:
            raise AssertionError("mixtral forward logits are not finite")
        if launches != only(flash_attention_fwd=cfg.n_layers):
            raise AssertionError(f"mixtral forward launched {launches}, not "
                                 f"{cfg.n_layers} forward kernels")
        _moe_checked("mixtral flash vs dense logits", rel_fd, tq_fd)
        _moe_checked("mixtral routed vs mixture", rel_rm, tq_rm)
        torch.cuda.empty_cache()

        # (b) greedy generate twice, chunked prefill against one shot
        prompts = torch.randint(0, cfg.vocab_size, (4, 128), generator=gen,
                                device="cuda")
        reset_launches()
        runs = []
        for _ in range(2):
            torch.cuda.synchronize()  # mxlint: disable=MXL004 — timed from an idle card
            t0 = time.perf_counter()
            out = llama.generate(cfg, params, prompts, 32)
            torch.cuda.synchronize()  # mxlint: disable=MXL004 — timed from an idle card
            runs.append((out, time.perf_counter() - t0))
        gen_launches = read_launches()
        (out, t1), (out2, t2) = runs
        new = out[:, 128:]
        emit({"phase": "mixtral_generate", "requests": 4, "prompt_len": 128,
              "new_tokens": 32, "seconds": [t1, t2],
              "tok_per_s": [4 * 32 / t1, 4 * 32 / t2],
              "reproducible": bool(torch.equal(out, out2)),
              "first_tokens": new[:, :8].tolist(), "launches": gen_launches})
        if not (tuple(out.shape) == (4, 160)
                and torch.equal(out[:, :128], prompts)
                and bool(((new >= 0) & (new < cfg.vocab_size)).all())):
            raise AssertionError("mixtral generate returned malformed tokens")
        if not torch.equal(out, out2):
            raise AssertionError("mixtral greedy generate is not "
                                 "reproducible")
        if gen_launches != only():
            raise AssertionError(f"mixtral generate launched {gen_launches}")
        chunk_launches = chunked_phase(cfg, params, gen,
                                       MIXTRAL_CHUNK_PROMPT, CHUNK_SIZE,
                                       "mixtral_chunked_prefill")
        torch.cuda.empty_cache()

        # (c) the engines
        engine_launches = mixtral_engines(cfg, params)
    del params
    torch.cuda.empty_cache()
    train_launches = mixtral_train_phase()
    return {k: launches[k] + chunk_launches[k] + engine_launches[k]
            + train_launches[k] for k in LAUNCH_COUNTERS}


def mixtral_engines(cfg, params):
    """bench_llama_serve's stream (SERVE_*) through
    :func:`dense_serve_run` (a reversed synchronous engine must give
    every stream bit for bit: the serving mixture routes each token by
    itself) and through 16-token pages (streams against the dense
    engine's, printed; one paged capture)."""
    reqs = serve_requests(cfg)
    row, invariant, first = dense_serve_run(cfg, params, reqs)
    reset_launches()
    paged, paged_streams = paged_serve_run(cfg, params, reqs)
    paged["launches"] = read_launches()
    shared = shared_tokens(paged_streams, first)
    emit({"phase": "mixtral_serve_engine", "config": "mixtral_8x7b",
          "n_layers": cfg.n_layers, "requests": len(reqs),
          "max_slots": SERVE_SLOTS, "max_len": SERVE_MAX_LEN,
          "generated_tokens": sum(r.max_new_tokens for r in reqs), **row,
          "scheduling_invariant": invariant, "paged": paged,
          "paged_equal_streams": sum(n == len(first[i]) for i, n in
                                     zip(sorted(first), shared)),
          "paged_shared_tokens": shared, "nvidia_smi": nvidia_smi()})
    check_dense_serve("mixtral_serve_engine", cfg, reqs, row, invariant,
                      first)
    if not (paged["exact_counts"] and paged["decode_captures"] == 1
            and paged["launches"] == only()):
        raise AssertionError(f"mixtral paged engine: {paged}")
    return row["launches"]


def mixtral_train_phase():
    """One Mixtral layer at full width in the reference's training dtypes
    (f32 params, bf16 compute, remat, the chunked cross-entropy): flash
    vs dense loss and grads at capacity E/K, then TRAIN_STEPS adamw
    steps at the config's capacity through make_train_step."""
    import torch
    from mxtpu_torch.models import llama
    from mxtpu_torch.parallel import optim, step as pstep
    cfg = replace(llama.CONFIGS["mixtral_8x7b"],
                  n_layers=MIXTRAL_TRAIN_LAYERS)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    params = llama.init_params(cfg, gen, device="cuda")
    tokens = torch.randint(0, cfg.vocab_size, (1, 2048), generator=gen,
                           device="cuda")
    batch = {"tokens": tokens}
    n_params = sum(p.numel() for _, p in _leaves_with_keys(params))
    picked = (("layers.moe_gate", lambda t: t["layers"]["moe_gate"]),
              ("layers.w_gate", lambda t: t["layers"]["w_gate"]),
              ("tok_embed", lambda t: t["tok_embed"]))
    nodrop = replace(cfg, moe_capacity=cfg.moe_experts / cfg.moe_top_k)
    found = {}
    for impl in ("flash", "dense"):
        live = {k: ({lk: lv.detach().requires_grad_()
                     for lk, lv in v.items()} if k == "layers"
                    else v.detach().requires_grad_())
                for k, v in params.items()}
        loss = llama.loss_fn(replace(nodrop, attn_impl=impl))(live, batch)
        grads = torch.autograd.grad(loss, [f(live) for _, f in picked])
        found[impl] = (loss.detach(), grads)
        del live, loss, grads
    (lf, gf), (ld, gd) = found["flash"], found["dense"]
    rels = {"loss": abs(lf.item() - ld.item()) / abs(ld.item())}
    rels.update({n: rel_dist(a, b) for (n, _), a, b in zip(picked, gf, gd)})
    del found, gf, gd
    torch.cuda.empty_cache()
    emit({"phase": "mixtral_train_vs_dense", "n_layers": cfg.n_layers,
          "params": n_params, "capacity": nodrop.moe_capacity,
          "loss_flash": lf.item(), "loss_dense": ld.item(), "rel": rels,
          "bound": MOE_TRAIN_REL_BOUND})
    if not all(math.isfinite(r) and r <= MOE_TRAIN_REL_BOUND
               for r in rels.values()):
        raise AssertionError(f"mixtral flash vs dense loss/grads {rels} > "
                             f"{MOE_TRAIN_REL_BOUND}")

    tx = optim.adamw(TRAIN_LR)
    state = pstep.init_state(params, tx)
    del params
    step = pstep.make_train_step(llama.loss_fn(cfg), tx)
    builds = telemetry_value("compile_events_total", fn="train_step")
    torch.cuda.reset_peak_memory_stats()
    losses, seconds, launches = [], [], []
    for _ in range(TRAIN_STEPS):
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        state, loss = step(state, batch)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
        launches.append(read_launches())
        losses.append(loss.item())
    final = pstep.make_eval_step(llama.loss_fn(cfg))(state.params,
                                                     batch).item()
    expected = math.log(cfg.vocab_size) + MOE_AUX_LOSS
    emit({"phase": "mixtral_train", "steps": TRAIN_STEPS, "lr": TRAIN_LR,
          "capacity": cfg.moe_capacity, "tokens_per_step": tokens.numel(),
          "losses": losses, "loss_after": final,
          "ln_vocab_plus_aux": expected, "step_seconds": seconds,
          "tokens_per_s": [tokens.numel() / t for t in seconds],
          "launches": launches,
          "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
          "nvidia_smi": nvidia_smi()})
    want = only(flash_attention_fwd=2 * cfg.n_layers,
                flash_attention_bwd_dkv=cfg.n_layers,
                flash_attention_bwd_dq=cfg.n_layers)
    if any(n != want for n in launches):
        raise AssertionError(f"a mixtral train step launched {launches}, "
                             f"not {want}")
    if not all(map(math.isfinite, losses + [final])):
        raise AssertionError(f"non-finite mixtral loss: {losses}, {final}")
    if abs(losses[0] - expected) > 1.5:
        raise AssertionError(f"first mixtral loss {losses[0]} is not near "
                             f"ln(vocab) + aux = {expected}")
    if not final < losses[0]:
        raise AssertionError(f"mixtral loss did not fall: {losses} then "
                             f"{final}")
    del state, step
    torch.cuda.empty_cache()
    return {k: sum(n[k] for n in launches) for k in want}


def bert_batch(cfg, rng, masked):
    """bench_bert's batch from ``rng``: random tokens, sorted MLM
    positions and labels, NSP labels; with ``masked`` the last BERT_PAD
    positions of every other row are padding."""
    import torch
    mask = np.ones((BERT_BATCH, BERT_SEQ), np.float32)
    if masked:
        mask[::2, -BERT_PAD:] = 0.0
    host = {"tokens": rng.integers(0, cfg.vocab_size,
                                   (BERT_BATCH, BERT_SEQ)),
            "mask": mask,
            "mlm_positions": np.sort(rng.integers(0, BERT_SEQ, (
                BERT_BATCH, BERT_MLM))),
            "mlm_labels": rng.integers(0, cfg.vocab_size,
                                       (BERT_BATCH, BERT_MLM)),
            "mlm_weights": np.ones((BERT_BATCH, BERT_MLM), np.float32),
            "nsp_labels": rng.integers(0, 2, (BERT_BATCH,))}
    return {k: torch.as_tensor(v, device="cuda") for k, v in host.items()}


def bert_phase():
    """BERT-base pretraining at bench_bert's shape: (a) forward with
    padding, bf16 against f32 compute; (b) BERT_STEPS adamw steps."""
    import torch
    from mxtpu_torch.models import bert
    from mxtpu_torch.parallel import optim, step as pstep
    cfg = bert.CONFIGS["bert_base"]
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    params = bert.init_params(cfg, gen, device="cuda")
    n_params = sum(p.numel() for _, p in _leaves_with_keys(params))
    rng = np.random.default_rng(SEED)
    reset_launches()
    with torch.inference_mode():
        b = bert_batch(cfg, rng, masked=True)
        seq, pooled = bert.forward(cfg, params, b["tokens"], mask=b["mask"])
        want, _ = bert.forward(replace(cfg, dtype=torch.float32), params,
                               b["tokens"], mask=b["mask"])
        finite = bool(torch.isfinite(seq).all() and
                      torch.isfinite(pooled).all())
        rel = rel_dist(seq, want)
        emit({"phase": "bert_forward", "config": "bert_base",
              "params": n_params, "batch": BERT_BATCH, "seq": BERT_SEQ,
              "padded_rows": BERT_BATCH // 2, "padding": BERT_PAD,
              "seq_out": list(seq.shape), "pooled": list(pooled.shape),
              "finite": finite, "rel_vs_f32": rel,
              "rel_bound": BERT_REL_BOUND})
        del seq, pooled, want
    if not (finite and rel <= BERT_REL_BOUND):
        raise AssertionError(f"bert forward: finite {finite}, bf16 vs f32 "
                             f"{rel} > {BERT_REL_BOUND}")
    batch = bert_batch(cfg, rng, masked=False)
    tx = optim.adamw(BERT_LR)
    state = pstep.init_state(params, tx)
    del params
    step = pstep.make_train_step(bert.loss_fn(cfg), tx)
    torch.cuda.reset_peak_memory_stats()
    losses, seconds = [], []
    for _ in range(BERT_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, loss = step(state, batch)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
        losses.append(loss.item())
    launches = read_launches()
    # bench_bert's count of the products' work: the encoder's weights at
    # every position, the tied decode at the MLM positions, attention
    n_dense = n_params - sum(
        state.params[k].numel() for k in ("tok_emb", "pos_emb", "type_emb"))
    flops = (6 * n_dense * BERT_BATCH * BERT_SEQ
             + 6 * cfg.dim * cfg.vocab_size * BERT_BATCH * BERT_MLM
             + 12 * cfg.n_layers * cfg.dim * BERT_SEQ * BERT_BATCH * BERT_SEQ)
    expected = math.log(cfg.vocab_size) + math.log(2)
    emit({"phase": "bert_train", "steps": BERT_STEPS, "lr": BERT_LR,
          "losses": losses, "ln_vocab_plus_ln2": expected,
          "step_seconds": seconds,
          "samples_per_s": [BERT_BATCH / t for t in seconds],
          "model_tflops_per_s": [flops / t / 1e12 for t in seconds],
          "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
          "launches": launches, "nvidia_smi": nvidia_smi()})
    if not all(map(math.isfinite, losses)):
        raise AssertionError(f"non-finite bert loss: {losses}")
    if abs(losses[0] - expected) > 1.0:
        raise AssertionError(f"first bert loss {losses[0]} is not within 1 "
                             f"of ln V + ln 2 = {expected}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"bert loss did not fall: {losses}")
    if launches != only():
        raise AssertionError(f"bert launched {launches}")
    del state, step, batch
    torch.cuda.empty_cache()
    return launches


def _leaves_with_keys(tree):
    """(last key, leaf) of a nested dict, in order."""
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves_with_keys(v)
        else:
            yield k, v


# The Hopper kernels reported in the build line: name -> (the library's
# attrs entry point, {key: (its arguments, the SASS function tag)})
_D = (64, 128)
REPORTED_KERNELS = {
    "flash_fwd": ("mxtpu_flash_attn_fwd_attrs", {
        f"d{d}": ((d,), f"flash_fwd_kernelILi{d}E") for d in _D}),
    "flash_bwd_dkv": ("mxtpu_flash_attn_bwd_attrs", {
        f"d{d}": ((0, d), f"flash_bwd_dkv_kernelILi{d}E") for d in _D}),
    "flash_bwd_dq": ("mxtpu_flash_attn_bwd_attrs", {
        f"d{d}": ((1, d), f"flash_bwd_dq_kernelILi{d}E") for d in _D}),
    "conv3x3": ("mxtpu_conv3x3_attrs", {
        f"bn{bn}_split{sp}": ((bn, sp), f"conv3x3_kernelILi{bn}ELi{sp}EE")
        for bn in (64, 128) for sp in (1, 2)}),
}


def kernel_report(info):
    """Per Hopper kernel and instantiation: registers at launch (ptxas, and
    the runtime's count), the dynamic shared memory each launch asks
    for, and from its SASS (``cuobjdump -sass`` of the built library)
    the HGMMA (wgmma), UTMALDG and UTMASTG (TMA load and store)
    instructions, the highest register the consumer warpgroups use after
    ``setmaxnreg`` raised their budget, and local-memory stores
    (spills)."""
    import ctypes
    import os
    import re
    from mxtpu_torch.ops import _build
    lib = _build.load_kernels()
    ptxas_regs, fn = {}, None
    for ln in str(info["ptxas"]).splitlines():
        m = re.search(r"entry function '([^']+)'", ln)
        if m:
            fn = m.group(1)
        m = re.search(r"Used (\d+) registers", ln)
        if m and fn:
            ptxas_regs[fn] = int(m.group(1))
    cuobjdump = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", str(info["path"])],
                          capture_output=True, text=True, check=True,
                          timeout=300).stdout
    funcs = {}
    for chunk in sass.split("Function : ")[1:]:
        funcs[chunk.split(None, 1)[0]] = chunk
    out = {}
    for kernel, (attrs_fn, variants) in REPORTED_KERNELS.items():
        attrs = getattr(lib, attrs_fn)
        out[kernel] = {}
        for key, (args, tag) in variants.items():
            regs, smem = ctypes.c_int(0), ctypes.c_int(0)
            _build.check(attrs(*args, ctypes.byref(regs),
                               ctypes.byref(smem)), attrs_fn)
            text = "".join(c for f, c in funcs.items() if tag in f)
            out[kernel][key] = {
                "ptxas_registers": [r for f, r in ptxas_regs.items()
                                    if tag in f],
                "registers": regs.value, "dynamic_smem_bytes": smem.value,
                "HGMMA": text.count("HGMMA"), "UTMALDG": text.count("UTMALDG"),
                "UTMASTG": text.count("UTMASTG"),
                "sass_registers": 1 + max(
                    (int(r) for r in re.findall(r"\bR(\d+)\b", text)),
                    default=-1),
                "STL": len(re.findall(r"\bSTL\b", text))}
    return out


# -- 19. image_record --------------------------------------------------------
IMG_RECORDS = 2048             # JPEG records, 500x375, quality 95
IMG_SIZE = (375, 500)          # (h, w)
IMG_QUALITY = 95
IMG_CLASSES = 1000
IMG_BATCH = 256
IMG_CROP = 224                 # data_shape (3, 224, 224)
IMG_EPOCHS, IMG_STEPS = 2, 8   # 8 steps of 256 an epoch
IMG_LR, IMG_MOMENTUM, IMG_WD = 0.05, 0.9, 1e-4
IMG_MEAN, IMG_STD = (123.7, 116.3, 103.5), (58.4, 57.1, 57.4)
IMG_SWEEP_IMAGES = 512         # the raw pipe's decode rate, per thread count
IMG_AUG_IMAGES, IMG_AUG_BATCH = 256, 64
FOLDER_IMAGES, FOLDER_BATCH, FOLDER_WORKERS = 64, 16, 2
DET_RECORDS, DET_SIZE, DET_BATCH = 256, 300, 32
DET_CLASSES = 20               # VOC: 20 classes, 21 channels with background
DET_NMS_BATCH = 4              # MultiBoxDetection's images (N x N IoU each)
DET_NMS_THRESH = 0.45          # MXNet's SSD example's nms_thresh
# SSD300 (vgg16_reduced) anchors: feature map, sizes, ratios (MXNet's
# example/ssd/symbol/symbol_factory.py): 8,732 anchors
SSD300_ANCHORS = [
    (38, (0.1, 0.141), (1, 2, 0.5)),
    (19, (0.2, 0.272), (1, 2, 0.5, 3, 1 / 3.0)),
    (10, (0.37, 0.447), (1, 2, 0.5, 3, 1 / 3.0)),
    (5, (0.54, 0.619), (1, 2, 0.5, 3, 1 / 3.0)),
    (3, (0.71, 0.79), (1, 2, 0.5)),
    (1, (0.88, 0.961), (1, 2, 0.5)),
]
JPEG_MEAN_BOUND, JPEG_MAX_BOUND = 2.0, 16   # tests/test_native.py:76-78
# nvJPEG's quality-95 round trip against libjpeg's on the same pixels
JPEG_ENCODE_SLACK = 0.5
LOC_REL = 1e-5                 # MultiBoxTarget's loc targets, card vs CPU
NMS_TIE = 1e-4                 # |IoU - threshold| of a near tie


def _host_probe():
    """(a) of ``image_record``: what the card's host has for the native
    IO library, and which codec the library was built with."""
    from mxtpu_torch import native

    def sh(cmd):
        out = subprocess.run(["bash", "-c", cmd], capture_output=True,
                             text=True, timeout=60)
        return (out.stdout + out.stderr).strip()
    return {"gxx": sh("g++ --version | head -1"),
            "libjpeg": sh("ls /usr/include/jpeglib.h "
                          "/usr/lib/x86_64-linux-gnu/libjpeg.so* 2>&1"),
            "nvjpeg": sh("ls /usr/local/cuda/include/nvjpeg.h "
                         "/usr/local/cuda/lib64/libnvjpeg* 2>&1"),
            "nproc": int(sh("nproc")),
            "PIL": sh("python3 -c 'import PIL; print(PIL.__version__)' "
                      "2>&1 | tail -1"),
            "codec": native.backend()}


def _jpeg_stats(a, b):
    d = np.abs(a.astype(np.int64) - b.astype(np.int64))
    return {"mean": float(d.mean()), "max": int(d.max())}


def _codec_check(codec):
    """The host's codec against libjpeg's pixels: the fixtures under
    ``tests/data/jpeg`` (``python -m mxtpu_torch.tools.jpeg_fixtures``).
    Each JPEG's decode (RGB and luma) within the JPEG bounds of
    libjpeg's, bit-equal where the codec is libjpeg; each source encoded
    here at quality 95 and decoded loses no more than libjpeg's round
    trip, within JPEG_ENCODE_SLACK of its mean."""
    import glob
    from mxtpu_torch import native
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "tests", "data", "jpeg")
    rows = {}
    for jpg in sorted(glob.glob(os.path.join(root, "*.jpg"))):
        name = jpg[:-len(".jpg")]
        with open(jpg, "rb") as f:
            buf = f.read()
        row = {}
        for channels, suffix in ((3, "rgb"), (1, "luma")):
            want = np.load(f"{name}.{suffix}.npy")
            got = native.jpeg_decode(buf, channels)
            if got.shape != want.shape:
                raise AssertionError(f"{jpg} {suffix}: {got.shape} vs "
                                     f"{want.shape}")
            row[suffix] = _jpeg_stats(got, want)
        src = np.load(f"{name}.src.npy")
        ours = native.jpeg_decode(native.jpeg_encode(src, IMG_QUALITY), 3)
        row["encode_round_trip"] = _jpeg_stats(ours, src)
        row["libjpeg_round_trip"] = _jpeg_stats(np.load(f"{name}.rgb.npy"),
                                                src)
        rows[os.path.basename(name)] = row
    if len(rows) != 3:
        raise AssertionError(f"the JPEG fixtures are missing: {rows}")
    exact = codec == "libjpeg"
    for name, row in rows.items():
        for suffix in ("rgb", "luma"):
            s = row[suffix]
            ok = s["max"] == 0 if exact else \
                s["mean"] < JPEG_MEAN_BOUND and s["max"] <= JPEG_MAX_BOUND
            if not ok:
                raise AssertionError(f"{codec} decode of {name} {suffix}: "
                                     f"{s}")
        if row["encode_round_trip"]["mean"] > \
                row["libjpeg_round_trip"]["mean"] + JPEG_ENCODE_SLACK:
            raise AssertionError(f"{codec} encode of {name}: {row}")
    return {"case": "bit-equal to libjpeg" if exact else
            f"{codec} within mean < {JPEG_MEAN_BOUND}, max <= "
            f"{JPEG_MAX_BOUND} of libjpeg", "images": rows}


def _decode_rate(rec, threads):
    """The raw pipe's img/s: IMG_SWEEP_IMAGES decoded, centre-cropped
    and resized to 224² by ``threads`` workers (uint8 out)."""
    from mxtpu_torch import native
    pipe = native.NativePipeline(rec, IMG_CROP, IMG_CROP, 3, threads=threads,
                                 out_u8=True)
    try:
        t0 = time.perf_counter()
        n = 0
        while n < IMG_SWEEP_IMAGES:
            data, _ = pipe.next_batch(IMG_BATCH)
            if not len(data):
                break
            n += len(data)
        return n / (time.perf_counter() - t0)
    finally:
        pipe.close()


def _post_bit_equal(mx, rec, threads):
    """One uint8 batch normalized on the card and on the host, bit for
    bit; and the first batch of the card's iterator (pinned buffers, its
    own stream) against the host's."""
    import torch
    from mxtpu_torch import io as mio, native
    mean = torch.tensor(IMG_MEAN, dtype=torch.float32)
    std = torch.tensor(IMG_STD, dtype=torch.float32)
    pipe = native.NativePipeline(rec, IMG_CROP, IMG_CROP, 3, threads=threads,
                                 out_u8=True)
    try:
        u8 = torch.from_numpy(pipe.next_batch(IMG_BATCH)[0].copy())
    finally:
        pipe.close()
    host = mio.normalize_u8(u8, mean, std)
    card = mio.normalize_u8(u8.cuda(), mean.cuda(), std.cuda()).cpu()
    batches = []
    for ctx in ("cuda", "cpu"):
        it = mio.NativeImageRecordIter(
            rec, (3, IMG_CROP, IMG_CROP), IMG_BATCH, preprocess_threads=threads,
            mean=list(IMG_MEAN), std=list(IMG_STD), ctx=ctx)
        try:
            batches.append(it.next().data[0]._data.cpu())
        finally:
            it.close()
    torch.cuda.synchronize()
    return {"post": bool(torch.equal(host, card)),
            "iterator": bool(torch.equal(*batches))}


def _image_train(mx, rec, threads):
    """(b) of ``image_record``: ImageRecordIter (native) → DevicePrefetcher
    → the zoo's ResNet-50 in bf16 through ``make_fused_step``."""
    import torch
    from mxtpu_torch import io as mio
    from mxtpu_torch.gluon import data as gdata
    from mxtpu_torch.tools.synth_images import build_resnet50_step
    kw = dict(path_imgrec=rec, data_shape=(3, IMG_CROP, IMG_CROP),
              batch_size=IMG_BATCH, shuffle=True, preprocess_threads=threads,
              mean_r=IMG_MEAN[0], mean_g=IMG_MEAN[1], mean_b=IMG_MEAN[2],
              std_r=IMG_STD[0], std_g=IMG_STD[1], std_b=IMG_STD[2],
              ctx="cuda")
    it = mio.ImageRecordIter(**kw)
    if not isinstance(it, mio.NativeImageRecordIter):
        raise AssertionError(f"ImageRecordIter routed to {type(it)}")
    # the pure input rate: decode + the uint8 upload + the card's post,
    # no training, fenced on the last batch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    n_in = 0
    for b in it:
        n_in += b.data[0].shape[0] - b.pad
    torch.cuda.synchronize()
    input_rate = n_in / (time.perf_counter() - t0)
    it.reset()
    step = build_resnet50_step(IMG_LR, IMG_MOMENTUM, IMG_WD, SEED, IMG_CROP,
                               IMG_CLASSES)
    torch.cuda.reset_peak_memory_stats()
    losses, waits, epoch_s = [], [], []
    with gdata.DevicePrefetcher(it, depth=2, device="cuda") as batches:
        for epoch in range(IMG_EPOCHS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            steps = 0
            while True:
                w0 = time.perf_counter()
                try:
                    b = next(batches)
                except StopIteration:
                    break
                if epoch:
                    waits.append(1e3 * (time.perf_counter() - w0))
                losses.append(float(step(b.data[0], b.label[0])
                                    .asscalar()))
                steps += 1
            torch.cuda.synchronize()
            epoch_s.append(time.perf_counter() - t0)
            if steps != IMG_STEPS:
                raise AssertionError(f"epoch {epoch}: {steps} steps")
            batches.reset()
    # the same step fed from memory: the last batch, already on the card
    x, y = b.data[0], b.label[0]
    step(x, y)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(IMG_STEPS // 2):
        step(x, y)
    torch.cuda.synchronize()
    memory_ms = 1e3 * (time.perf_counter() - t0) / (IMG_STEPS // 2)
    peak = torch.cuda.max_memory_allocated() / 1e9
    train_rate = IMG_STEPS * IMG_BATCH / epoch_s[-1]
    step_ms = 1e3 * epoch_s[-1] / IMG_STEPS
    row = {"routed": type(it).__name__, "input_img_per_s": input_rate,
           "train_img_per_s": train_rate, "epoch_seconds": epoch_s,
           "step_ms": step_ms, "from_memory_step_ms": memory_ms,
           "from_memory_img_per_s": 1e3 * IMG_BATCH / memory_ms,
           "losses": losses,
           "data_wait_ms": {"p50": _pct(waits, 50), "p99": _pct(waits, 99),
                            "count": len(waits)},
           # the step waits on its input when the median wait is a tenth
           # of a step or more
           "input_bounds_step": _pct(waits, 50) >= 0.1 * step_ms,
           "peak_gb": peak, "num_compiles": step.num_compiles()}
    del step, batches, x, y, b
    _release_gateway()
    first_ok = abs(losses[0] - math.log(IMG_CLASSES)) < 1.0
    if not (all(map(math.isfinite, losses)) and first_ok):
        raise AssertionError(f"image_record losses {losses}")
    return row


def _image_augment(rec, threads):
    """(c): ImageRecordIter with rand_crop and rand_mirror (the Python
    ImageIter under a PrefetchingIter), IMG_AUG_IMAGES images."""
    import torch
    from mxtpu_torch import io as mio
    it = mio.ImageRecordIter(
        path_imgrec=rec, data_shape=(3, IMG_CROP, IMG_CROP), batch_size=IMG_AUG_BATCH,
        shuffle=True, preprocess_threads=threads, rand_crop=True,
        rand_mirror=True, mean_r=IMG_MEAN[0], mean_g=IMG_MEAN[1],
        mean_b=IMG_MEAN[2], std_r=IMG_STD[0], std_g=IMG_STD[1],
        std_b=IMG_STD[2], ctx="cuda")
    if not isinstance(it, mio.PrefetchingIter):
        raise AssertionError(f"the augmenting path routed to {type(it)}")
    try:
        t0 = time.perf_counter()
        n = 0
        while n < IMG_AUG_IMAGES:
            b = it.next()
            n += b.data[0].shape[0] - b.pad
        torch.cuda.synchronize()
        rate = n / (time.perf_counter() - t0)
    finally:
        it.close()
    if b.data[0].shape != (IMG_AUG_BATCH, 3, IMG_CROP, IMG_CROP) or \
            not bool(torch.isfinite(b.data[0]._data).all()):
        raise AssertionError("the augmenting path's batch is wrong")
    return {"routed": "ImageIter under PrefetchingIter", "images": n,
            "img_per_s": rate}


def _det_labels(rng):
    """DET_RECORDS images' boxes, 1-5 each, packed as im2rec's detection
    labels ``[2, 5, (class, x1, y1, x2, y2) * k]``."""
    labels = []
    for i in range(DET_RECORDS):
        lab = [2.0, 5.0]
        for _ in range(1 + i % 5):
            x1, y1 = rng.uniform(0, 0.6, 2)
            bw, bh = rng.uniform(0.15, 0.4, 2)
            lab += [float(rng.integers(0, DET_CLASSES)), x1, y1,
                    min(1.0, x1 + bw), min(1.0, y1 + bh)]
        labels.append(lab)
    return labels


def _ssd300_anchors(mx, ctx):
    outs = [mx.nd.contrib.MultiBoxPrior(
        mx.nd.zeros((1, 1, side, side), ctx=ctx), sizes=sizes, ratios=ratios)
        for side, sizes, ratios in SSD300_ANCHORS]
    return mx.nd.concat(*outs, dim=1)


def _nms_ties(cpu, card, thresh):
    """Rows whose kept/suppressed state differs between the card and the
    CPU: the first in each image must be an IoU near tie at the
    threshold (the decoded boxes differ in the last bits of ``exp``);
    later ones follow from it."""
    diffs, ties = 0, []
    for b in range(cpu.shape[0]):
        kc, kg = cpu[b, :, 1] >= 0, card[b, :, 1] >= 0
        rows = np.nonzero(kc != kg)[0]
        diffs += len(rows)
        if not len(rows):
            continue
        # the rows before j are kept alike; j's class and its box as
        # the CPU decoded it, against the earlier kept boxes of its class
        j = rows[0]
        same = (cpu[b, :j, 0] == cpu[b, j, 0]) & kc[:j]
        bj = cpu[b, j, 2:].astype(np.float64)
        bi = cpu[b, :j, 2:][same].astype(np.float64)
        ix = np.clip(np.minimum(bi[:, 2], bj[2]) - np.maximum(bi[:, 0], bj[0]),
                     0, None)
        iy = np.clip(np.minimum(bi[:, 3], bj[3]) - np.maximum(bi[:, 1], bj[1]),
                     0, None)
        inter = ix * iy
        union = (bi[:, 2] - bi[:, 0]) * (bi[:, 3] - bi[:, 1]) + \
            (bj[2] - bj[0]) * (bj[3] - bj[1]) - inter
        iou = inter / np.where(union > 0, union, 1)
        ties.append(float(np.min(np.abs(iou - thresh))) if len(iou)
                    else float("inf"))
    return diffs, ties


def _image_detection(mx, rec):
    """(d): ImageDetIter over the detection .rec, then SSD300's anchors,
    MultiBoxTarget and MultiBoxDetection on the card against the CPU."""
    import random
    import torch
    from mxtpu_torch import image
    from mxtpu_torch.tools.timing import time_ms
    random.seed(SEED)
    np.random.seed(SEED)
    it = image.ImageDetIter(DET_BATCH, (3, DET_SIZE, DET_SIZE),
                            path_imgrec=rec, shuffle=True, rand_crop=1,
                            rand_mirror=True, ctx="cuda")
    t0 = time.perf_counter()
    n, first = 0, None
    for b in it:
        n += b.data[0].shape[0] - b.pad
        first = first or b
    torch.cuda.synchronize()
    det_rate = n / (time.perf_counter() - t0)
    label = first.label[0]
    rng = np.random.default_rng(SEED)
    anchors = {ctx: _ssd300_anchors(mx, ctx) for ctx in ("cuda", "cpu")}
    n_anchor = anchors["cpu"].shape[1]
    logits = rng.standard_normal((DET_BATCH, DET_CLASSES + 1, n_anchor),
                                 dtype=np.float32)
    prob = np.exp(logits - logits.max(axis=1, keepdims=True))
    prob = (prob / prob.sum(axis=1, keepdims=True)).astype(np.float32)
    loc = (0.3 * rng.standard_normal((DET_BATCH, n_anchor * 4))) \
        .astype(np.float32)
    args = {ctx: [mx.nd.array(a, ctx=ctx) for a in
                  (label.asnumpy(), logits, prob[:DET_NMS_BATCH],
                   loc[:DET_NMS_BATCH])] for ctx in ("cuda", "cpu")}
    c = mx.nd.contrib
    out = {}
    for ctx in ("cuda", "cpu"):
        lab, lg, pr, lc = args[ctx]
        out[ctx] = [o.asnumpy() for o in c.MultiBoxTarget(
            anchors[ctx], lab, lg, overlap_threshold=0.5,
            negative_mining_ratio=3, negative_mining_thresh=0.5)]
        out[ctx].append(c.MultiBoxDetection(pr, lc, anchors[ctx],
                                            nms_threshold=DET_NMS_THRESH).asnumpy())
    (loc_c, mask_c, cls_c, det_c), (loc_g, mask_g, cls_g, det_g) = \
        out["cpu"], out["cuda"]
    lab, lg, pr, lc = args["cuda"]
    ms = {"MultiBoxPrior": time_ms(lambda: _ssd300_anchors(mx, "cuda"), 3),
          "MultiBoxTarget": time_ms(lambda: c.MultiBoxTarget(
              anchors["cuda"], lab, lg, negative_mining_ratio=3), 3),
          "MultiBoxDetection": time_ms(lambda: c.MultiBoxDetection(
              pr, lc, anchors["cuda"], nms_threshold=DET_NMS_THRESH), 1, warmup=0)}
    loc_err = float(np.max(np.abs(loc_g - loc_c)
                           / np.maximum(np.abs(loc_c), 1.0)))
    diffs, ties = _nms_ties(det_c, det_g, DET_NMS_THRESH)
    row = {"images": n, "img_per_s": det_rate, "anchors": n_anchor,
           "classes": DET_CLASSES, "channels": DET_CLASSES + 1,
           "target_batch": DET_BATCH, "detection_batch": DET_NMS_BATCH,
           "cls_target_equal": bool(np.array_equal(cls_g, cls_c)),
           "mask_equal": bool(np.array_equal(mask_g, mask_c)),
           "loc_target_max_rel": loc_err,
           "positives": int(mask_c.sum() // 4),
           "kept": int((det_c[..., 1] >= 0).sum()),
           "kept_differ": diffs, "first_differences_iou_margin": ties,
           "card_ms": ms}
    if n_anchor != 8732:
        raise AssertionError(f"SSD300 has 8732 anchors, not {n_anchor}")
    if not (row["cls_target_equal"] and row["mask_equal"]
            and loc_err <= LOC_REL):
        raise AssertionError(f"MultiBoxTarget on the card differs: {row}")
    if any(t > NMS_TIE for t in ties):
        raise AssertionError(f"MultiBoxDetection on the card differs: {row}")
    if label.shape != (DET_BATCH, 5, 5):
        raise AssertionError(f"ImageDetIter's labels: {label.shape}")
    return row


def _image_folder_loader(root, make_image, codec):
    """(e): ImageFolderDataset over JPEG files under
    ``DataLoader(num_workers=FOLDER_WORKERS)``, Gluon's usual image
    training input. A worker process hides the card, so under nvJPEG
    the workers must be threads of this process; and a process that
    hides the card must say why nvJPEG cannot decode there."""
    from mxtpu_torch import image
    from mxtpu_torch.gluon.data import DataLoader
    from mxtpu_torch.gluon.data.vision import ImageFolderDataset
    for i in range(FOLDER_IMAGES):
        folder = os.path.join(root, f"class{i % 4}")
        os.makedirs(folder, exist_ok=True)
        with open(os.path.join(folder, f"{i}.jpg"), "wb") as f:
            f.write(image.imencode(make_image(i), ".jpg",
                                   quality=IMG_QUALITY))
    ds = ImageFolderDataset(root)

    def batches(**kw):
        loader = DataLoader(ds, batch_size=FOLDER_BATCH, ctx="cpu", **kw)
        t0 = time.perf_counter()
        out = [(x.asnumpy(), y.asnumpy()) for x, y in loader]
        return loader, out, len(ds) / (time.perf_counter() - t0)
    _, want, rate0 = batches()
    loader, got, rate = batches(num_workers=FOLDER_WORKERS)
    equal = len(got) == len(want) and all(
        np.array_equal(a, b) for g, w in zip(got, want) for a, b in zip(g, w))
    code = ("import sys\nfrom mxtpu_torch import native\n"
            "try:\n    native.jpeg_decode(open(sys.argv[1], 'rb').read())\n"
            "    print('decoded')\nexcept RuntimeError as e:\n    print(e)\n")
    hidden = subprocess.run(
        [sys.executable, "-c", code, ds.items[0][0]], capture_output=True,
        text=True, timeout=300, cwd=os.path.dirname(os.path.abspath(__file__)),
        env=dict(os.environ, CUDA_VISIBLE_DEVICES="")).stdout.strip()
    expect = "threads" if codec == "nvjpeg" else "processes"
    row = {"images": len(ds), "workers": FOLDER_WORKERS,
           "worker_kind": loader.worker_kind, "batches_equal": equal,
           "img_per_s": {"no_workers": rate0, "workers": rate},
           "card_hidden_decode": hidden}
    named = "cannot run in this process" in hidden and \
        "CUDA_VISIBLE_DEVICES=''" in hidden
    if loader.worker_kind != expect or not equal or \
            not (named if codec == "nvjpeg" else hidden == "decoded"):
        raise AssertionError(f"ImageFolderDataset under DataLoader: {row}")
    return row


def image_record_phase():
    """19 in the docstring: the image half of mx.io at ImageNet width."""
    import torch
    import mxtpu_torch as mx
    from mxtpu_torch.tools.synth_images import SynthImages, write_rec
    reset_launches()
    out_dir = os.path.join(build_dir(), "image_record")
    os.makedirs(out_dir, exist_ok=True)
    try:
        probe = _host_probe()
        threads = probe["nproc"]
        codec = _codec_check(probe["codec"])
        rec = os.path.join(out_dir, "train.rec")
        write_s = write_rec(rec, IMG_RECORDS,
                            SynthImages(0, IMG_RECORDS, *IMG_SIZE),
                            lambda i: float(i % IMG_CLASSES), threads,
                            IMG_QUALITY)
        sweep = {t: _decode_rate(rec, t)
                 for t in sorted({1, 2, 4, threads})}
        post = _post_bit_equal(mx, rec, threads)
        train = _image_train(mx, rec, threads)
        augment = _image_augment(rec, threads)
        det_rec = os.path.join(out_dir, "det.rec")
        boxes = _det_labels(np.random.default_rng(1))
        write_rec(det_rec, DET_RECORDS,
                  SynthImages(1, DET_RECORDS, DET_SIZE, DET_SIZE),
                  lambda i: boxes[i], threads, IMG_QUALITY)
        detection = _image_detection(mx, det_rec)
        loader = _image_folder_loader(os.path.join(out_dir, "folder"),
                                      SynthImages(2, FOLDER_IMAGES,
                                                  *IMG_SIZE),
                                      probe["codec"])
        torch.cuda.synchronize()
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    launches = read_launches()
    emit({"phase": "image_record", "card": nvidia_smi(), "host": probe,
          "codec_check": codec,
          "records": {"n": IMG_RECORDS, "hw": IMG_SIZE,
                      "quality": IMG_QUALITY, "write_seconds": write_s},
          "decode_img_per_s_by_threads": sweep,
          "post_bit_equal": post, "train": train, "augment": augment,
          "detection": detection, "loader": loader, "launches": launches})
    if not (post["post"] and post["iterator"]):
        raise AssertionError(f"the card's post differs from the host's: "
                             f"{post}")
    if launches != only():
        raise AssertionError(f"image_record launched {launches}")
    return launches


# op_set: the rest of the op set at published widths (ROADMAP item
# 10.4(b)): the update ops over one llama3_8b layer, sparse dot/add/
# retain at Avazu's shape and llama3_8b's embedding, a numpy Custom op
# at the vocabulary width, an int8 ResNet-50, and four vision ops.
OPSET_CHECK = 2 ** 16          # elements of each array held against the CPU
UPDATE_ULPS = 1                # card vs CPU update, f32 ulps (bf16: equal)
UPDATE_RULES = (               # (op, kwargs, state arrays, bytes a param)
    ("sgd_update", {"lr": 0.01, "wd": 1e-4}, (), 12),
    ("sgd_mom_update", {"lr": 0.01, "momentum": 0.9, "wd": 1e-4},
     ("mom",), 20),
    ("nag_mom_update", {"lr": 0.01, "momentum": 0.9, "wd": 1e-4},
     ("mom",), 20),
    ("adam_update", {"lr": 1e-3, "wd": 1e-4}, ("mean", "var"), 28),
    ("adamw_update", {"lr": 1e-3, "wd": 0.01, "eta": 1.0},
     ("mean", "var"), 28),
    ("rmsprop_update", {"lr": 1e-3, "gamma1": 0.95, "wd": 1e-4}, ("n",),
     20),
    ("ftrl_update", {"lr": 0.1, "lamda1": 1e-3, "beta": 1.0, "wd": 1e-4},
     ("z", "n"), 28),
    ("signsgd_update", {"lr": 0.01, "wd": 1e-4}, (), 12),
    ("mp_sgd_update", {"lr": 0.01, "wd": 1e-4}, ("weight32",), 14),
)
HBM_BYTES_PER_S = 3.35e12      # H100 SXM5 HBM3 peak memory rate
AVAZU = (8192, 1_000_000, 15)  # batch, hashed features, non-zeros a row
EMBED_TOKENS = 2048
SPARSE_PEAK_GB = 1.0           # allocated above the inputs
SOFTMAX_REL = 1e-6             # Custom vs mx.nd ops, of max |ref|
INT8_BATCH, INT8_CALIB_BATCH, INT8_IMAGE = 256, 64, 224
INT8_LAYER_IMAGES = 4          # images of the first batch per layer check
# ||int8 - f32|| / ||f32|| of the logits: 0.0142-0.0144 on the CPU at
# batch 4-16 (python -m mxtpu_torch.tools.int8_tolerance), 0.149-0.154
# with every activation threshold halved
INT8_LOGITS_REL = 0.03
VISION_REL = 1e-4              # card vs CPU on image 0, of max |ref|


def _ulps_any(got, want):
    """Largest distance in ulps (f32) or 0/1 for inequality (others)."""
    import torch
    if got.dtype == torch.float32:
        return int(_f32_ulps(got, want).max().item()) if got.numel() else 0
    return int(not torch.equal(got, want))


def _opset_updates(mx):
    """(a) each update rule over one llama3_8b layer's tree, one call
    an array, against the port's update on the CPU."""
    import torch
    from mxtpu_torch.models import llama
    from mxtpu_torch.tools import timing
    cfg = llama.CONFIGS["llama3_8b"]
    d, h, kv = cfg.dim, cfg.hidden_dim, cfg.n_kv_heads * cfg.head_dim
    shapes = [(d, d), (d, kv), (d, kv), (d, d), (d, h), (d, h), (h, d),
              (d,), (d,)]
    n_params = sum(math.prod(s) for s in shapes)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 20)

    def rand(s, kind):
        x = torch.randn(s, generator=gen, device="cuda")
        if kind in ("var", "n"):
            return x.abs() * 1e-6
        return x * {"w": 0.02, "g": 1e-3, "z": 1e-2}.get(kind, 1e-3)
    ws = [rand(s, "w") for s in shapes]
    gs = [rand(s, "g") for s in shapes]
    rows, n = [], OPSET_CHECK
    for op, kw, state_names, per_param in UPDATE_RULES:
        fn = getattr(mx.nd, op)
        mp = op == "mp_sgd_update"
        w_in = [w.to(torch.bfloat16) if mp else w for w in ws]
        g_in = [g.to(torch.bfloat16) if mp else g for g in gs]
        st_in = [[w.clone() if mp else rand(w.shape, s) for s in state_names]
                 for w in ws]
        weights = [mx.nd.NDArray(w) for w in w_in]
        grads = [mx.nd.NDArray(g) for g in g_in]
        states = [[mx.nd.NDArray(t) for t in st] for st in st_in]
        # as MXNet's optimizer calls them: the new weight into ``out``
        new_w = [fn(w, g, *st, out=w, **kw) for w, g, st in
                 zip(weights, grads, states)]
        if any(a is not b for a, b in zip(new_w, weights)):
            raise AssertionError(f"{op}(..., out=w) returned another array")
        worst = 0
        for i in range(len(shapes)):
            cut = [t.reshape(-1)[:n].cpu() for t in
                   [w_in[i], g_in[i]] + st_in[i]]
            cst = [mx.nd.NDArray(t.clone()) for t in cut[2:]]
            cw = fn(mx.nd.NDArray(cut[0]), mx.nd.NDArray(cut[1]), *cst, **kw)
            pairs = [(new_w[i]._data, cw._data)] + [
                (a._data, b._data) for a, b in zip(states[i], cst)]
            for got, want in pairs:
                worst = max(worst, _ulps_any(got.reshape(-1)[:n].cpu(),
                                             want))
        ms = timing.time_ms(
            lambda: [fn(w, g, *st, out=w, **kw) for w, g, st in
                     zip(weights, grads, states)], 3, warmup=1)
        nbytes = per_param * n_params
        rows.append({"op": op, "ms": ms, "bytes": nbytes,
                     "gb_per_s": nbytes / ms / 1e6,
                     "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
                     "share_of_bound": nbytes / HBM_BYTES_PER_S * 1e3 / ms,
                     "max_ulps": worst})
        del weights, grads, states, new_w, st_in
    tree = [mx.nd.NDArray(w) for w in ws]
    finite = float(mx.nd.multi_all_finite(*tree, num_arrays=9).asscalar())
    planted = ws[4].clone()
    planted[7, 11] = math.inf
    tree[4] = mx.nd.NDArray(planted)
    with_inf = float(mx.nd.multi_all_finite(*tree, num_arrays=9)
                     .asscalar())
    bad = [r["op"] for r in rows if r["max_ulps"] > UPDATE_ULPS]
    if bad or finite != 1.0 or with_inf != 0.0:
        raise AssertionError(f"op_set updates: beyond {UPDATE_ULPS} ulps "
                             f"{bad}, multi_all_finite {finite}/{with_inf}:"
                             f" {rows}")
    return {"params": n_params, "arrays": len(shapes), "rules": rows,
            "multi_all_finite": finite, "with_inf": with_inf}


def _csr_batch(mx, gen, rows, features, per_row, ones=False):
    """A CSR batch on the card: ``per_row`` sorted hashed features a row
    (a collision stays a duplicate entry), normal values (or ones)."""
    import torch
    from mxtpu_torch.ndarray import sparse
    cols = torch.randint(0, features, (rows, per_row), generator=gen,
                         device="cuda").sort(dim=1).values
    nnz = rows * per_row
    data = torch.ones(nnz, device="cuda") if ones else \
        torch.randn(nnz, generator=gen, device="cuda")
    indptr = torch.arange(0, nnz + 1, per_row, device="cuda",
                          dtype=torch.int32)
    return sparse.CSRNDArray(mx.nd.NDArray(data),
                             mx.nd.NDArray(cols.reshape(-1).to(torch.int32)),
                             mx.nd.NDArray(indptr), (rows, features))


def _reassoc_ok(got, want, absolute, n_terms):
    """|got - want| within 2·n·2^-24 of the sum of |terms| (the same
    products summed in any order)."""
    import torch
    bound = 2.0 * n_terms * 2.0 ** -24 * absolute
    return bool(torch.all((got - want).abs() <= bound + 1e-30).item())


def _abs_csr(csr):
    import torch
    from mxtpu_torch.ndarray import sparse
    return sparse.CSRNDArray(
        csr.data.__class__(torch.abs(csr.data._data)), csr.indices,
        csr.indptr, csr.shape)


def _opset_sparse(mx):
    """(b) sparse dot/add/retain at Avazu's shape and llama3_8b's
    one-hot embedding, against the CPU, with the peak memory above the
    inputs."""
    import tempfile
    import torch
    from mxtpu_torch.models import llama
    from mxtpu_torch.ndarray import sparse
    from mxtpu_torch.tools import timing
    rows, feats, per_row = AVAZU
    gen = torch.Generator(device="cuda").manual_seed(SEED + 21)
    csr = _csr_batch(mx, gen, rows, feats, per_row)
    csr2 = _csr_batch(mx, gen, rows, feats, per_row)
    w = mx.nd.NDArray(torch.randn(feats, 1, generator=gen, device="cuda")
                      * 0.01)
    g = mx.nd.NDArray(torch.randn(rows, 1, generator=gen, device="cuda"))
    g2 = mx.nd.NDArray(torch.randn(rows, 1, generator=gen, device="cuda"))
    vocab, dim = llama.CONFIGS["llama3_8b"].vocab_size, \
        llama.CONFIGS["llama3_8b"].dim
    onehot = _csr_batch(mx, gen, EMBED_TOKENS, vocab, 1, ones=True)
    emb = mx.nd.NDArray(torch.randn(vocab, dim, generator=gen,
                                    device="cuda") * 0.02)
    gout = mx.nd.NDArray(torch.randn(EMBED_TOKENS, dim, generator=gen,
                                     device="cuda"))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    y = sparse.dot(csr, w)
    gw = sparse.dot(csr, g, transpose_a=True)
    gw2 = sparse.dot(csr2, g2, transpose_a=True)
    summed = sparse.add(gw, gw2)
    keep = mx.nd.NDArray(csr.indices._data[:4096])
    kept = sparse.retain(summed, keep)
    e_fwd = sparse.dot(onehot, emb)
    e_bwd = sparse.dot(onehot, gout, transpose_a=True)
    torch.cuda.synchronize()
    peak_gb = (torch.cuda.max_memory_allocated() - base) / 1e9
    dense_built = [a._dense_cache is not None
                   for a in (csr, csr2, onehot, gw, gw2, summed, kept,
                             e_bwd)]
    again = sparse.dot(csr, g, transpose_a=True)
    e_again = sparse.dot(onehot, gout, transpose_a=True)
    bit_equal = {
        "avazu_t": torch.equal(again.data._data, gw.data._data),
        "embedding_t": torch.equal(e_again.data._data, e_bwd.data._data)}
    # the CPU on the same inputs
    c_csr, c_hot, cw, cg, cemb, cgo = (a.as_in_context("cpu") for a in
                                       (csr, onehot, w, g, emb, gout))
    col_count = torch.bincount(c_csr.indices._data.long()).max().item()
    tok_count = torch.bincount(c_hot.indices._data.long()).max().item()
    checks = {
        "avazu": _reassoc_ok(
            y._data.cpu(), sparse.dot(c_csr, cw)._data,
            sparse.dot(_abs_csr(c_csr), cw.abs())._data, per_row),
        "avazu_t": _reassoc_ok(
            gw.data._data.cpu(),
            sparse.dot(c_csr, cg, transpose_a=True).data._data,
            sparse.dot(_abs_csr(c_csr), cg.abs(),
                       transpose_a=True).data._data, col_count),
        "avazu_t_rows": torch.equal(
            gw.indices._data.cpu(),
            sparse.dot(c_csr, cg, transpose_a=True).indices._data),
        "add": torch.equal(summed.data._data.cpu(), sparse.add(
            gw.as_in_context("cpu"), gw2.as_in_context("cpu")).data._data),
        "retain": torch.equal(kept.data._data.cpu(), sparse.retain(
            summed.as_in_context("cpu"),
            keep.as_in_context("cpu")).data._data),
        "embedding": torch.equal(e_fwd._data.cpu(),
                                 sparse.dot(c_hot, cemb)._data),
        "embedding_t": _reassoc_ok(
            e_bwd.data._data.cpu(),
            sparse.dot(c_hot, cgo, transpose_a=True).data._data,
            sparse.dot(c_hot, cgo.abs(), transpose_a=True).data._data,
            tok_count)}
    with tempfile.TemporaryDirectory() as tmp:
        paths = [os.path.join(tmp, f) for f in ("card.params", "cpu.params")]
        mx.nd.save(paths[0], {"csr": csr, "rsp": gw})
        mx.nd.save(paths[1], {"csr": c_csr, "rsp": gw.as_in_context("cpu")})
        with open(paths[0], "rb") as f1, open(paths[1], "rb") as f2:
            checks["params_bytes_equal"] = f1.read() == f2.read()
    ms = {"avazu_dot": timing.time_ms(lambda: sparse.dot(csr, w), 5),
          "avazu_dot_t": timing.time_ms(
              lambda: sparse.dot(csr, g, transpose_a=True), 5),
          "add": timing.time_ms(lambda: sparse.add(gw, gw2), 5),
          "retain": timing.time_ms(lambda: sparse.retain(summed, keep), 5),
          "embedding_dot": timing.time_ms(lambda: sparse.dot(onehot, emb),
                                          5),
          "embedding_dot_t": timing.time_ms(
              lambda: sparse.dot(onehot, gout, transpose_a=True), 5)}
    row = {"avazu": {"rows": rows, "features": feats, "nnz": rows * per_row,
                     "grad_rows": gw.indices.shape[0],
                     "summed_rows": summed.indices.shape[0],
                     "kept_rows": kept.indices.shape[0]},
           "embedding": {"tokens": EMBED_TOKENS, "vocab": vocab, "dim": dim,
                         "grad_rows": e_bwd.indices.shape[0]},
           "ms": ms, "peak_gb_above_inputs": peak_gb,
           "dense_built": any(dense_built), "checks": checks,
           "two_calls_bit_equal": bit_equal,
           "note": "the transposed dots and add read their row count back "
                   "to the host inside the timed window"}
    if not all(checks.values()) or any(dense_built) or \
            peak_gb > SPARSE_PEAK_GB:
        raise AssertionError(f"op_set sparse: {row}")
    del csr, csr2, onehot, emb, gout, e_fwd, e_bwd, e_again
    return row


def _numpy_softmax_op(mx, moved):
    """MXNet's example/numpy-ops/custom_softmax.py: softmax in numpy,
    backward y - onehot(label), adding the bytes it moves to ``moved``."""
    class NumpySoftmax(mx.operator.CustomOp):
        def forward(self, is_train, req, in_data, out_data, aux):
            x = in_data[0].asnumpy()
            moved["to_host"] += x.nbytes
            y = np.exp(x - x.max(axis=1, keepdims=True))
            y /= y.sum(axis=1, keepdims=True)
            self.assign(out_data[0], req[0], y)
            moved["to_card"] += y.nbytes

        def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
            lab = in_data[1].asnumpy()
            y = out_data[0].asnumpy()
            moved["to_host"] += lab.nbytes + y.nbytes
            lab = lab.ravel().astype(np.int64)
            y[np.arange(lab.shape[0]), lab] -= 1.0
            self.assign(in_grad[0], req[0], y)
            moved["to_card"] += y.nbytes

    @mx.operator.register("op_set_softmax")
    class NumpySoftmaxProp(mx.operator.CustomOpProp):
        def __init__(self):
            super().__init__(need_top_grad=False)

        def list_arguments(self):
            return ["data", "label"]

        def infer_shape(self, in_shape):
            return in_shape, [in_shape[0]], []

        def create_operator(self, ctx, in_shapes, in_dtypes):
            return NumpySoftmax()


def _opset_custom(mx):
    """(c) the numpy softmax Custom op over (2048, 128256) f32 logits
    under record, against mx.nd.softmax and SoftmaxOutput's gradient;
    a hybridized Custom on the card raises."""
    import torch
    from mxtpu_torch.models import llama
    moved = {"to_host": 0, "to_card": 0}
    _numpy_softmax_op(mx, moved)
    vocab = llama.CONFIGS["llama3_8b"].vocab_size
    gen = torch.Generator(device="cuda").manual_seed(SEED + 22)
    x = mx.nd.NDArray(torch.randn(EMBED_TOKENS, vocab, generator=gen,
                                  device="cuda") * 2.0)
    label = mx.nd.NDArray(torch.randint(0, vocab, (EMBED_TOKENS,),
                                        generator=gen, device="cuda")
                          .to(torch.float32))
    x.attach_grad()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with mx.autograd.record():
        y = mx.nd.Custom(x, label, op_type="op_set_softmax")
    y.wait_to_read()
    fwd_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    y.backward()
    x.grad.wait_to_read()
    bwd_s = time.perf_counter() - t0
    want = mx.nd.softmax(x)
    out_rel = ((y._data - want._data).abs().max()
               / want._data.abs().max()).item()
    x2 = mx.nd.NDArray(x._data.clone())
    x2.attach_grad()
    with mx.autograd.record():
        so = mx.nd.SoftmaxOutput(x2, label)
    so.backward()
    grad_rel = ((x.grad._data - x2.grad._data).abs().max()
                / x2.grad._data.abs().max()).item()

    class Net(mx.gluon.HybridBlock):
        def hybrid_forward(self, F, a, b):
            return F.Custom(a, b, op_type="op_set_softmax")
    net = Net()
    net.initialize(ctx=mx.gpu())
    net.hybridize()
    raised = ""
    try:
        net(mx.nd.NDArray(x._data[:4, :16].clone()),
            mx.nd.NDArray(label._data[:4].remainder(16)))
    except mx.MXNetError as e:
        raised = str(e)
    row = {"shape": list(x.shape), "forward_s": fwd_s, "backward_s": bwd_s,
           "bytes_to_host": moved["to_host"],
           "bytes_to_card": moved["to_card"], "out_rel": out_rel,
           "grad_rel": grad_rel, "hybridized_raises": raised}
    if out_rel > SOFTMAX_REL or grad_rel > SOFTMAX_REL or not (
            "op_set_softmax" in raised and "un-hybridized" in raised):
        raise AssertionError(f"op_set custom: {row}")
    del x, y, want, x2, so
    return row


def _first_node(qsym, op, pred=lambda n: True):
    return next(n for n in qsym._topo() if n.op == op and pred(n))


def _int8_layer_check(mx, qnet, x):
    """The stem's quantized conv, the first 3×3 one and the quantized
    FC on the first images of the batch: their card outputs against the
    same op on the CPU on the same inputs, bit for bit."""
    import torch
    qsym = qnet._sb_symbol
    params = {k: p.data() for k, p in qnet.collect_params().items()}
    stem = _first_node(qsym, "_contrib_quantized_conv")
    conv3 = _first_node(qsym, "_contrib_quantized_conv",
                        lambda n: tuple(n.attrs["kernel"]) == (3, 3))
    fc = _first_node(qsym, "_contrib_quantized_fully_connected")
    nodes = [stem, conv3, fc]
    feeds = [n.inputs[0][0].name for n in nodes[1:]]
    internals = qsym.get_internals()
    aux = set(qsym.list_auxiliary_states())
    ex = mx.sym.Group([internals[f] for f in feeds]).bind(
        mx.gpu(), {**{k: v for k, v in params.items() if k not in aux},
                   "data": x}, grad_req="null",
        aux_states={k: v for k, v in params.items() if k in aux})
    inputs = [x] + ex.forward(is_train=False)
    out = {}
    for node, inp in zip(nodes, inputs):
        fn = mx.nd.OP_REGISTRY[node.op]
        attrs = {k: v for k, v in node.attrs.items() if not k.startswith("__")}
        arrays = [inp] + [params[p.name] for p, _ in node.inputs[1:]]
        card = fn(*arrays, **attrs)._data
        cpu = fn(*[a.as_in_context("cpu") for a in arrays], **attrs)._data
        out[node.name] = {"shape": list(card.shape),
                          "bit_equal": torch.equal(card.cpu(), cpu)}
    return out


def _opset_int8(mx):
    """(d) quantize_net of the zoo's ResNet-50, naive calibration over 4
    batches of 64, then eval at batch 256: int8 img/s against the f32
    net's replay, three quantized layers bit for bit with the CPU, and
    the logits' distance."""
    import torch
    from mxtpu_torch.tools import int8_tolerance as it
    from mxtpu_torch.tools import timing
    net = it.resnet50(mx.gpu(), INT8_IMAGE)
    t0 = time.perf_counter()
    qnet = it.quantize(net, INT8_CALIB_BATCH, INT8_IMAGE, mx.gpu())
    quantize_s = time.perf_counter() - t0
    x = mx.nd.NDArray(torch.from_numpy(
        it.images(INT8_BATCH, INT8_IMAGE, 2)).cuda())
    with mx.autograd.predict_mode():
        want = net(x)
        got = qnet(x)
        rel = it.logits_rel(got, want)
        f32_ms = timing.time_ms(lambda: net(x), 3, warmup=1)
        int8_ms = timing.time_ms(lambda: qnet(x), 3, warmup=1)
        layers = _int8_layer_check(
            mx, qnet, mx.nd.NDArray(x._data[:INT8_LAYER_IMAGES].clone()))
    n_q = sum(n.op.startswith("_contrib_quantized") for n in
              qnet._sb_symbol._topo())
    row = {"batch": INT8_BATCH, "image": INT8_IMAGE,
           "calib": [4, INT8_CALIB_BATCH], "quantized_layers": n_q,
           "quantize_s": quantize_s, "f32_ms": f32_ms, "int8_ms": int8_ms,
           "f32_img_per_s": INT8_BATCH / f32_ms * 1e3,
           "int8_img_per_s": INT8_BATCH / int8_ms * 1e3,
           "logits_rel": rel, "logits_rel_bound": INT8_LOGITS_REL,
           "finite": bool(torch.isfinite(got._data).all().item()),
           "layers": layers,
           "route": "im2col + torch._int_mm (int32), CPU float64"}
    if not (row["finite"] and rel <= INT8_LOGITS_REL
            and all(v["bit_equal"] for v in layers.values())):
        raise AssertionError(f"op_set int8: {row}")
    del net, qnet, x, want, got
    return row


def _vision_inputs(gen):
    import torch
    r = functools.partial(torch.randn, generator=gen, device="cuda")
    a = r(8, 256, 48, 64)
    theta = torch.tensor([1.0, 0.0, 0.0, 0.0, 1.0, 0.0], device="cuda") \
        + 0.05 * r(32, 6)
    return {
        "Correlation": ([a, r(8, 256, 48, 64)],
                        {"kernel_size": 1, "max_displacement": 20,
                         "stride1": 1, "stride2": 2, "pad_size": 20}, 2),
        "GroupNorm": ([r(32, 256, 56, 56), 1.0 + 0.1 * r(256),
                       0.1 * r(256)], {"num_groups": 32}, 1),
        "DeformableConvolution": (
            [r(8, 256, 56, 56), r(8, 18, 56, 56),
             0.02 * r(256, 256, 3, 3), 0.1 * r(256)],
            {"kernel": (3, 3), "pad": (1, 1), "num_filter": 256}, 2),
        "BilinearSampler": ([r(32, 256, 56, 56), theta], {}, 2),
    }


def _vision_run(mx, name, arrays, kw, n_grad, sample=None):
    """Forward and backward of one op: (output, input grads). For
    BilinearSampler the second input is theta, made into an affine grid
    by GridGenerator on the tape."""
    import torch
    xs = [mx.nd.NDArray(a.clone()) for a in arrays]
    for x in xs[:n_grad]:
        x.attach_grad()
    with mx.autograd.record():
        if name == "BilinearSampler":
            grid = mx.nd.GridGenerator(xs[1], transform_type="affine",
                                       target_shape=xs[0].shape[2:])
            y = mx.nd.BilinearSampler(xs[0], grid)
        else:
            y = getattr(mx.nd, name)(*xs, **kw)
    gen = torch.Generator(device=y._data.device).manual_seed(SEED + 24)
    head = torch.randn(y.shape, generator=gen, device=y._data.device) \
        if sample is None else sample
    y.backward(mx.nd.NDArray(head))
    return y._data, [x.grad._data for x in xs[:n_grad]], head


def _opset_vision(mx):
    """(e) four vision ops at published widths: forward and backward
    on the card, image 0 against the CPU, device ms."""
    import torch
    from mxtpu_torch.tools import timing
    gen = torch.Generator(device="cuda").manual_seed(SEED + 23)
    rows = {}
    for name, (arrays, kw, n_grad) in _vision_inputs(gen).items():
        y, grads, head = _vision_run(mx, name, arrays, kw, n_grad)
        y2, grads2, _ = _vision_run(mx, name, arrays, kw, n_grad, head)
        one = [a[:1].cpu() if a.ndim and a.shape[0] == arrays[0].shape[0]
               else a.cpu() for a in arrays]
        cy, cgrads, _ = _vision_run(mx, name, one, kw, n_grad,
                                    head[:1].cpu())
        errs = {"out": ((y[:1].cpu() - cy).abs().max()
                        / cy.abs().max()).item()}
        for i, (g, cg) in enumerate(zip(grads, cgrads)):
            if g.shape[0] == arrays[0].shape[0]:
                errs[f"grad{i}"] = ((g[:1].cpu() - cg).abs().max()
                                    / cg.abs().max()).item()
        xs = [mx.nd.NDArray(a) for a in arrays]
        if name == "BilinearSampler":
            grid = mx.nd.GridGenerator(xs[1], transform_type="affine",
                                       target_shape=xs[0].shape[2:])
            fwd = functools.partial(mx.nd.BilinearSampler, xs[0], grid)
        else:
            fwd = functools.partial(getattr(mx.nd, name), *xs, **kw)
        fwd_ms = timing.time_ms(fwd, 3, warmup=1)
        both_ms = timing.time_ms(
            lambda: _vision_run(mx, name, arrays, kw, n_grad, head), 2,
            warmup=1)
        rows[name] = {"shape": list(arrays[0].shape), "out": list(y.shape),
                      "rel_err": errs, "fwd_ms": fwd_ms,
                      "fwd_bwd_ms": both_ms,
                      "bwd_bit_equal": all(torch.equal(a, b) for a, b in
                                           zip(grads, grads2))}
        del y, y2, grads, grads2
    bad = {k: r["rel_err"] for k, r in rows.items()
           if max(r["rel_err"].values()) > VISION_REL}
    if bad:
        raise AssertionError(f"op_set vision beyond {VISION_REL}: {bad}")
    return rows


def op_set_phase():
    """20 in the docstring: the rest of the op set at published widths."""
    import torch
    import mxtpu_torch as mx
    import mxtpu_torch.contrib.quantization  # noqa: F401
    reset_launches()
    t0 = time.perf_counter()
    parts = {}
    for key, part in (("updates", _opset_updates), ("sparse", _opset_sparse),
                      ("custom", _opset_custom), ("int8", _opset_int8),
                      ("vision", _opset_vision)):
        t1 = time.perf_counter()
        parts[key] = part(mx)
        parts[key + "_seconds"] = time.perf_counter() - t1
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    launches = read_launches()
    emit({"phase": "op_set", "card": nvidia_smi(), **parts,
          "seconds": time.perf_counter() - t0, "launches": launches})
    if launches != only():
        raise AssertionError(f"op_set launched {launches}")
    return launches


# ---------------------------------------------------------------------------
# np_runtime: mx.np and mx.npx, mx.profiler, mx.engine, mx.runtime,
# mx.util, mx.test_utils and mx.context (ROADMAP item 10.4(c))
# ---------------------------------------------------------------------------
NP_TABLE_SHAPE = (4096, 4096)  # (b) each category's array
NP_LINALG_N = 1024             # (b) solve, qr, svd, eigh: the CPU's LAPACK
NP_RANDOM_SHAPE = (14336, 4096)   # (c) llama3_8b's FFN weight
NP_BETA_N = 2 ** 20
NP_CHOICE_N = 128256           # (c) llama3's vocabulary
NP_CHOICE_SIZE = (32, 4)
NP_MULTINOMIAL_N = 100
NP_LINALG_REL = {"float32": 1e-3, "float64": 1e-10}   # residuals, of ||A||
NP_CUMSUM_ATOL = {"float32": 1e-2, "float64": 1e-9}
NAN_OP = "broadcast_div"       # the op the sanitizer must name in (e)


def np_profiler_phase(cfg, params, tokens):
    """(d) of ``np_runtime``: ``GluonLlama`` eager over the slice's tree
    under ``mx.profiler``: the chrome trace's flash forward kernel
    events against the launch counter, their summed device time, the
    aggregate's counts against the dispatches counted by a wrapper of
    ``autograd.invoke``, a paused region that adds nothing, and the
    eager forward's host time with and without the aggregate's hook."""
    import torch
    import mxtpu_torch as mx
    from mxtpu_torch import autograd, profiler
    from mxtpu_torch.gluon.model_zoo import GluonLlama
    from mxtpu_torch.ndarray import ndarray as nd_mod
    net = GluonLlama(cfg)
    net.collect_params().setattr("grad_req", "null")
    net.load_pytree(params)
    tok = mx.nd.NDArray(tokens)
    out_dir = os.path.join(build_dir(), "np_profiler")
    shutil.rmtree(out_dir, ignore_errors=True)
    profiler.set_config(filename=os.path.join(out_dir, "llama.json"))
    counted = {}
    invoke = autograd.invoke

    def counting(raw_fn, arrays, parents, name="", *a, **kw):
        counted[name] = counted.get(name, 0) + 1
        return invoke(raw_fn, arrays, parents, name, *a, **kw)
    total = {k: 0 for k in LAUNCH_COUNTERS}

    def add(launches):
        for k in LAUNCH_COUNTERS:
            total[k] += launches[k]
    net(tok).wait_to_read()             # the aggregate sees a warm call
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    reset_launches()
    autograd.invoke = counting
    try:
        profiler.start()
        net(tok).wait_to_read()
        torch.cuda.synchronize()
        profiler.stop()
    finally:
        autograd.invoke = invoke
    traced = read_launches()
    add(traced)
    trace = profiler.last_trace()
    with open(trace) as f:
        events = json.load(f)["traceEvents"]
    flash = [e for e in events if e.get("cat") == "kernel"
             and "flash_fwd_kernel" in e.get("name", "")]
    agg = json.loads(profiler.dumps(format="json"))
    agg_counts = {k: v["count"] for k, v in agg.items()}
    # a paused region adds nothing to the aggregate (a new trace runs)
    reset_launches()
    profiler.resume()
    profiler.pause()
    net(tok).wait_to_read()
    profiler.resume()
    profiler.stop()
    add(read_launches())
    after_pause = {k: v["count"] for k, v in json.loads(
        profiler.dumps(format="json", reset=True)).items()}
    # the hook's cost: the eager forward's host time (the call's return,
    # from an idle card), hook off / on alternately, medians of 3 each
    host = {"off": [], "on": []}
    reset_launches()
    for _ in range(3):
        for label, hook in (("off", None), ("on", profiler._hook)):
            nd_mod._profile_hook = hook
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            y = net(tok)
            host[label].append((time.perf_counter() - t1) * 1e3)
            y.wait_to_read()
    nd_mod._profile_hook = None
    host = {k: {"median_ms": sorted(v)[1], "all_ms": v}
            for k, v in host.items()}
    profiler.dumps(reset=True)
    add(read_launches())
    dev_ms = sum(e.get("dur", 0.0) for e in flash) / 1e3
    row = {"phase": "np_runtime_profiler", "card": nvidia_smi(),
           "config": "llama3_8b", "n_layers": cfg.n_layers,
           "tokens": list(tokens.shape), "trace": os.path.relpath(trace),
           "trace_bytes": os.path.getsize(trace),
           "kernel_events": sum(1 for e in events
                                if e.get("cat") == "kernel"),
           "flash_fwd_events": len(flash),
           "flash_fwd_launches": traced["flash_attention_fwd"],
           "flash_fwd_device_ms": dev_ms,
           "flash_fwd_table_ms_x_layers": 0.0806 * cfg.n_layers,
           "aggregate": agg_counts, "dispatches_counted": counted,
           "aggregate_after_pause": after_pause,
           "forward_host_ms": host,
           "seconds": time.perf_counter() - t0, "launches": total}
    emit(row)
    n = cfg.n_layers
    if traced != only(flash_attention_fwd=n) or len(flash) != n:
        raise AssertionError(f"np_runtime profiler: {len(flash)} flash "
                             f"forward events in the trace, launches "
                             f"{traced}, not {n}")
    if agg_counts != counted or not counted:
        raise AssertionError(f"np_runtime profiler: aggregate {agg_counts}"
                             f" is not the dispatches made, {counted}")
    if after_pause != agg_counts:
        raise AssertionError(f"np_runtime profiler: a paused region moved "
                             f"the aggregate to {after_pause}")
    shutil.rmtree(out_dir, ignore_errors=True)
    del net
    return total


def _np_ffn(mx, x, wg, wu, wd):
    """llama's SwiGLU FFN written in mx.np calls only."""
    np_ = mx.np
    g = np_.matmul(x, wg)
    silu = g * np_.reciprocal(1 + np_.exp(-g))
    return np_.matmul(silu * np_.matmul(x, wu), wd)


def _nd_ffn(mx, x, wg, wu, wd):
    g = mx.nd.dot(x, wg)
    silu = g * (1 / (1 + mx.nd.exp(-g)))
    return mx.nd.dot(silu * mx.nd.dot(x, wu), wd)


def _np_ffn_part(mx):
    """(a) llama3_8b's FFN through mx.np against llama._ffn, and the same
    function through mx.nd, timed."""
    import torch
    from mxtpu_torch.models import llama
    from mxtpu_torch.tools.timing import host_ms, time_ms
    cfg = llama.CONFIGS["llama3_8b"]
    dim, hidden, n = cfg.dim, cfg.hidden_dim, FFN_TOKENS
    gen = torch.Generator(device="cuda").manual_seed(SEED + 23)

    def rand(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device="cuda")
                * scale).to(torch.bfloat16)
    xt, wgt = rand(n, dim), rand(dim, hidden, scale=dim ** -0.5)
    wut, wdt = rand(dim, hidden, scale=dim ** -0.5), rand(
        hidden, dim, scale=hidden ** -0.5)
    npa = [mx.np.array(t) for t in (xt, wgt, wut, wdt)]
    nda = [mx.nd.array(t, ctx=mx.gpu()) for t in (xt, wgt, wut, wdt)]
    y = _np_ffn(mx, *npa)
    ref = llama._ffn(cfg, {"w_gate": wgt, "w_up": wut, "w_down": wdt},
                     xt)[0]
    rel = rel_dist(y._data, ref)
    ynd = _nd_ffn(mx, *nda)
    times = {}
    for name, f in (("np", lambda: _np_ffn(mx, *npa)),
                    ("nd", lambda: _nd_ffn(mx, *nda)),
                    ("np_again", lambda: _np_ffn(mx, *npa)),
                    ("nd_again", lambda: _nd_ffn(mx, *nda))):
        times[name] = {"ms": time_ms(f, 5), "host_ms": host_ms(f, 5)}
    row = {"tokens": n, "dim": dim, "hidden": hidden,
           "dtype": str(y.dtype), "class": type(y).__name__,
           "finite": bool(torch.isfinite(y._data).all()),
           "rel_vs_llama_ffn": rel, "bound": FFN_REL_BOUND,
           "rel_nd_vs_np": rel_dist(ynd._data, y._data),
           "flop": 6 * n * dim * hidden, "times": times}
    ok = (row["finite"] and rel <= FFN_REL_BOUND
          and isinstance(y, mx.np.ndarray) and y.dtype == torch.bfloat16
          and tuple(y.shape) == (n, dim))
    return row, ok


def _np_table_part(mx):
    """(b) one case per category on the card against the port on the
    CPU (``test_utils.check_consistency`` over [cpu, gpu]); exact results
    bit-equal, linalg by its invariants on each device."""
    import torch
    tu = mx.test_utils
    rs = np.random.default_rng(SEED + 23)
    rows, bad = {}, []
    for dt in ("float32", "float64"):
        x = rs.standard_normal(NP_TABLE_SHAPE).astype(dt)
        y = rs.standard_normal(NP_TABLE_SHAPE).astype(dt)
        xn = x.copy()
        xn[rs.random(NP_TABLE_SHAPE) < 0.01] = np.nan

        def arr(v, ctx, dt=dt):
            return mx.np.array(v, dtype=v.dtype.name, ctx=ctx)
        exact = dict(rtol=0, atol=0)
        cases = {
            "unary_exp": (lambda a: mx.np.exp(a), [x], {}),
            "binary_arctan2": (lambda a, b: mx.np.arctan2(a, b), [x, y], {}),
            "reduce_sum_std": (lambda a: (mx.np.sum(a, axis=1),
                                          mx.np.std(a, axis=0)), [x], {}),
            "reduce_nan": (lambda a: (mx.np.nanmean(a, axis=1),
                                      mx.np.nanmax(a, axis=0),
                                      mx.np.nanstd(a)), [xn], {}),
            "sort": (lambda a: (mx.np.sort(a, axis=1),
                                mx.np.argsort(a, axis=0)), [x], exact),
            "unique": (lambda a: mx.np.unique(mx.np.round(a * 8),
                                              return_counts=True,
                                              return_index=True), [x],
                       exact),
            "cumsum": (lambda a: mx.np.cumsum(a, axis=1), [x],
                       dict(rtol=1e-3, atol=NP_CUMSUM_ATOL[dt])),
            "fft_rfft2": (lambda a: mx.np.fft.rfft2(a), [x],
                          dict(rtol=1e-3, atol=1e-2 if dt == "float32"
                               else 1e-8)),
            "einsum": (lambda a, b: mx.np.einsum("ij,jk->ik", a, b), [x, y],
                       dict(rtol=1e-3, atol=1e-2 if dt == "float32"
                            else 1e-9)),
            "mask_read": (lambda a: a[a > 0.5], [x], exact),
            "mask_write": (lambda a: _mask_write(mx, a), [x], exact),
        }
        for name, (f, ins, kw) in cases.items():
            t0 = time.perf_counter()
            try:
                tu.check_consistency(f, ins, ctx_list=[mx.cpu(), mx.gpu()],
                                     array_fn=arr, **kw)
                ok = True
            except AssertionError as e:
                ok, kw = False, {**kw, "error": str(e)[:300]}
            rows[f"{name}_{dt}"] = {"ok": ok, "seconds":
                                    time.perf_counter() - t0,
                                    **{k: v for k, v in kw.items()}}
            if not ok:
                bad.append(f"{name}_{dt}")
        lin = _np_linalg_invariants(mx, rs, dt)
        rows[f"linalg_{dt}"] = lin
        if not lin["ok"]:
            bad.append(f"linalg_{dt}")
        torch.cuda.empty_cache()
    return rows, not bad


def _mask_write(mx, a):
    b = a.copy()
    b[b < -0.5] = 0.0
    return b


def _np_linalg_invariants(mx, rs, dt):
    """solve, qr, svd and eigh on each device, each held by its
    residual (of ||A||), and the singular values and eigenvalues card
    against CPU."""
    n = NP_LINALG_N
    a = rs.standard_normal((n, n)).astype(dt) + n ** 0.5 * np.eye(n,
                                                                  dtype=dt)
    b = rs.standard_normal((n, 8)).astype(dt)
    s = a @ a.T
    res, vals = {}, {}
    for key, ctx in (("cpu", mx.cpu()), ("gpu", mx.gpu())):
        A, B, S = (mx.np.array(v, dtype=dt, ctx=ctx) for v in (a, b, s))
        t0 = time.perf_counter()
        norm = float(mx.np.linalg.norm(A))
        snorm = float(mx.np.linalg.norm(S))
        xs = mx.np.linalg.solve(A, B)
        q, r = mx.np.linalg.qr(A)
        u, sv, vh = mx.np.linalg.svd(A, full_matrices=False)
        w, v = mx.np.linalg.eigh(S)
        res[key] = {
            "solve": float(mx.np.linalg.norm(A @ xs - B)) / norm,
            "qr": float(mx.np.linalg.norm(q @ r - A)) / norm,
            "svd": float(mx.np.linalg.norm((u * sv) @ vh - A)) / norm,
            "eigh": float(mx.np.linalg.norm(S @ v - v * w)) / snorm,
            "seconds": time.perf_counter() - t0}
        vals[key] = (sv.asnumpy().astype(np.float64),
                     w.asnumpy().astype(np.float64))
    bound = NP_LINALG_REL[dt]
    sv_rel = float(np.abs(vals["gpu"][0] - vals["cpu"][0]).max()
                   / vals["cpu"][0].max())
    w_rel = float(np.abs(vals["gpu"][1] - vals["cpu"][1]).max()
                  / np.abs(vals["cpu"][1]).max())
    ok = all(v <= bound for d in res.values()
             for k, v in d.items() if k != "seconds") and \
        sv_rel <= bound and w_rel <= bound
    return {"n": n, "residuals": res, "svals_rel": sv_rel,
            "eigvals_rel": w_rel, "bound": bound, "ok": ok}


def _np_random_part(mx):
    """(c) mx.np.random at the FFN weight's shape: the card's draws
    against the CPU's after the same seed (the first RANDOM_CHECK
    elements of uniform and normal, the row permutation, beta at
    RANDOM_CHECK, choice, multinomial), and moments."""
    import scipy.stats
    import torch
    from mxtpu_torch import prng
    r = mx.np.random
    gen = torch.Generator(device="cuda").manual_seed(SEED + 24)
    p = torch.softmax(torch.randn(NP_CHOICE_N, generator=gen,
                                  device="cuda", dtype=torch.float64) * 2, 0)
    rows_h = np.arange(NP_RANDOM_SHAPE[0], dtype=np.float32)[:, None]

    def draws(ctx, big, beta_n, width):
        pv = mx.np.array(p, ctx=ctx)
        rows = mx.np.array(np.broadcast_to(rows_h, (len(rows_h), width)),
                           ctx=ctx)
        with ctx:
            out = {"uniform": r.uniform(size=big),
                   "normal": r.normal(size=big)}
            r.shuffle(rows)
            out["shuffle"] = rows[:, 0]
            out["beta"] = r.beta(2.0, 5.0, size=beta_n)
            out["beta_check"] = r.beta(2.0, 5.0, size=RANDOM_CHECK)
            for rep in (True, False):
                tag = "replace" if rep else "no_replace"
                out[f"choice_{tag}"] = r.choice(NP_CHOICE_N,
                                                NP_CHOICE_SIZE, rep)
                out[f"choice_p_{tag}"] = r.choice(NP_CHOICE_N,
                                                  NP_CHOICE_SIZE, rep, pv)
            out["multinomial"] = r.multinomial(NP_MULTINOMIAL_N, pv)
        return out
    order = ["uniform", "normal", "shuffle", "beta", "beta_check",
             "choice_replace", "choice_p_replace", "choice_no_replace",
             "choice_p_no_replace", "multinomial"]
    t0 = time.perf_counter()
    r.seed(SEED)
    card = draws(mx.gpu(), NP_RANDOM_SHAPE, NP_BETA_N, NP_RANDOM_SHAPE[1])
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    r.seed(SEED)
    cpu = draws(mx.cpu(), (RANDOM_CHECK // NP_RANDOM_SHAPE[1] or 1,
                           NP_RANDOM_SHAPE[1]), RANDOM_CHECK, 1)
    vs = {}
    for name in ("uniform", "normal"):
        got = card[name]._data.reshape(-1)[:RANDOM_CHECK].cpu()
        want = cpu[name]._data.reshape(-1)[:RANDOM_CHECK]
        u = _f32_ulps(got, want)
        vs[name] = {"max_ulps": u.max().item(),
                    "ok": u.max().item() <= (2 if name == "normal" else 0)}
    vs["shuffle"] = {"ok": bool(torch.equal(card["shuffle"]._data.cpu(),
                                            cpu["shuffle"]._data))}
    # beta: parts only where one of its gammas parts at a near-tie
    key = _np_chain_key(prng, order, "beta_check")
    k1, k2 = prng.split(key) # noqa: MXL301 — a check's seeded chain root, compared with the engine's
    _, m1 = prng.gamma(k1, 2.0, (RANDOM_CHECK,), margins=True)
    _, m2 = prng.gamma(k2, 5.0, (RANDOM_CHECK,), margins=True)
    got, want = card["beta_check"]._data.cpu(), cpu["beta_check"]._data
    far = _f32_ulps(got, want) > 1
    near = torch.minimum(m1, m2)[far]
    vs["beta"] = {"parted": int(far.sum()), "margins": near.tolist()[:8],
                  "ok": bool((near <= NEAR_TIE_ULPS).all())}
    for name in order[5:]:
        vs[name] = {"ok": bool(torch.equal(card[name]._data.cpu(),
                                           cpu[name]._data))}
    pc = p.double()
    idx = torch.arange(NP_CHOICE_N, device=pc.device, dtype=torch.float64)
    e = (pc * idx).sum().item()
    var = (pc * (idx - e) ** 2).sum().item()
    mu4 = (pc * (idx - e) ** 4).sum().item()
    bm, bv, _, bk = scipy.stats.beta(2.0, 5.0).stats(moments="mvsk")
    stats = {
        "uniform": _moments_ok(card["uniform"]._data, 0.5, 1 / 12, 1 / 80),
        "normal": _moments_ok(card["normal"]._data, 0.0, 1.0, 3.0),
        "beta": _moments_ok(card["beta"]._data, float(bm), float(bv),
                            (float(bk) + 3) * float(bv) ** 2),
        "choice_p_replace": _moments_ok(card["choice_p_replace"]._data,
                                        e, var, mu4),
        "multinomial_total": {"ok": int(card["multinomial"]._data.sum())
                              == NP_MULTINOMIAL_N}}
    ok = all(v["ok"] for v in vs.values()) and \
        all(v["ok"] for v in stats.values())
    return {"shape": list(NP_RANDOM_SHAPE), "beta_n": NP_BETA_N,
            "choice": [NP_CHOICE_N, list(NP_CHOICE_SIZE)],
            "card_seconds": card_s, "vs_cpu": vs, "stats": stats}, ok


def _np_chain_key(prng, order, name):
    key = prng.PRNGKey(SEED, "cpu") # noqa: MXL301 — a check's seeded chain root, compared with the engine's
    for n in order:
        key, sub = prng.split(key) # noqa: MXL301 — a check's seeded chain root, compared with the engine's
        if n == name:
            return sub
    raise KeyError(name)


def _np_engine_part(mx):
    """(e) the NaN sanitizer on a hybridized bf16 Dense(14336,
    in_units=4096) + row normalisation (a captured CUDA graph in predict
    mode): a clean replay passes, a zero row's 0/0 raises naming the
    op, the flag off lets it through; the flag's cost on a clean replay;
    Features, num_gpus, the with-scope and get_gpu_memory."""
    import torch
    from mxtpu_torch import engine, runtime, util
    from mxtpu_torch.gluon import nn

    class Normalize(mx.gluon.HybridBlock):
        def hybrid_forward(self, F, x):
            return F.broadcast_div(x, F.norm(x, axis=1, keepdims=True))
    net = nn.HybridSequential()
    net.add(nn.Dense(14336, in_units=4096, use_bias=False,
                     dtype="bfloat16"), Normalize())
    mx.random.seed(SEED)
    net.initialize(ctx=mx.gpu())
    net.hybridize()
    gen = torch.Generator(device="cuda").manual_seed(SEED + 25)
    xt = torch.randn(FFN_TOKENS, 4096, generator=gen,
                     device="cuda").to(torch.bfloat16)
    x = mx.nd.NDArray(xt)
    zt = xt.clone()
    zt[7] = 0
    z = mx.nd.NDArray(zt)
    net(x).wait_to_read()
    net(x).wait_to_read()

    def replay_ms(flag, reps=10):
        secs = []
        with engine.debug_nans(flag):
            for _ in range(reps):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                net(x).wait_to_read()
                secs.append((time.perf_counter() - t0) * 1e3)
        return sorted(secs)[reps // 2]
    cost = {"off_ms": replay_ms(False), "on_ms": replay_ms(True),
            "off_again_ms": replay_ms(False), "on_again_ms": replay_ms(True)}
    with engine.debug_nans(True):
        clean = bool(torch.isfinite(net(x)._data).all())
        try:
            net(z).wait_to_read()
            named = None
        except FloatingPointError as e:
            named = str(e)
    through = net(z)._data
    let_through = bool(torch.isnan(through[7]).all()) and \
        bool(torch.isfinite(through[:7]).all())
    feats = runtime.Features()
    with mx.cpu():
        scoped = [mx.nd.array([1.0]).context, mx.np.zeros((2,)).context,
                  mx.np.random.uniform(size=(2,)).context]
    outside = [mx.nd.array([1.0]).context, mx.np.zeros((2,)).context]
    mem, info = util.get_gpu_memory(0), tuple(torch.cuda.mem_get_info(0))
    row = {"captures": net.captures, "clean_replay": clean,
           "nan_error": named, "flag_off_lets_nan_through": let_through,
           "flag_cost": cost,
           "features": {k: feats.is_enabled(k)
                        for k in ("CUDA", "CUDNN", "NCCL", "TPU",
                                  "IMAGE_CODEC", "DIST_KVSTORE")},
           "num_gpus": mx.num_gpus(),
           "scoped": [str(d) for d in scoped],
           "outside": [str(d) for d in outside],
           "tpu_is_card": mx.tpu() == torch.device("cuda", 0),
           "gpu_memory": list(mem), "mem_get_info": list(info)}
    ok = (net.captures == 1 and clean and named is not None
          and NAN_OP in named and let_through
          and all(row["features"][k] for k in ("CUDA", "CUDNN", "NCCL"))
          and row["num_gpus"] == torch.cuda.device_count()
          and all(d == torch.device("cpu") for d in scoped)
          and all(d == torch.device("cuda", 0) for d in outside)
          and row["tpu_is_card"] and mem == info)
    del net
    return row, ok


def np_runtime_phase():
    """21 in the docstring: mx.np/mx.npx, mx.np.random, mx.engine,
    mx.runtime, mx.util, mx.test_utils and mx.context on the card."""
    import torch
    import mxtpu_torch as mx
    reset_launches()
    t0 = time.perf_counter()
    parts, oks = {}, {}
    for key, part in (("ffn", _np_ffn_part), ("table", _np_table_part),
                      ("random", _np_random_part),
                      ("engine", _np_engine_part)):
        t1 = time.perf_counter()
        parts[key], oks[key] = part(mx)
        parts[key + "_seconds"] = time.perf_counter() - t1
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    launches = read_launches()
    emit({"phase": "np_runtime", "card": nvidia_smi(), **parts, "ok": oks,
          "seconds": time.perf_counter() - t0, "launches": launches})
    bad = [k for k, v in oks.items() if not v]
    if bad:
        raise AssertionError(f"np_runtime: {bad} failed their checks")
    if launches != only():
        raise AssertionError(f"np_runtime launched {launches}")
    return launches


# the contrib phase: the deployed GluonLlama (llama3_8b width, depth cut
# to 4 layers: a 3.9 GB archive) and the ONNX ResNet-50 round trip
CONTRIB_LAYERS, CONTRIB_TOKENS = 4, 2048
ONNX_BATCH = 256
ONNX_LOGITS_REL = 1e-5        # of max |logit|, the imported net's replay
# tensorboardX is not installed on the card's host (its package list,
# probed in a chip run), so contrib.summary is held on the CPU only


def contrib_phase():
    """22 in the docstring: contrib.deploy, contrib.onnx and lockcheck on
    the card."""
    import torch
    import mxtpu_torch as mx
    reset_launches()
    t0 = time.perf_counter()
    out_dir = os.path.join(build_dir(), "contrib")
    os.makedirs(out_dir, exist_ok=True)
    deploy = _contrib_deploy(mx, out_dir)
    _release_gateway()
    onnx = _contrib_onnx(mx, out_dir)
    _release_gateway()
    shutil.rmtree(out_dir, ignore_errors=True)
    lockcheck = _contrib_lockcheck()
    _release_gateway()
    launches = read_launches()
    emit({"phase": "contrib", "card": nvidia_smi(), "deploy": deploy,
          "onnx": onnx, "lockcheck": lockcheck,
          "summary": "held on the CPU: no tensorboardX on this host",
          "seconds": time.perf_counter() - t0, "launches": launches})
    if not (deploy["bit_equal"] or deploy["rel_max"] <= 2e-2):
        raise AssertionError(f"the deployed Llama's logits are off the "
                             f"Gluon forward's: {deploy}")
    if deploy["flash_nodes"] != CONTRIB_LAYERS or deploy["call_launches"] \
            != only(flash_attention_fwd=CONTRIB_LAYERS):
        raise AssertionError(f"the artifact does not launch the flash "
                             f"kernel once a layer: {deploy}")
    if not (onnx["rel_max"] <= ONNX_LOGITS_REL and onnx["captures"] == 1):
        raise AssertionError(f"the ONNX ResNet-50 is off the source net: "
                             f"{onnx}")
    if lockcheck["violations"] or not lockcheck["threaded"]["ok"]:
        raise AssertionError(f"lockcheck found violations or the threaded "
                             f"engines failed: {lockcheck}")
    return launches


def _contrib_deploy(mx, out_dir):
    """(a): export_stablehlo → deploy.load → a call, against the eager
    Gluon forward on the same weights."""
    import torch
    from mxtpu_torch.contrib import deploy
    from mxtpu_torch.gluon.model_zoo import GluonLlama
    from mxtpu_torch.models import llama
    from mxtpu_torch.tools.timing import time_ms
    cfg = replace(llama.CONFIGS["llama3_8b"], n_layers=CONTRIB_LAYERS,
                  param_dtype=torch.bfloat16)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    net = GluonLlama(cfg)
    net.load_pytree(llama.init_params(cfg, gen, device="cuda"))
    tokens = mx.nd.NDArray(torch.randint(
        0, cfg.vocab_size, (1, CONTRIB_TOKENS), generator=gen,
        device="cuda"))
    with mx.autograd.pause(train_mode=False):
        want = net(tokens)._data
    t1 = time.perf_counter()
    path = net.export_stablehlo(os.path.join(out_dir, "llama"), tokens)
    export_s = time.perf_counter() - t1
    size_gb = os.path.getsize(path) / 1e9
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    pred = deploy.load(path, ctx=mx.gpu())
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t1
    flash_nodes = sum(
        1 for n in pred._program.graph.nodes
        if n.op == "call_function"
        and n.target is torch.ops.mxtpu_torch.flash_attn_fwd.default)
    graph_ops = sorted({str(n.target) for n in pred._program.graph.nodes
                        if n.op == "call_function"})
    before = read_launches()
    got = pred(tokens)._data
    torch.cuda.synchronize()
    after = read_launches()
    call_launches = {k: after[k] - before[k] for k in LAUNCH_COUNTERS}
    top = float(want.float().abs().max())
    row = {"config": "llama3_8b", "layers": CONTRIB_LAYERS,
           "tokens": CONTRIB_TOKENS, "export_s": export_s,
           "archive_gb": size_gb, "load_s": load_s,
           "flash_nodes": flash_nodes, "call_launches": call_launches,
           "bit_equal": bool(torch.equal(got, want)),
           "rel_max": float((got.float() - want.float()).abs().max()) / top,
           "graph_ops": graph_ops}
    with mx.autograd.pause(train_mode=False):
        row["gluon_ms"] = time_ms(lambda: net(tokens), reps=5)
    row["artifact_ms"] = time_ms(lambda: pred(tokens), reps=5)
    del pred, net, got, want
    return row


def _contrib_onnx(mx, out_dir):
    """(b): the zoo's ResNet-50 through ONNX and back, on the card."""
    import torch
    from mxtpu_torch.contrib import onnx
    from mxtpu_torch.tools.timing import time_ms
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    images = mx.nd.NDArray(torch.randn((ONNX_BATCH, 3, 224, 224),
                                       generator=gen, device="cuda"))
    mx.random.seed(SEED)
    net = mx.gluon.model_zoo.vision.get_model("resnet50_v1")
    net.initialize(mx.initializer.Xavier(magnitude=2), ctx=mx.gpu())
    with mx.autograd.pause(train_mode=False):
        want = net(images)._data          # eager: resolves the shapes
    path = os.path.join(out_dir, "resnet50_v1.onnx")
    t1 = time.perf_counter()
    onnx.export_model(net, input_shapes=[tuple(images.shape)],
                      onnx_file=path)
    export_s = time.perf_counter() - t1
    t1 = time.perf_counter()
    block = onnx.import_to_gluon(path, ctx=mx.gpu())
    import_s = time.perf_counter() - t1
    block.hybridize()
    with mx.autograd.pause(train_mode=False):
        block(images)                     # the eager first call
        block(images)                     # the capture
        got = block(images)._data         # a replay
        torch.cuda.synchronize()
        ms = time_ms(lambda: block(images), reps=5, warmup=1)
    top = float(want.abs().max())
    row = {"config": "resnet50_v1", "batch": ONNX_BATCH,
           "file_mb": os.path.getsize(path) / 1e6, "export_s": export_s,
           "import_s": import_s, "captures": block.captures,
           "bit_equal": bool(torch.equal(got, want)),
           "rel_max": float((got - want).abs().max()) / top,
           "bound": ONNX_LOGITS_REL, "replay_ms": ms,
           "img_per_s": ONNX_BATCH / (ms / 1e3)}
    del block, net, got, want, images
    return row


def _contrib_lockcheck():
    """(c): the serve_engine phase's threaded engines under lockcheck, on
    4 f32 layers of seeded llama3_8b weights."""
    import torch
    from mxtpu_torch.contrib.analysis import lockcheck
    from mxtpu_torch.models import llama
    cfg4 = replace(llama.CONFIGS["llama3_8b"], n_layers=SERVE_LAYERS,
                   dtype=torch.float32, param_dtype=torch.float32)
    p4 = llama.init_params(cfg4, torch.Generator(device="cuda")
                           .manual_seed(SEED), device="cuda")
    lockcheck.install()
    try:
        lockcheck.reset()
        threaded = engines_on_threads(cfg4, p4)
        pairs = lockcheck.observed_pairs()
        found = lockcheck.violations()
    finally:
        lockcheck.uninstall()
        lockcheck.reset()
    del p4
    return {"threaded": threaded, "violations": found,
            "observed_pairs": sorted(f"{a} -> {b}" for a, b in pairs)}


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card is visible", file=sys.stderr)
        return 1
    import mxtpu_torch  # noqa: F401  (fails when run outside the repo)
    from mxtpu_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi()
    emit({"phase": "card", "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32,
          "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32})
    _build.load_kernels()
    info = _build.build_info()
    report = kernel_report(info)
    emit({"phase": "build", "built": info["built"],
          "seconds": info["seconds"], "path": info["path"], **report,
          "ptxas": [ln.strip() for ln in str(info["ptxas"]).splitlines()
                    if any(w in ln for w in ("entry function", "registers",
                                             "spill", "wgmma",
                                             "setmaxnreg"))]})
    lacking = [f"{k} {v}" for k, per in report.items()
               for v, r in per.items()
               if not (r["HGMMA"] and r["UTMALDG"])
               or (k == "conv3x3" and r["STL"])]
    if lacking:
        raise AssertionError(f"the SASS of {lacking} lacks wgmma or TMA "
                             f"loads, or a conv3x3 spills: {report}")

    rows = {r["shape"]: r for r in kernel_phase()}
    bwd_rows = {r["shape"]: r for r in kernel_bwd_phase()}
    conv_rows = {r["shape"]: r for r in kernel_conv_phase()}
    rtc_rows = {(r["kernel"], r["shape"]): r for r in kernel_rtc_phase()}
    rng_phase()
    torch.cuda.empty_cache()
    fwd_launches = slice_phase()
    _release_gateway()        # what the serving tier's cycles still hold
    train_launches = train_phase()
    torch.cuda.empty_cache()
    mesh_launches = mesh_phase()
    torch.cuda.empty_cache()
    flywheel_launches = flywheel_phase()
    _release_gateway()
    resnet_launches = resnet_phase()
    probe_launches = experiment_probe2_phase()
    frontend_launches = frontend_phase()
    random_launches = nd_random_phase()
    serde_launches = serde_phase()
    torch.cuda.empty_cache()
    mixtral_launches = mixtral_phase()
    bert_launches = bert_phase()
    torch.cuda.empty_cache()
    gluon_launches = gluon_phase()
    torch.cuda.empty_cache()
    symbol_launches = symbol_module_phase()
    torch.cuda.empty_cache()
    image_launches = image_record_phase()
    torch.cuda.empty_cache()
    op_set_launches = op_set_phase()
    torch.cuda.empty_cache()
    np_launches = np_runtime_phase()
    torch.cuda.empty_cache()
    contrib_launches = contrib_phase()
    telemetry_phase()
    launches = {k: fwd_launches[k] + train_launches[k]
                + mesh_launches[k] + flywheel_launches[k] + resnet_launches[k]
                + probe_launches[k] + frontend_launches[k]
                + random_launches[k] + serde_launches[k]
                + mixtral_launches[k] + bert_launches[k]
                + gluon_launches[k] + symbol_launches[k]
                + image_launches[k] + op_set_launches[k] + np_launches[k]
                + contrib_launches[k]
                for k in LAUNCH_COUNTERS}

    main_row, bwd = rows["llama3_8b"], bwd_rows["llama3_8b"]
    conv = conv_rows["experiment"]
    bwd_src = "mxtpu_torch/ops/csrc/flash_attn_bwd.cu"
    pallas = "jax/experimental/pallas/ops/tpu/flash_attention.py"
    emit({"kernels": [{
        "name": "flash_attention_fwd", "route": "cuda",
        "source": "mxtpu_torch/ops/csrc/flash_attn_fwd.cu",
        "replaces": "mxtpu/ops/attention.py:157",
        "launches": launches["flash_attention_fwd"],
        "max_abs_err": max(r["max_abs_err"] for r in rows.values()),
        "ms": main_row["kernel_ms"], "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"],
        "bound_by": main_row["bound_by"],
        "library_ms": main_row["library_ms"]}, {
        "name": "flash_attention_bwd_dkv", "route": "cuda",
        "source": bwd_src, "replaces": f"{pallas}:1121",
        "launches": launches["flash_attention_bwd_dkv"],
        "max_abs_err": max(max(r["max_abs_err"]["dk"], r["max_abs_err"]["dv"])
                           for r in bwd_rows.values()),
        "ms": bwd["dkv_ms"], "plain_ms": bwd["plain_ms"],
        "bound_ms": bwd["dkv_bound_ms"], "bound_by": bwd["dkv_bound_by"],
        "library_ms": bwd["library_ms"]}, {
        "name": "flash_attention_bwd_dq", "route": "cuda",
        "source": bwd_src, "replaces": f"{pallas}:1456",
        "launches": launches["flash_attention_bwd_dq"],
        "max_abs_err": max(r["max_abs_err"]["dq"] for r in bwd_rows.values()),
        "ms": bwd["dq_ms"], "plain_ms": bwd["plain_ms"],
        "bound_ms": bwd["dq_bound_ms"], "bound_by": bwd["dq_bound_by"],
        "library_ms": bwd["library_ms"]}, {
        "name": "conv3x3", "route": "cuda",
        "source": "mxtpu_torch/ops/csrc/conv3x3.cu",
        "replaces": "benchmark/resnet_shape_experiment.py:80",
        "launches": launches["conv3x3_kernel"],
        "max_abs_err": max(r["max_abs_err"] for r in conv_rows.values()),
        "ms": conv["kernel_ms"], "plain_ms": conv["plain_ms"],
        "bound_ms": conv["bound_ms"], "bound_by": conv["bound_by"],
        "library_ms": conv["library_ms"]}] + rtc_kernel_rows(rtc_rows,
                                                            launches)})
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
