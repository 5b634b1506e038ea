#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--group all|serving|training|gang|device]

Builds every kernel of the port's serving and training paths from the
sources in the checkout, then runs seventy-one phases; any failure
exits non-zero.  ``--group`` (default ``all``, every phase in the order
below, but 69-71, which run right after the build; 52-54, 58, 60 and 62,
which run right after 10, before any gang starts, so that they time the
card or read its memory with no other process on it; 66-68, which run
right after 50 in the gangs of 49-50; 51; then 55-57, 59, 61 and 63 in
the gangs they share; and 64 and 65, which run at the same time; a bare
call runs them so) runs phases 1 and the build, then only the serving
phases (2-7, 11-40), the training phases (8-10, 41-63, 66-68), the gang
phases (64-65) or the device layer, the control plane and the gateway
(69-71), and prints no per-kernel record; each phase's seconds are
printed after it as ``[phase_name N s]``.  Gangs of ranks boot while other work runs (``Gang.start()``):
the four of 42-44 and the two, four and eight of 49-50 and 66-68
beside 36-40, the two and four of 55, 59, 61 and 63 beside 42-44, all
idle through 45-48; one gang serves several meshes by laying its world
out anew (``remesh``).  The worker runs that phases 40, 44, 51 and 69
expect refused (one card; a card the host lacks) start right after
phase 1 and boot beside the build, as do phase 70's pod, which its
extender binds right after phase 1 and whose worker waits for the
build before it serves, and phase 71's replica, which serves only once
phase 70's worker has exited:

1. device: the card's name and power limit, TF32 off;
2. K1 (paged decode attention, ``ops/csrc/paged_attention.cu``: the
   split walk, then the merge) against its plain PyTorch version at the
   serving path's shapes (8 slots, 32 heads, head_dim 128, page 128, a
   shuffled table, ragged lengths including 0, 1, 127, 128 and a full
   table), in float32 (rtol=atol=2e-5) and bfloat16 (rtol=2^-7,
   atol=1e-5: both compute in f32 and round once to bf16, so they may
   differ by one rounding step); its split plan (pages a split, splits
   a table, live walk blocks, ring tiles and stages), its device time
   (launches captured in a CUDA graph), the plain version's time, its
   bandwidth bound and the share of it, and at the flagship the ratio
   to K2's 5-row walk to the same contexts; then the same at the
   worker's defaults' geometry (8 heads of 64, pages of 32, 36-page
   tables);
3. K2 (paged multi-query attention, the speculative verify, same
   source) at the verify's shapes (8 slots, a 5-row window, 32 heads,
   head_dim 128, page 128, a shuffled 9-page table, lengths whose windows
   cross page boundaries and reach the full table) against its plain
   version and the dense oracle at the same tolerances; its row j must
   equal K1 at lengths + j bit for bit (also for windows across the
   first and second split edges), and a 1-row window K1; its launch plan
   (rows per walk, ring tiles and their rows, shared bytes, the split),
   its time, K1's at the same widest contexts and the ratio of the two,
   the plain time and the bound; then the same at the worker's defaults'
   geometry with a 9-row window (``--spec-k 8``: two walks);
4. the serving path at the flagship's full width (vocab 32768, hidden
   4096, 4 layers, 32 heads, prompt 128, page 128, 8 slots, 16 requests
   per wave) in bfloat16 through the worker's entry point; K1 must have
   launched decode steps x layers times;
5. the same wave through the worker's ``--speculate --spec-k 4`` (a
   fresh 1-layer draft, hidden 1024): every budget met, K2 launched
   verify steps x layers times and K1 never;
6. card against CPU at float32 on a small model: first-step logits
   within rtol=atol=1e-4, and token streams identical wherever the CPU's
   top-2 logit margin exceeds 1e-3 (a closer call is printed as a
   near-tie);
7. speculation on the card at float32 on the same small model, k 2 and
   4, a hopeless and a perfect draft: pipelined and synchronous streams
   identical, streams equal to the card's plain streams under the
   near-tie rule, and the perfect draft needs fewer verify steps;
8. K3, K4, K5 and the backward's delta pre-pass (flash attention
   forward, dK/dV, dQ and rowsum(dO * O), ``ops/csrc/flash_attention.cu``)
   against their plain versions at the training path's shapes (b 16,
   s 1024, 32 heads of 128, causal) in float32 (out and lse
   rtol=atol=2e-5, gradients 1e-4) and bfloat16 (the tensor-core out and
   gradients within twice the error of the twins' bf16 emulation of p
   and ds, plus 1e-5, against the float32 twin, and within the
   emulation's element and 64-row block allowances; lse 2e-5), and at two
   small shapes (causal over an uneven 1000 rows; non-causal 640 queries
   over 1024 keys); the bf16 K3, K4 and K5 must hold HGMMA instructions
   of both forms, operands from shared memory and A from registers
   (``cuobjdump -sass``); each kernel's device time (CUDA graph replay),
   its plain version's time, its bound, and the time of PyTorch's
   scaled_dot_product_attention forward and backward at the same shapes,
   with the backend it picked, and K4 + K5 + the pre-pass against SDPA's
   backward;
9. full-width training through the worker's ``--model lm`` (the 1.08B
   flagship, batch 16, seq 1024, 5 steps, bf16 compute): K3, K4, K5 and
   the delta pre-pass launched steps x layers times each, every loss
   finite; first step, tokens/s and peak device memory;
10. training card against CPU at float32 on a small model (vocab 256,
   hidden 256, 2 layers, 4 heads of 64, seq 128, batch 4) from one
   initial tree and one token stream: three losses within rtol 1e-4,
   every gradient of step 1 within rtol=atol=1e-4, and the card's
   ``einsum`` attention within 1e-4 of its ``flash`` on the losses (the
   float32 kernels take delta from out: no pre-pass);
11. K1q (K1 over an int8 pool with (pages, heads) float32 scales) at
   phase 2's two geometries, pools from ``quantize_pages`` of random data:
   against its plain version and the dense oracle over
   ``dequantize_pages``, in float32 and bfloat16 q at phase 2's
   tolerances; its split plan, graph-replay time, plain time and byte
   bound, and at the flagship the ratio to K2q's 5-row walk;
12. K2q likewise at phase 3's shapes and windows: row j equal to K1q at
   lengths + j bit for bit (across split edges too), a 1-row window
   equal to K1q;
13. the flagship wave of phase 4 with ``--kv-dtype int8`` (bf16 weights):
   K1q launched decode steps x layers times, K1 never; the pool's bytes;
14. the flagship wave with ``--kv-dtype int8 --int8 --speculate --spec-k
   4`` (int8 pool and ring, weight-only int8): K2q launched verify steps
   x layers times, K1, K1q and K2 never;
15. card against CPU at float32 on phase 6's model and traffic with an
   int8 pool and ``decode_page_cache="quantized"``: pipelined and
   synchronous card streams identical, card and CPU streams under the
   near-tie rule, pages requantized at sealing, every cache-owned page at
   full int8 range on the card, and (where the streams agree) the card
   and CPU pools equal except for at most one int8 step, whose share is
   printed;
16. the worker at its own defaults (``--model decode``: 8 heads of 64,
   pages of 32, 32 slots, 64 requests a wave): K1 launched decode steps x
   layers times;
17. the same with ``--speculate --spec-k 8``: K2 launched verify steps x
   layers times over 9-row windows, K1 never;
18. the same with ``--kv-dtype int8``: K1q launched decode steps x layers
   times;
19. the HTTP replica at the flagship's width: the worker's
   ``build_batcher`` and ``warm_batcher`` on phase 4's argv behind an
   in-process ``ReplicaServer`` on loopback, 16 requests posted at once
   and read as they stream (http.client and a small SSE reader): every
   stream's deltas concatenate to its ``done`` list of its full budget,
   K1 launched ``stats["steps"]`` x layers times (counts set to 0 just
   before the traffic, read after the server stopped); the client's
   TTFT mean and max, tokens/s over the wire, ``/metrics``'
   ``serve_ttft_seconds`` count and the ledger's host/device split are
   printed, beside the same batcher serving the same requests in process
   just before and, after, from a client in another process; then a long
   request cancelled over the wire after two token events gives back its
   pages (``/v1/state``'s free, live and cached counts back at their idle
   values, ``assert_page_accounting``);
20. the same with ``--speculate --spec-k 4``: K2 launched verify steps x
   layers times, K1 never;
21. phase 6's model and traffic through a card ``ReplicaServer`` over
   loopback against the CPU batcher's streams, under the near-tie rule;
22. the worker's entry point, ``python -m kubegpu_tpu_torch.models.worker
   --model decode --serve-http 0`` at its defaults, in a subprocess: it
   prints ``REPLICA_HTTP_SERVING`` (the seconds to it are printed),
   answers one submit with a full ``done`` and exits 0 on SIGTERM;
23. the port's threefry PRNG (``ops/prng.py``) on the card: random bits,
   uniforms, ``fold_in`` and ``split`` equal to the CPU port's bit for bit
   at (8, 32768) and (8, 5, 32768), golden values computed once by JAX
   held as literals, gumbel noise within 2 ulp of the CPU's (at the
   noise's scale, the spacing of max(|g|, 1)), categorical draws equal
   to JAX's but for near-ties (top-2 perturbed scores within 1e-4);
24. sampled flagship serving in bfloat16 through the worker's entry
   point: ``--sample-temperature 0.8``, with ``--sample-top-k 50``, and
   ``--speculate --spec-k 4`` sampled; every budget met, K1 launched
   decode steps x layers times (speculating: K2 verify steps x layers,
   K1 once a layer for each sampled admission's first token), a second
   run of the same seed-pinned waves byte-identical; ms a step and
   tokens/s beside phases 4-5's greedy waves, and a steady window of 8
   decoding slots (``profile_serving``) greedy against sampled, plain
   and speculative: ms a step, tokens/s and device kernel launches a
   step;
25. phase 6's model and prompts as seed-pinned sampled traffic at
   float32, card against CPU: plain (K1), speculative (K2, phase 7's
   hopeless draft), an int8 pool plain (K1q) and speculative (K2q); each
   stream compared up to its first difference, where the CPU must find a
   near-tie (the target's top-2 perturbed scores, logit/T + gumbel,
   within 1e-4; speculating also the draft proposal's and the accept
   test's |u q - p|); then the plain traffic over the wire through a
   card ``ReplicaServer`` against the card's in-process streams, under
   the same rule (the keys depend on seed and position only);
26. the reference's migration bench (``bench.py::serving_migration``) at
   its full width (vocab 32768, 4 layers, hidden 4096, 32 heads, pages of
   64, prompt_pad 320, max_seq 768) in bfloat16, three warm card
   batchers sharing one set of weights, then the same with an int8
   pool: turn 1 completes on A, A's sealed chain crosses the port's
   codec into B, turn 2 runs on B (restored) and C (cold), min-of-3
   TTFT with the orders interleaved; restored TTFT strictly below cold,
   restored tokens equal to the turn 2 that never migrated (on A), cold
   ones under the near-tie rule (the card's dense model puts the top two
   logits within 0.125 at the first difference); pages moved, wire
   bytes, bytes a page and pages/s through export and import, and the
   int8 page's bytes exactly half the bf16 page's plus its scales;
27. live mid-stream migration card to card through the codec at the
   flagship serving width, plain (K1) and speculative k 4 (K2) on a
   bfloat16 and an int8 pool (K1q, K2q): the continuation equals the
   un-migrated stream but for printed near-ties, and each kernel's count,
   set to 0 just before the import, is the importer's steps x layers;
   then on phase 6's float32 model card to CPU and CPU to card under the
   near-tie rule, and a seed-pinned sampled speculative sequence whose
   draft ring ships, identical;
28. the wire: two card ``ReplicaServer``s at the flagship width with
   512-token prompts: a live ``POST /v1/export`` on A and ``POST
   /v1/import`` on B, whose SSE continuation completes the budget; then
   ``POST /v1/role`` prefill on A and a streamed handoff (deltas while A
   prefills, ``reclaim``, the final export from the cursor into B);
   export and import ms a page and the wire's MB/s;
29. ``samples/jax-decode.yaml``'s decode replica (the 1.08B flagship, 8
   prompts of 128 tokens, 256 steps, ``--seq 1023``) through the
   worker's default mode, ``static``, in a subprocess, bf16 and then
   ``--int8``: ``FIRST_DECODE_DONE``, tokens/s, ms a call and peak device
   memory; the worker's launch counts of K1-K5 are all 0;
30. bench.py's ``_serving_traffic`` (the flagship, 8 slots, prompt_pad
   128, max_seq 512, 16 prompts of 16-127 tokens, budgets 32/64/96/256)
   through the port's ``ContinuousBatcher`` in bf16: tokens, steps,
   admits and the static batches' step count (``serving_continuous_
   batching``), tokens/s and TTFT; then through the paged batcher (page
   128, 25 pages): tokens/s, peak pages and cache bytes against the
   dense cache's, and the bf16 agreement of the two, with the card's
   dense top-2 margin at each first divergence (within 0.125);
31. ``serving_prefill_latency`` part (a) at full width (6 slots,
   prompt_pad 256, chunk 64, 4 runners, 8 long admits): the runners'
   ITL p95 chunked against monolithic (min of 3 interleaved waves; a
   warning, not a failure, when chunked is not below) and TTFT p95;
32. the speculative batcher (k 4, the worker's fresh 1-layer draft of
   hidden 1024 from seed 7) against the dense batcher on the
   reference's 16 prompts of 16-63 tokens (budgets 32/64/96/192, 8
   slots, prompt_pad 64): the step ratio, tokens/s and the bf16
   agreement; at float32 equal token for token but for printed
   near-ties (the CPU rule's 1e-3 on the card's dense model), the
   reference's ``spec_serving_match_dense`` gate;
33. phase 6's model and traffic at float32, card against CPU, through
   ``ContinuousBatcher`` (chunked, monolithic, under a token budget)
   and ``SpeculativeContinuousBatcher``, greedy and seed-pinned sampled,
   under phases 6 and 25's near-tie rules;
34. the worker at its defaults with ``--serving continuous`` and
   ``--serving speculative --spec-k 8`` waves, then ``--serving
   continuous --serve-http 0`` in a subprocess: four streamed requests,
   a wire cancel, ``/v1/state`` and the export route answering as the
   JAX dense replica does.

35. K1, K1q, K2 and K2q through their head-sharded wrappers on each of
   two ranks' halves of the flagship's heads (16 of 32 heads of 128,
   pages of 128, phases 2-3's tables, lengths and windows), float32 and
   bfloat16: within phases 2-3's tolerances of the plain version on the
   same half and bit for bit the unsharded kernel's heads; each kernel's
   time at one rank's shape (graph replay), its plain time and bound;
36. tensor-parallel serving, a gang of two ranks, both on the card over
   gloo (NCCL refuses two ranks on one GPU; gloo copies each collective
   through the host, so no time here is a TP speed): phase 6's float32
   model at TP 2 against the card's TP 1 batcher, plain, speculative and
   int8 pool, token for token; each rank rests exactly half the pool,
   station and draft ring, and launched its kernel steps x layers times
   (counts set to 0 in each rank just before its wave);
37. the flagship's full width in bfloat16 (vocab 32768, hidden 4096, 4
   layers, 32 heads: 16 a rank, pages of 128, 8 slots, 8 requests):
   TP 2 plain, speculative (k 4), int8 pool and int8 pool speculative
   against TP 1 under the near-tie rule (the card's dense model puts
   the top two logits within 0.125 at a first difference), the bytes and
   each rank's launches as in 36, and the wave's seconds beside TP 1's;
38. a TP 2 sequence exported mid-stream continues in a card TP 1
   batcher as the stream that never migrated (float32);
39. a TP 2 replica (rank 0 runs the ``ReplicaServer``) answers four
   requests over loopback with the card TP 1 streams; ``/v1/state``
   reports ``tp`` 2;
40. the worker's ``--tp 2``: refused on a one-card machine ("exceeds the
   visible device count"), and the NCCL path reported as not exercised;
   with two cards or more, the same wave over NCCL.

41. K3, K4, K5 and the delta pre-pass at one tp 2 rank's 16 of the
   flagship's 32 heads (b 16, s 1024, d 128, causal, bf16) against their
   plain twins under phase 8's bf16 gates; each kernel's graph-replay
   time, plain time, bound and SDPA's time;
42. data x tensor-parallel training, a gang of four ranks on the card
   over gloo (host-staged collectives: no time here is a TP speed):
   phase 10's small float32 model at dp 2 x tp 2 with sequence
   parallelism and flash attention, remat off and on: one step's loss
   and every gradient, gathered whole, within rtol=atol 1e-4 of the
   card's one-device step on the same global batch, K3 launched once a
   layer on every rank (twice with remat), K4 and K5 once; three steps'
   losses, weights and momentum within 1e-4;
43. the flagship at full width (vocab 32768, hidden 4096, 32 heads, 4
   layers, seq 1024, bf16 compute over float32 weights) at dp 2 x tp 2,
   2 rows a data rank, three steps from ``synthetic_token_batches_for_
   mesh``: finite losses that fall, the first within 1e-2 of the card's
   one-device loss on the same global batch, K3, K4, K5 and the pre-pass
   launched steps x layers times on every rank (counts set to 0 in each
   rank just before the steps), each rank's parameter and momentum bytes
   1/tp of the whole but for the LayerNorms; seconds a step, one more
   step's parts (forward and backward, ``sync_grads``, the optimizer)
   and each rank's peak memory;
44. the worker's ``--model lm --tp 2``: refused on a one-card machine
   ("exceeds the visible device count"), NCCL reported as not
   exercised; with two cards or more, three small steps over NCCL.

45. checkpoints, in a temporary directory outside the checkout (its
   ``df`` printed; 2 of the flagship's 4 layers when two steps fit with
   a tenth to spare, else depth 1, printed as a cut): the flagship
   (vocab 32768, hidden 4096, 32 heads of 128, ``--seq 1024``, batch 4)
   trains 2 steps through the worker's ``--model lm --ckpt-dir`` and
   saves step 2 (``CHECKPOINT_SAVED step=2``); a second run resumes
   (``RESUMED step=2``) and saves step 4; K3, K4, K5 and the pre-pass
   launched steps x layers times in each run; a step's bytes are the
   parameters' and the momentum's (at the trained depth) plus under
   1 MiB of headers; each save's and the restore's seconds
   and GB/s; phase 5's draft (1 layer, hidden 1024) trains 2 steps into
   its own directory;
46. phase 45's step 4 served through ``--model decode --serving paged
   --ckpt-dir`` at phase 4's widths (``RESTORED_FOR_SERVING step=4``):
   K1 launched decode steps x layers times, the served bf16 weights bit
   for bit a bf16 cast of what phase 45 saved, the serving restore's
   seconds; then ``--speculate --spec-k 4 --draft-ckpt-dir`` with the
   trained draft (``RESTORED_DRAFT_FOR_SERVING``): K2 launched verify
   steps x layers times, K1 never, tokens a verify;
47. resume against an uninterrupted run at float32 on phase 10's small
   model with flash attention: "2 steps, save, restore into fresh
   weights, 2 steps" against "4 steps" at one device (SGD and Adam) and
   in phases 42-44's dp 2 x tp 2 gang (SGD): losses, weights and
   optimizer state within 1e-6, the largest difference printed (0 when
   the bits are equal: the kernels are deterministic); the gang's step
   2 restored onto one device is the saved bits, and one device trains
   on from it within 1e-4 of the gang.

48. K3 unmasked (a block owned by an earlier rank) and causal (the
   diagonal), K4, K5 and the delta pre-pass at one ring block of the
   flagship at cp 2 (b 1, 4096 rows, 32 heads of 128, bf16) against
   their plain twins under phase 8's gates; then K4 and K5 on both
   blocks from the global out and lse the two fold into, as the ring's
   backward runs them; each kernel's graph-replay time, plain time,
   bound and SDPA's time, unmasked and causal;
49. context-parallel training in gloo gangs on the card (the ring's hops
   and the all-to-alls staged through pinned host buffers; no time here
   is a CP speed): phase 10's small float32 model at cp 2 (two ranks) and
   dp 2 x cp 2 (four), ring through its flash body (64 rows a rank),
   ring through its einsum body (136 rows, which ``ring_block_sizes``
   does not tile), Ulysses, ring with remat: one step's loss and every
   gradient within rtol=atol 1e-4 of the card's one-device flash step on
   the same global batch; K3, K4 and K5 launched (r + 1) times a layer
   on the rank at "seq" coordinate r under the ring's flash body (K3
   twice with remat), once under Ulysses, never under the einsum body;
50. the flagship at full width (vocab 32768, hidden 4096, 4 layers, 32
   heads, bf16 compute over float32 weights) at cp 2, seq 8192, batch 1,
   in a two-rank gang: one step with ring attention, then one with
   Ulysses: finite losses, the first within 1e-2 of the card's
   one-device loss on the same tokens, each rank's launches as in 49
   (with the pre-pass once a layer); each rank's seconds for its one
   step (a first step: warm-up included, not a steady step), bytes
   sent along "seq" a step, peak memory, and (ring) one more step's
   parts (forward and backward, ``sync_grads``' mean over data x seq,
   the optimizer);
51. the worker's ``--model lm-cp --cp 2``: refused on a one-card machine,
   NCCL reported as not exercised (with two cards or more, three small
   steps over NCCL); then ``samples/jax-lm-cp.yaml``'s argv at ``--cp
   1`` (the worker's default widths, seq 8192, 8 windows, 2 steps) in a
   subprocess: K3, K4, K5 and the pre-pass launched steps x layers times.

52. ResNet data-parallel training (no kernel of the port is on its
   path: its convolutions are cuDNN's, as XLA's are the JAX ResNet's):
   ``resnet-tiny`` at float32, card against CPU, TF32 off for the phase
   (PyTorch lets cuDNN run float32 convolutions in TF32 by default) and
   restored after: three carried nesterov SGD steps on 8 images from one
   fresh tree, at 32 px and at an odd 37 px: losses within rtol 1e-4,
   the first step's gradients within rtol=atol 1e-4 and its new
   ``batch_stats`` within 1e-5;
53. ``samples/jax-resnet.yaml``'s worker command at ``--steps 15``
   instead of its 100 (no ``--model``: the default, the scan-rolled ResNet-50, batch 32, 224
   px, 1000 classes), through the port's entry point in a subprocess:
   ``FIRST_STEP_DONE`` (the worker's seconds from its start, and this
   phase's from the spawn), steady images/s, peak memory, every kernel
   count 0; cuDNN autotuning is PyTorch's default, off, and the worker
   sets nothing.  Then what a window's length does to that rate: the
   same model and batches (the worker's builder) stepped 40 times in
   this process with no sync between steps, as the worker steps them:
   images/s on the device's clock over steps 2-20, 21-40 and 2-40; then
   5 more steps profiled: the device's busy ms a step against a step of
   2-40, and its idle share;
54. the reference's steady state (``bench.py`` ``steady_state_resnet``):
   the unrolled ResNet-50 at batch 256 on a device pool of 3 synthetic
   batches, 5 warm-up and 15 timed steps: ms a step, images/s, and the
   share of the card's dense bf16 peak (989 TFLOP/s) that the convs' and
   head's FLOPs (3 x the forward's 2 x MACs, counted from their shapes)
   make; then the same with cuDNN autotuning on (its first step and its
   steady step), and a profile of 3 steps with it off: device time by
   operation (convolutions, BatchNorm/ReLU/elementwise passes, casts,
   pooling, the head's matmul, the optimizer) and the idle share;
55. a two-rank gloo gang on the card (``{"data": 2}``; the gradient mean
   and every BatchNorm's sums are copied through the host, so no time
   here is a data-parallel speed): ``resnet-tiny`` at float32 against
   one device at the global batch (losses, first-step gradients and
   ``batch_stats`` within 1e-4); ResNet-50 at 32 images a rank: the
   first loss within 1e-2 of one device's at 64, seconds a step and the
   gradient mean's share;
56. ResNet-50 checkpoints through the worker's ``--ckpt-dir`` (batch 32,
   cuDNN deterministic for the phase): 2 steps, a resumed 2, against 4
   uninterrupted: every leaf, the ``batch_stats`` included, within 1e-6;
   the step's bytes, each save's and the restore's seconds.

57. the MoE transformer (``models/moe.py``) at float32 with flash
   attention, card against CPU (2 layers, hidden 64, 4 heads of 16, 4
   experts, vocab 256, batch 4, seq 128), each router with each dispatch
   (top1 and top2 einsum and gather, expert choice): three carried
   nesterov SGD steps from one tree, losses within rtol 1e-4, the first
   step's gradients within rtol=atol 1e-4, drop rates equal unless a
   printed near-tie (the CPU's closest gates within 1e-5), K3/K4/K5
   launched steps x layers times on the card;
58. the reference's MoE bench row (``bench.py`` ``steady_state_moe``:
   b8, s1024, vocab 32768, hidden 2048, 16 heads of 128, 4 layers, 4
   experts, capacity factor 2, flash attention, bf16) on one card: the
   dense twin (``TransformerLM``) and the six MoE rows (top1 fp32- and
   fast-dispatch, top2, expert choice, top1 and top2 gather), each 2 warm
   and 5 timed steps on a device pool of 2 batches of the reference's
   stream: ms a step, tokens/s, aux and drop rate (after the steps, on
   the first batch, as the reference reads them), peak memory, and the
   share of the dense bf16 peak (FLOPs counted by ``FlopCounterMode``
   over the first step, plus the flash kernels' from their shapes); K3,
   K4, K5 and the pre-pass launched 4 times a step each; one more step
   of the default row (top1 fast-dispatch) profiled, device time by
   class (router, dispatch and combine, experts, flash kernels,
   attention projections, head, optimizer, other) and the idle share;
59. expert meshes in gloo gangs on the card (host-staged: no time here
   is an expert-parallel speed): phase 57's float32 model at dp 2 x ep 2
   and ep 2 x tp 2 (four ranks each) against the card's one device, top1
   einsum, top2 gather and expert choice: loss, aux and every gradient
   within 1e-4; the bench width at ep 2 (two ranks, two experts each):
   the first bf16 loss within 1e-2 of phase 58's default row, each
   rank's expert bytes half of the whole, seconds a step;
60. the worker's ``--model moe --num-experts 4 --steps 10`` at its
   defaults (vocab 32000, hidden 512, 8 heads, 4 layers, seq 1024, b32,
   einsum attention) and with ``--moe-router top2 --moe-dispatch
   gather``: ``FIRST_STEP_DONE``, tokens/s, the router's line, no flash
   kernel launched; then ``--ckpt-dir``: 2 steps and a resumed 2 against
   4, every leaf within 1e-6.

61. the pipelined LM (``models/pipeline_lm.py``, no kernel of the port:
   its attention is einsum) at float32, card against CPU: a small
   pipeline (vocab 512, hidden 64, 4 heads, 2 layers a stage, seq 64, 4
   microbatches of 2), three carried non-Nesterov SGD steps on one
   device, in a ``{"pipe": 2}`` gloo gang on ``cuda:0`` (GPipe, and
   circular V 2 at twice the depth) and a ``{"pipe": 2, "model": 2}``
   gang: every loss, first-step gradient leaf, weight and momentum
   within 1e-5 of the CPU's one device at the same depth;
62. the worker's ``--model pp --steps 5`` at its defaults (one card, one
   stage: vocab 32000, hidden 512, 8 heads, 4 layers, seq 1024, 4
   microbatches of 32): ``FIRST_STEP_DONE``, tokens/s, peak memory,
   every kernel count 0; where the defaults do not fit the card, the
   peak they reached, then the same at ``--batch-per-chip 16``;
63. a ``{"pipe": 2}`` gloo gang on ``cuda:0`` at the worker's width
   (hidden 512, 8 heads, vocab 32000, seq 1024, 4 layers a stage, 4
   microbatches of 8), GPipe and circular V 2, three steps each: each
   rank holds exactly half the block bytes, the first loss within 1e-5
   of one device's on the same weights, seconds a step and the seconds
   of it in the hops, and the bytes the hops sent and staged through the
   host (host-staged: no time here is a pipeline speed).

64. ``samples/jax-resnet.yaml``'s gang on the card: 4 pods as OS
   processes, each the sample's worker command (the default ResNet-50,
   batch 32 a pod, 224 px, 1000 classes) at ``--steps 3`` instead of
   100, each with exactly the env the port's CRI shim injects
   (``crishim/inject.py::compute_injection`` over ``NvmlGpuProvider``,
   each pod bound by a one-card assignment annotation to card 0, which
   the four share as no allocator would): card 0's NVML UUID in
   ``CUDA_VISIBLE_DEVICES`` and ``NVIDIA_VISIBLE_DEVICES`` and the
   rendezvous table, the pods named after loopback addresses so the
   shim's coordinator, the first pod's hostname at a free port, is
   127.0.0.1; every pod prints the injected variables as it got them,
   equal to the injection byte for byte, and ``WORKER_DEVICES`` naming
   the card: one world of 4 ranks on ``cuda:0`` over gloo (host-staged:
   no time here is a data-parallel speed); every pod prints ``TRAINING_MESH
   data=4 process=p/4``, ``FIRST_STEP_DONE`` and ``steady_state`` with
   the same losses, and every kernel count 0 (each pod's counts are the
   paged kernels' ``gang_launches``); the first loss within 1e-2 of one
   device's step from the same initial weights on the gang's global
   batch (each pod's 32 rows of its own process id's stream, in process
   order), and nearer to it than to one device's on 128 rows of stream
   0 alone (one process of 4 devices); each pod's seconds to its first
   step and peak memory, and the gang's seconds a step;
65. an LM gang on the card (``samples/jax-lm-tp.yaml``'s shape at phase
   10's small widths: 2 pods of 1 rank, ``--model lm --tp 2``, flash
   attention, float32 compute), each pod a script calling
   ``worker.run_lm`` under the env the port's shim injects (as in 64,
   echoed and equal byte for byte): every step's loss within 1e-5
   of the same gang on the CPU (one process, ``--device cpu --cpu-ranks
   2``), and each pod's K3, K4 and K5 launched steps x layers times (its
   float32 instantiation; no pre-pass at float32), the per-kernel
   record's ``gang_launches``;
66. data x tensor x context parallelism: phase 49's small float32 model
   in a gloo gang of eight ranks on the card over ``{"data": 2, "model":
   2, "seq": 2}`` (``tests/torch_3d_cases.py``), ring through its flash
   body and Ulysses, each rank on its 2 of the 4 heads: one step's loss
   and every gradient leaf, gathered whole, within rtol=atol 1e-4 of the
   card's one-device flash step on the same global batch, and each rank's
   K3, K4 and K5 launches as ``cp_want_launches`` gives them by its "seq"
   coordinate (the per-kernel record's ``cp3d_small_launches`` and
   ``cp3d_small_ulysses_launches``);
67. the flagship at full width over ``{"data": 1, "model": 2, "seq":
   2}`` in a four-rank gang on the card, seq 8192, batch 1, one step of
   ring and one of Ulysses (16 of the 32 heads a rank): finite losses,
   the first within 1e-2 of phase 50's one-device loss, each rank's
   launches as phase 50's (the per-kernel record's ``cp3d_launches`` and
   ``cp3d_ulysses_launches``), its peak memory and seconds (host-staged
   gloo: not a speed);
68. ZeRO-1 (``parallel/zero.py``) at the flagship's width, dp 2 in a
   two-rank gang on the card, adam, seq 1024, b 2 a rank: two steps with
   replicated moments, then two with ZeRO-1 from the same weights: finite
   losses, every step's equal within 1e-4 and each parameter's
   position-weighted checksum after the last update within 1e-6 of its
   weighted magnitude (the host-staged reduce-scatter, the sliced adam
   step and the all-gather on the card), every parameter's moments cut
   over "data" (``state_bytes_per_device``: 4,312,055,812 B of optimizer
   state a rank against 8,624,111,620), K3, K4, K5 and the pre-pass
   launched steps x layers times a rank (``zero1_launches``), each rank's
   peak device memory in both runs.

69. the GPU device layer (``kubegpu_tpu_torch/plugins``): NVML through
   ctypes counts the cards torch counts, and each card's UUID, name and
   memory (NVML's total less the driver's reserve) are torch's; every
   card is healthy and its ``/dev/nvidia<minor>`` opens read-write; the
   node annotation the advertiser would write is printed; the device
   plugin's Allocate, run on request bytes without gRPC, grants every
   card (their UUIDs in ``CUDA_VISIBLE_DEVICES`` and
   ``NVIDIA_VISIBLE_DEVICES``, their device nodes and the driver's
   control nodes) and refuses a card the host lacks; a worker whose
   ``CUDA_VISIBLE_DEVICES`` names a UUID no card has exits non-zero
   with the no-card error, its ``WORKER_DEVICES`` line naming that UUID,
   and trains nothing;
70. the control plane on the card (``kubegpu_tpu_torch/scheduler``):
   the port's advertiser over ``NvmlGpuProvider`` advertises this machine
   into the port's in-memory API server and the port's
   ``ExtenderServer`` listens on loopback; kube-scheduler's wire calls
   to it refuse ``samples/jax-serve-gateway.yaml``'s ``decode-replica-*``
   gang (3 pods of one card) whole on the one-card node (no plan, no
   reservation, no bind), then filter, prioritize and bind one pod of
   ``decode-replica-0``'s container alone (the flagship's width, its 256
   steps cut to 8, without ``--serve-http``, ``--ckpt-dir`` and the pod
   group); the port's shim turns its assignment into an env naming the
   card's UUID, and the port's worker runs as the pod's process under
   exactly that env: its ``WORKER_DEVICES`` names the card, K1
   launches decode steps x layers times and no other kernel launches
   (its ``KERNEL_LAUNCHES``, the paged records' ``bound_pod_launches``);
   deleting the pod returns the card and the same pod binds to it
   again, now with the sample's serving command (phase 71's replica);
   the host's milliseconds from filter to bind, both times;
71. the sample's gateway in front of its replica (``kubegpu_tpu_torch/
   gateway``, the ``device`` group, right after 70): ``decode-replica-0``
   as phase 70 binds it again runs the sample's container command with
   ``--serve-http=0`` in place of 8700 (its steps cut as in 70) under
   the shim's env, its process booted beside the build and serving once
   70's worker has exited; the pod's status gets ``podIP: 127.0.0.1``
   and ``phase: Running``; the port's gateway is wired as its in-cluster
   mode wires it (``ReplicaRegistry`` over 70's API server, the group
   ``decode``, ``HttpReplicaClient`` resolving podIP:port with its probe
   as the registry's, the sample's ``--queue-capacity=256 --deadline=30
   --hedge-after=1.0``): ``/readyz`` 503 before the replica answers its
   probe and 200 after; 3 greedy prompts of 128 tokens, 32 new, each
   streamed through the gateway's SSE equal to the same request sent
   alone straight to the replica's ``/v1/submit`` (sent there twice
   first, so that both read the prompt from the prefix cache); a burst
   of 16, 8 at a time, every stream 32 tokens, no retry, hedge or 429 in
   the gateway's ``/metrics``; ``python -m
   kubegpu_tpu_torch.gateway.server --replica-endpoint`` in a subprocess
   announces its port, serves one of the prompts with the replica's
   tokens and exits 0 on SIGTERM after its drain; the pod deleted turns
   ``/readyz`` 503 within one refresh; the replica, stopped by SIGTERM,
   launched K1 decode steps x layers times and no other kernel (its
   ``KERNEL_LAUNCHES`` line, the paged records' ``gateway_launches``);
   the gateway's ``gateway_ttft_seconds`` and ``gateway_itl_seconds``
   over the burst beside the replica's ``serve_ttft_seconds`` and
   ``serve_itl_seconds``, and each single's first-token time straight
   and through the gateway, with the card's name and power limit.

Phases 29-34, 53-54, 60, 61-63 and 64 set every kernel's launch count to 0
before each run and require it to be 0 after: the dense paths, the
ResNet, the worker's einsum-attention MoE and the pipeline run none of
K1-K5.

The line before the last is the per-kernel JSON record, and the line
before that the card's name and power limit again; the last line is
``{"ok": true, "device": {...}}``.  Without a CUDA device the script
exits non-zero and prints no result.
"""

import argparse
import concurrent.futures
import contextlib
import functools
import json
import shutil
import subprocess
import sys
import tempfile
import time

F32_TOL = 2e-5
BF16_RTOL = 2 ** -7
BF16_ATOL = 1e-5
CARD_CPU_LOGIT_TOL = 1e-4
NEAR_TIE_MARGIN = 1e-3
GRAD_TOL = 1e-4
TRAIN_TOL = 1e-4
HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory
F32_FLOPS_PER_S = 67e12     # H100 SXM float32 outside the tensor cores
BF16_FLOPS_PER_S = 989e12   # H100 SXM bf16 dense tensor cores
SPEC_K = 4
# the worker's defaults' verify window: --spec-k 8
DEFAULT_SPEC_K = 8
# the training path's attention: batch, seq, heads, head_dim
FLASH_SHAPE = (16, 1024, 32, 128)
# the paged kernels' shapes: the flagship's (32 heads of 128, pages of
# 128) and the worker's defaults' (8 heads of 64, pages of 32), 8 slots
# of up to CONTEXT_ROWS rows each
FLAGSHIP_PAGED = dict(b=8, h=32, hd=128, page=128)
DEFAULT_PAGED = dict(b=8, h=8, hd=64, page=32)
CONTEXT_ROWS = 1152   # the flagship's table width: ceil(1025 / 128) pages


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, n: int, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
        enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(n):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / n


def graph_ms(fn, n: int, replays: int = 10) -> float:
    """Device time of one ``fn()``: n calls captured in one CUDA graph and
    replayed, so the host's cost per call stays out of the number."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    return time_ms(graph.replay, replays) / n


def phase_device() -> tuple:
    """The card's name and its ``nvidia-smi`` name and power-limit line;
    TF32 off."""
    import torch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    log(smi)
    name = torch.cuda.get_device_name(0)
    log(f"device: {name} count={torch.cuda.device_count()} torch="
        f"{torch.__version__} cuda={torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return name, smi


def phase_build() -> None:
    from kubegpu_tpu_torch.ops import (  # noqa: F401
        _build,
        attention,
        paged_attention,
    )

    t0 = time.monotonic()
    paths = _build.build()
    log(f"build: {len(paths)} kernel libraries in "
        f"{time.monotonic() - t0:.1f} s, every nvcc started together (a "
        "parted library's parts, then its link) ("
        + ", ".join(f"{n} {s:.1f} s"
                    for n, s in _build.BUILD_SECONDS.items()) + ")")
    for name, text in _build.BUILD_LOG.items():
        for line in text.splitlines():
            if "error" in line:
                log(f"  nvcc[{name}]: {line.strip()}")
        for kernel, regs, stores, loads in ptxas_report(text):
            log(f"  ptxas[{name}] {kernel}: {regs} registers, {stores} B "
                f"spill stores, {loads} B spill loads")


def ptxas_report(text: str) -> list:
    """(kernel, registers, spill store bytes, spill load bytes) of each
    entry function in ``ptxas -v`` output, the kernel's name demangled
    (``cu++filt``) down to its template."""
    import re

    rows, name, spill = [], None, (0, 0)
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = m.group(1)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spill = (int(m.group(1)), int(m.group(2)))
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and name is not None:
            rows.append([name, int(m.group(1)), *spill])
            name, spill = None, (0, 0)
    filt = (shutil.which("cu++filt")
            or shutil.which("/usr/local/cuda/bin/cu++filt")
            or shutil.which("c++filt"))
    if rows and filt is not None:
        names = subprocess.run([filt], input="\n".join(r[0] for r in rows),
                               capture_output=True, text=True,
                               timeout=60).stdout.splitlines()
        for row, full in zip(rows, names):
            full = full[:full.index(">(") + 1] if ">(" in full else (
                full.split("(")[0])
            for noise in ("void ", "<unnamed>::", "(anonymous namespace)::",
                          "(int)", "(bool)"):
                full = full.replace(noise, "")
            row[0] = full
    return [tuple(r) for r in rows]


def paged_operands(shape, dtype, g, quant: bool):
    """Random K/V pools of ``shape`` for the paged kernels: ``dtype`` at
    full width, or int8 from ``quantize_pages`` with their scales.
    Returns (k, v, scale kwargs, the pools the dense oracle reads)."""
    import torch

    from kubegpu_tpu_torch.ops.paged_attention import (
        dequantize_pages,
        quantize_pages,
    )

    dev = torch.device("cuda")
    kp, vp = ((torch.randn(shape, generator=g, device=dev) * 0.3)
              for _ in range(2))
    if not quant:
        kp, vp = kp.to(dtype), vp.to(dtype)
        return kp, vp, {}, (kp, vp)
    (kd, ks), (vd, vs) = quantize_pages(kp), quantize_pages(vp)
    return (kd, vd, dict(k_scale=ks, v_scale=vs),
            (dequantize_pages(kd, ks), dequantize_pages(vd, vs)))


def geometry_label(geo: dict) -> str:
    return f"hd {geo['hd']}, page {geo['page']}, {geo['h']} heads"


def phase_k1(quant: bool = False, geo: dict = FLAGSHIP_PAGED) -> dict:
    import torch

    from kubegpu_tpu_torch.ops.paged_attention import (
        paged_chunk_attention,
        paged_decode_attention,
        paged_decode_attention_plain,
        reference_paged_attention,
        split_plan,
    )

    dev = torch.device("cuda")
    b, h, hd, page = geo["b"], geo["h"], geo["hd"], geo["page"]
    label = f"{'K1q' if quant else 'K1'} ({geometry_label(geo)})"
    n_pages = CONTEXT_ROWS // page
    pool = b * n_pages + 8
    lengths_l = [0, 1, page - 1, page, 200, 513, 1000, n_pages * page]
    seed = (11 if quant else 1) + (0 if geo is FLAGSHIP_PAGED else 100)
    g = torch.Generator(device=dev).manual_seed(seed)
    table = torch.stack([
        torch.randperm(pool, generator=g, device=dev)[:n_pages]
        for _ in range(b)
    ]).to(torch.int32)
    lengths = torch.tensor(lengths_l, dtype=torch.int32, device=dev)
    rec = {}
    for dtype, rtol, atol in ((torch.float32, F32_TOL, F32_TOL),
                              (torch.bfloat16, BF16_RTOL, BF16_ATOL)):
        q = torch.randn((b, h, hd), generator=g, device=dev).to(dtype)
        kp, vp, sc, full = paged_operands((pool, h, page, hd), dtype, g,
                                          quant)
        args = (q, kp, vp, table, lengths)
        out = paged_decode_attention(*args, **sc)
        plain = paged_decode_attention_plain(*args, **sc)
        dense = reference_paged_attention(q, *full, table, lengths)
        torch.cuda.synchronize()
        assert out.shape == q.shape and out.dtype == dtype
        assert torch.isfinite(out.float()).all(), f"{label} gave non-finite"
        assert (out[0] == 0).all(), "length-0 slot must give zeros"
        diff = (out.float() - plain.float()).abs()
        err = diff.max().item()
        # the worst element's share of its allowance (<= 1 passes)
        share = (diff / (atol + rtol * plain.float().abs())).max().item()
        err_dense = (out.float() - dense.float()).abs().max().item()
        torch.testing.assert_close(out.float(), plain.float(), rtol=rtol,
                                   atol=atol)
        torch.testing.assert_close(out.float(), dense.float(), rtol=rtol,
                                   atol=atol)
        name = str(dtype).replace("torch.", "")
        split, tile, stages, smem = split_plan(page, hd, dtype, quant)
        n_splits = -(-n_pages // split)
        live_blocks = h * sum(-(-min(-(-n // page), n_pages) // split)
                              for n in lengths_l)
        log(f"{label} {name}: split plan {split} pages a split, {n_splits} "
            f"splits a {n_pages}-page table, {live_blocks} live walk blocks "
            f"(of {h * b * n_splits}), a ring of {stages} tiles of {tile} "
            f"rows, {smem} B of shared memory; then the merge")
        log(f"{label} {name}: max|kernel - plain| = {err:.3e} ({share:.3f} "
            f"of rtol {rtol:.3g} atol {atol:.3g}), max|kernel - dense "
            f"oracle| = {err_dense:.3e}; mean |out| of the live slots "
            f"{out[1:].float().abs().mean().item():.3e}")
        itemsize = q.element_size()
        live_pages = sum(-(-n // page) for n in lengths_l)
        nbytes = (2 * sum(lengths_l) * h * hd * kp.element_size()  # K/V
                  + 2 * live_pages * h * 4 * bool(quant)   # their scales
                  + 2 * b * h * hd * itemsize              # q in, out
                  + 4 * (live_pages + b))                  # table, lengths
        bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ms = graph_ms(lambda: paged_decode_attention(*args, **sc), 50)
        call_ms = time_ms(lambda: paged_decode_attention(*args, **sc), 200)
        plain_ms = time_ms(
            lambda: paged_decode_attention_plain(*args, **sc), 20)
        log(f"{label} {name}: kernel {ms * 1e3:.2f} us (graph replay, walk "
            f"and merge; {call_ms * 1e3:.2f} us a call from Python), plain "
            f"{plain_ms * 1e3:.2f} us, bound {bound_ms * 1e3:.2f} us "
            f"({nbytes} B over "
            f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s) -> "
            f"{bound_ms / ms * 100:.1f}% of bound; no single PyTorch call "
            "computes paged attention, so library_ms is null")
        if geo is FLAGSHIP_PAGED:
            # K2's 5-row walk over the same widest contexts, same call
            q5 = torch.randn((b, SPEC_K + 1, h, hd), generator=g,
                             device=dev).to(dtype)
            short = (lengths - SPEC_K).clamp(min=0)
            k2_ms = graph_ms(lambda: paged_chunk_attention(
                q5, kp, vp, table, short, **sc), 50)
            log(f"{label} {name}: {'K2q' if quant else 'K2'}'s {SPEC_K + 1}"
                f"-row walk to the same widest contexts {k2_ms * 1e3:.2f} us "
                f"-> {label.split()[0]} / {'K2q' if quant else 'K2'} = "
                f"{ms / k2_ms:.3f}")
        rec[name] = dict(max_abs_err=err, ms=ms, call_ms=call_ms,
                         plain_ms=plain_ms,
                         bound_ms=bound_ms, bytes=nbytes, split=split)
    return rec


def phase_k2(quant: bool = False, geo: dict = FLAGSHIP_PAGED,
             spec_k: int = SPEC_K) -> dict:
    import torch

    from kubegpu_tpu_torch.ops.paged_attention import (
        chunk_plan,
        paged_chunk_attention,
        paged_chunk_attention_plain,
        paged_decode_attention,
        reference_paged_chunk_attention,
        split_plan,
    )

    dev = torch.device("cuda")
    k1_label = "K1q" if quant else "K1"
    b, L, h, hd, page = geo["b"], spec_k + 1, geo["h"], geo["hd"], geo["page"]
    label = (f"{'K2q' if quant else 'K2'} ({geometry_label(geo)}, "
             f"{L}-row window)")
    n_pages = CONTEXT_ROWS // page
    pool = b * n_pages + 8
    # windows crossing page boundaries (page - 4 .. page), mid-table, and
    # one whose widest row reaches the full table
    lengths_l = [1, page - 4, page - 2, page - 1, page, 513, 1000,
                 n_pages * page - (L - 1)]
    seed = (13 if quant else 3) + (0 if geo is FLAGSHIP_PAGED else 100)
    g = torch.Generator(device=dev).manual_seed(seed)
    table = torch.stack([
        torch.randperm(pool, generator=g, device=dev)[:n_pages]
        for _ in range(b)
    ]).to(torch.int32)
    lengths = torch.tensor(lengths_l, dtype=torch.int32, device=dev)
    widest = lengths + (L - 1)
    rec = {}
    for dtype, rtol, atol in ((torch.float32, F32_TOL, F32_TOL),
                              (torch.bfloat16, BF16_RTOL, BF16_ATOL)):
        q = torch.randn((b, L, h, hd), generator=g, device=dev).to(dtype)
        kp, vp, sc, full = paged_operands((pool, h, page, hd), dtype, g,
                                          quant)
        args = (q, kp, vp, table, lengths)
        out = paged_chunk_attention(*args, **sc)
        plain = paged_chunk_attention_plain(*args, **sc)
        dense = reference_paged_chunk_attention(q, *full, table, lengths)
        torch.cuda.synchronize()
        assert out.shape == q.shape and out.dtype == dtype
        assert torch.isfinite(out.float()).all(), f"{label} gave non-finite"
        diff = (out.float() - plain.float()).abs()
        err = diff.max().item()
        share = (diff / (atol + rtol * plain.float().abs())).max().item()
        err_dense = (out.float() - dense.float()).abs().max().item()
        torch.testing.assert_close(out.float(), plain.float(), rtol=rtol,
                                   atol=atol)
        torch.testing.assert_close(out.float(), dense.float(), rtol=rtol,
                                   atol=atol)
        # row j folds through K1's device routine: the same bits as K1 at
        # lengths + j, and a 1-row window is K1
        for j in range(L):
            single = paged_decode_attention(q[:, j].contiguous(), kp, vp,
                                            table, lengths + j, **sc)
            assert torch.equal(out[:, j], single), (
                f"{label} row {j} differs from {k1_label} at lengths + {j}")
        one = paged_chunk_attention(q[:, :1].contiguous(), kp, vp, table,
                                    lengths, **sc)
        assert torch.equal(one[:, 0], paged_decode_attention(
            q[:, 0].contiguous(), kp, vp, table, lengths, **sc)), (
            f"a 1-row {label} window differs from {k1_label}")
        # windows whose rows straddle the first and second split edges
        split = split_plan(page, hd, dtype, quant)[0]
        edge, full = split * page, n_pages * page - (L - 1)
        edges = torch.tensor(
            [min(max(n, 0), full) for n in (edge - L + 1, edge - L // 2,
                                            edge - 1, edge, 2 * edge - L + 1,
                                            2 * edge - L // 2, 2 * edge - 1,
                                            full)],
            dtype=torch.int32, device=dev)
        across = paged_chunk_attention(q, kp, vp, table, edges, **sc)
        for j in range(L):
            assert torch.equal(across[:, j], paged_decode_attention(
                q[:, j].contiguous(), kp, vp, table, edges + j, **sc)), (
                f"{label} row {j} differs from {k1_label} at lengths + {j} "
                "across a split edge")
        name = str(dtype).replace("torch.", "")
        plan = chunk_plan(page, hd, dtype, quant)
        log(f"{label} {name}: plan {plan[0]} rows per walk, a ring of "
            f"{plan[2]} tiles of {plan[1]} rows, {plan[3]} B of shared "
            f"memory; {split} pages a split (edges every {edge} rows), "
            f"{-(-n_pages // split)} splits a table; then the merge")
        log(f"{label} {name}: max|kernel - plain| = {err:.3e} ({share:.3f} "
            f"of rtol {rtol:.3g} atol {atol:.3g}), max|kernel - dense "
            f"oracle| = {err_dense:.3e}; rows 0..{L - 1} equal {k1_label} "
            f"at lengths + j bit for bit, also for windows across the split "
            f"edges at {edge} and {2 * edge} rows, and a 1-row window "
            f"equals {k1_label}")
        itemsize = q.element_size()
        rows = [min(n + L - 1, n_pages * page) for n in lengths_l]
        live_pages = sum(-(-n // page) for n in rows)
        nbytes = (2 * sum(rows) * h * hd * kp.element_size()  # widest K/V
                  + 2 * live_pages * h * 4 * bool(quant)     # their scales
                  + 2 * b * L * h * hd * itemsize        # q in, out
                  + 4 * (live_pages + b))                # table, lengths
        # 2 flops for q.k and 2 for p.v per attended K/V row element
        flops = 4 * sum(min(n + j, n_pages * page)
                        for n in lengths_l for j in range(L)) * h * hd
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        flops_ms = flops / F32_FLOPS_PER_S * 1e3
        bound_ms = max(bytes_ms, flops_ms)
        bound_by = "bytes" if bytes_ms >= flops_ms else "operations"
        ms = graph_ms(lambda: paged_chunk_attention(*args, **sc), 50)
        call_ms = time_ms(lambda: paged_chunk_attention(*args, **sc), 200)
        k1_args = (q[:, -1].contiguous(), kp, vp, table, widest)
        k1_ms = graph_ms(lambda: paged_decode_attention(*k1_args, **sc), 50)
        plain_ms = time_ms(
            lambda: paged_chunk_attention_plain(*args, **sc), 5)
        log(f"{label} {name}: kernel {ms * 1e3:.2f} us (graph replay; "
            f"{call_ms * 1e3:.2f} us a call from Python), {k1_label} at the same "
            f"widest contexts {k1_ms * 1e3:.2f} us ({label.split()[0]} / "
            f"{k1_label} = {ms / k1_ms:.3f}), plain "
            f"{plain_ms * 1e3:.2f} us, bound {bound_ms * 1e3:.2f} us by "
            f"{bound_by} ({nbytes} B over {HBM_BYTES_PER_S / 1e12:.2f} "
            f"TB/s = {bytes_ms * 1e3:.2f} us; {flops} flop over "
            f"{F32_FLOPS_PER_S / 1e12:.0f} TFLOP/s f32 = "
            f"{flops_ms * 1e3:.2f} us) -> {bound_ms / ms * 100:.1f}% of "
            "bound; no single PyTorch call computes paged multi-query "
            "attention, so library_ms is null")
        rec[name] = dict(max_abs_err=err, ms=ms, call_ms=call_ms,
                         k1_ms=k1_ms, plain_ms=plain_ms, bound_ms=bound_ms,
                         bound_by=bound_by, bytes=nbytes, flops=flops,
                         split=split)
    return rec


FLAGSHIP_ARGV = ["--model", "decode", "--serving", "paged", "--vocab",
                 "32768", "--hidden", "4096", "--layers", "4", "--heads",
                 "32", "--prompt-len", "128", "--page-size", "128",
                 "--batch-per-chip", "8", "--steps", "64"]


def check_wave(r: dict, args) -> None:
    """Every request of the wave came back with its full budget of
    in-vocabulary tokens."""
    assert r["requests"] >= 16
    budgets = [max(args.steps * (1 + i % 4) // 4, 1)
               for i in range(r["requests"])]
    out = r["outputs"]
    assert sorted(out) == list(range(r["requests"]))
    for i, toks in out.items():
        assert len(toks) == budgets[i], (i, len(toks), budgets[i])
        assert all(0 <= t < args.vocab for t in toks)


def run_wave(label: str, argv) -> tuple:
    """Serve the worker's waves with every paged kernel's count set to 0
    just before; returns (result, args, launches by kernel, peak)."""
    import torch

    from kubegpu_tpu_torch.models import worker
    from kubegpu_tpu_torch.ops.paged_attention import (
        paged_chunk_attention,
        paged_decode_attention,
    )

    counters = {"K1": (paged_decode_attention, "launches"),
                "K1q": (paged_decode_attention, "int8_launches"),
                "K2": (paged_chunk_attention, "launches"),
                "K2q": (paged_chunk_attention, "int8_launches")}
    args = worker.build_parser().parse_args(argv)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    for fn, attr in counters.values():
        setattr(fn, attr, 0)
    r = worker.run_decode(args)
    launches = {k: getattr(fn, attr) for k, (fn, attr) in counters.items()}
    peak = torch.cuda.max_memory_allocated()
    log(f"{label}: {r['requests']} requests, {r['tokens']} tokens in "
        f"{r['wave_s']:.3f} s -> {r['tokens_per_sec']:.1f} tok/s; TTFT mean "
        f"{r['ttft_mean_s'] * 1e3:.1f} ms max {r['ttft_max_s'] * 1e3:.1f} ms; "
        f"first wave done {r['first_decode_s']:.1f} s after start; pool "
        f"({r['kv_dtype']}) {r['pool_bytes'] / 2**20:.1f} MiB; peak device "
        f"memory {peak / 2**30:.2f} GiB; launches {launches}")
    check_wave(r, args)
    return r, args, launches, peak


# the worker at its defaults: 8 heads of 64, pages of 32, 32 slots
DEFAULT_ARGV = ["--model", "decode", "--serving", "paged"]


def phase_flagship(int8: bool = False, base=FLAGSHIP_ARGV,
                   name: str = "flagship") -> dict:
    argv = base + (["--kv-dtype", "int8"] if int8 else [])
    label, kname = (f"int8-pool {name}", "K1q") if int8 else (name, "K1")
    r, args, launches, peak = run_wave(label, argv)
    n = launches.pop(kname)
    log(f"{label}: {kname} launches {n} = decode steps "
        f"{r['decode_steps_total']} x layers {args.layers}; others "
        f"{launches}")
    assert n > 0 and n == r["decode_steps_total"] * args.layers
    assert not any(launches.values()), launches
    return dict(r, launches=n, peak_bytes=peak)


def phase_spec_flagship(int8: bool = False, base=FLAGSHIP_ARGV,
                        name: str = "flagship", spec_k: int = SPEC_K) -> dict:
    argv = base + ["--speculate", "--spec-k", str(spec_k)]
    label, kname = f"speculative {name}", "K2"
    if int8:
        argv += ["--kv-dtype", "int8", "--int8"]
        label, kname = f"int8 speculative {name} (int8 weights)", "K2q"
    r, args, launches, peak = run_wave(label, argv)
    steps = r["spec_steps_total"]
    n = launches.pop(kname)
    log(f"{label}: k={spec_k}, timed wave {r['spec_steps']} "
        f"verify steps for {r['spec_tokens']} tokens = "
        f"{r['spec_tokens'] / r['spec_steps']:.3f} tokens a verify; "
        f"draft ring wraps {r['draft_wraps']}; {kname} launches {n} = "
        f"verify steps {steps} x layers {args.layers}; others {launches}")
    assert n > 0 and n == steps * args.layers
    assert not any(launches.values()), (
        "the speculative path must never run the plain step", launches)
    assert r["spec_tokens"] == r["tokens"]
    return dict(r, launches=n, peak_bytes=peak)


def phase_card_vs_cpu() -> dict:
    import numpy as np
    import torch

    from kubegpu_tpu_torch.models.decoding import DecodeLM, init_caches
    from kubegpu_tpu_torch.models.paging import (
        PagedContinuousBatcher,
        PagedDecodeLM,
    )
    from kubegpu_tpu_torch.models.params import bind_params, init_params, tree_map

    cfg = dict(vocab_size=512, num_layers=2, num_heads=2, hidden=256,
               max_seq=97)
    params = init_params(cfg, torch.Generator().manual_seed(2),
                         torch.float32, "cpu")
    on = {"cpu": params,
          "cuda": tree_map(lambda t: t.to("cuda"), params)}
    # first-step logits: the dense prefill and one paged decode step
    rng = np.random.RandomState(3)
    hd = cfg["hidden"] // cfg["num_heads"]
    pools_np = [rng.randn(2, 6, 2, 16, hd).astype(np.float32) * 0.3
                for _ in range(cfg["num_layers"])]
    table = np.array([[1, 2, 3], [4, 5, 0]], np.int32)
    pos = np.array([40, 17], np.int32)
    tokens = rng.randint(0, 512, size=(2, 1)).astype(np.int32)
    prompt = rng.randint(0, 512, size=(2, 24)).astype(np.int32)
    logits = {}
    for d in ("cpu", "cuda"):
        paged = bind_params(PagedDecodeLM(dtype=torch.float32, **cfg), on[d])
        pools = [(torch.from_numpy(p[0]).to(d), torch.from_numpy(p[1]).to(d))
                 for p in pools_np]
        step = paged(torch.from_numpy(tokens).to(d), pools,
                     torch.from_numpy(table).to(d), torch.from_numpy(pos).to(d))
        dense = bind_params(DecodeLM(dtype=torch.float32, **cfg), on[d])
        caches = init_caches(2, cfg["num_layers"], cfg["num_heads"],
                             cfg["hidden"], cfg["max_seq"], torch.float32, d)
        pre = dense(torch.from_numpy(prompt).to(d), caches, 0)
        logits[d] = (step.cpu(), pre.cpu())
    for i, name in enumerate(("paged step", "dense prefill")):
        a, c = logits["cuda"][i], logits["cpu"][i]
        assert torch.isfinite(a).all() and a.shape == c.shape
        log(f"card vs cpu {name} logits: max abs diff "
            f"{(a - c).abs().max().item():.3e}")
        torch.testing.assert_close(a, c, rtol=CARD_CPU_LOGIT_TOL,
                                   atol=CARD_CPU_LOGIT_TOL)
    # the batcher on both devices: shared prefixes, more requests than
    # slots, a token budget
    shared = rng.randint(0, 512, size=20).astype(np.int32)
    prompts = [np.concatenate([shared, rng.randint(0, 512, size=n)]).astype(
        np.int32) if i % 2 == 0 else rng.randint(0, 512, size=n + 4).astype(
        np.int32) for i, n in enumerate((5, 9, 3, 11, 7, 1, 12, 6))]
    budgets = [24, 17, 30, 9, 28, 20, 13, 25]
    kw = dict(cfg, slots=4, prompt_pad=32, page_size=16, pool_pages=20,
              token_budget=40, dtype=torch.float32)
    streams = {}
    for d, pipe in (("cpu", True), ("cuda", True), ("cuda", False)):
        cb = PagedContinuousBatcher(params, device=d, pipeline_decode=pipe,
                                    **kw)
        streams[(d, pipe)] = cb.run(prompts, budgets)
        cb.assert_page_accounting()
        log(f"batcher {d} pipeline={pipe}: prefix hit tokens "
            f"{cb.stats['prefix_hit_tokens']}, steps {cb.stats['steps']}")
    assert streams[("cuda", True)] == streams[("cuda", False)], (
        "pipelined and synchronous card streams differ")
    cpu, card = streams[("cpu", True)], streams[("cuda", True)]
    dense = bind_params(DecodeLM(dtype=torch.float32, **cfg), params)
    agree, total = near_tie_agreement("card and cpu", cfg, dense, prompts,
                                      cpu, card)
    log(f"card vs cpu streams: {agree}/{total} tokens agree before any "
        "near-tie divergence")
    return dict(cfg=cfg, params=params, dense=dense, prompts=prompts,
                budgets=budgets, kw=kw, card=card, cpu=cpu)


def near_tie_agreement(label: str, cfg: dict, dense, prompts, ref: dict,
                       other: dict) -> tuple:
    """Compare two stream sets request by request: at the first token
    where ``other`` leaves ``ref``, the float32 dense model on the CPU
    must put ``ref``'s top two logits within NEAR_TIE_MARGIN (a near-tie
    that rounding may flip), or the divergence is a fault.  Returns
    (tokens agreeing before any divergence, tokens)."""
    import numpy as np
    import torch

    from kubegpu_tpu_torch.models.decoding import init_caches

    agree = total = 0
    for i in sorted(ref):
        a, c = other[i], ref[i]
        total += len(c)
        t = next((j for j in range(len(c)) if a[j] != c[j]), None)
        if t is None:
            agree += len(c)
            continue
        agree += t
        seq = np.concatenate([prompts[i], np.asarray(c[:t], np.int32)])
        caches = init_caches(1, cfg["num_layers"], cfg["num_heads"],
                             cfg["hidden"], cfg["max_seq"], torch.float32)
        with torch.no_grad():
            row = dense(torch.from_numpy(seq)[None], caches, 0)[0]
        top2 = torch.topk(row, 2).values
        margin = (top2[0] - top2[1]).item()
        log(f"request {i}: {label} diverge at token {t} "
            f"(cpu margin {margin:.3e})")
        assert margin <= NEAR_TIE_MARGIN, (
            f"request {i} diverged at token {t} with margin {margin}")
        log(f"request {i}: near-tie, not a fault")
    return agree, total


def phase_spec_card(ctx: dict) -> None:
    """Greedy speculation on the card against the card's plain streams
    (phase 6's model and traffic), for a hopeless draft (a fresh
    1-layer model) and a perfect one (the target itself)."""
    import torch

    from kubegpu_tpu_torch.models.paging import PagedContinuousBatcher
    from kubegpu_tpu_torch.models.params import init_params

    cfg, params = ctx["cfg"], ctx["params"]
    hopeless_cfg = dict(vocab_size=cfg["vocab_size"], num_layers=1,
                        hidden=64, max_seq=cfg["max_seq"])
    drafts = {
        "hopeless": (init_params(hopeless_cfg,
                                 torch.Generator().manual_seed(5),
                                 torch.float32, "cpu"),
                     dict(draft_num_layers=1, draft_num_heads=2,
                          draft_hidden=64)),
        "perfect": (params, dict(draft_num_layers=cfg["num_layers"],
                                 draft_num_heads=cfg["num_heads"],
                                 draft_hidden=cfg["hidden"])),
    }
    for k in (2, 4):
        verify_steps = {}
        for name, (dparams, dims) in drafts.items():
            streams = {}
            for pipe in (True, False):
                cb = PagedContinuousBatcher(
                    params, device="cuda", pipeline_decode=pipe,
                    draft_params=dparams, speculate_k=k, **dims,
                    **ctx["kw"])
                streams[pipe] = cb.run(ctx["prompts"], ctx["budgets"])
                cb.assert_page_accounting()
                verify_steps[name] = cb.stats["spec_steps"]
                log(f"speculation k={k} {name} draft pipeline={pipe}: "
                    f"{cb.stats['spec_steps']} verify steps for "
                    f"{cb.stats['spec_tokens']} tokens, draft ring wraps "
                    f"{cb.stats['draft_wraps']}")
            assert streams[True] == streams[False], (
                f"k={k} {name}: pipelined and synchronous card streams "
                "differ")
            agree, total = near_tie_agreement(
                f"k={k} {name} speculation and the plain card batcher",
                cfg, ctx["dense"], ctx["prompts"], ctx["card"],
                streams[True])
            log(f"speculation k={k} {name} draft vs plain card streams: "
                f"{agree}/{total} tokens agree before any near-tie "
                "divergence")
        assert verify_steps["perfect"] < verify_steps["hopeless"], (
            f"k={k}: the perfect draft took {verify_steps['perfect']} "
            f"verify steps, the hopeless one {verify_steps['hopeless']}")


def phase_int8_card_vs_cpu(ctx: dict) -> None:
    """Phase 6's model and traffic over an int8 pool with quantized
    sealing, card against CPU at float32."""
    import torch

    from kubegpu_tpu_torch.models.paging import PagedContinuousBatcher

    kw = dict(ctx["kw"], kv_dtype="int8", decode_page_cache="quantized")
    runs = {}
    for d, pipe in (("cpu", True), ("cuda", True), ("cuda", False)):
        cb = PagedContinuousBatcher(ctx["params"], device=d,
                                    pipeline_decode=pipe, **kw)
        runs[(d, pipe)] = (cb.run(ctx["prompts"], ctx["budgets"]), cb)
        cb.assert_page_accounting()
        log(f"int8 batcher {d} pipeline={pipe}: steps {cb.stats['steps']}, "
            f"decode pages sealed {cb.stats['decode_pages_sealed']}, seal "
            f"requantizations {cb.stats['seal_requants']}, prefix hit "
            f"tokens {cb.stats['prefix_hit_tokens']}")
        assert cb.stats["seal_requants"] > 0
    (cpu, cpu_cb), (card, card_cb) = runs[("cpu", True)], runs[("cuda", True)]
    assert card == runs[("cuda", False)][0], (
        "pipelined and synchronous int8 card streams differ")
    agree, total = near_tie_agreement("int8 card and cpu", ctx["cfg"],
                                      ctx["dense"], ctx["prompts"], cpu, card)
    log(f"int8 card vs cpu streams: {agree}/{total} tokens agree before any "
        "near-tie divergence")
    cached = sorted(card_cb.prefix_cache.pages())
    assert cached
    for kent, vent in card_cb.pools:
        for data, scale in (kent, vent):
            mx = data[cached].abs().amax(dim=(2, 3))
            assert ((mx == 127) | (scale[cached] == 0)).all(), (
                "a cache-owned page is not at full int8 range")
    log(f"int8 card: all {len(cached)} cache-owned pages at full int8 range")
    if card != cpu:
        log("int8 card vs cpu: the streams part at a near-tie, so their "
            "pools are not compared")
        return
    # page 0 is the dump page every idle lane writes, in no fixed order
    differ = elems = 0
    worst_scale = 0.0
    for (ck, cv), (gk, gv) in zip(cpu_cb.pools, card_cb.pools):
        for (cd, cs), (gd, gs) in ((ck, gk), (cv, gv)):
            diff = (gd[1:].cpu().int() - cd[1:].int()).abs()
            assert diff.max().item() <= 1, (
                f"card and cpu int8 pools differ by {diff.max().item()}")
            differ += int((diff != 0).sum())
            elems += diff.numel()
            rel = ((gs[1:].cpu() - cs[1:]).abs()
                   / cs[1:].abs().clamp(min=1e-30)).max().item()
            worst_scale = max(worst_scale, rel)
    log(f"int8 card vs cpu pools: {differ}/{elems} int8 elements "
        f"({differ / elems:.3e}) differ, each by one step; worst scale "
        f"relative difference {worst_scale:.3e}")


# -- the HTTP replica (phases 19-22) -----------------------------------------

def sse_request(port: int, path: str, body: dict, on_event=None,
                timeout: float = 300.0) -> list:
    """POST ``body`` over loopback and read the answer as it streams:
    returns ``[(event, payload, seconds since the request was sent)]``
    for an SSE answer, or ``[("json", payload, s)]`` for a JSON one.
    ``on_event(event, payload)`` is called as each event arrives."""
    import http.client

    t0 = time.monotonic()
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        conn.request("POST", path, json.dumps(body),
                     {"Content-Type": "application/json"})
        r = conn.getresponse()
        if r.getheader("Content-Type") != "text/event-stream":
            return [("json", json.loads(r.read()), time.monotonic() - t0)]
        events, ev = [], None
        while True:
            line = r.readline()
            if not line:
                break
            line = line.decode().strip()
            if line.startswith("event:"):
                ev = line[6:].strip()
            elif line.startswith("data:") and ev:
                payload = json.loads(line[5:].strip())
                events.append((ev, payload, time.monotonic() - t0))
                if on_event is not None:
                    on_event(ev, payload)
                if ev in ("done", "error"):
                    break
                ev = None
        return events
    finally:
        conn.close()


def http_get(port: int, path: str) -> str:
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        conn.request("GET", path)
        r = conn.getresponse()
        body = r.read().decode()
        assert r.status == 200, (path, r.status, body)
        return body
    finally:
        conn.close()


def post_concurrently(port: int, bodies: list) -> tuple:
    """POST every body at once, one thread each; returns (events by
    request index, wall seconds from the first send to the last
    terminal event)."""
    import threading

    got = {}

    def post(i):
        got[i] = sse_request(port, "/v1/submit", bodies[i])

    t0 = time.monotonic()
    threads = [threading.Thread(target=post, args=(i,))
               for i in range(len(bodies))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(600)
    assert sorted(got) == list(range(len(bodies))), "a request did not end"
    return got, time.monotonic() - t0


def post_from_another_process(port: int, bodies: list) -> tuple:
    """``post_concurrently`` run by a separate Python process, whose
    threads do not share this process's interpreter lock with the
    serving thread, as a gateway's would not."""
    import os

    code = ("import json, sys\n"
            "import chip_smoke as c\n"
            "a = json.load(sys.stdin)\n"
            "got, wall = c.post_concurrently(a['port'], a['bodies'])\n"
            "print(json.dumps({'got': got, 'wall': wall}))\n")
    proc = subprocess.run(
        [sys.executable, "-c", code], input=json.dumps(
            {"port": port, "bodies": bodies}), capture_output=True,
        text=True, timeout=600,
        cwd=os.path.dirname(os.path.abspath(__file__)))
    assert proc.returncode == 0, proc.stderr[-2000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    return ({int(i): [tuple(e) for e in events]
             for i, events in out["got"].items()}, out["wall"])


def check_streams(got: dict, budgets=None) -> tuple:
    """Every stream ended with ``done`` and its deltas concatenate to
    the done list (of its budget, when given); returns (streams,
    client-side TTFTs: the first tokens event's arrival)."""
    streams, ttfts = {}, []
    for i, events in sorted(got.items()):
        kind, done, _ = events[-1]
        assert kind == "done", (i, events[-1][:2])
        deltas = [t for k, e, _ in events[:-1] if k == "tokens"
                  for t in e["tokens"]]
        assert deltas == done["tokens"], (i, len(deltas), len(done["tokens"]))
        if budgets is not None:
            assert len(done["tokens"]) == budgets[i], (i, len(deltas))
        streams[i] = done["tokens"]
        ttfts.append(next(t for k, _, t in events if k == "tokens"))
    return streams, ttfts


def paged_counts() -> dict:
    from kubegpu_tpu_torch.ops.paged_attention import (
        paged_chunk_attention,
        paged_decode_attention,
    )

    return {"K1": (paged_decode_attention, "launches"),
            "K1q": (paged_decode_attention, "int8_launches"),
            "K2": (paged_chunk_attention, "launches"),
            "K2q": (paged_chunk_attention, "int8_launches")}


def phase_http_flagship(speculate: bool = False) -> dict:
    """The flagship behind an in-process ``ReplicaServer``: 16 requests
    posted concurrently over loopback, a long request cancelled over the
    wire mid-stream.  The batcher comes from the worker's own
    ``build_batcher`` and ``warm_batcher``."""
    import numpy as np
    import torch

    from kubegpu_tpu_torch.gateway.dataplane import ReplicaServer
    from kubegpu_tpu_torch.models import worker
    from kubegpu_tpu_torch.utils.metrics import Metrics

    argv = FLAGSHIP_ARGV + (["--speculate", "--spec-k", str(SPEC_K)]
                            if speculate else [])
    label = "http speculative flagship" if speculate else "http flagship"
    kname = "K2" if speculate else "K1"
    args = worker.build_parser().parse_args(argv)
    torch.cuda.empty_cache()
    cb = worker.build_batcher(args)
    worker.warm_batcher(cb)
    metrics = Metrics()
    cb.attach_metrics(metrics)
    counters = paged_counts()
    rng = np.random.RandomState(19)
    n_req = 2 * args.batch_per_chip
    prompts = worker.wave_requests(rng, n_req, args.vocab, args.prompt_len)
    budgets = [max(args.steps * (1 + i % 4) // 4, 1) for i in range(n_req)]
    bodies = [{"request_id": f"f{i}", "prompt": p.tolist(),
               "max_new_tokens": budgets[i]} for i, p in enumerate(prompts)]
    # the same batcher and traffic in process first, for a same-call
    # comparison with the wire (its stats and ledger reset after)
    cb.attach_metrics(None)
    t_in = time.monotonic()
    local = cb.run(prompts, budgets)
    torch.cuda.synchronize()
    t_in = time.monotonic() - t_in
    in_ttft = list(cb.first_token_s.values())
    in_rows = [r for r in cb.ledger_rows() if r["active"]]
    in_tokens = sum(len(v) for v in local.values())
    log(f"{label}: in process, the same batcher and traffic: {in_tokens} "
        f"tokens in {t_in:.3f} s -> {in_tokens / t_in:.1f} tok/s; TTFT mean "
        f"{np.mean(in_ttft) * 1e3:.1f} ms max {max(in_ttft) * 1e3:.1f} ms; "
        f"{cb.stats['steps']} steps, decode rows' host_ms mean "
        f"{np.mean([r['host_ms'] for r in in_rows]):.3f} device_ms mean "
        f"{np.mean([r['device_ms'] for r in in_rows]):.3f}")
    cb._reset_stats()
    cb._ledger.clear()
    cb.attach_metrics(metrics)
    srv = ReplicaServer(cb, metrics=metrics).start()
    try:
        for fn, attr in counters.values():
            setattr(fn, attr, 0)
        got, wall = post_concurrently(srv.port, bodies)
        state = json.loads(http_get(srv.port, "/v1/state?ledger=512"))
        scrape = http_get(srv.port, "/metrics")
    finally:
        srv.stop()
    # the counts are read once the serving thread has stopped
    launches = {k: getattr(fn, attr) for k, (fn, attr) in counters.items()}
    assert srv.loop.error is None, srv.loop.error
    streams, ttfts = check_streams(got, budgets)
    same = sum(streams[i] == local[i] for i in streams)
    log(f"{label}: {same}/{n_req} streams over the wire equal the in-process "
        "ones (bf16: a different admission order may flip near-ties)")
    steps = cb.stats["spec_steps" if speculate else "steps"]
    rows = state["ledger"]
    ttft_count = next(
        float(line.split()[-1]) for line in scrape.splitlines()
        if line.startswith("serve_ttft_seconds_count"))
    tokens = sum(len(v) for v in streams.values())
    last = rows[-1]
    host = [r["host_ms"] for r in rows if r["active"]]
    device = [r["device_ms"] for r in rows if r["active"]]
    log(f"{label}: {n_req} requests over loopback, {tokens} tokens in "
        f"{wall:.3f} s -> {tokens / wall:.1f} tok/s over the wire; client "
        f"TTFT mean {np.mean(ttfts) * 1e3:.1f} ms max "
        f"{max(ttfts) * 1e3:.1f} ms; /metrics serve_ttft_seconds_count "
        f"{ttft_count:.0f}; ledger rows {len(rows)}, decode rows' host_ms "
        f"mean {np.mean(host):.3f} device_ms mean {np.mean(device):.3f}; "
        f"last row host_ms {last['host_ms']} device_ms {last['device_ms']}; "
        f"launches {launches}")
    n = launches.pop(kname)
    log(f"{label}: {kname} launches {n} = "
        f"{'verify' if speculate else 'decode'} steps {steps} x layers "
        f"{args.layers}; others {launches}")
    assert n > 0 and n == steps * args.layers
    assert not any(launches.values()), launches
    assert ttft_count == n_req
    # a second endpoint over the same batcher: the same traffic from a
    # client in another process, then the wire cancel — a long request
    # cancelled after its second token event, and a short probe request
    # (one page, nothing sealed) to refresh the ledger row that
    # /v1/state's page counts come from
    cb._reset_stats()
    cb._ledger.clear()
    srv = ReplicaServer(cb, metrics=Metrics()).start()
    try:
        got_x, wall_x = post_from_another_process(srv.port, bodies)
        state_x = json.loads(http_get(srv.port, "/v1/state?ledger=512"))
        idle = state_x["pages"]
        rows_x = [r for r in state_x["ledger"] if r["active"]]
        _, ttfts_x = check_streams(got_x, budgets)
        log(f"{label}: the same traffic from a client in another process: "
            f"{tokens} tokens in {wall_x:.3f} s -> {tokens / wall_x:.1f} "
            f"tok/s; client TTFT mean {np.mean(ttfts_x) * 1e3:.1f} ms max "
            f"{max(ttfts_x) * 1e3:.1f} ms; {cb.stats['steps']} steps, "
            f"decode rows' host_ms mean "
            f"{np.mean([r['host_ms'] for r in rows_x]):.3f} device_ms mean "
            f"{np.mean([r['device_ms'] for r in rows_x]):.3f}")
        seen = []

        def cancel_after_two(ev, payload):
            if ev == "tokens":
                seen.append(payload)
                if len(seen) == 2:
                    ans = sse_request(srv.port, "/v1/cancel",
                                      {"request_id": "long"})
                    assert ans[0][1] == {"cancelled": True}, ans

        long_budget = args.seq + 1 - args.prompt_len - (
            SPEC_K if speculate else 0) - 64
        events = sse_request(srv.port, "/v1/submit", {
            "request_id": "long", "prompt": prompts[0].tolist(),
            "max_new_tokens": long_budget}, on_event=cancel_after_two)
        kind, payload, _ = events[-1]
        assert kind == "error" and payload["error"] == "cancelled", (
            kind, payload)
        streamed = sum(len(p["tokens"]) for p in seen)
        probe = sse_request(srv.port, "/v1/submit", {
            "request_id": "probe", "prompt": [1, 2, 3], "max_new_tokens": 1})
        assert probe[-1][0] == "done"
        after = json.loads(http_get(srv.port, "/v1/state"))
    finally:
        srv.stop()
    assert srv.loop.error is None, srv.loop.error
    log(f"{label}: wire cancel after {streamed} of {long_budget} tokens; "
        f"pages idle {idle}, after the cancel {after['pages']}; active "
        f"streams {after['active_streams']}")
    assert streamed < long_budget
    assert after["active_streams"] == 0
    for key in ("free", "live", "cached"):
        assert after["pages"][key] == idle[key], (key, idle, after)
    cb.assert_page_accounting()
    assert not cb.has_work()
    result = dict(requests=n_req, tokens=tokens, wall_s=wall,
                  tokens_per_sec=tokens / wall, ttft_mean_s=float(
                      np.mean(ttfts)), ttft_max_s=max(ttfts), launches=n,
                  steps=steps, host_ms_mean=float(np.mean(host)),
                  device_ms_mean=float(np.mean(device)))
    del cb, srv
    torch.cuda.empty_cache()
    return result


def phase_http_card_vs_cpu(ctx: dict) -> None:
    """Phase 6's model and traffic through a card ``ReplicaServer`` over
    loopback, against the same weights' CPU batcher in process (phase
    6's streams), under the near-tie rule."""
    import torch

    from kubegpu_tpu_torch.gateway.dataplane import ReplicaServer
    from kubegpu_tpu_torch.models.paging import PagedContinuousBatcher

    cb = PagedContinuousBatcher(ctx["params"], device="cuda", **ctx["kw"])
    bodies = [{"request_id": f"c{i}", "prompt": p.tolist(),
               "max_new_tokens": ctx["budgets"][i]}
              for i, p in enumerate(ctx["prompts"])]
    srv = ReplicaServer(cb).start()
    try:
        got, wall = post_concurrently(srv.port, bodies)
    finally:
        srv.stop()
    assert srv.loop.error is None, srv.loop.error
    wire, _ = check_streams(got, ctx["budgets"])
    cb.assert_page_accounting()
    agree, total = near_tie_agreement("card over the wire and cpu",
                                      ctx["cfg"], ctx["dense"],
                                      ctx["prompts"], ctx["cpu"], wire)
    log(f"card over the wire vs cpu in process (fp32): {agree}/{total} "
        f"tokens agree before any near-tie divergence; {len(wire)} streams "
        f"in {wall:.3f} s")
    del cb, srv
    torch.cuda.empty_cache()


def phase_http_worker() -> dict:
    """The entry point: ``python -m kubegpu_tpu_torch.models.worker
    --model decode --serve-http 0`` at the worker's defaults, in a
    subprocess: it must advertise its port (room for a cold kernel
    build), answer one submit with a full ``done`` and exit 0 on
    SIGTERM.  The process is killed if anything fails."""
    import os
    import signal

    cmd = [sys.executable, "-m", "kubegpu_tpu_torch.models.worker",
           "--model", "decode", "--serving", "paged", "--serve-http", "0"]
    root = os.path.dirname(os.path.abspath(__file__))
    t0 = time.monotonic()
    proc = subprocess.Popen(cmd, cwd=root, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    lines = ProcLines(proc)
    try:
        line = lines.until("REPLICA_HTTP_SERVING", 300)
        up_s = time.monotonic() - t0
        port = int(fields(line)["port"])
        events = sse_request(port, "/v1/submit", {
            "request_id": "w", "prompt": [5, 6, 7, 8], "max_new_tokens": 8})
        streams, _ = check_streams({0: events}, [8])
        proc.send_signal(signal.SIGTERM)
        rc = lines.wait(120)
        stopped = next(x for x in lines.out
                       if x.startswith("REPLICA_HTTP_STOPPED"))
        log(f"worker --serve-http 0 at its defaults: {line}; "
            f"REPLICA_HTTP_SERVING {up_s:.1f} s after the launch; one "
            f"submit -> {len(streams[0])} tokens; {stopped}; exit {rc}")
        assert rc == 0, (lines.out, lines.tail())
        assert "error=False" in stopped
        return dict(serving_s=up_s)
    finally:
        lines.kill()


# -- sampling (phases 23-25) --------------------------------------------------

# jax.random's values, computed once by JAX 0.9 (threefry, partitionable
# layout) on the CPU: the card has no JAX, so these literals hold the
# port's draws to the reference directly
GOLDEN = {
    "fold_in(PRNGKey(42), 7)": [2547012911, 1371500959],
    "split(PRNGKey(42), 3)": [[1832780943, 270669613],
                              [64467757, 2916123636],
                              [2465931498, 255383827]],
    # bits(fold_in(PRNGKey(42), 7), (8, 32768)) at [0, 0], [3, 1000],
    # [7, 32767]; of shape (8, 5, 32768) at [0, 0, 0], [5, 2, 17],
    # [7, 4, 32767]
    "bits 8x32768": [2635269230, 2102076962, 276564076],
    "bits 8x5x32768": [2635269230, 1593718684, 827050376],
    "uniform(PRNGKey(7), (4,)) bits": [0x3F2C9128, 0x3F79807E, 0x3E9B0E50,
                                       0x3EE34E88],
    "position_key(PRNGKey(2**31 - 1), 4095, ACCEPT)": [1186638194,
                                                       2970669281],
    "PRNGKey(2**40 + 3), PRNGKey(-1)": [[0, 3], [0, 4294967295]],
    # categorical(PRNGKey(5), (arange(32) % 5 * 0.25).reshape(2, 16))
    "categorical 2x16": [4, 4],
    # vmap(categorical)(split(PRNGKey(9), 8), RandomState(0).randn(8,
    # 32768) as float32)
    "categorical rows 8x32768": [10855, 18049, 24438, 27176, 3754, 14477,
                                 14353, 19657],
}
SAMPLE_NEAR_TIE = 1e-4   # a draw whose deciding gap is smaller may flip
SAMPLE_TEMP = "0.8"


def gumbel_ulps(got, want):
    """Largest |got - want| over the spacing of max(|want|, 1): gumbel's
    ulp at its own scale."""
    import torch

    scale = torch.maximum(want.abs(), torch.ones_like(want))
    spacing = torch.nextafter(scale, torch.full_like(scale, float("inf"))
                              ) - scale
    return ((got - want).abs() / spacing).max().item()


def top2_gap(scores) -> float:
    import torch

    v = torch.topk(scores, 2, dim=-1).values
    return (v[..., 0] - v[..., 1]).min().item()


def phase_prng() -> None:
    """The port's threefry draws on the card: equal to the CPU port's bit
    for bit and to JAX's golden values; gumbel within 2 ulp of the
    CPU's, categorical identical but for classified near-ties."""
    import numpy as np
    import torch

    from kubegpu_tpu_torch.models.decoding import (
        KEY_TAG_ACCEPT,
        position_key,
    )
    from kubegpu_tpu_torch.ops import prng

    key = prng.fold_in(prng.PRNGKey(42), 7)
    for d in ("cpu", "cuda"):
        k = prng.PRNGKey(42).to(d)
        assert prng.fold_in(k, 7).tolist() == GOLDEN[
            "fold_in(PRNGKey(42), 7)"], d
        assert prng.split(k, 3).tolist() == GOLDEN["split(PRNGKey(42), 3)"]
        b2 = prng.random_bits(key.to(d), (8, 32768))
        b3 = prng.random_bits(key.to(d), (8, 5, 32768))
        assert [b2[0, 0].item(), b2[3, 1000].item(), b2[7, 32767].item()] \
            == GOLDEN["bits 8x32768"], d
        assert [b3[0, 0, 0].item(), b3[5, 2, 17].item(),
                b3[7, 4, 32767].item()] == GOLDEN["bits 8x5x32768"], d
        u = prng.uniform(prng.PRNGKey(7).to(d), (4,))
        assert (u.cpu().view(torch.int32).tolist()
                == GOLDEN["uniform(PRNGKey(7), (4,)) bits"]), d
        assert position_key(prng.PRNGKey(2 ** 31 - 1).to(d), 4095,
                            KEY_TAG_ACCEPT).tolist() == GOLDEN[
            "position_key(PRNGKey(2**31 - 1), 4095, ACCEPT)"], d
    assert [prng.PRNGKey(2 ** 40 + 3).tolist(), prng.PRNGKey(-1).tolist()] \
        == GOLDEN["PRNGKey(2**40 + 3), PRNGKey(-1)"]
    # card against the CPU port, bit for bit, at the serving shapes: one
    # key per row (or per row and window slot) drawing a vocabulary, and
    # one key drawing the whole block
    keys8 = prng.split(prng.PRNGKey(3), 8)                 # (8, 2)
    keys85 = prng.split(prng.PRNGKey(4), (8, 5))           # (8, 5, 2)
    for keys, shape in ((keys8, (32768,)), (keys85, (32768,)),
                        (prng.PRNGKey(6), (8, 32768)),
                        (prng.PRNGKey(6), (8, 5, 32768))):
        for fn in (prng.random_bits, prng.uniform):
            want = fn(keys, shape)
            got = fn(keys.cuda(), shape).cpu()
            assert torch.equal(got, want), (fn.__name__, tuple(want.shape))
        want = prng.gumbel(keys, shape)
        ulp = gumbel_ulps(prng.gumbel(keys.cuda(), shape).cpu(), want)
        assert ulp <= 2, ("gumbel", ulp)
    # split into (8, 32768) and (8, 5, 32768) keys, each folding its own
    # datum
    for shape in ((8, 32768), (8, 5, 32768)):
        keys = prng.split(prng.PRNGKey(12), shape)
        assert torch.equal(prng.split(prng.PRNGKey(12).cuda(), shape).cpu(),
                           keys)
        data = torch.arange(keys[..., 0].numel()).view(shape) * 977 - 3
        assert torch.equal(prng.fold_in(keys.cuda(), data.cuda()).cpu(),
                           prng.fold_in(keys, data))
    # categorical: the golden draws and card against CPU
    lg = (torch.arange(32, dtype=torch.float32).view(2, 16) % 5) * 0.25
    rows = torch.from_numpy(
        np.random.RandomState(0).randn(8, 32768).astype(np.float32))
    rkeys = prng.split(prng.PRNGKey(9), 8)
    flips = 0
    for keys, logits, name in ((prng.PRNGKey(5), lg, "categorical 2x16"),
                               (rkeys, rows, "categorical rows 8x32768")):
        for d in ("cpu", "cuda"):
            got = prng.categorical(keys.to(d), logits.to(d)).cpu()
            scores = (prng.gumbel(keys, logits.shape[keys.dim() - 1:])
                      + logits)
            for r, (g, w) in enumerate(zip(got.tolist(), GOLDEN[name])):
                if g != w:
                    gap = top2_gap(scores[r])
                    log(f"{name} row {r} on {d}: {g} against JAX's {w}, "
                        f"top-2 perturbed gap {gap:.3e}")
                    assert gap <= SAMPLE_NEAR_TIE, (name, r, d, gap)
                    flips += 1
    log(f"prng: threefry bits, uniforms, fold_in and split on the card "
        f"equal the CPU port's bit for bit at (8, 32768) and (8, 5, 32768) "
        f"and JAX's golden values; gumbel within 2 ulp; categorical draws "
        f"equal JAX's but {flips} classified near-ties")


SAMPLED_FLAGSHIP = (
    ("sampled T 0.8", ["--sample-temperature", SAMPLE_TEMP]),
    ("sampled T 0.8 top-k 50", ["--sample-temperature", SAMPLE_TEMP,
                                "--sample-top-k", "50"]),
    ("sampled speculative k 4 T 0.8", ["--speculate", "--spec-k",
                                       str(SPEC_K), "--sample-temperature",
                                       SAMPLE_TEMP]),
)


def steady_step_cost(flags) -> dict:
    """A steady window of the flagship with 8 decoding slots
    (``profile_serving``): ms a step and tokens/s from an unprofiled
    window, device kernel launches a step from a profiled one."""
    import torch

    from kubegpu_tpu_torch import profile_serving as ps

    cb = ps.steady_batcher(flags)
    wall, tokens = ps.timed_window(cb)
    _, kernels = ps.profiled_window(cb)
    assert kernels, "the profiler recorded no device kernel"
    del cb
    torch.cuda.empty_cache()
    return dict(ms=wall / ps.WINDOW * 1e3, tok_s=tokens / wall,
                launches=sum(n for _, n in kernels.values()) / ps.WINDOW)


def phase_sampled_flagship(greedy: dict, greedy_spec: dict) -> dict:
    """Sampled flagship serving, bf16, through the worker's entry point:
    every budget met, K1 (K2 speculating) launched steps x layers times,
    a second run of the same waves byte-identical; ms a step, tokens/s
    and launches a step beside the greedy runs of this call."""
    out = {}
    for label, flags in SAMPLED_FLAGSHIP:
        spec = "--speculate" in flags
        runs = [run_wave(f"{label} (run {n})", FLAGSHIP_ARGV + flags)
                for n in (1, 2)]
        (r, args, _, _), (r2, _, _, _) = runs
        assert r["outputs"] == r2["outputs"], (
            f"{label}: the seed-pinned wave did not replay")
        for rr, _, launches, _ in runs:
            if spec:
                # every sampled admission draws its first token through
                # one b = 1 plain step (K1), then verifies through K2
                admits = 2 * rr["requests"]
                assert launches["K2"] == rr["spec_steps_total"] * args.layers
                assert launches["K1"] == admits * args.layers, launches
            else:
                assert launches["K1"] == rr["decode_steps_total"] * args.layers
                assert launches["K2"] == 0
            assert launches["K1q"] == launches["K2q"] == 0
        ref = greedy_spec if spec else greedy
        ms, ref_ms = (r["wave_s"] / r["steps"] * 1e3,
                      ref["wave_s"] / ref["steps"] * 1e3)
        log(f"{label}: replay byte-identical; {ms:.3f} ms a step, "
            f"{r['tokens_per_sec']:.1f} tok/s over {r['steps']} steps "
            f"against the greedy wave's {ref_ms:.3f} ms a step, "
            f"{ref['tokens_per_sec']:.1f} tok/s over {ref['steps']} steps "
            f"(this call)")
        out[label] = dict(ms_step=ms, tok_s=r["tokens_per_sec"])
    spec = ["--speculate", "--spec-k", str(SPEC_K)]
    sample = ["--sample-temperature", SAMPLE_TEMP]
    for label, flags in (("greedy", []), ("sampled", sample),
                         ("greedy speculative", spec),
                         ("sampled speculative", spec + sample)):
        cost = steady_step_cost(flags)
        log(f"steady flagship step, 8 slots, {label}: {cost['ms']:.3f} ms "
            f"a step, {cost['tok_s']:.1f} tok/s, {cost['launches']:.1f} "
            "device kernel launches a step")
        out[f"steady {label}"] = cost
    return out


def draw_gaps(ctx, seq, temp: float, seed: int, draft=None) -> list:
    """The CPU's gaps deciding the token drawn after ``seq`` (at absolute
    position len(seq)) of a seed-pinned request, at float32: the top-2
    gap of the target's perturbed scores (logit/T + gumbel); speculating,
    also the draft proposal's top-2 gap and the accept test's |u q - p|.
    A token is a near-tie if the smallest is within SAMPLE_NEAR_TIE."""
    import torch

    from kubegpu_tpu_torch.models.decoding import (
        KEY_TAG_ACCEPT,
        KEY_TAG_DRAFT,
        KEY_TAG_SAMPLE,
        init_caches,
        position_key,
        warp_logits,
    )
    from kubegpu_tpu_torch.ops import prng

    def last_logits(model):
        caches = init_caches(1, model.num_layers, model.num_heads,
                             model.hidden, model.max_seq, torch.float32)
        with torch.no_grad():
            return model(torch.from_numpy(seq)[None], caches, 0)[0]

    pos, base = len(seq), prng.PRNGKey(seed)
    t = torch.tensor(temp)
    tw = warp_logits(last_logits(ctx["dense"]), t)
    vocab = tw.shape[-1]
    if draft is None:
        return [top2_gap(tw + prng.gumbel(prng.fold_in(base, pos), vocab))]
    gaps = [top2_gap(tw + prng.gumbel(
        position_key(base, pos, KEY_TAG_SAMPLE), vocab))]
    dw = warp_logits(last_logits(draft), t)
    d_scores = dw + prng.gumbel(position_key(base, pos, KEY_TAG_DRAFT), vocab)
    gaps.append(top2_gap(d_scores))
    x = d_scores.argmax()
    p, q = torch.softmax(tw, -1)[x], torch.softmax(dw, -1)[x]
    u = prng.uniform(position_key(base, pos, KEY_TAG_ACCEPT))
    gaps.append(abs((u * q - p).item()))
    return gaps


def sampled_agreement(label, ctx, ref, other, temps, seeds,
                      draft=None) -> tuple:
    """Compare two seed-pinned sampled stream sets request by request, up
    to each first difference: there the CPU must find a near-tie
    (``draw_gaps``), or the divergence is a fault.  Returns (tokens
    agreeing before any divergence, tokens, near-ties)."""
    import numpy as np

    agree = total = ties = 0
    for i in sorted(ref):
        a, c = other[i], ref[i]
        total += len(c)
        t = next((j for j in range(len(c)) if a[j] != c[j]), None)
        if t is None:
            agree += len(c)
            continue
        agree += t
        seq = np.concatenate([ctx["prompts"][i], np.asarray(c[:t], np.int32)])
        gaps = draw_gaps(ctx, seq, temps[i], seeds[i], draft)
        log(f"request {i}: {label} diverge at token {t}; the CPU's deciding "
            f"gaps {', '.join(f'{g:.3e}' for g in gaps)}")
        assert min(gaps) <= SAMPLE_NEAR_TIE, (
            f"request {i} diverged at token {t}, no near-tie: {gaps}")
        ties += 1
    return agree, total, ties


def phase_sampled_card_vs_cpu(ctx: dict) -> None:
    """Phase 6's model and prompts as seed-pinned sampled traffic at
    float32, card against CPU: plain (K1), speculative k 4 with phase 7's
    hopeless draft (K2), an int8 pool plain (K1q) and speculative (K2q);
    then the plain traffic over the wire through a card
    ``ReplicaServer`` against the card's in-process streams."""
    import torch

    from kubegpu_tpu_torch.gateway.dataplane import ReplicaServer
    from kubegpu_tpu_torch.models.decoding import DecodeLM
    from kubegpu_tpu_torch.models.paging import PagedContinuousBatcher
    from kubegpu_tpu_torch.models.params import bind_params, init_params

    cfg, n = ctx["cfg"], len(ctx["prompts"])
    temps = [0.8, 1.0, 0.7, 1.2, 0.9, 0.6, 1.1, 0.8][:n]
    seeds = [100 + i for i in range(n)]
    d_cfg = dict(vocab_size=cfg["vocab_size"], num_layers=1, hidden=64,
                 max_seq=cfg["max_seq"])
    dparams = init_params(d_cfg, torch.Generator().manual_seed(5),
                          torch.float32, "cpu")
    draft = bind_params(DecodeLM(num_heads=2, dtype=torch.float32, **d_cfg),
                        dparams)
    spec = dict(draft_params=dparams, speculate_k=SPEC_K, sampling=True,
                draft_num_layers=1, draft_num_heads=2, draft_hidden=64)
    configs = (("plain", {}, "K1"), ("speculative", spec, "K2"),
               ("int8 pool", dict(kv_dtype="int8"), "K1q"),
               ("int8 speculative", dict(spec, kv_dtype="int8"), "K2q"))
    counters = paged_counts()
    card_plain = None
    for name, kw, kernel in configs:
        streams = {}
        for d in ("cpu", "cuda"):
            for fn, attr in counters.values():
                setattr(fn, attr, 0)
            cb = PagedContinuousBatcher(ctx["params"], device=d,
                                        **ctx["kw"], **kw)
            streams[d] = cb.run(ctx["prompts"], ctx["budgets"],
                                temperatures=temps, seeds=seeds)
            cb.assert_page_accounting()
        fn, attr = counters[kernel]
        assert getattr(fn, attr) > 0, (name, kernel)
        agree, total, ties = sampled_agreement(
            f"sampled {name} card and cpu", ctx, streams["cpu"],
            streams["cuda"], temps, seeds, draft if "speculate_k" in kw
            else None)
        log(f"sampled {name} card vs cpu (fp32, seed-pinned, {kernel} "
            f"{getattr(fn, attr)} launches): {agree}/{total} tokens agree "
            f"before any divergence, {ties} near-ties")
        if name == "plain":
            card_plain = streams["cuda"]
    cb = PagedContinuousBatcher(ctx["params"], device="cuda", **ctx["kw"])
    bodies = [{"request_id": f"s{i}", "prompt": p.tolist(),
               "max_new_tokens": ctx["budgets"][i], "temperature": temps[i],
               "seed": seeds[i]} for i, p in enumerate(ctx["prompts"])]
    srv = ReplicaServer(cb).start()
    try:
        got, wall = post_concurrently(srv.port, bodies)
    finally:
        srv.stop()
    assert srv.loop.error is None, srv.loop.error
    wire, _ = check_streams(got, ctx["budgets"])
    cb.assert_page_accounting()
    agree, total, ties = sampled_agreement(
        "sampled card over the wire and card in process", ctx, card_plain,
        wire, temps, seeds)
    log(f"sampled card over the wire vs in process (fp32, seed-pinned): "
        f"{agree}/{total} tokens agree before any divergence, {ties} "
        f"near-ties; {len(wire)} streams in {wall:.3f} s")
    del cb, srv
    torch.cuda.empty_cache()


# -- migration and disaggregation (phases 26-28) ------------------------------

# bench.py's serving_migration at full width: vocab 32768, 4 layers,
# hidden 4096, 32 heads of 128, pages of 64, prompt_pad 320, max_seq 768
MIGRATION_CFG = dict(vocab_size=32768, num_layers=4, num_heads=32,
                     hidden=4096, max_seq=768)
MIGRATION_KW = dict(slots=4, prompt_pad=320, page_size=64, pool_pages=64)
MIGRATION_TURNS = dict(p1_len=128, t1_new=65, t2_new=32, probes=3)
# a bfloat16 near-tie: the card's dense model puts the reference's top
# two logits this close at the first differing token
BF16_NEAR_TIE_MARGIN = 0.125


def fresh_params(cfg: dict, dtype, device: str = "cuda", seed: int = 0):
    """Weights drawn as the worker draws them (float32 from ``seed``, then
    cast to ``dtype``), on ``device``."""
    import torch

    from kubegpu_tpu_torch.models.params import init_params, tree_map

    gen = torch.Generator(device=device).manual_seed(seed)
    params = init_params(cfg, gen, torch.float32, device)
    return tree_map(lambda t: t.to(dtype), params)


def dense_margin(params, cfg: dict, dtype, tokens, device: str) -> float:
    """The top-2 logit margin of the dense model (``params`` at
    ``dtype``, float32 head) after ``tokens``: how near a tie the next
    token is."""
    import numpy as np
    import torch

    from kubegpu_tpu_torch.models.decoding import DecodeLM, init_caches
    from kubegpu_tpu_torch.models.params import bind_params

    dense = bind_params(DecodeLM(dtype=dtype, **cfg), params)
    caches = init_caches(1, cfg["num_layers"], cfg["num_heads"],
                         cfg["hidden"], cfg["max_seq"], dtype, device)
    with torch.no_grad():
        row = dense(torch.from_numpy(np.asarray(tokens, np.int32))[None].to(
            device), caches, 0)[0].float()
    top2 = torch.topk(row, 2).values
    return (top2[0] - top2[1]).item()


def same_or_near_tie(label: str, got, want, prompt, margin_fn,
                     limit: float) -> int:
    """``got`` equals ``want`` up to its end, or parts from it where
    ``margin_fn(prompt + want[:t])`` finds a near-tie (within ``limit``,
    printed).  Returns the tokens agreeing before any divergence."""
    t = next((j for j in range(len(want)) if got[j] != want[j]), None)
    assert len(got) == len(want), (label, len(got), len(want))
    if t is None:
        return len(want)
    margin = margin_fn(list(prompt) + list(want[:t]))
    log(f"{label}: diverges at token {t} (margin {margin:.3e})")
    assert margin <= limit, (f"{label} diverged at token {t} with margin "
                             f"{margin}")
    log(f"{label}: near-tie, not a fault")
    return t


def through_codec(payload: dict) -> tuple:
    """A payload through the wire codec: (decoded payload, wire bytes,
    encode seconds, decode seconds)."""
    from kubegpu_tpu_torch.gateway.dataplane import (
        decode_kv_payload,
        encode_kv_payload,
    )

    t0 = time.perf_counter()
    wire = json.dumps(encode_kv_payload(payload))
    t1 = time.perf_counter()
    back = decode_kv_payload(json.loads(wire))
    return back, len(wire), t1 - t0, time.perf_counter() - t1


def raw_page_bytes(payload: dict) -> int:
    """Raw bytes of a payload's page and scale arrays."""
    return sum(int(a.nbytes) for sect in ("layers", "scales")
               for pair in payload.get(sect, []) for a in pair)


def sync(device: str) -> None:
    import torch

    if device == "cuda":
        torch.cuda.synchronize()


def phase_migration_bench(cfg: dict = MIGRATION_CFG,
                          kw: dict = MIGRATION_KW,
                          turns: dict = MIGRATION_TURNS,
                          device: str = "cuda") -> dict:
    """bench.py's serving_migration at full width, bf16 then an int8
    pool: turn 1 completes on A, A's sealed chain crosses the codec into
    B, and turn 2 runs on B (restored) and C (cold), min-of-N TTFT with
    the orders interleaved.  Restored TTFT strictly below cold; restored
    tokens equal to the turn 2 that never migrated (on A), cold under
    the near-tie rule; int8 bytes a page half of bf16's plus the
    scales."""
    import numpy as np
    import torch

    from kubegpu_tpu_torch.models.paging import PagedContinuousBatcher

    params = fresh_params(cfg, torch.bfloat16, device)
    out = {}
    for pool in ("bfloat16", "int8"):
        extra = dict(kv_dtype="int8") if pool == "int8" else {}
        mk = (lambda: PagedContinuousBatcher(
            params, dtype=torch.bfloat16, device=device,
            decode_page_cache="all", **cfg, **kw, **extra))
        home, restored, cold = mk(), mk(), mk()
        rs = np.random.RandomState(17)
        warm = rs.randint(0, cfg["vocab_size"],
                          size=turns["p1_len"]).astype(np.int32)
        for cb in (home, restored, cold):      # first use off the clock
            cb.run([warm], [turns["t1_new"]])

        def drive_ttft(cb, seq, prompt, budget):
            t0 = time.perf_counter()
            cb.submit(seq, prompt, budget)
            t1, done = None, {}
            while cb.has_work():
                done.update(cb.serve_step())
                if t1 is None and (cb.live_tokens().get(seq)
                                   or done.get(seq)):
                    t1 = time.perf_counter()
            return t1 - t0, done[seq]

        ttft = {"restored": [], "cold": []}
        wire_bytes = raw = pages = 0
        t_export = t_import = t_codec = 0.0
        export_ms = []
        agree = total = 0
        margin_fn = (lambda toks: dense_margin(params, cfg, torch.bfloat16,
                                               toks, device))
        for p in range(turns["probes"]):
            p1 = rs.randint(0, cfg["vocab_size"],
                            size=turns["p1_len"]).astype(np.int32)
            _, t1_toks = drive_ttft(home, 100 + p, p1, turns["t1_new"])
            stream = [int(t) for t in p1] + t1_toks
            p2 = np.asarray(stream + [int(rs.randint(0, cfg["vocab_size"]))],
                            np.int32)
            sync(device)
            te0 = time.perf_counter()
            payload = home.export_sealed_chain(stream)
            te1 = time.perf_counter()
            assert payload is not None, "turn 1 sealed nothing"
            back, nbytes, enc_s, dec_s = through_codec(payload)
            ti0 = time.perf_counter()
            n = restored.import_sealed_chain(back)
            sync(device)
            t_import += time.perf_counter() - ti0
            t_export += te1 - te0
            export_ms.append(round((te1 - te0) * 1e3, 3))
            t_codec += enc_s + dec_s
            assert n == len(payload["page_keys"]) > 0, n
            wire_bytes += nbytes
            raw += raw_page_bytes(payload)
            pages += n
            lanes = [("restored", restored), ("cold", cold)]
            if p % 2:
                lanes = lanes[::-1]
            toks = {}
            for name, cb in lanes:
                t, toks[name] = drive_ttft(cb, 200 + p, p2,
                                           turns["t2_new"])
                ttft[name].append(t)
            _, ref = drive_ttft(home, 300 + p, p2, turns["t2_new"])
            assert toks["restored"] == ref, (
                "the restored turn 2 differs from the never-migrated one")
            agree += same_or_near_tie(f"{pool} cold turn 2, probe {p}",
                                      toks["cold"], ref, p2, margin_fn,
                                      BF16_NEAR_TIE_MARGIN)
            total += len(ref)
            for cb in (home, restored, cold):
                cb.assert_page_accounting()
        best_r, best_c = min(ttft["restored"]), min(ttft["cold"])
        moved_s = t_export + t_codec + t_import
        rec = dict(ttft_restored_ms=best_r * 1e3, ttft_cold_ms=best_c * 1e3,
                   pages=pages, wire_bytes=wire_bytes,
                   wire_bytes_per_page=wire_bytes / pages,
                   raw_bytes_per_page=raw / pages,
                   export_ms_per_page=t_export * 1e3 / pages,
                   import_ms_per_page=t_import * 1e3 / pages,
                   codec_ms_per_page=t_codec * 1e3 / pages,
                   pages_per_s=pages / moved_s)
        log(f"migration bench ({pool} pool, {turns['probes']} probes, warm "
            f"batchers): re-pin TTFT restored {rec['ttft_restored_ms']:.3f} "
            f"ms vs cold {rec['ttft_cold_ms']:.3f} ms "
            f"({best_c / best_r:.2f}x); {pages} pages moved, {wire_bytes} "
            f"wire bytes ({rec['wire_bytes_per_page']:.0f} B/page on the "
            f"wire, {rec['raw_bytes_per_page']:.0f} B/page raw); export "
            f"{rec['export_ms_per_page']:.3f} ms/page, codec "
            f"{rec['codec_ms_per_page']:.3f} ms/page, import "
            f"{rec['import_ms_per_page']:.3f} ms/page -> "
            f"{rec['pages_per_s']:.1f} pages/s through export and import "
            f"(exports by probe {export_ms} ms); "
            f"restored == never-migrated on every probe, cold "
            f"{agree}/{total} tokens before any near-tie")
        assert best_r < best_c, (
            f"{pool}: restored TTFT {best_r} not below cold {best_c}")
        out[pool] = rec
        del home, restored, cold
        if device == "cuda":
            torch.cuda.empty_cache()
    hd = cfg["hidden"] // cfg["num_heads"]
    scale_bytes = 2 * cfg["num_layers"] * cfg["num_heads"] * 4
    want = out["bfloat16"]["raw_bytes_per_page"] / 2 + scale_bytes
    log(f"migration bench: int8 {out['int8']['raw_bytes_per_page']:.0f} "
        f"B/page raw = bf16 {out['bfloat16']['raw_bytes_per_page']:.0f} / 2 "
        f"+ {scale_bytes} B of scales (head_dim {hd})")
    assert out["int8"]["raw_bytes_per_page"] == want
    return out


def lazy_margin(cfg: dict, dtype, device: str, params=None):
    """``dense_margin`` over ``cfg``'s weights (drawn as the worker draws
    them unless given), made only if a divergence asks for it."""
    held = [params]

    def margin(tokens):
        if held[0] is None:
            held[0] = fresh_params(cfg, dtype, device)
        return dense_margin(held[0], cfg, dtype, tokens, device)

    return margin


def migrate_live(src, dst, prompt, budget, after: int, seq: int = 1,
                 run_kw=None, before_import=None) -> tuple:
    """Serve ``prompt`` on ``src`` until ``after`` tokens, export it mid
    decode, pass the payload through the codec and finish it on
    ``dst`` (``before_import()`` runs just before the import); returns
    (tokens, payload, wire bytes, dst steps)."""
    run_kw = run_kw or {}
    src.submit(seq, prompt, budget, **run_kw)
    for _ in range(10 * budget):
        src.serve_step()
        if len(src.live_tokens().get(seq, [])) >= after:
            break
    payload = src.export_pages(seq)
    src.cancel(seq)
    src.assert_page_accounting()
    back, nbytes, _, _ = through_codec(payload)
    steps0 = dst.stats["steps"]
    if before_import is not None:
        before_import()
    dst.import_pages(seq, back)
    done = {}
    while dst.has_work():
        done.update(dst.serve_step())
    dst.assert_page_accounting()
    return done[seq], payload, nbytes, dst.stats["steps"] - steps0


def phase_live_migration(ctx: dict, device: str = "cuda",
                         argv=FLAGSHIP_ARGV) -> dict:
    """Live mid-stream migration card to card through the codec, at the
    flagship serving width: plain (K1) and speculative k 4 (K2), on a
    bf16 and an int8 pool (K1q, K2q); the continuation equals the
    un-migrated stream but for printed near-ties, and each kernel's
    launches (counted from 0 around the imported sequence's steps) are
    its steps x layers.  Then on phase 6's float32 model: card to CPU and
    CPU to card, and a seed-pinned sampled speculative sequence whose
    draft ring ships through the codec."""
    import numpy as np
    import torch

    from kubegpu_tpu_torch.models import worker
    from kubegpu_tpu_torch.models.paging import PagedContinuousBatcher

    args = worker.build_parser().parse_args(argv)
    cfg = dict(vocab_size=args.vocab, num_layers=args.layers,
               num_heads=args.heads, hidden=args.hidden,
               max_seq=args.seq + 1)
    d_hidden = max(args.hidden // 4, 128)
    d_heads = max(d_hidden // 128, 1)
    params = fresh_params(cfg, torch.bfloat16, device)
    dparams = fresh_params(dict(cfg, num_layers=1, hidden=d_hidden),
                           torch.bfloat16, device, seed=1)
    rng = np.random.RandomState(27)
    prompt = rng.randint(0, args.vocab, size=args.prompt_len).astype(
        np.int32)
    budget = args.steps
    counters = paged_counts()
    margin_fn = lazy_margin(cfg, torch.bfloat16, device, params)
    out = {}
    for kname, spec, quant in (("K1", False, False), ("K2", True, False),
                               ("K1q", False, True), ("K2q", True, True)):
        kw = dict(cfg, slots=args.batch_per_chip, prompt_pad=args.prompt_len,
                  page_size=args.page_size, dtype=torch.bfloat16,
                  device=device, pool_pages=2 * args.batch_per_chip * (
                      -(-(args.prompt_len + budget + SPEC_K)
                        // args.page_size)) + 1)
        if quant:
            kw["kv_dtype"] = "int8"
        if spec:
            kw.update(draft_params=dparams, speculate_k=SPEC_K,
                      draft_num_layers=1, draft_num_heads=d_heads,
                      draft_hidden=d_hidden)
        src = PagedContinuousBatcher(params, **kw)
        dst = PagedContinuousBatcher(params, **kw)
        ref = src.run([prompt], [budget])[0]
        dst.run([prompt[:8]], [2])              # first use off the count

        def zero_counts():
            for fn, attr in counters.values():
                setattr(fn, attr, 0)

        got, payload, nbytes, steps = migrate_live(
            src, dst, prompt, budget, after=8, before_import=zero_counts)
        # read once the importer drained: its steps alone ran since 0
        launches = {k: getattr(fn, attr) for k, (fn, attr) in
                    counters.items()}
        agree = same_or_near_tie(f"live migration {kname}", got, ref,
                                 prompt, margin_fn, BF16_NEAR_TIE_MARGIN)
        n_src = len(payload["tokens"])
        log(f"live migration {kname} ({'int8' if quant else 'bf16'} pool"
            f"{', speculative k=%d' % SPEC_K if spec else ''}): exported "
            f"after {n_src} tokens, {len(payload['page_keys'])} pages, "
            f"{nbytes} wire bytes; continuation {agree}/{budget} tokens "
            f"equal before any near-tie; the importer's steps {steps}, "
            f"launches {launches}")
        if device == "cuda":
            n = launches.pop(kname)
            assert n == steps * args.layers > 0, (kname, n, steps)
            assert not any(launches.values()), launches
            launches[kname] = n
        out[kname] = dict(launches=launches[kname], steps=steps,
                          pages=len(payload["page_keys"]), wire=nbytes)
        del src, dst
        if device == "cuda":
            torch.cuda.empty_cache()
    # phase 6's float32 model: card to CPU and CPU to card
    small_kw = dict(ctx["kw"])
    cpu_cb = PagedContinuousBatcher(ctx["params"], device="cpu", **small_kw)
    card_cb = PagedContinuousBatcher(ctx["params"], device=device,
                                     **small_kw)
    i = max(range(len(ctx["prompts"])), key=lambda j: ctx["budgets"][j])
    p, b = ctx["prompts"][i], ctx["budgets"][i]
    for name, src, dst in (("card to cpu", card_cb, cpu_cb),
                           ("cpu to card", cpu_cb, card_cb)):
        ref = src.run([p], [b])[0]              # the source's own stream
        got, payload, _, _ = migrate_live(src, dst, p, b, after=5)
        agree, _ = near_tie_agreement(f"{name} migration", ctx["cfg"],
                                      ctx["dense"], [p], {0: ref},
                                      {0: got})
        log(f"live migration {name} (float32): {agree}/{b} tokens equal "
            "the source device's un-migrated stream before any near-tie")
    # a seed-pinned sampled speculative sequence: its ring ships
    spec_kw = dict(small_kw, speculate_k=2, sampling=True,
                   draft_params=ctx["params"],
                   draft_num_layers=ctx["cfg"]["num_layers"],
                   draft_num_heads=ctx["cfg"]["num_heads"],
                   draft_hidden=ctx["cfg"]["hidden"])
    src = PagedContinuousBatcher(ctx["params"], device=device, **spec_kw)
    dst = PagedContinuousBatcher(ctx["params"], device=device, **spec_kw)
    ref = src.run([p], [b], temperatures=[0.8], seeds=[11])[0]
    got, payload, _, _ = migrate_live(src, dst, p, b, after=5,
                                      run_kw=dict(temperature=0.8, seed=11))
    assert "draft" in payload, "the sampled ring did not ship"
    same = "identical" if got == ref else "DIFFERS"
    log(f"live migration, sampled speculative (seed 11, ring of "
        f"{payload['draft']['window']} rows at d_pos "
        f"{payload['draft']['d_pos']}): {same}")
    assert got == ref, "the sampled speculative continuation differs"
    return out


def phase_wire_migration(device: str = "cuda", argv=None) -> dict:
    """Two card ``ReplicaServer``s at the flagship width with 512-token
    prompts (four 8 MiB bf16 pages a prompt): a live ``POST /v1/export``
    on A and ``POST /v1/import`` on B whose SSE continuation completes
    the budget; then ``POST /v1/role`` prefill on A and a streamed
    handoff: deltas while A prefills, ``reclaim``, and the final export
    from its cursor into B.  Prints export and import ms a page and the
    wire's MB/s."""
    import threading

    import numpy as np
    import torch

    from kubegpu_tpu_torch.gateway.dataplane import ReplicaServer
    from kubegpu_tpu_torch.models import worker

    if argv is None:
        argv = FLAGSHIP_ARGV + ["--prompt-len", "512", "--steps", "32"]
    args = worker.build_parser().parse_args(argv)
    cbs = [worker.build_batcher(args) for _ in range(2)]
    for cb in cbs:
        worker.warm_batcher(cb)
    rng = np.random.RandomState(28)
    prompt = rng.randint(0, args.vocab, size=args.prompt_len).astype(
        np.int32)
    # the handoff's prompt is a second one: B holds the first one's
    # pages once the live migration has landed
    prompt_h = rng.randint(0, args.vocab, size=args.prompt_len).astype(
        np.int32)
    budget = args.steps
    ref, ref_h = (cbs[0].run([p], [budget])[0] for p in (prompt, prompt_h))
    cbs[0]._reset_stats()
    cfg = dict(vocab_size=args.vocab, num_layers=args.layers,
               num_heads=args.heads, hidden=args.hidden,
               max_seq=args.seq + 1)
    margin_fn = lazy_margin(cfg, torch.bfloat16, device)
    # a 10 ms pause between A's steps leaves room to export mid-stream
    a = ReplicaServer(cbs[0], step_delay_s=0.01).start()
    b = ReplicaServer(cbs[1]).start()
    timings = {"export": [], "import": []}
    try:
        # the live migration
        got_a = []       # (event, payload) as each arrives
        t = threading.Thread(target=lambda: sse_request(
            a.port, "/v1/submit", {"request_id": "live",
                                   "prompt": prompt.tolist(),
                                   "max_new_tokens": budget},
            on_event=lambda ev, p: got_a.append((ev, p))))
        t.start()
        deadline = time.monotonic() + 120
        while sum(1 for e in got_a if e[0] == "tokens") < 2:
            assert time.monotonic() < deadline, "no tokens on A"
            time.sleep(0.005)
        t0 = time.perf_counter()
        exp = sse_request(a.port, "/v1/export", {"request_id": "live"})
        t_exp = time.perf_counter() - t0
        t.join(60)
        kind, body, _ = exp[0]
        assert kind == "json" and "payload" in body, exp
        assert body["payload"]["kind"] == "live", exp
        wire_live = len(json.dumps({"request_id": "live",
                                    "payload": body["payload"]}))
        assert got_a[-1][0] == "error" and got_a[-1][1]["error"] == "migrated"
        streamed_a = [x for k, e in got_a if k == "tokens"
                      for x in e["tokens"]]
        t0 = time.perf_counter()
        cont = sse_request(b.port, "/v1/import", {
            "request_id": "live", "payload": body["payload"]})
        t_imp_stream = time.perf_counter() - t0
        assert cont[-1][0] == "done", cont[-1][:2]
        full = cont[-1][1]["tokens"]
        deltas = [x for k, e, _ in cont[:-1] if k == "tokens"
                  for x in e["tokens"]]
        assert len(full) == budget and full[: len(streamed_a)] == streamed_a
        assert streamed_a + deltas == full
        n_live = body["pages"]
        agree = same_or_near_tie("wire live migration", full, ref, prompt,
                                 margin_fn, BF16_NEAR_TIE_MARGIN)
        log(f"wire live migration: A streamed {len(streamed_a)} tokens, "
            f"export of {n_live} pages in {t_exp * 1e3:.1f} ms "
            f"({t_exp * 1e3 / n_live:.2f} ms/page, {wire_live} wire bytes, "
            f"{wire_live / t_exp / 1e6:.1f} MB/s), B's continuation "
            f"{len(deltas)} tokens in {t_imp_stream:.3f} s; {agree}/{budget} "
            "tokens equal the un-migrated stream before any near-tie")
        # the streamed handoff.  A keeps its 10 ms pause: a loop whose
        # only sequence is parked steps without end, and with no pause it
        # would hold this process's interpreter lock from both servers
        # and the client (so each control op on A waits up to one pause)
        role = sse_request(a.port, "/v1/role", {"role": "prefill"})
        assert role[0][1] == {"role": "prefill"}, role
        got_h = []
        t = threading.Thread(target=lambda: sse_request(
            a.port, "/v1/submit", {"request_id": "hand",
                                   "prompt": prompt_h.tolist(),
                                   "max_new_tokens": budget},
            on_event=lambda ev, p: got_h.append((ev, p))))
        t.start()
        cursor = n_deltas = wire_deltas = 0
        deadline = time.monotonic() + 120
        while True:
            assert time.monotonic() < deadline, "the handoff never sealed"
            sealed = any(k == "sealed" for k, _ in got_h)
            t0 = time.perf_counter()
            d = sse_request(a.port, "/v1/export", {
                "request_id": "hand", "delta": True, "cursor": cursor})
            if "payload" not in d[0][1]:
                # the submit has not reached A's serving loop, or its
                # batcher's slots, yet
                assert ("no live stream" in d[0][1]["error"]
                        or "unknown sequence" in d[0][1]["error"]), d
                time.sleep(0.002)
                continue
            payload = d[0][1]["payload"]
            if payload is not None:
                timings["export"].append(
                    (time.perf_counter() - t0, len(payload["page_keys"])))
                t0 = time.perf_counter()
                ack = sse_request(b.port, "/v1/import", {"payload": payload})
                timings["import"].append(
                    (time.perf_counter() - t0, len(payload["page_keys"])))
                assert ack[0][1]["staged"] == len(payload["page_keys"]), ack
                wire_deltas += len(json.dumps({"payload": payload}))
                cursor += len(payload["page_keys"])
                n_deltas += 1
            elif sealed:
                break
            else:
                time.sleep(0.002)
        rec = sse_request(a.port, "/v1/export", {"request_id": "hand",
                                                 "reclaim": cursor})
        assert rec[0][1]["reclaimed"] == cursor, rec
        final = sse_request(a.port, "/v1/export", {"request_id": "hand",
                                                   "cursor": cursor})
        fbody = final[0][1]
        assert fbody["payload"]["layer_base"] == cursor
        t.join(60)
        assert [k for k, _ in got_h] == ["sealed", "error"], got_h
        cont = sse_request(b.port, "/v1/import", {
            "request_id": "hand", "payload": fbody["payload"]})
        assert cont[-1][0] == "done", cont[-1][:2]
        hand = cont[-1][1]["tokens"]
        agree_h = same_or_near_tie("wire streamed handoff", hand, ref_h,
                                   prompt_h, margin_fn,
                                   BF16_NEAR_TIE_MARGIN)
        state_b = json.loads(http_get(b.port, "/v1/state"))
    finally:
        a.stop()
        b.stop()
    assert a.loop.error is None and b.loop.error is None
    for cb in cbs:
        cb.assert_page_accounting()
    exp_s = sum(s for s, _ in timings["export"])
    exp_n = sum(n for _, n in timings["export"])
    imp_s = sum(s for s, _ in timings["import"])
    log(f"wire streamed handoff: {n_deltas} deltas of {exp_n} pages "
        f"({wire_deltas} wire bytes) while A prefilled; delta export "
        f"{exp_s * 1e3 / max(exp_n, 1):.2f} ms/page, import "
        f"{imp_s * 1e3 / max(exp_n, 1):.2f} ms/page, "
        f"{wire_deltas / max(exp_s + imp_s, 1e-9) / 1e6:.1f} MB/s over the "
        f"wire; reclaimed {cursor} pages; final export of "
        f"{len(fbody['payload']['page_keys']) - cursor} page(s) past the "
        f"cursor; B imports {state_b['stats']['imports']}, pages imported "
        f"{state_b['stats']['pages_imported']}; {agree_h}/{budget} tokens "
        "equal the co-located stream before any near-tie")
    assert n_deltas >= 1 and cursor == (args.prompt_len - 1) // (
        args.page_size or 128)
    assert state_b["stats"]["imports"] == 2
    return dict(live_export_ms_per_page=t_exp * 1e3 / n_live,
                delta_export_ms_per_page=exp_s * 1e3 / max(exp_n, 1),
                delta_import_ms_per_page=imp_s * 1e3 / max(exp_n, 1),
                wire_mb_per_s=wire_deltas / max(exp_s + imp_s, 1e-9) / 1e6)


def max_err(got, want, rtol, atol) -> tuple:
    """(max |got - want|, the worst element's share of its allowance);
    raises if an element is outside ``atol + rtol * |want|``."""
    import torch

    diff = (got.float() - want.float()).abs()
    share = (diff / (atol + rtol * want.float().abs())).max().item()
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol,
                               atol=atol)
    return diff.max().item(), share


def flash_inputs(b, sq, sk, h, d, dtype, g):
    import torch

    dev = torch.device("cuda")
    q = torch.randn((b, sq, h, d), generator=g, device=dev).to(dtype)
    k = torch.randn((b, sk, h, d), generator=g, device=dev).to(dtype)
    v = torch.randn((b, sk, h, d), generator=g, device=dev).to(dtype)
    dout = torch.randn((b, sq, h, d), generator=g, device=dev).to(dtype)
    return q, k, v, dout


def bf16_gradient_errs(got, q, k, v, out, lse, dout, causal) -> dict:
    """The bf16 gradient gate: for each of dq, dk, dv (``got``), the max
    abs error against the float32 twin (fed the same bf16 values as
    float32) must be at most ``bf16_gradient_allowance`` of the error of
    the twins' bf16 emulation, which rounds p and ds as the kernels do;
    and each element and each 64-row block must lie within
    ``bf16_emulation_shares``'s allowances of the emulation itself.
    Logs each gradient's median |value| beside its allowances.  Returns
    name -> (kernel error, share of the allowance, emulation error);
    raises past an allowance."""
    import torch

    from kubegpu_tpu_torch.ops.attention import (
        bf16_emulation_shares,
        bf16_gradient_allowance,
        flash_backward_dkdv_plain,
        flash_backward_dq_plain,
    )

    f32 = [t.float() for t in (q, k, v, out)]
    ref = (flash_backward_dq_plain(*f32, lse, dout.float(), causal),
           *flash_backward_dkdv_plain(*f32, lse, dout.float(), causal))
    del f32
    emu = (flash_backward_dq_plain(q, k, v, out, lse, dout, causal,
                                   operand_dtype=torch.bfloat16),
           *flash_backward_dkdv_plain(q, k, v, out, lse, dout, causal,
                                      operand_dtype=torch.bfloat16))
    errs = {}
    for name, g, e, r in zip(("dq", "dk", "dv"), got, emu, ref):
        err = (g.float() - r).abs().max().item()
        emu_err = (e.float() - r).abs().max().item()
        allow = bf16_gradient_allowance(emu_err)
        element, block = bf16_emulation_shares(g, e)
        log(f"  bf16 {name}: median |{name}| {e.float().abs().median():.3e}, "
            f"rms {e.float().square().mean().sqrt():.3e}; against the f32 "
            f"twin {err:.3e} of {allow:.3e} allowed; against the emulation "
            f"max {(g.float() - e.float()).abs().max():.3e}, worst element "
            f"{element:.3f} and worst 64-row block {block:.3f} of their "
            f"allowances")
        assert err <= allow, (
            f"bf16 {name}: kernel error {err:.3e} exceeds {allow:.3e} (twice "
            f"the emulation's {emu_err:.3e} plus {BF16_ATOL})")
        assert element <= 1 and block <= 1, (
            f"bf16 {name} strays from the emulation: element share "
            f"{element:.3f}, block share {block:.3f}")
        errs[name] = (err, err / allow, emu_err)
    return errs


def bf16_forward_errs(out, q, k, v, causal) -> tuple:
    """The bf16 K3 gate, as for the gradients: out's max abs error
    against the float32 twin (fed the same bf16 values as float32) must
    be at most ``bf16_gradient_allowance`` of the error of the twin's
    bf16 emulation (p rounded before p . v, l from the f32 p), and each
    element and each 64-row block of out must lie within
    ``bf16_emulation_shares``'s allowances of the emulation.  Returns
    (kernel error, its share of the allowance, emulation error); raises
    past an allowance."""
    import torch

    from kubegpu_tpu_torch.ops.attention import (
        bf16_emulation_shares,
        bf16_gradient_allowance,
        flash_forward_plain,
    )

    ref, _ = flash_forward_plain(*(t.float() for t in (q, k, v)), causal)
    emu, _ = flash_forward_plain(q, k, v, causal,
                                 operand_dtype=torch.bfloat16)
    err = (out.float() - ref).abs().max().item()
    emu_err = (emu.float() - ref).abs().max().item()
    allow = bf16_gradient_allowance(emu_err)
    element, block = bf16_emulation_shares(out, emu)
    log(f"  bf16 out: median |out| {emu.float().abs().median():.3e}, rms "
        f"{emu.float().square().mean().sqrt():.3e}; against the f32 twin "
        f"{err:.3e} of {allow:.3e} allowed (emulation {emu_err:.3e}); "
        f"against the emulation max "
        f"{(out.float() - emu.float()).abs().max():.3e}, worst element "
        f"{element:.3f} and worst 64-row block {block:.3f} of their "
        "allowances")
    assert err <= allow, (
        f"bf16 out: kernel error {err:.3e} exceeds {allow:.3e} (twice the "
        f"emulation's {emu_err:.3e} plus {BF16_ATOL})")
    assert element <= 1 and block <= 1, (
        f"bf16 out strays from the emulation: element share {element:.3f}, "
        f"block share {block:.3f}")
    return err, err / allow, emu_err


def check_flash(q, k, v, dout, causal) -> dict:
    """K3, K4, K5 and the delta pre-pass against their plain versions on
    one input; the backward kernels read the plain forward's out and lse,
    so both sides of each check see the same operands.  bf16 out passes
    :func:`bf16_forward_errs` and bf16 gradients
    :func:`bf16_gradient_errs`; lse is within 2e-5 of the float32 twin in
    both types.  Returns each kernel's max abs error (K4: over dk and dv;
    bf16 out and gradients against the float32 twin)."""
    import torch

    from kubegpu_tpu_torch.ops.attention import (
        flash_backward_delta,
        flash_backward_delta_plain,
        flash_backward_dkdv,
        flash_backward_dkdv_plain,
        flash_backward_dq,
        flash_backward_dq_plain,
        flash_forward,
        flash_forward_plain,
    )

    bf16 = q.dtype == torch.bfloat16
    out, lse = flash_forward(q, k, v, causal)
    p_out, p_lse = flash_forward_plain(q, k, v, causal)
    # the pre-pass and its delta are the bf16 backward's alone
    delta = flash_backward_delta(p_out, dout) if bf16 else None
    dk, dv = flash_backward_dkdv(q, k, v, p_out, p_lse, dout, causal, delta)
    dq = flash_backward_dq(q, k, v, p_out, p_lse, dout, causal, delta)
    torch.cuda.synchronize()
    for t, ref in ((out, q), (dq, q), (dk, k), (dv, v)):
        assert t.shape == ref.shape and t.dtype == ref.dtype
        assert torch.isfinite(t.float()).all(), "a flash kernel gave non-finite"
    assert lse.dtype == torch.float32 and torch.isfinite(lse).all()
    errs = {
        "out": (bf16_forward_errs(out, q, k, v, causal)[:2] if bf16
                else max_err(out, p_out, F32_TOL, F32_TOL)),
        "lse": max_err(lse, p_lse, F32_TOL, F32_TOL),
    }
    if bf16:
        errs["delta"] = max_err(delta, flash_backward_delta_plain(p_out, dout),
                                F32_TOL, F32_TOL)
        gate = bf16_gradient_errs((dq, dk, dv), q, k, v, p_out, p_lse, dout,
                                  causal)
        errs.update((n, (e, sh)) for n, (e, sh, _) in gate.items())
    else:
        p_dk, p_dv = flash_backward_dkdv_plain(q, k, v, p_out, p_lse, dout,
                                               causal)
        p_dq = flash_backward_dq_plain(q, k, v, p_out, p_lse, dout, causal)
        errs.update(dq=max_err(dq, p_dq, GRAD_TOL, GRAD_TOL),
                    dk=max_err(dk, p_dk, GRAD_TOL, GRAD_TOL),
                    dv=max_err(dv, p_dv, GRAD_TOL, GRAD_TOL))
    b, sq, h, d = q.shape
    name = str(q.dtype).replace("torch.", "")
    log(f"flash {name} b{b} sq{sq} sk{k.shape[1]} h{h} d{d} causal={causal}: "
        + ", ".join(f"{n} {e:.3e} ({sh:.3f} of allowance)"
                    for n, (e, sh) in errs.items()))
    if bf16:
        log("  bf16 emulation of p and ds against the float32 twin: "
            + ", ".join(f"{n} {emu:.3e}" for n, (_, _, emu) in gate.items()))
    rec = {
        "flash_forward": errs["out"][0],
        "flash_backward_dkdv": max(errs["dk"][0], errs["dv"][0]),
        "flash_backward_dq": errs["dq"][0],
    }
    if bf16:
        rec["flash_backward_delta"] = errs["delta"][0]
    return rec


def flash_bound(kernel: str, b, sq, sk, h, d, causal, itemsize) -> tuple:
    """(bound ms, "bytes" or "operations", bytes, flops) of one kernel:
    each operand read once and each result written once over the card's
    memory rate, against its matrix products (K3 2, K4 4, K5 3, over the
    score pairs the causal mask leaves) over the peak rate of the
    operands' type; the delta pre-pass does one multiply-add per element
    of dO on the CUDA cores.  The float32 K4 and K5 read out; the bf16
    ones read the pre-pass's delta, the size of lse, instead."""
    pairs = sq * (sq + 1) // 2 if causal else sq * sk
    q_bytes = b * sq * h * d * itemsize
    kv_bytes = b * sk * h * d * itemsize
    lse_bytes = 4 * b * h * sq
    if kernel == "flash_backward_delta":  # out, dout in; delta out
        flops = 2 * b * sq * h * d
        nbytes = 2 * q_bytes + lse_bytes
        peak = F32_FLOPS_PER_S
    else:
        products = {"flash_forward": 2, "flash_backward_dkdv": 4,
                    "flash_backward_dq": 3}[kernel]
        flops = products * 2 * b * h * pairs * d
        peak = BF16_FLOPS_PER_S if itemsize == 2 else F32_FLOPS_PER_S
    if kernel == "flash_forward":      # q, k, v in; out, lse out
        nbytes = 2 * q_bytes + 2 * kv_bytes + lse_bytes
    elif kernel == "flash_backward_dkdv" and itemsize == 2:
        nbytes = 2 * q_bytes + 4 * kv_bytes + 2 * lse_bytes  # q, dout, delta
    elif kernel == "flash_backward_dkdv":  # q, k, v, out, dout, lse; dk, dv
        nbytes = 3 * q_bytes + 4 * kv_bytes + lse_bytes
    elif kernel == "flash_backward_dq" and itemsize == 2:
        nbytes = 3 * q_bytes + 2 * kv_bytes + 2 * lse_bytes  # q, dout, delta
    elif kernel == "flash_backward_dq":  # q, k, v, out, dout, lse; dq
        nbytes = 4 * q_bytes + 2 * kv_bytes + lse_bytes
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    flops_ms = flops / peak * 1e3
    return (max(bytes_ms, flops_ms),
            "bytes" if bytes_ms >= flops_ms else "operations", nbytes, flops)


def sdpa_times(q, k, v, dout, causal: bool = True) -> dict:
    """PyTorch's fused attention on the same inputs (heads moved to dim
    1 as views), as a yardstick: forward ms, backward ms (dq, dk, dv
    together) and the backend torch picked."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend

    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_()
                  for t in (q, k, v))
    dot = dout.transpose(1, 2)
    choice = torch._fused_sdp_choice(qt, kt, vt, None, 0.0, causal)
    backend = next((n for n, e in SDPBackend.__members__.items()
                    if int(e.value) == int(choice)), str(choice))
    with torch.no_grad():
        fwd_ms = time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal), 20)
    out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal)
    bwd_ms = time_ms(lambda: torch.autograd.grad(
        out, (qt, kt, vt), dot, retain_graph=True), 20)
    return {"backend": backend, "fwd_ms": fwd_ms, "bwd_ms": bwd_ms}


def hgmma_instructions(library) -> dict:
    """The HGMMA (wgmma) instructions of each kernel function in a built
    library, from ``cuobjdump -sass`` (which ships beside nvcc); raises
    where the tool is missing or fails."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", str(library)], capture_output=True,
                          text=True, timeout=120, check=True).stdout
    found, fn = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split("Function :")[1].strip()
            found[fn] = []
        elif fn is not None and "HGMMA" in line:
            # "/*2450*/  HGMMA.64x64x16.F32.BF16 R184, gdesc[UR8], RZ ;  /*..*/"
            found[fn].append(line.split("*/", 1)[1].split(";")[0].strip())
    return found


def time_flash(q, k, v, dout, errs: dict, rec: dict,
               causal: bool = True) -> dict:
    """K3, K4, K5 (and in bf16 the delta pre-pass) on one input, causal
    unless asked: each kernel's graph-replay time, its plain twin's time,
    its bound and the library call's time, with ``errs`` (from
    :func:`check_flash`), into ``rec[kernel][dtype name]``.  Returns
    SDPA's times."""
    import torch

    from kubegpu_tpu_torch.ops.attention import (
        flash_backward_delta,
        flash_backward_delta_plain,
        flash_backward_dkdv,
        flash_backward_dkdv_plain,
        flash_backward_dq,
        flash_backward_dq_plain,
        flash_forward,
        flash_forward_plain,
    )

    b, s, h, d = q.shape
    name = str(q.dtype).replace("torch.", "")
    out, lse = flash_forward(q, k, v, causal)
    bf16 = q.dtype == torch.bfloat16
    # the bf16 kernels read the pre-pass's delta, timed on its own
    delta = flash_backward_delta(out, dout) if bf16 else None
    calls = {
        "flash_forward": (lambda: flash_forward(q, k, v, causal),
                          lambda: flash_forward_plain(q, k, v, causal)),
        "flash_backward_dkdv": (
            lambda: flash_backward_dkdv(q, k, v, out, lse, dout, causal,
                                        delta),
            lambda: flash_backward_dkdv_plain(q, k, v, out, lse, dout,
                                              causal)),
        "flash_backward_dq": (
            lambda: flash_backward_dq(q, k, v, out, lse, dout, causal,
                                      delta),
            lambda: flash_backward_dq_plain(q, k, v, out, lse, dout,
                                            causal)),
    }
    if bf16:
        calls["flash_backward_delta"] = (
            lambda: flash_backward_delta(out, dout),
            lambda: flash_backward_delta_plain(out, dout))
    lib = sdpa_times(q, k, v, dout, causal)
    log(f"SDPA {name} h{h} causal={causal} ({lib['backend']}): forward "
        f"{lib['fwd_ms']:.3f} "
        f"ms, backward (dq, dk, dv) {lib['bwd_ms']:.3f} ms")
    # one PyTorch call for delta: rowsum(dO * O) as a batched dot
    vecdot_ms = time_ms(lambda: torch.linalg.vecdot(dout, out), 20)
    for kname, (kernel, plain) in calls.items():
        ms = graph_ms(kernel, 2, replays=5)
        plain_ms = time_ms(plain, 2, warmup=1)
        bound_ms, bound_by, nbytes, flops = flash_bound(
            kname, b, s, s, h, d, causal, q.element_size())
        library_ms = {"flash_forward": lib["fwd_ms"],
                      "flash_backward_dkdv": lib["bwd_ms"],
                      "flash_backward_delta": vecdot_ms}.get(kname)
        log(f"{kname} {name} h{h} s{s} causal={causal}: kernel {ms:.3f} ms "
            f"(graph replay), plain "
            f"{plain_ms:.3f} ms, bound {bound_ms:.4f} ms by {bound_by} "
            f"({nbytes} B, {flop_str(flops)}) -> "
            f"{bound_ms / ms * 100:.2f}% of bound; library "
            + (f"{library_ms:.3f} ms" if kname != "flash_backward_dq" else
               "n/a (SDPA's backward is one call for dq, dk and dv, "
               "counted under flash_backward_dkdv)"))
        rec.setdefault(kname, {})[name] = dict(
            max_abs_err=errs[kname], ms=ms, plain_ms=plain_ms,
            bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms,
            sdpa_backend=lib["backend"])
    return lib


def phase_flash() -> dict:
    import torch

    from kubegpu_tpu_torch.ops import _build

    sass = hgmma_instructions(_build.library_path("flash_attention"))
    for kname in ("flash_forward_wgmma_kernel",
                  "flash_backward_dkdv_wgmma_kernel",
                  "flash_backward_dq_wgmma_kernel"):
        found = {fn: ins for fn, ins in sass.items() if kname in fn}
        log(f"SASS {kname}: HGMMA per instantiation "
            f"{sorted(len(ins) for ins in found.values())}")
        assert found and all(found.values()), f"{kname} runs no HGMMA: {found}"
        # one instruction of each form: operands from shared memory (S, dP)
        # and with A from registers, B transposed (the sums)
        forms = {}
        for ins in (i for fn in sorted(found) for i in found[fn]):
            forms.setdefault((ins.split()[0], ".tnspB" in ins), ins)
        for ins in forms.values():
            log(f"  {ins}")
        assert any(rs for _, rs in forms) and not all(rs for _, rs in forms), (
            f"{kname} lacks the shared-memory (SS) or the register-A (RS) "
            f"form: {sorted(forms)}")
    g = torch.Generator(device="cuda").manual_seed(4)
    for dtype in (torch.float32, torch.bfloat16):
        check_flash(*flash_inputs(2, 1000, 1000, 4, 128, dtype, g), True)
        check_flash(*flash_inputs(2, 640, 1024, 4, 128, dtype, g), False)
    b, s, h, d = FLASH_SHAPE
    rec = {}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).replace("torch.", "")
        q, k, v, dout = flash_inputs(b, s, s, h, d, dtype, g)
        errs = check_flash(q, k, v, dout, True)
        lib = time_flash(q, k, v, dout, errs, rec)
        backward = [k for k in ("flash_backward_delta", "flash_backward_dkdv",
                                "flash_backward_dq") if name in rec.get(k, {})]
        total = sum(rec[k][name]["ms"] for k in backward)
        bound = sum(rec[k][name]["bound_ms"] for k in backward)
        log(f"flash backward {name} ({' + '.join(backward)}): {total:.3f} ms "
            f"against SDPA's backward {lib['bwd_ms']:.3f} ms "
            f"({total / lib['bwd_ms']:.2f}x) and the summed bounds "
            f"{bound:.4f} ms ({bound / total * 100:.2f}% of bound)")
        del q, k, v, dout
        torch.cuda.empty_cache()
    return rec


def flop_str(flops: int) -> str:
    return f"{flops} flop ({flops / 1e9:.1f} GFLOP)"


TRAIN_ARGV = ["--model", "lm", "--vocab", "32768", "--hidden", "4096",
              "--heads", "32", "--layers", "4", "--seq", "1024",
              "--batch-per-chip", "16", "--steps", "5"]


def flash_counts_to_zero() -> tuple:
    """K3, K4, K5 and the delta pre-pass, their launch counts set to 0."""
    from kubegpu_tpu_torch.ops.attention import (
        flash_backward_delta,
        flash_backward_dkdv,
        flash_backward_dq,
        flash_forward,
    )

    kernels = (flash_forward, flash_backward_dkdv, flash_backward_dq,
               flash_backward_delta)
    for fn in kernels:
        fn.launches = 0
    return kernels


def phase_train_flagship() -> dict:
    import math

    from kubegpu_tpu_torch.models import worker

    args = worker.build_parser().parse_args(TRAIN_ARGV)
    kernels = flash_counts_to_zero()
    r = worker.run_lm(args)
    launches = {fn.__name__: fn.launches for fn in kernels}
    peak = r["peak_bytes"]
    log(f"training flagship: first step {r['first_step_s']:.2f} s, steady "
        f"{r['tokens_per_sec']:.1f} tokens/s ({r['steady_s'] / (args.steps - 1) * 1e3:.1f} "
        f"ms a step of {r['tokens_per_step']} tokens), losses "
        f"{[round(x, 4) for x in r['losses']]}, peak device memory "
        f"{peak / 2**30:.2f} GiB; launches {launches} for {args.steps} steps "
        f"x {args.layers} layers")
    assert len(r["losses"]) == args.steps
    assert all(math.isfinite(x) for x in r["losses"]), r["losses"]
    for n in launches.values():
        assert n == args.steps * args.layers, launches
    return dict(r, launches=launches)


def phase_train_card_vs_cpu() -> None:
    import numpy as np
    import torch

    from kubegpu_tpu_torch.models.data import synthetic_token_batches
    from kubegpu_tpu_torch.models.params import init_params, tree_map
    from kubegpu_tpu_torch.models.train import (
        create_train_state,
        lm_loss,
        lm_step,
    )
    from kubegpu_tpu_torch.models.transformer import TransformerLM

    cfg = dict(vocab_size=256, num_layers=2, hidden=256, max_seq=129)
    params = init_params(cfg, torch.Generator().manual_seed(6),
                         torch.float32, "cpu")
    source = synthetic_token_batches(4, 129, cfg["vocab_size"], seed=1)
    batches = [torch.from_numpy(next(source)) for _ in range(3)]
    runs = {}
    for device, impl in (("cpu", "flash"), ("cuda", "flash"),
                         ("cuda", "einsum")):
        kernels = flash_counts_to_zero()
        model = TransformerLM(num_heads=4, dtype=torch.float32,
                              attn_impl=impl, **cfg)
        state = create_train_state(
            model, tree_map(lambda t: t.to(device).clone(), params))
        # step 1 by hand, to read its gradients before the optimizer
        # (torch's multi-tensor nesterov SGD adds the momentum into them)
        loss = lm_loss(model, batches[0].to(device))
        loss.backward()
        grads = {n: p.grad.detach().cpu().clone()
                 for n, p in model.named_parameters()}
        state.opt.step()
        state.opt.zero_grad(set_to_none=True)
        losses = [loss.item()] + [lm_step(state, tokens.to(device)).item()
                                  for tokens in batches[1:]]
        launches = [fn.launches for fn in kernels]
        runs[(device, impl)] = (np.asarray(losses), grads)
        log(f"training {device} {impl} fp32: losses {losses}; K3/K4/K5/"
            f"delta launches {launches}")
        want = 3 * cfg["num_layers"] if (device, impl) == ("cuda", "flash") else 0
        # the float32 K4 and K5 take delta from out: no pre-pass
        assert launches == [want] * 3 + [0], launches
    cpu_l, cpu_g = runs[("cpu", "flash")]
    card_l, card_g = runs[("cuda", "flash")]
    np.testing.assert_allclose(card_l, cpu_l, rtol=TRAIN_TOL, atol=0)
    worst = 0.0
    for n, want in cpu_g.items():
        torch.testing.assert_close(card_g[n], want, rtol=TRAIN_TOL,
                                   atol=TRAIN_TOL)
        worst = max(worst, (card_g[n] - want).abs().max().item())
    ein_l = runs[("cuda", "einsum")][0]
    np.testing.assert_allclose(ein_l, card_l, rtol=TRAIN_TOL, atol=TRAIN_TOL)
    log(f"training card vs cpu fp32: loss diffs "
        f"{np.abs(card_l - cpu_l).tolist()}, worst step-1 gradient diff "
        f"{worst:.3e} over {len(cpu_g)} leaves; card einsum vs flash loss "
        f"diffs {np.abs(ein_l - card_l).tolist()}")


# -- the dense serving slice (phases 29-34) ------------------------------------

# samples/jax-decode.yaml's decode replica (its --serve and --ckpt-dir
# dropped: one timed run on fresh weights); no --serving, so the
# worker's default, static, serves it
DECODE_SAMPLE_ARGV = ["--model=decode", "--batch-per-chip=8",
                      "--prompt-len=128", "--steps=256", "--vocab=32768",
                      "--layers=4", "--heads=32", "--hidden=4096",
                      "--seq=1023"]
# bench.py's _serving_traffic (:977-1011): the flagship, 8 slots,
# prompt_pad 128, max_seq 512
SERVING_CFG = dict(vocab_size=32768, num_layers=4, num_heads=32,
                   hidden=4096, max_seq=512)
FLAGSHIP_DRAFT = dict(vocab_size=32768, num_layers=1, hidden=1024,
                      max_seq=512)
DRAFT_DIMS = dict(draft_num_layers=1, draft_num_heads=8, draft_hidden=1024)
# the top-2 margin within which the card's bf16 dense model calls a
# divergence a near-tie (phase 26's rule)
BF16_NEAR_TIE = 0.125


def kernel_counts() -> dict:
    """Every kernel wrapper of the port by ID (the worker's K1-K5) and
    the backward's pre-pass."""
    from kubegpu_tpu_torch.models.worker import kernel_counters
    from kubegpu_tpu_torch.ops.attention import flash_backward_delta

    return dict(kernel_counters(), DELTA=(flash_backward_delta, "launches"))


def zero_counts() -> None:
    for fn, attr in kernel_counts().values():
        setattr(fn, attr, 0)


def assert_no_kernel(label: str) -> None:
    """The dense paths run none of K1-K5: every count set to 0 before
    the run is 0 after it."""
    counts = {k: getattr(fn, a) for k, (fn, a) in kernel_counts().items()}
    log(f"{label}: kernel launches {counts}")
    assert not any(counts.values()), (label, counts)


def run_worker_lines(argv: list, timeout: float = 600) -> dict:
    """The worker's entry point in a subprocess; returns its output lines
    keyed by their first word (the process is killed on a timeout)."""
    import os

    cmd = [sys.executable, "-m", "kubegpu_tpu_torch.models.worker", *argv]
    proc = subprocess.Popen(cmd, cwd=os.path.dirname(os.path.abspath(
        __file__)), stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    try:
        out, _ = proc.communicate(timeout=timeout)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, out[-3000:]
    return {line.split()[0]: line for line in out.splitlines() if line}


# worker runs begun right after phase 1 so that their interpreters boot
# beside other phases: those refused at their start on one card (they
# never reach the card), and the pod that phase 70's extender binds; each
# phase that reads one waits for it (key -> Popen)
_EARLY: dict = {}
# the worker on argv[2:], its interpreter booted and torch imported at
# once, its run begun once the file argv[1] exists (the kernels built)
WORKER_GATE = "\n".join([
    "import os, sys, time",
    "import torch  # noqa: F401",
    "from kubegpu_tpu_torch.models import worker",
    "while not os.path.exists(sys.argv[1]):",
    "    time.sleep(0.05)",
    "sys.exit(worker.main(sys.argv[2:]))"])


def worker_popen(argv: list, env=None, gate=None):
    """The port's worker on ``argv`` (under ``env``) in a subprocess;
    with ``gate``, it runs once the file ``gate`` exists."""
    import os

    head = (["-c", WORKER_GATE, gate] if gate
            else ["-m", "kubegpu_tpu_torch.models.worker"])
    return subprocess.Popen(
        [sys.executable, *head, *argv],
        cwd=os.path.dirname(os.path.abspath(__file__)), env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def refused_runs() -> dict:
    """The refused worker runs of phases 40, 44, 51 and 69 on this machine:
    key -> (argv, env).  Phases 40, 44 and 51 expect a refusal only with
    fewer cards than their mesh; on more they run over NCCL instead."""
    import torch

    n_cards = torch.cuda.device_count()
    runs = {"bogus": (BOGUS_WORKER_ARGV, bogus_env())}
    if n_cards < TP:
        runs.update(tp_serve=(TP_WORKER_ARGV, None),
                    tp_train=(TRAIN_TP_WORKER_ARGV, None))
    if n_cards < CP:
        runs["cp"] = (CP_WORKER_ARGV, None)
    return runs


def start_refused(keys) -> None:
    """Begin the refused runs ``keys`` now (:func:`refused_runs`)."""
    runs = refused_runs()
    for key in keys:
        if key in runs and key not in _EARLY:
            _EARLY[key] = worker_popen(*runs[key])


def stop_early() -> None:
    """Kill and reap every early run no phase read."""
    while _EARLY:
        proc = _EARLY.popitem()[1]
        proc.kill()
        proc.communicate()


def early_run(key: str, argv: list, env=None):
    """The worker on ``argv`` (under ``env``) to its exit, begun early
    under ``key`` or else now: a ``CompletedProcess``."""
    proc = _EARLY.pop(key, None) or worker_popen(argv, env)
    try:
        out, err = proc.communicate(timeout=300)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    return subprocess.CompletedProcess(proc.args, proc.returncode, out, err)


def fields(line: str) -> dict:
    return dict(f.split("=", 1) for f in line.split()[1:] if "=" in f)


def phase_static_sample() -> dict:
    """Phase 29: samples/jax-decode.yaml's replica through the worker's
    default mode, static, in a subprocess: bf16, then int8 weights."""
    results = {}
    for label, extra in (("bf16", []), ("int8 weights", ["--int8"])):
        zero_counts()
        lines = run_worker_lines(DECODE_SAMPLE_ARGV + extra)
        assert_no_kernel(f"static {label} (this process)")
        first = fields(lines["FIRST_DECODE_DONE"])
        done = fields(lines["DECODE_DONE"])
        launches = fields(lines["KERNEL_LAUNCHES"])
        assert launches.pop("serving") == "static", lines["KERNEL_LAUNCHES"]
        launches.pop("device")
        assert set(launches.values()) == {"0"}, launches
        peak = lines["PEAK_MEM_GIB"].split()[1]
        if extra:
            assert "SERVING_INT8" in lines
        log(f"static decode sample, {label} (8 x 128-token prompts, 256 "
            f"steps, 1.08B): first call done {first['seconds']} s after "
            f"the launch; {done['tokens_per_sec']} tokens/s, "
            f"{done['ms_per_call']} ms a call "
            f"({float(done['ms_per_call']) / 256:.3f} ms a step); peak "
            f"device memory {peak} GiB; worker kernel launches {launches}")
        results[label] = dict(tok_s=float(done["tokens_per_sec"]),
                              ms_call=float(done["ms_per_call"]),
                              peak_gib=float(peak))
    return results


def serving_traffic():
    """bench.py's _serving_traffic recipe: 16 prompts of 16-127 tokens
    from RandomState(0), budgets 32/64/96/256."""
    import numpy as np

    rs = np.random.RandomState(0)
    budgets = [(32, 64, 96, 256)[i % 4] for i in range(16)]
    prompts = [rs.randint(0, SERVING_CFG["vocab_size"],
                          size=rs.randint(16, 128)).astype(np.int32)
               for _ in budgets]
    return prompts, budgets


def agreement(label: str, params, cfg: dict, dtype, prompts, ref: dict,
              other: dict, limit: float) -> tuple:
    """Tokens of ``other`` agreeing with ``ref`` before each request's
    first difference, and the card's dense top-2 margin there (each
    printed; the margin must be within ``limit``)."""
    agree = total = 0
    margins = []

    def margin(toks):
        margins.append(dense_margin(params, cfg, dtype, toks, "cuda"))
        return margins[-1]

    for i in sorted(ref):
        total += len(ref[i])
        agree += same_or_near_tie(f"{label} request {i}", other[i], ref[i],
                                  prompts[i], margin, limit)
    return agree, total, margins


def timed_run(cb, prompts, budgets) -> tuple:
    """A warm-up pass, then the timed one: (outputs, seconds)."""
    import torch

    cb.run(prompts[:cb.slots], [2] * min(len(prompts), cb.slots))
    torch.cuda.synchronize()
    t0 = time.monotonic()
    out = cb.run(prompts, budgets)
    torch.cuda.synchronize()
    return out, time.monotonic() - t0


def phase_dense_serving() -> dict:
    """Phase 30: bench.py's serving_continuous_batching and serving_paged
    rows at full width in bf16: the same traffic through the port's
    ContinuousBatcher, against static batching's step count and the
    paged batcher."""
    import numpy as np
    import torch

    from kubegpu_tpu_torch.models.paging import PagedContinuousBatcher
    from kubegpu_tpu_torch.models.serving import ContinuousBatcher
    from kubegpu_tpu_torch.models.worker import cache_bytes

    prompts, budgets = serving_traffic()
    params = fresh_params(SERVING_CFG, torch.bfloat16)
    kw = dict(SERVING_CFG, slots=8, prompt_pad=128, dtype=torch.bfloat16,
              device="cuda")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cb = ContinuousBatcher(params, **kw)
    zero_counts()
    dense, dense_s = timed_run(cb, prompts, budgets)
    assert_no_kernel("continuous batching")
    dense_peak = torch.cuda.max_memory_allocated()
    total = sum(len(v) for v in dense.values())
    assert total == sum(budgets)
    assert all(0 <= t < SERVING_CFG["vocab_size"]
               for v in dense.values() for t in v)
    static_steps = sum(max(budgets[i:i + 8]) for i in range(0, 16, 8))
    ttft = sorted(cb.first_token_s.values())
    st = dict(cb.stats)
    log(f"continuous batching (1.08B bf16, 8 slots, 16 prompts, budgets "
        f"32..256, chunk {cb.prefill_chunk}): {total} tokens in "
        f"{st['steps']} steps + {st['admits']} admits ({st['prefill_chunks']} "
        f"chunks) vs {static_steps} static-batch steps -> "
        f"{static_steps / st['steps']:.3f}x step efficiency; {dense_s:.3f} s "
        f"-> {total / dense_s:.1f} tok/s, {dense_s / st['steps'] * 1e3:.3f} "
        f"ms a step; TTFT mean {np.mean(ttft) * 1e3:.1f} ms max "
        f"{ttft[-1] * 1e3:.1f} ms; dense cache {cache_bytes(cb) / 2**20:.1f} "
        f"MiB; peak device memory {dense_peak / 2**30:.2f} GiB")
    dense_bytes = cache_bytes(cb)
    del cb
    torch.cuda.empty_cache()
    pb = PagedContinuousBatcher(params, **kw, page_size=128, pool_pages=25)
    paged, paged_s = timed_run(pb, prompts, budgets)
    pt = dict(pb.stats)
    paged_bytes = cache_bytes(pb)
    log(f"paged continuous batching (page 128, pool 25 pages): {total} "
        f"tokens in {pt['steps']} steps + {pt['admits']} admits, peak "
        f"{pt['peak_pages']} pages; {paged_s:.3f} s -> "
        f"{total / paged_s:.1f} tok/s, {paged_s / pt['steps'] * 1e3:.3f} ms "
        f"a step; cache {paged_bytes / 2**20:.1f} MiB vs dense "
        f"{dense_bytes / 2**20:.1f} MiB ({dense_bytes / paged_bytes:.2f}x)")
    del pb
    torch.cuda.empty_cache()
    agree, n, margins = agreement(
        "bf16 paged vs dense", params, SERVING_CFG, torch.bfloat16, prompts,
        dense, paged, BF16_NEAR_TIE)
    log(f"bf16 paged vs dense streams: {agree}/{n} tokens agree before any "
        f"divergence ({agree / n:.4f}); margins at first divergence "
        f"{['%.3e' % m for m in margins]}")
    return dict(tok_s=total / dense_s, steps=st["steps"],
                static_steps=static_steps, paged_tok_s=total / paged_s,
                ms_step=dense_s / st["steps"] * 1e3,
                paged_ms_step=paged_s / pt["steps"] * 1e3)


def phase_prefill_itl() -> dict:
    """Phase 31: bench.py's serving_prefill_latency part (a) at full
    width: 4 runners decode while 8 prompt_pad-long prompts arrive;
    the runners' ITL p95, chunked (64) against monolithic, min of 3
    interleaved waves a mode on warm batchers."""
    import numpy as np
    import torch

    from kubegpu_tpu_torch.models.serving import ContinuousBatcher
    from kubegpu_tpu_torch.utils.metrics import Metrics

    vocab, prompt_pad, chunk = 32768, 256, 64
    params = fresh_params(SERVING_CFG, torch.bfloat16)
    cfg = dict(SERVING_CFG, slots=6, prompt_pad=prompt_pad,
               dtype=torch.bfloat16, device="cuda")
    rs = np.random.RandomState(0)
    runner_budget, n_long, long_budget = 64, 8, 4

    def build(prefill_chunk):
        cb = ContinuousBatcher(params, prefill_chunk=prefill_chunk, **cfg)
        cb.submit(90, rs.randint(0, vocab, size=prompt_pad).astype(
            np.int32), 2)
        while cb.has_work():
            cb.serve_step()
        cb.attach_metrics(Metrics())
        return cb

    waves = [0]

    def itl_wave(cb):
        base = 1000 * waves[0]
        waves[0] += 1
        runners = [base + i for i in range(4)]
        for rid in runners:
            cb.submit(rid, rs.randint(0, vocab, size=16).astype(np.int32),
                      runner_budget)

        def by_id():
            return {s.seq_id: s for s in cb._slots if s.seq_id >= 0}

        while not all(rid in by_id() and by_id()[rid].tokens
                      for rid in runners):
            cb.serve_step()
        counts = {rid: len(by_id()[rid].tokens) for rid in runners}
        now = time.perf_counter()
        last = {rid: now for rid in runners}
        long_ids = set()
        for j in range(n_long):
            long_ids.add(base + 100 + j)
            cb.submit(base + 100 + j, rs.randint(
                0, vocab, size=prompt_pad).astype(np.int32), long_budget)
        gaps, done = [], {}
        while not long_ids <= set(done):
            done.update(cb.serve_step())
            now = time.perf_counter()
            sl = by_id()
            for rid in runners:
                s = sl.get(rid)
                if s is not None and len(s.tokens) > counts[rid]:
                    gaps.append(now - last[rid])
                    last[rid] = now
                    counts[rid] = len(s.tokens)
        while cb.has_work():
            cb.serve_step()
        gaps.sort()
        return gaps[min(len(gaps) - 1, int(0.95 * len(gaps)))]

    zero_counts()
    mono_cb, chunk_cb = build(None), build(chunk)
    mono, chunked = [], []
    for w in range(3):
        order = ((mono_cb, mono), (chunk_cb, chunked))
        for cb, out in (order if w % 2 == 0 else order[::-1]):
            out.append(itl_wave(cb))
    assert_no_kernel("chunked and monolithic prefill")
    itl_mono, itl_chunk = min(mono), min(chunked)
    ttft_p95 = chunk_cb.metrics.quantile("serve_ttft_seconds", 0.95)
    mono_ttft_p95 = mono_cb.metrics.quantile("serve_ttft_seconds", 0.95)
    log(f"serving ITL under long-prompt admits (1.08B bf16, 6 slots, "
        f"prompt_pad {prompt_pad}, chunk {chunk}): runners' ITL p95 "
        f"{itl_chunk * 1e3:.2f} ms chunked vs {itl_mono * 1e3:.2f} ms "
        f"monolithic ({itl_mono / itl_chunk:.2f}x); waves "
        f"{['%.2f' % (x * 1e3) for x in chunked]} vs "
        f"{['%.2f' % (x * 1e3) for x in mono]} ms; "
        f"{chunk_cb.stats['prefill_chunks']} chunks; TTFT p95 "
        f"{ttft_p95 * 1e3:.1f} ms chunked, {mono_ttft_p95 * 1e3:.1f} ms "
        f"monolithic")
    if itl_chunk >= itl_mono:
        log("serving ITL WARNING: chunked p95 not below monolithic")
    del mono_cb, chunk_cb
    torch.cuda.empty_cache()
    return dict(itl_chunk_ms=itl_chunk * 1e3, itl_mono_ms=itl_mono * 1e3,
                ttft_p95_ms=ttft_p95 * 1e3)


def phase_spec_serving() -> dict:
    """Phase 32: bench.py's speculative serving rows (:866-975) at full
    width with the worker's fresh draft (1 layer, hidden 1024, seed 7),
    k 4: the step ratio and tokens/s against the dense batcher and the
    bf16 agreement; at float32 the reference's gate, speculative equal
    to dense but for printed near-ties."""
    import numpy as np
    import torch

    from kubegpu_tpu_torch.models.serving import ContinuousBatcher
    from kubegpu_tpu_torch.models.spec_serving import (
        SpeculativeContinuousBatcher,
    )

    rs = np.random.RandomState(1)
    budgets = [(32, 64, 96, 192)[i % 4] for i in range(16)]
    prompts = [rs.randint(0, SERVING_CFG["vocab_size"],
                          size=rs.randint(16, 64)).astype(np.int32)
               for _ in budgets]
    out = {}
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).replace("torch.", "")
        params = fresh_params(SERVING_CFG, dtype)
        dparams = fresh_params(FLAGSHIP_DRAFT, dtype, seed=7)
        kw = dict(SERVING_CFG, slots=8, prompt_pad=64, dtype=dtype,
                  device="cuda")
        zero_counts()
        dense_cb = ContinuousBatcher(params, **kw)
        dense, dense_s = timed_run(dense_cb, prompts, budgets)
        dense_steps = dense_cb.stats["steps"]
        del dense_cb
        spec_cb = SpeculativeContinuousBatcher(params, dparams, k=SPEC_K,
                                               **DRAFT_DIMS, **kw)
        spec, spec_s = timed_run(spec_cb, prompts, budgets)
        st = dict(spec_cb.stats)
        del spec_cb
        torch.cuda.empty_cache()
        assert_no_kernel(f"{name} dense and speculative batchers")
        n = sum(len(v) for v in dense.values())
        assert n == sum(budgets) == sum(len(v) for v in spec.values())
        log(f"{name} speculative serving (k {SPEC_K}, fresh 1-layer draft): "
            f"{n} tokens in {st['steps']} verify steps vs dense "
            f"{dense_steps} steps ({dense_steps / st['steps']:.3f}x fewer); "
            f"{spec_s:.3f} s ({n / spec_s:.1f} tok/s, "
            f"{spec_s / st['steps'] * 1e3:.3f} ms a verify) vs dense "
            f"{dense_s:.3f} s ({n / dense_s:.1f} tok/s)")
        limit = BF16_NEAR_TIE if dtype == torch.bfloat16 else NEAR_TIE_MARGIN
        agree, total, margins = agreement(
            f"{name} speculative vs dense", params, SERVING_CFG, dtype,
            prompts, dense, spec, limit)
        log(f"{name} speculative vs dense streams: {agree}/{total} tokens "
            f"agree before any divergence ({agree / total:.4f}); margins "
            f"{['%.3e' % m for m in margins]}")
        out[name] = dict(ratio=dense_steps / st["steps"], tok_s=n / spec_s,
                         dense_tok_s=n / dense_s, agree=agree / total)
        del params, dparams
        torch.cuda.empty_cache()
    return out


def phase_dense_card_vs_cpu(ctx: dict) -> None:
    """Phase 33: phase 6's model and traffic at float32, card against
    CPU, through ContinuousBatcher (chunked, monolithic, under a token
    budget) and SpeculativeContinuousBatcher (phase 7's hopeless draft,
    k 4), greedy and seed-pinned sampled."""
    import torch

    from kubegpu_tpu_torch.models.decoding import DecodeLM
    from kubegpu_tpu_torch.models.params import bind_params, init_params
    from kubegpu_tpu_torch.models.serving import ContinuousBatcher
    from kubegpu_tpu_torch.models.spec_serving import (
        SpeculativeContinuousBatcher,
    )

    cfg, n = ctx["cfg"], len(ctx["prompts"])
    temps = [0.8, 1.0, 0.7, 1.2, 0.9, 0.6, 1.1, 0.8][:n]
    seeds = [100 + i for i in range(n)]
    d_cfg = dict(vocab_size=cfg["vocab_size"], num_layers=1, hidden=64,
                 max_seq=cfg["max_seq"])
    dparams = init_params(d_cfg, torch.Generator().manual_seed(5),
                          torch.float32, "cpu")
    draft = bind_params(DecodeLM(num_heads=2, dtype=torch.float32, **d_cfg),
                        dparams)
    base = dict(cfg, slots=4, prompt_pad=32, dtype=torch.float32)
    configs = (
        ("chunked 8", ContinuousBatcher, dict(prefill_chunk=8)),
        ("monolithic", ContinuousBatcher, dict(prefill_chunk=None)),
        ("chunked 8, budget 12", ContinuousBatcher,
         dict(prefill_chunk=8, token_budget=12)),
        ("speculative k 4", SpeculativeContinuousBatcher,
         dict(k=SPEC_K, draft_num_layers=1, draft_num_heads=2,
              draft_hidden=64)),
    )
    for name, cls, kw in configs:
        spec = cls is SpeculativeContinuousBatcher
        args = (ctx["params"], dparams) if spec else (ctx["params"],)
        for sampled in (False, True):
            streams = {}
            for d in ("cpu", "cuda"):
                zero_counts()
                cb = cls(*args, device=d, **base, **kw,
                         **(dict(sampling=True) if spec and sampled else {}))
                run_kw = (dict(temperatures=temps, seeds=seeds) if sampled
                          else {})
                streams[d] = cb.run(ctx["prompts"], ctx["budgets"], **run_kw)
                assert_no_kernel(f"{name} on {d}")
            if sampled:
                agree, total, ties = sampled_agreement(
                    f"sampled dense {name} card and cpu", ctx,
                    streams["cpu"], streams["cuda"], temps, seeds,
                    draft if spec else None)
                log(f"sampled dense {name} card vs cpu (fp32, "
                    f"seed-pinned): {agree}/{total} tokens agree before any "
                    f"divergence, {ties} near-ties")
            else:
                agree, total = near_tie_agreement(
                    f"dense {name} card and cpu", cfg, ctx["dense"],
                    ctx["prompts"], streams["cpu"], streams["cuda"])
                log(f"dense {name} card vs cpu (fp32): {agree}/{total} "
                    "tokens agree before any near-tie divergence")
                if name == "chunked 8":
                    # the dense and paged batchers serve one model
                    a2, t2 = near_tie_agreement(
                        "dense and paged on the card", cfg, ctx["dense"],
                        ctx["prompts"], ctx["card"], streams["cuda"])
                    log(f"dense vs paged card streams (fp32): {a2}/{t2} "
                        "tokens agree before any near-tie divergence")
    torch.cuda.empty_cache()


def phase_dense_worker() -> dict:
    """Phase 34: the worker at its defaults in the dense modes: a
    ``--serving continuous`` and a ``--serving speculative --spec-k 8``
    wave in process, then ``--serving continuous --serve-http 0`` in a
    subprocess: streamed requests, a wire cancel, ``/v1/state`` and the
    migration routes answering as the JAX dense replica answers."""
    import os
    import queue
    import signal
    import threading

    import torch

    from kubegpu_tpu_torch.models import worker

    for serving, extra in (("continuous", []),
                           ("speculative", ["--spec-k", str(DEFAULT_SPEC_K)])):
        args = worker.build_parser().parse_args(
            ["--model", "decode", "--serving", serving] + extra)
        zero_counts()
        r = worker.run_decode(args)
        assert_no_kernel(f"worker --serving {serving} at its defaults")
        check_wave(r, args)
        log(f"worker --serving {serving} {' '.join(extra)} at its "
            f"defaults: {r['requests']} requests, {r['tokens']} tokens in "
            f"{r['wave_s']:.3f} s -> {r['tokens_per_sec']:.1f} tok/s; "
            f"{r['steps']} steps, {r['admits']} admits; cache "
            f"{r['cache_bytes'] / 2**20:.1f} MiB")
        torch.cuda.empty_cache()
    cmd = [sys.executable, "-m", "kubegpu_tpu_torch.models.worker",
           "--model", "decode", "--serving", "continuous", "--serve-http",
           "0", "--serve-http-step-delay", "0.01"]
    t0 = time.monotonic()
    proc = subprocess.Popen(cmd, cwd=os.path.dirname(os.path.abspath(
        __file__)), stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    lines: "queue.Queue" = queue.Queue()
    out = []

    def pump():
        for line in proc.stdout:
            lines.put(line)
        lines.put(None)

    threading.Thread(target=pump, daemon=True).start()
    try:
        deadline = t0 + 300
        while True:
            line = lines.get(timeout=max(0.0, deadline - time.monotonic()))
            assert line is not None, f"worker exited {proc.wait()}: {out}"
            out.append(line.rstrip())
            if line.startswith("REPLICA_HTTP_SERVING"):
                break
        up_s = time.monotonic() - t0
        port = int(fields(line)["port"])
        assert fields(line)["serving"] == "continuous"
        bodies = [{"request_id": f"d{i}", "prompt": [5 + i, 6, 7, 8],
                   "max_new_tokens": 8 + 4 * i} for i in range(4)]
        got, wall = post_concurrently(port, bodies)
        streams, ttfts = check_streams(got, [b["max_new_tokens"]
                                             for b in bodies])
        # a long request cancelled over the wire after two token events
        seen = []
        cancelled = {}

        def on_event(ev, payload):
            seen.append(ev)
            if seen.count("tokens") == 2 and not cancelled:
                cancelled.update(sse_request(port, "/v1/cancel", {
                    "request_id": "long"})[0][1])

        events = sse_request(port, "/v1/submit", {
            "request_id": "long", "prompt": [1, 2, 3],
            "max_new_tokens": 900}, on_event=on_event)
        assert cancelled == {"cancelled": True}, cancelled
        assert events[-1][0] == "error", events[-1][:2]
        state = json.loads(http_get(port, "/v1/state"))
        deadline = time.monotonic() + 30
        while state["active_streams"] and time.monotonic() < deadline:
            time.sleep(0.05)
            state = json.loads(http_get(port, "/v1/state"))
        assert state["active_streams"] == 0, state
        export = sse_request(port, "/v1/export", {"request_id": "gone"})
        sealed = sse_request(port, "/v1/export", {"stream": [1, 2, 3]})
        assert "no live stream" in export[0][1]["error"], export
        assert sealed[0][1] == {"payload": None, "pages": 0}, sealed
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=120)
        while True:
            rest = lines.get(timeout=10)
            if rest is None:
                break
            out.append(rest.rstrip())
        stopped = next(x for x in out if x.startswith("REPLICA_HTTP_STOPPED"))
        log(f"worker --serving continuous --serve-http 0: up in {up_s:.1f} "
            f"s; 4 streams ({sum(len(s) for s in streams.values())} tokens) "
            f"in {wall:.3f} s, client TTFT max {max(ttfts) * 1e3:.1f} ms; "
            f"the long request cancelled after {seen.count('tokens')} token "
            f"events; /v1/state stats {state['stats']}; export of an "
            f"unknown stream -> {export[0][1]}, sealed capture -> "
            f"{sealed[0][1]}; {stopped}; exit {rc}")
        assert rc == 0 and "error=False" in stopped
        assert all(f"{k}_LAUNCHES=0" in stopped
                   for k in ("K1", "K1q", "K2", "K2q", "K3", "K4", "K5"))
        return dict(serving_s=up_s)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


# tensor parallelism: two ranks, each with half the flagship's 32 heads
TP = 2
TP_PAGED = dict(b=8, h=32 // TP, hd=128, page=128)
TP_FLAGSHIP = dict(vocab_size=32768, num_layers=4, num_heads=32,
                   hidden=4096, max_seq=1025)
TP_FLAGSHIP_KW = dict(slots=8, prompt_pad=128, page_size=128, pool_pages=25)
TP_DRAFT = dict(draft_num_layers=1, draft_num_heads=8, draft_hidden=1024)


def phase_tp_kernels() -> dict:
    """Phase 35: K1, K1q, K2 and K2q through their head-sharded wrappers
    on each rank's half of the flagship's heads (8 slots, 16 of 32 heads
    of 128, pages of 128, phases 2-3's tables and lengths), float32 and
    bfloat16: within phases 2-3's tolerances of the plain version on the
    same half, and bit for bit the unsharded kernel's result for those
    heads.  Each kernel's time at the rank's shape (graph replay), the
    plain time and the bound."""
    import torch

    from kubegpu_tpu_torch.ops import paged_attention as pa
    from kubegpu_tpu_torch.parallel.mesh import Mesh

    dev = torch.device("cuda")
    b, h, hd, page = TP_PAGED["b"], TP_PAGED["h"] * TP, TP_PAGED["hd"], (
        TP_PAGED["page"])
    n_pages = CONTEXT_ROWS // page
    pool = b * n_pages + 8
    meshes = [Mesh(size=TP, rank=r, device=dev, backend="gloo")
              for r in range(TP)]
    rec = {}
    for name, L, quant in (("paged_decode_attention", 1, False),
                           ("paged_decode_attention_int8", 1, True),
                           ("paged_chunk_attention", SPEC_K + 1, False),
                           ("paged_chunk_attention_int8", SPEC_K + 1, True)):
        kernel, plain, sharded = (
            (pa.paged_decode_attention, pa.paged_decode_attention_plain,
             pa.paged_decode_attention_sharded) if L == 1 else
            (pa.paged_chunk_attention, pa.paged_chunk_attention_plain,
             pa.paged_chunk_attention_sharded))
        lengths_l = ([0, 1, page - 1, page, 200, 513, 1000, n_pages * page]
                     if L == 1 else
                     [1, page - 4, page - 2, page - 1, page, 513, 1000,
                      n_pages * page - (L - 1)])
        g = torch.Generator(device=dev).manual_seed(41 + L + 2 * quant)
        table = torch.stack([torch.randperm(pool, generator=g,
                                            device=dev)[:n_pages]
                             for _ in range(b)]).to(torch.int32)
        lengths = torch.tensor(lengths_l, dtype=torch.int32, device=dev)
        for dtype, rtol, atol in ((torch.float32, F32_TOL, F32_TOL),
                                  (torch.bfloat16, BF16_RTOL, BF16_ATOL)):
            shape = (b, h, hd) if L == 1 else (b, L, h, hd)
            q = torch.randn(shape, generator=g, device=dev).to(dtype)
            kp, vp, sc, _ = paged_operands((pool, h, page, hd), dtype, g,
                                           quant)
            whole = kernel(q, kp, vp, table, lengths, **sc)
            w, err, shards = h // TP, 0.0, []
            for rank in range(TP):
                heads = slice(rank * w, (rank + 1) * w)
                args = (q[..., heads, :].contiguous(),
                        kp[:, heads].contiguous(), vp[:, heads].contiguous(),
                        table, lengths)
                scs = {k: v[:, heads].contiguous() for k, v in sc.items()}
                out = sharded(*args, meshes[rank], h, **scs)
                want = plain(*args, **scs)
                torch.testing.assert_close(out.float(), want.float(),
                                           rtol=rtol, atol=atol)
                assert torch.equal(out, whole[..., heads, :]), (
                    f"{name} rank {rank} differs from the unsharded kernel")
                err = max(err, (out.float() - want.float()).abs().max()
                          .item())
                shards.append((args, scs))
            dname = str(dtype).replace("torch.", "")
            log(f"TP {name} {dname} ({w} of {h} heads a rank): "
                f"max|kernel - plain| = {err:.3e}, each rank's heads equal "
                "the unsharded kernel's bit for bit")
            if dtype != torch.bfloat16:
                continue
            args, scs = shards[0]
            rows = [min(n + L - 1, n_pages * page) for n in lengths_l]
            live_pages = sum(-(-n // page) for n in rows)
            nbytes = (2 * sum(rows) * w * hd * args[1].element_size()
                      + 2 * live_pages * w * 4 * quant
                      + 2 * b * L * w * hd * q.element_size()
                      + 4 * (live_pages + b))
            flops = 4 * sum(min(n + j, n_pages * page) for n in lengths_l
                            for j in range(L)) * w * hd
            bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
            flops_ms = flops / F32_FLOPS_PER_S * 1e3
            bound_ms = max(bytes_ms, flops_ms)
            ms = graph_ms(lambda: sharded(*args, meshes[0], h, **scs), 50)
            plain_ms = time_ms(lambda: plain(*args, **scs), 5)
            log(f"TP {name} bfloat16 at one rank's {w} heads: kernel "
                f"{ms * 1e3:.2f} us (graph replay), plain "
                f"{plain_ms * 1e3:.2f} us, bound {bound_ms * 1e3:.2f} us by "
                f"{'bytes' if bytes_ms >= flops_ms else 'operations'} -> "
                f"{bound_ms / ms * 100:.1f}% of bound")
            rec[name] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                             max_abs_err=err)
    return rec


def _np_tree(tree):
    return {k: _np_tree(v) if isinstance(v, dict) else v.cpu().numpy()
            for k, v in tree.items()}


def tp_gang(tmp: str, device: str):
    """Two ranks on the one card over gloo (NCCL refuses two ranks on
    one GPU): gloo copies each collective's tensors through the host."""
    from kubegpu_tpu_torch.parallel.launch import Gang

    dev = "cuda:0" if device == "cuda" else device
    return Gang(TP, tmp, backend="gloo", devices=[dev] * TP,
                timeout_s=600.0)


def tp_cases():
    """The rank bodies the port's tensor-parallel tests share
    (``tests/torch_tp_cases.py``); the gang's processes inherit the
    path."""
    import os

    tests = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "tests")
    if tests not in sys.path:
        sys.path.insert(0, tests)
    import torch_tp_cases

    return torch_tp_cases


def tp_check_ranks(label: str, got: dict, ref_cb, key: str,
                   layers: int) -> None:
    """(c) each rank rests half the unsharded batcher's pool, station and
    ring; (d) each rank launched ``key`` steps x layers times (on the
    card; the CPU launches none)."""
    full = tp_cases().rank_bytes(ref_cb)
    steps = got["stats"]["steps"]
    if ref_cb.device.type != "cuda":
        layers = 0
    for rank, (sizes, launches) in enumerate(zip(got["rank_bytes"],
                                                 got["rank_launches"])):
        assert {k: TP * v for k, v in sizes.items()} == full, (
            label, rank, sizes, full)
        assert launches[key] == steps * layers, (label, rank, launches)
        others = {k: v for k, v in launches.items() if k != key}
        assert not any(others.values()), (label, rank, launches)
        log(f"TP {label}: rank {rank} rests {sizes} B (unsharded {full}), "
            f"launched {key} {launches[key]} = {steps} steps x {layers} "
            "layers")


def phase_tp(ctx: dict, device: str = "cuda", flagship: dict = TP_FLAGSHIP,
             flagship_kw: dict = TP_FLAGSHIP_KW,
             draft: dict = TP_DRAFT) -> dict:
    """Phases 36-40: tensor-parallel serving, a two-rank gloo gang with
    both ranks on the card (host-staged collectives: its times are no
    tensor-parallel speed).  ``device="cpu"`` with a small ``flagship``
    rehearses it on the CPU."""
    import os
    import tempfile

    import numpy as np
    import torch

    from kubegpu_tpu_torch.models.paging import PagedContinuousBatcher

    cases = tp_cases()
    tmp = tempfile.mkdtemp(prefix="chip-smoke-tp-")
    cfg, small_kw = ctx["cfg"], ctx["kw"]
    np_small = _np_tree(ctx["params"])
    prompts, budgets = ctx["prompts"], ctx["budgets"]
    batch_kw = {k: v for k, v in small_kw.items()
                if k not in cfg and k != "dtype"}
    out = {"launches": {}}
    t_gang = time.monotonic()
    with tp_gang(tmp, device) as gang:
        # phase 36: the small float32 model, card TP 2 against card TP 1
        small_spec = dict(speculate_k=SPEC_K,
                          draft_num_layers=cfg["num_layers"],
                          draft_num_heads=cfg["num_heads"],
                          draft_hidden=cfg["hidden"])
        for mode, kw in (("plain", {}),
                         ("speculative", small_spec),
                         ("int8-pool", dict(kv_dtype="int8")),
                         ("int8-pool speculative",
                          dict(small_spec, kv_dtype="int8"))):
            spec = "speculate_k" in kw
            ref_cb = PagedContinuousBatcher(
                ctx["params"], device=device, **small_kw, **kw,
                **(dict(draft_params=ctx["params"]) if spec else {}))
            ref = ref_cb.run(prompts, budgets)
            got = gang.run(cases.serve, dict(
                params=np_small, cfg=cfg, kw=dict(batch_kw, **kw),
                draft=np_small if spec else None), prompts, budgets)
            assert got["streams"] == ref, f"TP 2 {mode} fp32 differs"
            n = sum(len(v) for v in ref.values())
            log(f"TP small fp32 {mode}: card TP 2 == card TP 1, {n}/{n} "
                "tokens")
            if mode == "plain":
                assert ref == ctx["card"]
            tp_check_ranks(f"small fp32 {mode}", got, ref_cb,
                           ("K2" if spec else "K1")
                           + ("q" if "kv_dtype" in kw else ""),
                           cfg["num_layers"])
        # phase 37: the flagship's full width in bf16, TP 2 against TP 1
        rng = np.random.RandomState(9)
        pad = flagship_kw["prompt_pad"]
        f_prompts = [rng.randint(0, flagship["vocab_size"],
                                 size=min(n, pad)).astype(np.int32)
                     for n in (16, 128, 64, 100, 33, 127, 90, 50)]
        f_budgets = [24, 16, 32, 8, 20, 28, 12, 30]
        init = dict(init=flagship, seed=0, dtype=torch.bfloat16)
        draft_cfg = dict(vocab_size=flagship["vocab_size"], num_layers=1,
                         hidden=draft["draft_hidden"],
                         max_seq=flagship["max_seq"])
        dinit = dict(init=draft_cfg, seed=7, dtype=torch.bfloat16)
        params = cases.weights(init, device)
        dparams = cases.weights(dinit, device)
        margin = lazy_margin(flagship, torch.bfloat16, device, params)
        for mode, kw, key in (
                ("plain", {}, "K1"),
                ("speculative", dict(speculate_k=SPEC_K, **draft), "K2"),
                ("int8-pool", dict(kv_dtype="int8"), "K1q"),
                ("int8-pool speculative", dict(kv_dtype="int8",
                                               speculate_k=SPEC_K,
                                               **draft), "K2q")):
            spec = "speculate_k" in kw
            ref_cb = PagedContinuousBatcher(
                params, dtype=torch.bfloat16, device=device, **flagship,
                **flagship_kw, **kw,
                **(dict(draft_params=dparams) if spec else {}))
            t0 = time.monotonic()
            ref = ref_cb.run(f_prompts, f_budgets)
            sync(device)
            tp1_s = time.monotonic() - t0
            got = gang.run(cases.serve, dict(
                params=init, cfg=flagship, dtype=torch.bfloat16,
                kw=dict(flagship_kw, **kw),
                draft=dinit if spec else None), f_prompts, f_budgets,
                None, False, False)
            agree = sum(same_or_near_tie(
                f"TP flagship {mode} request {i}", got["streams"][i],
                ref[i], f_prompts[i], margin, BF16_NEAR_TIE_MARGIN)
                for i in ref)
            total = sum(len(v) for v in ref.values())
            log(f"TP flagship bf16 {mode}: TP 2 agrees with TP 1 on "
                f"{agree}/{total} tokens before any near-tie; wave "
                f"{got['seconds']:.3f} s at TP 2 (gloo, host-staged on one "
                f"card: not a TP speed) against {tp1_s:.3f} s at TP 1")
            tp_check_ranks(f"flagship bf16 {mode}", got, ref_cb, key,
                           flagship["num_layers"])
            out["launches"][key] = [n[key] for n in got["rank_launches"]]
            del ref_cb
        del params, dparams
        # phase 38: a TP 2 export imported into a TP 1 batcher on the card
        prompt = prompts[1]
        tp1 = PagedContinuousBatcher(ctx["params"], device=device,
                                     **small_kw)
        whole = tp1.run([prompt], [30])[0]
        payload = gang.run(cases.export_mid_stream, dict(
            params=np_small, cfg=cfg, kw=batch_kw), prompt, 30, 6)
        assert payload["geometry"]["tp"] == TP
        dst = PagedContinuousBatcher(ctx["params"], device=device,
                                     **small_kw)
        dst.import_pages(10, payload)
        cont = {}
        while dst.has_work():
            cont.update(dst.serve_step())
        dst.assert_page_accounting()
        assert cont[10] == whole, "TP 2 -> TP 1 continuation differs"
        log(f"TP export: a TP 2 sequence exported after "
            f"{len(payload['tokens'])} tokens continues in a card TP 1 "
            f"batcher as the stream that never migrated ({len(whole)} "
            "tokens)")
        # phase 39: a TP 2 replica over loopback HTTP
        ctrl = os.path.join(tmp, "http")
        os.makedirs(ctrl)
        import concurrent.futures

        with concurrent.futures.ThreadPoolExecutor(1) as ex:
            served = ex.submit(gang.run, cases.serve_http, dict(
                params=np_small, cfg=cfg, kw=batch_kw), ctrl, 0.0)
            endpoint = os.path.join(ctrl, "endpoint")
            deadline = time.monotonic() + 300
            while not os.path.exists(endpoint) and not served.done():
                assert time.monotonic() < deadline, "no TP replica endpoint"
                time.sleep(0.05)
            try:
                port = int(open(endpoint).read().rsplit(":", 1)[1])
                bodies = [{"request_id": f"tp{i}",
                           "prompt": [int(t) for t in prompts[i]],
                           "max_new_tokens": budgets[i]} for i in range(4)]
                got, wall = post_concurrently(port, bodies)
                state = json.loads(http_get(port, "/v1/state"))
            finally:
                open(os.path.join(ctrl, "stop"), "w").close()
            result = served.result(timeout=300)
        streams, _ = check_streams(got, budgets[:4])
        for i in range(4):
            assert streams[i] == ctx["card"][i], f"TP replica request {i}"
        assert state["tp"] == TP and result["tp"] == TP
        assert result["error"] is None
        log(f"TP replica: 4 requests over loopback in {wall:.3f} s equal "
            f"the card TP 1 streams; /v1/state tp={state['tp']}")
    out["gang_s"] = time.monotonic() - t_gang
    # phase 40: the worker's --tp 2 on this machine
    n_cards = torch.cuda.device_count() if device == "cuda" else 0
    argv = TP_WORKER_ARGV
    if n_cards < TP:
        proc = early_run("tp_serve", argv)
        want = f"exceeds the visible device count {n_cards}"
        assert proc.returncode != 0 and want in proc.stderr, (
            proc.returncode, proc.stderr[-2000:])
        log(f"TP worker: --tp {TP} refused on {n_cards} card(s): {want}")
        log("TP over NCCL: not exercised (one card visible); the NCCL "
            "path is unverified on this machine")
    else:
        # with two cards or more, the same wave over NCCL, one rank a card
        lines = run_worker_lines(argv)
        assert fields(lines["SERVING_TP"])["backend"] == "nccl"
        log(f"TP over NCCL: {lines['SERVING_TP']} / {lines['DECODE_DONE']}")
    return out


# phase 40's worker: the small model's wave at --tp 2
TP_WORKER_ARGV = ["--model", "decode", "--serving", "paged", "--tp", str(TP),
                  "--vocab", "512", "--hidden", "256", "--heads", "2",
                  "--layers", "2", "--seq", "96", "--prompt-len", "32",
                  "--page-size", "16", "--batch-per-chip", "4", "--steps",
                  "16", "--serve-fp32"]


# data x tensor-parallel training: a ("data", "model") mesh of four ranks
TRAIN_AXES = {"data": 2, "model": 2}
TRAIN_TP_SHAPE = (16, 1024, 32 // TRAIN_AXES["model"], 128)
TRAIN_SMALL = dict(vocab_size=256, num_layers=2, num_heads=4, hidden=256,
                   max_seq=129)
TRAIN_FLAGSHIP = dict(vocab_size=32768, num_layers=4, num_heads=32,
                      hidden=4096, max_seq=1025)
TRAIN_FLAGSHIP_RUN = dict(seq=1024, batch_per_chip=2, steps=3)
# bf16 compute: the mesh's row-parallel sums and reduce-scatters round
# differently from one device's GEMMs
FLAGSHIP_LOSS_TOL = 1e-2


def phase_tp_flash() -> dict:
    """Phase 41: K3, K4, K5 and the delta pre-pass at one tp 2 rank's 16
    of the flagship's 32 heads (b 16, s 1024, d 128, causal, bf16):
    against their plain twins as in phase 8, each kernel's graph-replay
    time, bound, plain time and SDPA's time."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(8)
    b, s, h, d = TRAIN_TP_SHAPE
    q, k, v, dout = flash_inputs(b, s, s, h, d, torch.bfloat16, g)
    errs = check_flash(q, k, v, dout, True)
    rec: dict = {}
    time_flash(q, k, v, dout, errs, rec)
    del q, k, v, dout
    torch.cuda.empty_cache()
    return {k: v["bfloat16"] for k, v in rec.items()}


def train_gang(tmp: str, device: str):
    """The four ranks of the training mesh on the one card over gloo
    (NCCL refuses two ranks on one GPU): every collective is copied
    through the host."""
    from kubegpu_tpu_torch.parallel.launch import Gang

    tp_cases()   # tests/ on the path before the ranks inherit it
    dev = "cuda:0" if device == "cuda" else device
    return Gang(TRAIN_AXES, tmp, backend="gloo", devices=[dev] * 4,
                timeout_s=900.0)


def tree_close(label: str, got: dict, want: dict, tol: float) -> float:
    """Every leaf of ``got`` within rtol=atol ``tol`` of ``want``;
    returns the largest difference."""
    import numpy as np

    worst = 0.0
    for k, w in want.items():
        if isinstance(w, dict):
            worst = max(worst, tree_close(f"{label}/{k}", got[k], w, tol))
            continue
        np.testing.assert_allclose(got[k], w, rtol=tol, atol=tol,
                                   err_msg=f"{label}/{k}")
        worst = max(worst, float(np.abs(got[k] - w).max()))
    return worst


def phase_tp_train_small(gang, device: str = "cuda",
                         cfg: dict = TRAIN_SMALL) -> None:
    """Phase 42: phase 10's small float32 model at dp 2 x tp 2 with
    sequence parallelism in the gang, flash attention with remat off and
    on: one step's loss and every gradient leaf, gathered whole, within
    rtol=atol 1e-4 of the card's one-device step on the same global batch,
    K3 launched once a layer a rank (twice with remat) and K4, K5 once;
    then three steps' losses, weights and momentum within 1e-4."""
    import numpy as np
    import torch

    from kubegpu_tpu_torch.models.params import init_params, tree_map
    from kubegpu_tpu_torch.models.train import (
        create_train_state,
        gather_state,
        grad_tree,
        lm_grads,
        lm_step,
    )
    from kubegpu_tpu_torch.models.transformer import TransformerLM

    cases = tp_cases()
    params = init_params(cfg, torch.Generator().manual_seed(6),
                         torch.float32, "cpu")
    np_params = _np_tree(params)
    seq = cfg["max_seq"] - 1
    rng = np.random.RandomState(1)
    batches = [rng.randint(0, cfg["vocab_size"], size=(4, seq + 1))
               .astype(np.int32) for _ in range(3)]
    layers = cfg["num_layers"]
    kernels = device == "cuda"
    for remat in (False, True):
        def one_device():
            model = TransformerLM(dtype=torch.float32, attn_impl="flash",
                                  remat=remat, **cfg)
            return create_train_state(
                model, tree_map(lambda t: t.to(device).clone(), params))

        state = one_device()
        loss = lm_grads(state, torch.from_numpy(batches[0]).to(device))
        grads = _np_tree(grad_tree(state))
        state = one_device()
        losses = [lm_step(state, torch.from_numpy(t).to(device)).item()
                  for t in batches]
        whole, opt_state = gather_state(state)
        whole, moments = _np_tree(whole), _np_tree(opt_state["trace"])
        spec = dict(params=np_params, cfg=cfg, tokens=batches,
                    model=dict(attn_impl="flash", sequence_parallel=True,
                               remat=remat))
        got = gang.run(cases.train_grads, spec)
        steps = gang.run(cases.train_steps, spec)
        np.testing.assert_allclose(got["loss"], loss.item(), rtol=TRAIN_TOL,
                                   atol=TRAIN_TOL)
        g_worst = tree_close("grad", got["grads"], grads, TRAIN_TOL)
        want = dict(flash_forward=(1 + remat) * layers * kernels,
                    flash_backward_dkdv=layers * kernels,
                    flash_backward_dq=layers * kernels,
                    flash_backward_delta=0)
        assert got["launches"] == want, (got["launches"], want)
        np.testing.assert_allclose(steps["losses"], losses, rtol=TRAIN_TOL,
                                   atol=TRAIN_TOL)
        p_worst = tree_close("param", steps["params"], whole, TRAIN_TOL)
        m_worst = tree_close("momentum", steps["momentum"], moments,
                             TRAIN_TOL)
        log(f"train dp 2 x tp 2 fp32 remat={remat}: loss {got['loss']:.6f} "
            f"against one device {loss.item():.6f}, worst gradient diff "
            f"{g_worst:.3e}; three steps {steps['losses']} against "
            f"{losses}, worst weight diff {p_worst:.3e}, momentum "
            f"{m_worst:.3e}; launches a rank {got['launches']}")


def expected_rank_bytes(cfg: dict, tp: int) -> tuple:
    """(one rank's parameter bytes at tp, the whole model's) in float32,
    from the model's own shapes (built on the meta device): a leaf the
    rules shard holds 1/tp, the LayerNorms whole."""
    from kubegpu_tpu_torch.models.transformer import TransformerLM
    from kubegpu_tpu_torch.parallel.sharding import shard_dim

    mine = whole = 0
    for name, p in TransformerLM(**cfg).named_parameters():
        n = p.numel() * 4
        whole += n
        mine += n if shard_dim(name.replace(".", "/")) is None else n // tp
    return mine, whole


def phase_tp_train_flagship(gang, device: str = "cuda",
                            cfg: dict = TRAIN_FLAGSHIP,
                            run: dict = TRAIN_FLAGSHIP_RUN) -> dict:
    """Phase 43: the flagship at full width (bf16 compute over float32
    weights, flash attention, sequence parallelism) at dp 2 x tp 2 in the
    gang for three steps on ``synthetic_token_batches_for_mesh``: finite
    losses that fall, a first loss within 1e-2 of the card's one-device
    loss on the same global batch, K3, K4, K5 and the pre-pass launched
    steps x layers times on every rank, each rank's parameter and
    momentum bytes 1/tp of the whole but for the LayerNorms.  Prints the
    seconds a step (host-staged gloo on one card: no TP speed) and each
    rank's peak memory."""
    import math

    import numpy as np
    import torch

    from kubegpu_tpu_torch.models.data import synthetic_token_batches
    from kubegpu_tpu_torch.models.params import init_params
    from kubegpu_tpu_torch.models.train import create_train_state, lm_loss
    from kubegpu_tpu_torch.models.transformer import TransformerLM

    cases = tp_cases()
    dp, tp = TRAIN_AXES["data"], TRAIN_AXES["model"]
    seq, bpc, steps = run["seq"], run["batch_per_chip"], run["steps"]
    # the global batch of the first step: each data shard's first rows
    tokens = np.concatenate([next(synthetic_token_batches(
        bpc, seq + 1, cfg["vocab_size"], shard=d)) for d in range(dp)])
    model = TransformerLM(dtype=torch.bfloat16, attn_impl="flash",
                          sequence_parallel=True, **cfg)
    gen = torch.Generator(device=device).manual_seed(0)
    state = create_train_state(model, init_params(cfg, gen, torch.float32,
                                                  device))
    with torch.no_grad():
        ref = lm_loss(state.model, torch.from_numpy(tokens).to(device)).item()
    del state, model
    if device == "cuda":
        torch.cuda.empty_cache()
    t0 = time.monotonic()
    every = gang.run(cases.train_flagship, dict(
        params=dict(init=cfg, seed=0, dtype=torch.float32), cfg=cfg,
        dtype=torch.bfloat16, batch=bpc * dp, seq=seq, steps=steps,
        model=dict(attn_impl="flash", sequence_parallel=True)))
    wall = time.monotonic() - t0
    mine, whole = expected_rank_bytes(cfg, tp)
    kernels = device == "cuda"
    for rank, r in enumerate(every):
        losses = r["losses"]
        assert all(math.isfinite(x) for x in losses), (rank, losses)
        assert losses[-1] < losses[0], (rank, losses)
        assert abs(losses[0] - ref) <= FLAGSHIP_LOSS_TOL, (rank, losses, ref)
        assert r["param_bytes"] == r["momentum_bytes"] == mine, (
            rank, r["param_bytes"], r["momentum_bytes"], mine)
        want = steps * cfg["num_layers"] * kernels
        assert r["launches"] == {k: want for k in r["launches"]}, (
            rank, r["launches"])
        peak = r["peak_bytes"]
        log(f"train flagship dp {dp} x tp {tp} rank {rank} (data, model) "
            f"{r['coords']}: losses {[round(x, 4) for x in losses]} (one "
            f"device's first {ref:.4f}); seconds a step "
            f"{[round(x, 3) for x in r['seconds']]} (gloo, host-staged on "
            f"one card: not a TP speed); parameters {r['param_bytes']} B "
            f"and momentum {r['momentum_bytes']} B of {whole} B whole; "
            f"launches {r['launches']}; peak device memory "
            + (f"{peak / 2**30:.2f} GiB" if peak is not None else
               "not measured"))
        parts = r["parts"]
        log(f"train flagship rank {rank}, one more step in parts: forward "
            f"and backward {parts['forward_backward_s']:.3f} s, sync_grads "
            f"(LayerNorm sum over model, flat mean of "
            f"{parts['grad_bytes']} B over data) "
            f"{parts['sync_grads_s']:.3f} s, optimizer "
            f"{parts['optimizer_s']:.3f} s")
    log(f"train flagship dp {dp} x tp {tp}: {steps} steps of "
        f"{bpc * dp} x {seq} tokens, the gang's call {wall:.1f} s")
    return dict(launches=[r["launches"] for r in every],
                seconds=[r["seconds"] for r in every],
                parts=[r["parts"] for r in every],
                peak=[r["peak_bytes"] for r in every])


TRAIN_TP_WORKER_ARGV = ["--model", "lm", "--tp", "2", "--vocab", "512",
                        "--hidden", "256", "--heads", "4", "--layers", "2",
                        "--seq", "128", "--batch-per-chip", "2", "--steps",
                        "3"]


def phase_tp_train_worker(device: str = "cuda") -> None:
    """Phase 44: the worker's ``--model lm --tp 2`` on this machine:
    refused on one card ("exceeds the visible device count"); with two
    cards or more, a few small steps over NCCL."""
    import torch

    n_cards = torch.cuda.device_count() if device == "cuda" else 0
    argv = TRAIN_TP_WORKER_ARGV
    if n_cards < 2:
        proc = early_run("tp_train", argv)
        want = f"exceeds the visible device count {n_cards}"
        assert proc.returncode != 0 and want in proc.stderr, (
            proc.returncode, proc.stderr[-2000:])
        log(f"train worker: --model lm --tp 2 refused on {n_cards} card(s): "
            f"{want}; data x tensor-parallel training over NCCL: not "
            "exercised (one card visible)")
    else:
        lines = run_worker_lines(argv)
        assert fields(lines["TRAINING_MESH"])["backend"] == "nccl"
        log(f"train worker over NCCL: {lines['TRAINING_MESH']} / "
            f"{lines['FIRST_STEP_DONE']}")


def phase_tp_train(device: str = "cuda", small: dict = TRAIN_SMALL,
                   flagship: dict = TRAIN_FLAGSHIP,
                   run: dict = TRAIN_FLAGSHIP_RUN,
                   ckpt_root: str = None, gang=None) -> dict:
    """Phases 42-44 in one four-rank gang (``device="cpu"`` with small
    configs rehearses them on the CPU): ``gang``, started by the caller
    (closed here), else its own; with ``ckpt_root``, phase 47's mesh half
    runs in the same gang."""
    import tempfile

    # the gang boots beside earlier phases, or beside phase 42's
    # one-device steps
    with (gang or train_gang(tempfile.mkdtemp(prefix="chip-smoke-train-"),
                             device)).start() as gang:
        t0 = time.monotonic()
        phase_tp_train_small(gang, device, small)
        log(f"train small phase {time.monotonic() - t0:.1f} s (the gang's "
            "start included)")
        out = phase_tp_train_flagship(gang, device, flagship, run)
        if ckpt_root is not None:
            phase_ckpt_gang(gang, ckpt_root, device, small)
    phase_tp_train_worker(device)
    return out


# -- checkpoints (phases 45-47) -------------------------------------------------

# the flagship's full width; --layers and --ckpt-dir are added per run
CKPT_TRAIN = ["--model", "lm", "--vocab", "32768", "--hidden", "4096",
              "--heads", "32", "--seq", "1024", "--batch-per-chip", "4",
              "--steps", "2"]
# the speculative draft of phase 5 (1 layer, hidden 1024 in 8 heads of 128)
CKPT_DRAFT = ["--model", "lm", "--vocab", "32768", "--hidden", "1024",
              "--heads", "8", "--layers", "1", "--seq", "1024",
              "--batch-per-chip", "4", "--steps", "2"]
# 2 of the flagship's 4 layers: the smoke's time limit (a 4-layer step's
# two saves and restore took 41-50 s)
CKPT_LAYERS = 2
# a resumed run against an uninterrupted one: the kernels are
# deterministic, so equal bits are expected; the gate
RESUME_TOL = 1e-6


def captured(fn, *args):
    """``fn(*args)`` with its standard output captured, then echoed;
    returns (value, output)."""
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        value = fn(*args)
    out = buf.getvalue()
    sys.stdout.write(out)
    sys.stdout.flush()
    return value, out


def lm_param_bytes(cfg: dict) -> int:
    """The float32 bytes of the LM's parameters, from its shapes."""
    return expected_rank_bytes(cfg, 1)[1]


def ckpt_layers(root: str, flagship_cfg: dict) -> int:
    """``df`` of the checkpoint directory; the flagship's depth when two
    steps of parameters and momentum (the second save's temporary copy
    beside the first) fit with a tenth to spare, else depth 1."""
    usage = shutil.disk_usage(root)
    step = 2 * lm_param_bytes(dict(flagship_cfg, num_layers=CKPT_LAYERS))
    layers = CKPT_LAYERS if usage.free >= 2.2 * step else 1
    log(f"checkpoint disk {root}: total {usage.total / 1e9:.1f} GB, free "
        f"{usage.free / 1e9:.1f} GB; a {CKPT_LAYERS}-layer step holds "
        f"{step} B; training at {layers} layer(s)"
        + ("" if layers == CKPT_LAYERS else
           " (depth cut: two steps do not fit)"))
    return layers


def train_with_checkpoints(label: str, argv: list, device: str) -> tuple:
    """``worker.run_lm`` with the flash kernels' counts set to 0 just
    before; returns (result, output, launches)."""
    from kubegpu_tpu_torch.models import worker

    args = worker.build_parser().parse_args(argv + ["--device", device])
    kernels = flash_counts_to_zero()
    r, out = captured(worker.run_lm, args)
    launches = {fn.__name__: fn.launches for fn in kernels}
    want = args.steps * args.layers * (device == "cuda")
    assert all(n == want for n in launches.values()), (label, launches)
    ck = r["checkpoint"]
    log(f"{label}: losses {[round(x, 4) for x in r['losses']]}; launches "
        f"{launches} = {args.steps} steps x {args.layers} layers each; "
        f"restore {ck['restore_s']} s, saves {ck['save_s']} s; step "
        f"{ck['ckpt_step']} holds {ck['ckpt_bytes']} B")
    return r, out, launches


def phase_ckpt_train(root: str, device: str = "cuda",
                     base: list = CKPT_TRAIN, draft: list = CKPT_DRAFT,
                     cfg: dict = TRAIN_FLAGSHIP) -> dict:
    """Phase 45: the flagship trains 2 steps through the worker's ``--model
    lm --ckpt-dir`` and saves step 2 (``CHECKPOINT_SAVED step=2``), then a
    second run resumes (``RESUMED step=2``) and saves step 4; each run's
    K3, K4, K5 and pre-pass launches are steps x layers; each step's bytes
    are the parameters' and the momentum's (plus the npz headers); the
    seconds of each save and of the restore.  The 1-layer draft of
    phase 5 trains 2 steps into its own directory the same way."""
    import os

    layers = ckpt_layers(root, cfg)
    target, draft_dir = os.path.join(root, "target"), os.path.join(root,
                                                                   "draft")
    argv = base + ["--layers", str(layers), "--ckpt-dir", target]
    r1, out1, _ = train_with_checkpoints("checkpoint train", argv, device)
    assert "CHECKPOINT_SAVED step=2" in out1 and "RESUMED" not in out1
    r2, out2, _ = train_with_checkpoints("checkpoint resume", argv, device)
    assert "RESUMED step=2" in out2 and "CHECKPOINT_SAVED step=4" in out2
    params = lm_param_bytes(dict(cfg, num_layers=layers))
    ck1, ck2 = r1["checkpoint"], r2["checkpoint"]
    for ck in (ck1, ck2):
        # parameters and momentum, float32, plus the npz headers and json
        assert 0 <= ck["ckpt_bytes"] - 2 * params < 2**20, (ck, params)
    save_s = ck1["save_s"] + ck2["save_s"]
    log(f"checkpoint flagship ({layers} layers): parameters {params} B, "
        f"momentum {params} B, a step {ck2['ckpt_bytes']} B; saves "
        f"{[round(x, 3) for x in save_s]} s "
        f"({[round(ck2['ckpt_bytes'] / x / 1e9, 3) for x in save_s]} GB/s), "
        f"restore {ck2['restore_s']:.3f} s "
        f"({ck2['ckpt_bytes'] / ck2['restore_s'] / 1e9:.3f} GB/s)")
    rd, outd, _ = train_with_checkpoints(
        "checkpoint draft", draft + ["--ckpt-dir", draft_dir], device)
    assert "CHECKPOINT_SAVED step=2" in outd
    return dict(target=target, draft=draft_dir, layers=layers,
                params_bytes=params, step_bytes=ck2["ckpt_bytes"],
                save_s=save_s, restore_s=ck2["restore_s"],
                draft_bytes=rd["checkpoint"]["ckpt_bytes"])


def serve_restored(label: str, argv: list, device: str) -> tuple:
    """The worker's waves with every paged kernel's count set to 0 just
    before; returns (result, args, launches, output)."""
    from kubegpu_tpu_torch.models import worker

    args = worker.build_parser().parse_args(argv + ["--device", device])
    zero_counts()
    r, out = captured(worker.run_decode, args)
    launches = {k: getattr(fn, a) for k, (fn, a) in kernel_counts().items()}
    log(f"{label}: {r['requests']} requests, {r['tokens']} tokens in "
        f"{r['wave_s']:.3f} s -> {r['tokens_per_sec']:.1f} tok/s; first "
        f"wave done {r['first_decode_s']:.1f} s after start (the restore "
        f"included); launches {launches}")
    check_wave(r, args)
    return r, args, launches, out


def phase_ckpt_serve(ck: dict, device: str = "cuda",
                     base: list = FLAGSHIP_ARGV) -> None:
    """Phase 46: phase 45's step 4 served through the worker's
    ``--model decode --serving paged --ckpt-dir`` (``RESTORED_FOR_SERVING
    step=4``): K1 launched decode steps x layers times; the served bf16
    weights are bit for bit a bf16 cast of what phase 45 saved.  Then
    ``--speculate --spec-k 4 --draft-ckpt-dir`` with phase 45's draft
    (``RESTORED_DRAFT_FOR_SERVING``): K2 launched verify steps x layers
    times, K1 never."""
    import os

    import numpy as np
    import torch

    from kubegpu_tpu_torch.models import worker

    argv = base + ["--layers", str(ck["layers"]), "--ckpt-dir", ck["target"]]
    r, args, launches, out = serve_restored("restored flagship", argv, device)
    assert "RESTORED_FOR_SERVING step=4" in out, out[-2000:]
    kernels = device == "cuda"
    assert launches["K1"] == r["decode_steps_total"] * args.layers * kernels
    assert not any(v for k, v in launches.items() if k != "K1"), launches
    t0 = time.monotonic()
    params, _, dtype = worker.serving_params(args, device, announce=False)
    restore_s = time.monotonic() - t0
    n = 0
    with np.load(os.path.join(ck["target"], "lm", "4", "state.npz")) as z:
        for path, got in _leaves_by_path(params):
            want = torch.from_numpy(z[f"params/{path}"]).to(device).to(dtype)
            assert got.dtype == dtype and torch.equal(got, want), path
            n += 1
    log(f"restored flagship: K1 launches {launches['K1']} = decode steps "
        f"{r['decode_steps_total']} x layers {args.layers}; the {n} served "
        f"{str(dtype).replace('torch.', '')} leaves equal the bf16 cast of "
        f"the saved float32 bit for bit; the serving restore (parameters "
        f"only, {ck['params_bytes']} B read) took {restore_s:.3f} s")
    del params
    spec = argv + ["--speculate", "--spec-k", str(SPEC_K),
                   "--draft-ckpt-dir", ck["draft"]]
    r, args, launches, out = serve_restored("restored speculative flagship",
                                            spec, device)
    assert "RESTORED_DRAFT_FOR_SERVING" in out
    assert "RESTORED_FOR_SERVING step=4" in out
    assert launches["K2"] == r["spec_steps_total"] * args.layers * kernels
    assert not any(v for k, v in launches.items() if k != "K2"), launches
    assert r["spec_tokens"] == r["tokens"]
    log(f"restored speculative flagship: k={SPEC_K}, timed wave "
        f"{r['spec_steps']} verify steps for {r['spec_tokens']} tokens = "
        f"{r['spec_tokens'] / r['spec_steps']:.3f} tokens a verify (the "
        f"trained draft); K2 launches {launches['K2']} = verify steps "
        f"{r['spec_steps_total']} x layers {args.layers}")


def _leaves_by_path(tree: dict, prefix: str = ""):
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            yield from _leaves_by_path(v, path)
        else:
            yield path, v


def _tree_diff(got: dict, want: dict) -> float:
    """The largest difference between two trees of tensors."""
    fg, fw = dict(_leaves_by_path(got)), dict(_leaves_by_path(want))
    assert fg.keys() == fw.keys()
    return max(float((fg[k].detach().cpu().double()
                      - fw[k].detach().cpu().double()).abs().max())
               for k in fw)


def phase_ckpt_resume(root: str, device: str = "cuda",
                      cfg: dict = TRAIN_SMALL) -> None:
    """Phase 47 at one device: phase 10's small float32 model (flash
    attention: K3, K4, K5) trained "2 steps, save, restore into fresh
    weights, 2 steps" against "4 steps", SGD and Adam: losses, weights and
    optimizer state equal (the largest difference printed, 0 when the
    bits are equal), within 1e-6."""
    import os

    import numpy as np
    import torch

    from kubegpu_tpu_torch.models.checkpoint import (
        make_manager,
        restore_checkpoint,
        save_checkpoint,
    )
    from kubegpu_tpu_torch.models.params import init_params, tree_map
    from kubegpu_tpu_torch.models.train import (
        adam,
        create_train_state,
        gather_state,
        lm_step,
        sgd,
    )
    from kubegpu_tpu_torch.models.transformer import TransformerLM

    widths = {k: v for k, v in cfg.items() if k != "num_heads"}
    seq = cfg["max_seq"] - 1
    rng = np.random.RandomState(1)
    data = [torch.from_numpy(rng.randint(0, cfg["vocab_size"],
                                         size=(4, seq + 1)).astype(np.int32))
            .to(device) for _ in range(4)]

    def state_of(seed, optimizer):
        tree = init_params(widths, torch.Generator().manual_seed(seed),
                           torch.float32, "cpu")
        model = TransformerLM(dtype=torch.float32, attn_impl="flash", **cfg)
        return create_train_state(model, tree_map(lambda t: t.to(device),
                                                  tree), optimizer=optimizer)

    for optimizer in (sgd(), adam(lr=1e-3)):
        straight = state_of(6, optimizer)
        want = [lm_step(straight, t).item() for t in data]
        state = state_of(6, optimizer)
        got = [lm_step(state, t).item() for t in data[:2]]
        mgr = make_manager(os.path.join(root, f"resume-{optimizer.name}"))
        save_checkpoint(mgr, state)
        fresh = state_of(7, optimizer)
        restore_checkpoint(mgr, fresh)
        got += [lm_step(fresh, t).item() for t in data[2:]]
        np.testing.assert_allclose(got, want, rtol=RESUME_TOL,
                                   atol=RESUME_TOL)
        wp, wo = gather_state(straight)
        gp, go = gather_state(fresh)
        p_diff, o_diff = _tree_diff(gp, wp), _tree_diff(go, wo)
        assert p_diff <= RESUME_TOL and o_diff <= RESUME_TOL
        log(f"resume fp32 one device {optimizer.name}: losses equal "
            f"{got == want}, largest weight difference {p_diff}, optimizer "
            f"state {o_diff} (0: the same bits) against 4 uninterrupted "
            "steps")


def phase_ckpt_gang(gang, root: str, device: str = "cuda",
                    cfg: dict = TRAIN_SMALL) -> None:
    """Phase 47 over the mesh, in phases 42-44's dp 2 x tp 2 gang: the
    same model "2 steps, save, restore, 2 steps" against "4 steps" on
    the mesh (SGD), equal within 1e-6 (the largest difference printed);
    the gang's step 2 restores onto one device with every leaf the saved
    bits, and one device trains on from it within 1e-4 of the gang."""
    import os

    import numpy as np
    import torch

    from kubegpu_tpu_torch.models.checkpoint import (
        make_manager,
        restore_checkpoint,
    )
    from kubegpu_tpu_torch.models.params import init_params, tree_map
    from kubegpu_tpu_torch.models.train import (
        create_train_state,
        gather_state,
        lm_step,
    )
    from kubegpu_tpu_torch.models.transformer import TransformerLM

    cases = tp_cases()
    widths = {k: v for k, v in cfg.items() if k != "num_heads"}

    def init(seed):
        return init_params(widths, torch.Generator().manual_seed(seed),
                           torch.float32, "cpu")

    seq = cfg["max_seq"] - 1
    rng = np.random.RandomState(1)
    tokens = [rng.randint(0, cfg["vocab_size"], size=(4, seq + 1))
              .astype(np.int32) for _ in range(4)]
    d = os.path.join(root, "gang")
    got = gang.run(cases.train_save_resume, dict(
        params=_np_tree(init(6)), fresh=_np_tree(init(7)), cfg=cfg,
        model=dict(attn_impl="flash", sequence_parallel=True),
        tokens=tokens, save_after=2, dir=d))
    straight, resumed = got["straight"], got["resumed"]
    np.testing.assert_allclose(resumed["losses"], straight["losses"],
                               rtol=RESUME_TOL, atol=RESUME_TOL)
    p_diff = tree_close("gang resume param", resumed["params"],
                        straight["params"], RESUME_TOL)
    o_diff = tree_close("gang resume trace", resumed["opt_state"]["trace"],
                        straight["opt_state"]["trace"], RESUME_TOL)
    model = TransformerLM(dtype=torch.float32, attn_impl="flash", **cfg)
    state = create_train_state(model, tree_map(lambda t: t.to(device),
                                               init(8)))
    restore_checkpoint(make_manager(d), state)
    whole, opt = gather_state(state)
    with np.load(os.path.join(d, "2", "state.npz")) as z:
        for path, t in _leaves_by_path(whole):
            assert np.array_equal(t.cpu().numpy(), z[f"params/{path}"]), path
        for path, t in _leaves_by_path(opt):
            assert np.array_equal(t.cpu().numpy(),
                                  z[f"opt_state/{path}"]), path
    losses = [lm_step(state, torch.from_numpy(t).to(device)).item()
              for t in tokens[2:]]
    np.testing.assert_allclose(losses, resumed["losses"][2:], rtol=TRAIN_TOL,
                               atol=TRAIN_TOL)
    log(f"resume fp32 dp 2 x tp 2 (gloo on one card): losses equal "
        f"{resumed['losses'] == straight['losses']}, largest weight "
        f"difference {p_diff}, momentum {o_diff} (0: the same bits); the "
        f"gang's step 2 restored onto one device bit for bit, and its two "
        f"steps on {losses} against the gang's {resumed['losses'][2:]}")


# -- context-parallel training (phases 48-51) --------------------------------

CP = 2
# one ring block of the flagship at cp 2: b 1, 8192 / 2 rows, 32 heads of 128
CP_BLOCK = (1, 8192 // CP, 32, 128)
# phase 10's small model, with room for the einsum body's 2 x 136 rows
CP_SMALL = dict(TRAIN_SMALL, max_seq=273)
# 64 rows a rank at cp 2, which ring_block_sizes tiles (the flash body),
# and 136, which it does not (the einsum body)
CP_SMALL_SEQS = dict(flash=128, einsum=272)
CP_FLAGSHIP = dict(vocab_size=32768, num_layers=4, num_heads=32,
                   hidden=4096, max_seq=8193)
# one step of each attention; the steady step is the one timed in parts
# after it
CP_FLAGSHIP_RUN = dict(seq=8192, batch=1, steps=1)
# samples/jax-lm-cp.yaml's argv at --cp 1 and 2 steps, at the worker's
# default widths; --batch-per-chip 8 holds the sample's tokens a chip
# (its default 32 rows x 8192 / 4)
CP_SAMPLE_ARGV = ["--model", "lm-cp", "--cp", "1", "--seq", "8192",
                  "--attn-impl", "ring", "--steps", "2",
                  "--batch-per-chip", "8"]


def cp_cases():
    """The rank bodies the port's context-parallel tests share
    (``tests/torch_cp_cases.py``)."""
    tp_cases()   # puts tests/ on the path
    import torch_cp_cases

    return torch_cp_cases


def cp_gang(axes: dict, tmp: str, device: str):
    """The ranks of a mesh of ``axes`` on the one card over gloo: the
    ring's hops, the all-to-alls and ZeRO-1's reduce-scatters are staged
    through pinned host buffers, the other collectives through gloo's
    own host copies."""
    import math

    from kubegpu_tpu_torch.parallel.launch import Gang

    tp_cases()   # tests/ on the path before the ranks inherit it
    dev = "cuda:0" if device == "cuda" else device
    return Gang(axes, tmp, backend="gloo",
                devices=[dev] * math.prod(axes.values()), timeout_s=900.0)


def phase_cp_kernels() -> dict:
    """Phase 48: K3 unmasked and causal, K4, K5 and the delta pre-pass at
    one ring block of the flagship at cp 2 (b 1, 4096 rows, 32 heads of
    128, bf16) against their plain twins under phase 8's gates; then K4
    and K5 on both blocks from the global (out, lse) the two fold into,
    which neither block's K3 computed; each kernel's graph-replay time,
    bound, plain time and SDPA's time, unmasked and causal."""
    import torch

    from kubegpu_tpu_torch.ops.attention import (
        _fold,
        flash_backward_delta,
        flash_backward_dkdv,
        flash_backward_dq,
        flash_forward,
    )

    g = torch.Generator(device="cuda").manual_seed(9)
    b, s, h, d = CP_BLOCK
    q, k, v, dout = flash_inputs(b, s, s, h, d, torch.bfloat16, g)
    k0, v0 = (torch.randn(k.shape, generator=g, device="cuda")
              .to(torch.bfloat16) for _ in range(2))
    rec: dict = {}
    for causal in (False, True):
        errs = check_flash(q, k0 if not causal else k,
                           v0 if not causal else v, dout, causal)
        got: dict = {}
        time_flash(q, k0 if not causal else k, v0 if not causal else v,
                   dout, errs, got, causal)
        for kname, by_dtype in got.items():
            rec.setdefault(kname, {})["causal" if causal else "unmasked"] = (
                by_dtype["bfloat16"])
    # the ring's fold: an earlier rank's block (unmasked), then the
    # diagonal; K4 and K5 read the global out and lse
    o = torch.zeros(q.shape, device="cuda")
    lse = torch.full((b, h, s), float("-inf"), device="cuda")
    for kb, vb, causal in ((k0, v0, False), (k, v, True)):
        o_blk, lse_blk = flash_forward(q, kb, vb, causal)
        o, lse = _fold(o, lse, o_blk.float(), lse_blk)
    out = o.to(torch.bfloat16)
    delta = flash_backward_delta(out, dout)
    for kb, vb, causal in ((k0, v0, False), (k, v, True)):
        dk, dv = flash_backward_dkdv(q, kb, vb, out, lse, dout, causal,
                                     delta)
        dq = flash_backward_dq(q, kb, vb, out, lse, dout, causal, delta)
        gate = bf16_gradient_errs((dq, dk, dv), q, kb, vb, out, lse, dout,
                                  causal)
        log(f"ring block causal={causal} from the global lse: "
            + ", ".join(f"{n} {e:.3e} ({sh:.3f} of allowance)"
                        for n, (e, sh, _) in gate.items()))
    del q, k, v, dout, k0, v0, o, out
    torch.cuda.empty_cache()
    return rec


def cp_want_launches(impl: str, seq_coord: int, layers: int, steps: int,
                     remat: bool, bf16: bool, flash_body: bool = True) -> dict:
    """Each rank's launches, causal: the ring's flash body runs K3, K4 and
    K5 (r + 1) times a layer at "seq" coordinate r (K3 twice with remat),
    Ulysses once, the einsum body never; the bf16 pre-pass once a layer."""
    if impl == "ring" and not flash_body:
        n = 0
    else:
        n = layers * steps * (seq_coord + 1 if impl == "ring" else 1)
    return dict(flash_forward=n * (1 + remat), flash_backward_dkdv=n,
                flash_backward_dq=n,
                flash_backward_delta=layers * steps if bf16 and n else 0)


def shared_gang(gang, axes: dict, device: str, prefix: str):
    """``gang`` as it is (its owner closes it), else a new ``cp_gang`` of
    ``axes`` closed after the ``with``."""
    if gang is not None:
        return contextlib.nullcontext(gang)
    return cp_gang(axes, tempfile.mkdtemp(prefix=prefix), device)


def phase_cp_small(device: str = "cuda", cfg: dict = CP_SMALL,
                   seqs: dict = CP_SMALL_SEQS, gangs=(None, None)) -> None:
    """Phase 49: phase 10's small float32 model in gloo gangs on the card
    at cp 2 (two ranks) and dp 2 x cp 2 (four; ``gangs`` of two and four
    ranks, else its own): ring through its flash
    body, ring through its einsum body (136 rows a rank), Ulysses, and
    ring with remat: one step's loss and every gradient leaf within
    rtol=atol 1e-4 of the card's one-device flash step on the same
    global batch, and each rank's K3, K4 and K5 launches."""
    import tempfile

    import numpy as np
    import torch

    from kubegpu_tpu_torch.models.params import init_params, tree_map
    from kubegpu_tpu_torch.models.train import (
        create_train_state,
        grad_tree,
        lm_grads,
    )
    from kubegpu_tpu_torch.models.transformer import TransformerLM

    cases = cp_cases()
    params = init_params(cfg, torch.Generator().manual_seed(6),
                         torch.float32, "cpu")
    np_params = _np_tree(params)
    rng = np.random.RandomState(1)
    batches = {body: rng.randint(0, cfg["vocab_size"], size=(4, seq + 1))
               .astype(np.int32) for body, seq in seqs.items()}
    ref = {}
    for body, tokens in batches.items():
        model = TransformerLM(dtype=torch.float32, attn_impl="flash", **cfg)
        state = create_train_state(
            model, tree_map(lambda t: t.to(device).clone(), params))
        loss = lm_grads(state, torch.from_numpy(tokens).to(device))
        ref[body] = (loss.item(), _np_tree(grad_tree(state)))
    runs = (("ring", "flash", False), ("ring", "einsum", False),
            ("ulysses", "flash", False), ("ring", "flash", True))
    layers = cfg["num_layers"]
    for axes, shared in zip(({"data": 1, "seq": CP}, {"data": 2, "seq": CP}),
                            gangs):
        t0 = time.monotonic()
        with shared_gang(shared, axes, device, "chip-smoke-cp-") as gang:
            for impl, body, remat in runs:
                got = gang.run(cases.cp_grads, dict(
                    params=np_params, cfg=cfg, tokens=[batches[body]],
                    axes=axes, model=dict(attn_impl=impl, remat=remat)))
                loss, grads = ref[body]
                np.testing.assert_allclose(got["loss"], loss, rtol=TRAIN_TOL,
                                           atol=TRAIN_TOL)
                worst = tree_close("grad", got["grads"], grads, TRAIN_TOL)
                for rank, launches in enumerate(got["launches"]):
                    want = cp_want_launches(impl, rank % CP, layers, 1,
                                            remat, False, body == "flash")
                    if device != "cuda":
                        want = {k: 0 for k in want}
                    assert launches == want, (axes, impl, body, rank,
                                              launches, want)
                log(f"cp small fp32 {axes} {impl} ({body} body, "
                    f"{batches[body].shape[1] - 1} rows, remat={remat}): "
                    f"loss {got['loss']:.6f} against one device "
                    f"{loss:.6f}, worst gradient diff {worst:.3e}; "
                    f"launches by rank {got['launches']}")
        log(f"cp small gang {axes}: {time.monotonic() - t0:.1f} s")


def flagship_first_loss(cfg: dict, run: dict, device: str) -> float:
    """One device's loss (bf16 compute, flash attention, weights from seed
    0 drawn on ``device``) on the first ``synthetic_token_batches`` batch
    of shard 0 at ``run``'s batch and seq: the first loss of a gang whose
    single data shard draws the same rows; the model is freed after."""
    import torch

    from kubegpu_tpu_torch.models.data import synthetic_token_batches
    from kubegpu_tpu_torch.models.params import init_params
    from kubegpu_tpu_torch.models.train import create_train_state, lm_loss
    from kubegpu_tpu_torch.models.transformer import TransformerLM

    tokens = next(synthetic_token_batches(run["batch"], run["seq"] + 1,
                                          cfg["vocab_size"], shard=0))
    model = TransformerLM(dtype=torch.bfloat16, attn_impl="flash", **cfg)
    gen = torch.Generator(device=device).manual_seed(0)
    state = create_train_state(model, init_params(cfg, gen, torch.float32,
                                                  device))
    with torch.no_grad():
        ref = lm_loss(state.model, torch.from_numpy(tokens).to(device)).item()
    del state, model
    if device == "cuda":
        torch.cuda.empty_cache()
    return ref


def phase_cp_flagship(device: str = "cuda", cfg: dict = CP_FLAGSHIP,
                      run: dict = CP_FLAGSHIP_RUN, gang=None) -> dict:
    """Phase 50: the flagship at full width (bf16 compute over float32
    weights) at cp 2 in a two-rank gloo gang on the card, seq 8192,
    batch 1: one step with ring attention, then one with Ulysses, on
    ``synthetic_token_batches_for_mesh``: finite losses, the first within
    1e-2 of the card's one-device loss on the same tokens (computed
    before the gang starts, then freed), each rank's launches as
    ``cp_want_launches`` says; each rank's peak memory, seconds a step,
    bytes sent along "seq" a step and (ring) one more step's parts."""
    import math
    import tempfile

    import torch

    cases = cp_cases()
    seq, batch, steps = run["seq"], run["batch"], run["steps"]
    ref = flagship_first_loss(cfg, run, device)
    layers = cfg["num_layers"]
    out = {}
    axes = {"data": 1, "seq": CP}
    with shared_gang(gang, axes, device, "chip-smoke-cp-flagship-") as gang:
        for impl in ("ring", "ulysses"):
            t0 = time.monotonic()
            every = gang.run(cases.cp_flagship, dict(
                params=dict(init=cfg, seed=0, dtype=torch.float32), cfg=cfg,
                dtype=torch.bfloat16, batch=batch, seq=seq, steps=steps,
                axes=axes, model=dict(attn_impl=impl),
                parts=impl == "ring"))
            wall = time.monotonic() - t0
            for rank, r in enumerate(every):
                losses = r["losses"]
                assert all(math.isfinite(x) for x in losses), (rank, losses)
                assert abs(losses[0] - ref) <= FLAGSHIP_LOSS_TOL, (
                    impl, rank, losses, ref)
                want = cp_want_launches(impl, r["coords"][1], layers, steps,
                                        False, True)
                if device != "cuda":
                    want = {k: 0 for k in want}
                assert r["launches"] == want, (impl, rank, r["launches"])
                peak = r["peak_bytes"]
                log(f"cp flagship {impl} cp {CP} rank {rank} (data, seq) "
                    f"{r['coords']}: losses {[round(x, 4) for x in losses]} "
                    f"(one device's first {ref:.4f}); seconds a step "
                    f"{[round(x, 3) for x in r['seconds']]}"
                    + (" (a first step, warm-up included)" if steps == 1
                       else "") + " (gloo, "
                    f"host-staged on one card: not a CP speed); bytes sent "
                    f"a step {r['traffic_per_step']}; launches "
                    f"{r['launches']}; peak device memory "
                    + (f"{peak / 2**30:.2f} GiB" if peak is not None else
                       "not measured"))
                parts = r["parts"]
                if parts is not None:
                    log(f"cp flagship {impl} rank {rank}, one more step in "
                        f"parts: forward and backward "
                        f"{parts['forward_backward_s']:.3f} s, sync_grads "
                        f"(flat mean of {parts['grad_bytes']} B over data x "
                        f"seq) {parts['sync_grads_s']:.3f} s, optimizer "
                        f"{parts['optimizer_s']:.3f} s")
            log(f"cp flagship {impl}: {steps} steps of {batch} x {seq} "
                f"tokens, the gang's call {wall:.1f} s")
            out[impl] = every
    return dict(launches={impl: [r["launches"] for r in every]
                          for impl, every in out.items()},
                peak={impl: [r["peak_bytes"] for r in every]
                      for impl, every in out.items()},
                ref=ref)


CP_WORKER_ARGV = ["--model", "lm-cp", "--cp", "2", "--vocab", "512",
                  "--hidden", "256", "--heads", "4", "--layers", "2", "--seq",
                  "128", "--batch-per-chip", "2", "--steps", "3"]


def phase_cp_worker(device: str = "cuda", sample=CP_SAMPLE_ARGV) -> dict:
    """Phase 51: the worker's ``--model lm-cp``: ``--cp 2`` refused on a
    one-card machine ("exceeds the visible device count"), NCCL reported
    as not exercised (with two cards or more, three small steps over
    NCCL); then ``samples/jax-lm-cp.yaml``'s argv at ``--cp 1`` in a
    subprocess: a {"data": 1, "seq": 1} mesh whose ring runs one
    diagonal block, K3, K4, K5 and the pre-pass launched steps x layers
    times."""
    import torch

    n_cards = torch.cuda.device_count() if device == "cuda" else 0
    argv = CP_WORKER_ARGV
    if device == "cuda" and n_cards < 2:
        proc = early_run("cp", argv)
        want = f"exceeds the visible device count {n_cards}"
        assert proc.returncode != 0 and want in proc.stderr, (
            proc.returncode, proc.stderr[-2000:])
        log(f"cp worker: --model lm-cp --cp 2 refused on {n_cards} card(s): "
            f"{want}; context-parallel training over NCCL: not exercised "
            "(one card visible)")
    elif device == "cuda":
        lines = run_worker_lines(argv)
        assert fields(lines["TRAINING_MESH"])["backend"] == "nccl"
        log(f"cp worker over NCCL: {lines['TRAINING_MESH']} / "
            f"{lines['FIRST_STEP_DONE']}")
    t0 = time.monotonic()
    lines = run_worker_lines(sample + (["--device", "cpu"]
                                       if device != "cuda" else []))
    args = {a.lstrip("-"): b for a, b in zip(sample[::2], sample[1::2])}
    mesh = fields(lines["TRAINING_MESH"])
    assert mesh["data"] == "1" and mesh["seq"] == "1", mesh
    steps, layers = int(args["steps"]), int(args.get("layers", 4))
    for key in ("K3_LAUNCHES", "K4_LAUNCHES", "K5_LAUNCHES",
                "DELTA_LAUNCHES"):
        n = int(next(v for k, v in fields(lines[key]).items()
                     if k.startswith("flash_")))
        assert n == (steps * layers if device == "cuda" else 0), lines[key]
    for key in ("TRAINING_MESH", "FIRST_STEP_DONE", "steady_state",
                "K3_LAUNCHES", "K4_LAUNCHES", "K5_LAUNCHES",
                "DELTA_LAUNCHES", "PEAK_MEM_GIB", "CP_BYTES"):
        log(f"cp sample: {lines[key]}")
    log(f"cp sample ({' '.join(sample)}): {time.monotonic() - t0:.1f} s")
    return {k: lines[k] for k in ("FIRST_STEP_DONE", "steady_state",
                                  "PEAK_MEM_GIB")}


# -- data x tensor x context parallelism and ZeRO-1 (phases 66-68) -----------

AXES_3D = {"data": 2, "model": 2, "seq": 2}
# the flagship's 3-D gang: four ranks, tp 2 x cp 2, one data shard
FLAGSHIP_3D_AXES = {"data": 1, "model": 2, "seq": 2}
# ZeRO-1 at the flagship's width: dp 2, adam, b 2 a rank, seq 1024; two
# steps plain, then two with ZeRO-1 from the same weights
ZERO1_RUN = dict(seq=1024, batch=4, steps=2)
ZERO1_AXES = {"data": 2}
# ZeRO-1 against plain data parallelism: every step's loss (the same
# math: the reduce-scatter's sum and the all-reduce's agree on two ranks,
# and adam is elementwise), and each parameter's position-weighted sum
# after the last step, relative to its weighted sum of magnitudes
ZERO1_LOSS_TOL = 1e-4
ZERO1_SUM_TOL = 1e-6


def cases_3d():
    """The rank bodies of the 3-D tests (``tests/torch_3d_cases.py``)."""
    cp_cases()   # puts tests/ on the path
    import torch_3d_cases

    return torch_3d_cases


def zero_cases():
    """The rank bodies of the ZeRO-1 tests (``tests/torch_zero_cases.py``)."""
    tp_cases()   # puts tests/ on the path
    import torch_zero_cases

    return torch_zero_cases


def phase_3d_small(device: str = "cuda", cfg: dict = CP_SMALL,
                   seq: int = CP_SMALL_SEQS["flash"], gang=None) -> dict:
    """Phase 66: phase 49's small float32 model in a gloo gang of eight
    ranks on the card over ``{"data": 2, "model": 2, "seq": 2}``
    (``gang``, else its own), ring
    (flash body) and Ulysses, heads sharded over "model": one step's loss
    and every gradient leaf, gathered whole, within rtol=atol 1e-4 of the
    card's one-device flash step on the same global batch, and each
    rank's K3, K4 and K5 launches as ``cp_want_launches`` gives them by
    its "seq" coordinate; returns them by attention, in rank order."""
    import numpy as np
    import torch

    from kubegpu_tpu_torch.models.params import init_params, tree_map
    from kubegpu_tpu_torch.models.train import (
        create_train_state,
        grad_tree,
        lm_grads,
    )
    from kubegpu_tpu_torch.models.transformer import TransformerLM

    cases = cases_3d()
    params = init_params(cfg, torch.Generator().manual_seed(6),
                         torch.float32, "cpu")
    tokens = np.random.RandomState(3).randint(
        0, cfg["vocab_size"], size=(4, seq + 1)).astype(np.int32)
    model = TransformerLM(dtype=torch.float32, attn_impl="flash", **cfg)
    state = create_train_state(
        model, tree_map(lambda t: t.to(device).clone(), params))
    loss = lm_grads(state, torch.from_numpy(tokens).to(device)).item()
    grads = _np_tree(grad_tree(state))
    del state, model
    layers = cfg["num_layers"]
    t0 = time.monotonic()
    out = {}
    with shared_gang(gang, AXES_3D, device, "chip-smoke-3d-") as gang:
        for impl in ("ring", "ulysses"):
            got = gang.run(cases.grads_3d, dict(
                params=_np_tree(params), cfg=cfg, tokens=[tokens],
                model=dict(attn_impl=impl)))
            np.testing.assert_allclose(got["loss"], loss, rtol=TRAIN_TOL,
                                       atol=TRAIN_TOL)
            worst = tree_close("grad", got["grads"], grads, TRAIN_TOL)
            assert not got["heads_replicated"], impl
            for rank, (launches, coords) in enumerate(
                    zip(got["launches"], got["coords"])):
                want = cp_want_launches(impl, coords[2], layers, 1, False,
                                        False)
                if device != "cuda":
                    want = {k: 0 for k in want}
                assert launches == want, (impl, rank, coords, launches, want)
            log(f"3-D small fp32 {AXES_3D} {impl} (flash body, {seq} rows, "
                f"{cfg['num_heads'] // AXES_3D['model']} heads a rank): loss "
                f"{got['loss']:.6f} against one device {loss:.6f}, worst "
                f"gradient diff {worst:.3e}; launches by rank (data, model, "
                f"seq) {list(zip(got['coords'], got['launches']))}")
            out[impl] = got["launches"]
    log(f"3-D small gang of 8: {time.monotonic() - t0:.1f} s")
    return out


def phase_3d_flagship(ref=None, device: str = "cuda",
                      cfg: dict = CP_FLAGSHIP, run: dict = CP_FLAGSHIP_RUN,
                      axes: dict = FLAGSHIP_3D_AXES, gang=None) -> dict:
    """Phase 67: the flagship at full width (bf16 compute over float32
    weights) over ``{"data": 1, "model": 2, "seq": 2}`` in a four-rank
    gloo gang on the card (``gang``'s world laid out so, else its own),
    seq 8192, batch 1: one step with ring
    attention, then one with Ulysses, each rank holding its tp 2 shards
    and 16 of the 32 heads: finite losses, the first within
    ``FLAGSHIP_LOSS_TOL`` of one device's on the same tokens (``ref``,
    phase 50's, else computed here), each rank's K3/K4/K5 and pre-pass
    launches as ``cp_want_launches`` says; each rank's peak memory,
    seconds a step (host-staged gloo: not a speed) and bytes sent along
    "seq"."""
    import math
    import tempfile

    import torch

    cases = cp_cases()
    seq, batch, steps = run["seq"], run["batch"], run["steps"]
    if ref is None:
        ref = flagship_first_loss(cfg, run, device)
    layers = cfg["num_layers"]
    out = {}
    with shared_gang(gang, axes, device, "chip-smoke-3d-flagship-") as gang:
        for impl in ("ring", "ulysses"):
            t0 = time.monotonic()
            every = gang.run(cases.cp_flagship, dict(
                params=dict(init=cfg, seed=0, dtype=torch.float32), cfg=cfg,
                dtype=torch.bfloat16, batch=batch, seq=seq, steps=steps,
                axes=axes, model=dict(attn_impl=impl), parts=False))
            wall = time.monotonic() - t0
            for rank, r in enumerate(every):
                losses = r["losses"]
                assert all(math.isfinite(x) for x in losses), (rank, losses)
                assert abs(losses[0] - ref) <= FLAGSHIP_LOSS_TOL, (
                    impl, rank, losses, ref)
                want = cp_want_launches(impl, r["coords"][1], layers, steps,
                                        False, True)
                if device != "cuda":
                    want = {k: 0 for k in want}
                assert r["launches"] == want, (impl, rank, r["launches"])
                peak = r["peak_bytes"]
                log(f"3-D flagship {impl} {axes} rank {rank} (data, seq) "
                    f"{r['coords']}: losses {[round(x, 4) for x in losses]} "
                    f"(one device's first {ref:.4f}); seconds a step "
                    f"{[round(x, 3) for x in r['seconds']]} (a first step, "
                    "warm-up included; gloo, host-staged on one card: not a "
                    f"speed); bytes sent a step {r['traffic_per_step']}; "
                    f"launches {r['launches']}; peak device memory "
                    + (f"{peak / 2**30:.2f} GiB" if peak is not None else
                       "not measured"))
            log(f"3-D flagship {impl}: {steps} step(s) of {batch} x {seq} "
                f"tokens over {axes}, the gang's call {wall:.1f} s")
            out[impl] = every
    return dict(launches={impl: [r["launches"] for r in every]
                          for impl, every in out.items()},
                peak={impl: [r["peak_bytes"] for r in every]
                      for impl, every in out.items()})


def phase_zero1_flagship(device: str = "cuda", cfg: dict = TRAIN_FLAGSHIP,
                         run: dict = ZERO1_RUN, axes: dict = ZERO1_AXES,
                         gang=None) -> dict:
    """Phase 68: ZeRO-1 at the flagship's full width (bf16 compute over
    float32 weights, flash attention, adam) at dp 2 in a two-rank gloo
    gang on the card (``gang``'s world laid out as ``{"data": 2}``, else
    its own), seq 1024, b 2 a rank: two steps with the moments
    replicated (plain data parallelism), then two with ZeRO-1, from the
    same weights on the same batches: finite losses, every step's equal
    between the two runs within ``ZERO1_LOSS_TOL`` (the second reads the
    first update: the host-staged reduce-scatter, the sliced adam step
    and the all-gather), and each parameter's checksum after the last
    update (``torch_zero_cases.param_sums``) within ``ZERO1_SUM_TOL``
    of the plain run's, relative; every parameter cut over "data",
    so each rank's moment bytes (``state_bytes_per_device``, and the
    tensors its optimizer really holds) are half the plain run's but
    Adam's count; K3/K4/K5 and the pre-pass launched steps x layers times
    a rank; each rank's peak device memory, seconds a step (host-staged
    gloo: not a speed) and bytes staged through the host."""
    import math

    import torch

    from kubegpu_tpu_torch.models.train import adam

    cases = zero_cases()
    layers = cfg["num_layers"]
    res = {}
    with shared_gang(gang, axes, device, "chip-smoke-zero1-") as gang:
        for zero1 in (False, True):
            t0 = time.monotonic()
            every = gang.run(cases.zero1_flagship, dict(
                params=dict(init=cfg, seed=0, dtype=torch.float32), cfg=cfg,
                axes=axes, dtype=torch.bfloat16, optimizer=adam(),
                zero1=zero1,
                model=dict(attn_impl="flash"), batch=run["batch"],
                seq=run["seq"],
                steps=run["steps"]))
            label = "ZeRO-1" if zero1 else "plain"
            for rank, r in enumerate(every):
                assert all(math.isfinite(x) for x in r["losses"]), r
                want = {k: layers * run["steps"] for k in
                        ("flash_forward", "flash_backward_dkdv",
                         "flash_backward_dq", "flash_backward_delta")}
                if device != "cuda":
                    want = {k: 0 for k in want}
                assert r["launches"] == want, (label, rank, r["launches"])
                # the optimizer's tensors are what the reckoning says
                assert r["held_opt"] == r["bytes"][1] - 4, r
                peak = r["peak_bytes"]
                log(f"zero1 flagship {label} rank {rank}: losses "
                    f"{[round(x, 4) for x in r['losses']]}; "
                    f"state_bytes_per_device (params, opt) {r['bytes']}; "
                    f"parameters cut over data {r['cut']}; seconds a step "
                    f"{[round(x, 3) for x in r['seconds']]} (gloo, "
                    "host-staged on one card: not a speed); staged through "
                    f"the host a step {r['staged_per_step']} B; launches "
                    f"{r['launches']}; peak device memory "
                    + (f"{peak / 2**30:.2f} GiB ({peak} B)"
                       if peak is not None else "not measured"))
            log(f"zero1 flagship {label}: the gang's call "
                f"{time.monotonic() - t0:.1f} s")
            res[zero1] = every
    plain, zero = res[False], res[True]
    worst_loss = worst_sum = 0.0
    for rank, (p, z) in enumerate(zip(plain, zero)):
        assert len(p["losses"]) == len(z["losses"]) == run["steps"]
        worst_loss = max([worst_loss] + [
            abs(a - b) for a, b in zip(p["losses"], z["losses"])])
        assert [n for n, _, _ in p["sums"]] == [n for n, _, _ in z["sums"]]
        for (name, ps, pa), (_, zs, _) in zip(p["sums"], z["sums"]):
            rel = abs(ps - zs) / pa
            assert rel <= ZERO1_SUM_TOL, (rank, name, ps, zs, pa)
            worst_sum = max(worst_sum, rel)
    assert worst_loss <= ZERO1_LOSS_TOL, (plain[0]["losses"],
                                          zero[0]["losses"])
    log(f"zero1 flagship against plain: worst loss diff over "
        f"{run['steps']} steps and both ranks {worst_loss:.3e} (gate "
        f"{ZERO1_LOSS_TOL}); worst parameter checksum diff after the last "
        f"update {worst_sum:.3e} of its weighted magnitude (gate "
        f"{ZERO1_SUM_TOL})")
    n_params = sum(p.numel() for p in _lm_shapes(cfg))
    for p, z in zip(plain, zero):
        assert p["bytes"][1] == 8 * n_params + 4, p["bytes"]
        assert z["bytes"][1] == 4 * n_params + 4, z["bytes"]
        assert z["bytes"][0] == p["bytes"][0] == 4 * n_params
        assert z["cut"] == len(_lm_shapes(cfg)), z["cut"]
    drops = [None if p["peak_bytes"] is None else
             p["peak_bytes"] - z["peak_bytes"] for p, z in zip(plain, zero)]
    log(f"zero1 flagship: {n_params} parameters; moments a rank "
        f"{plain[0]['bytes'][1] - 4} B plain, {zero[0]['bytes'][1] - 4} B "
        f"ZeRO-1; peak drop a rank "
        + ", ".join("not measured" if d is None else
                    f"{d / 2**30:.2f} GiB ({d} B)" for d in drops))
    return dict(launches={label: [r["launches"] for r in every]
                          for label, every in (("plain", plain),
                                               ("zero1", zero))},
                peak_drop=drops, worst_loss_diff=worst_loss,
                worst_sum_diff=worst_sum)


def _lm_shapes(cfg: dict) -> list:
    """The LM's parameters at ``cfg``, on the meta device."""
    import torch

    from kubegpu_tpu_torch.models.transformer import TransformerLM

    return list(TransformerLM(dtype=torch.float32, **cfg).parameters())


# -- ResNet data-parallel training (phases 52-56) -----------------------------

RESNET_TINY = dict(layout="unrolled", stage_sizes=(1, 1, 1, 1), num_filters=8,
                   num_classes=10, dtype="float32")
RESNET50 = dict(layout="scan", stage_sizes=(3, 4, 6, 3), num_filters=64,
                num_classes=1000, dtype="bfloat16")
# samples/jax-resnet.yaml's worker command (no --model: the default) at
# 15 of its 100 steps: the smoke's time limit
RESNET_SAMPLE_ARGV = ["--steps", "15"]
# NVIDIA's data sheet, H100 SXM, dense bf16
BF16_PEAK_FLOPS = 989e12
RESNET_STATS_TOL = 1e-5


def resnet_cases():
    """The rank bodies the port's ResNet tests share
    (``tests/torch_resnet_cases.py``)."""
    tp_cases()   # puts tests/ on the path
    import torch_resnet_cases

    return torch_resnet_cases


def resnet_tree(cfg: dict, seed: int) -> tuple:
    """Fresh float32 ``(params, batch_stats)`` of ``cfg`` as numpy."""
    import torch

    from kubegpu_tpu_torch.models.params import init_resnet_params

    cases = resnet_cases()
    params, stats = init_resnet_params(
        cases.make_model(cfg), torch.Generator().manual_seed(seed), "cpu")
    return cases.numpy_tree(params), cases.numpy_tree(stats)


def resnet_batches(size: int, batch: int, steps: int = 3,
                   classes: int = 10) -> tuple:
    import numpy as np

    rng = np.random.default_rng(size)
    return (rng.standard_normal((steps, batch, size, size, 3),
                                dtype=np.float32),
            rng.integers(0, classes, (steps, batch), dtype=np.int32))


def phase_resnet_card_vs_cpu(device: str = "cuda") -> None:
    """Phase 52: ``resnet-tiny`` at float32, card against CPU (TF32 off
    inside ``torch_resnet_cases.train`` and restored after), 3 carried
    SGD steps at 32 and 37 px."""
    import numpy as np

    cases = resnet_cases()
    params, stats = resnet_tree(RESNET_TINY, seed=3)
    for size in (32, 37):
        images, labels = resnet_batches(size, 8)
        cpu = cases.train(None, RESNET_TINY, params, stats, images, labels,
                          device="cpu")
        card = cases.train(None, RESNET_TINY, params, stats, images, labels,
                           device=device)
        np.testing.assert_allclose(card["losses"], cpu["losses"],
                                   rtol=TRAIN_TOL, atol=0)
        grads = tree_close(f"resnet-tiny {size}px gradients", card["grads"],
                           cpu["grads"], TRAIN_TOL)
        stats1 = tree_close(f"resnet-tiny {size}px batch_stats",
                            card["stats1"], cpu["stats1"], RESNET_STATS_TOL)
        log(f"resnet-tiny fp32 {size}px card vs cpu: losses "
            f"{[round(x, 6) for x in card['losses']]}, diffs "
            f"{np.abs(np.subtract(card['losses'], cpu['losses'])).tolist()}"
            f"; worst step-1 gradient diff {grads:.3e}, batch_stats "
            f"{stats1:.3e}")


def read_worker(argv: list, timeout: float = 600) -> tuple:
    """The worker's entry point in a subprocess: ``(lines by first word,
    seconds from the spawn to the FIRST_STEP_DONE line)``; killed on a
    timeout."""
    import os
    import threading

    cmd = [sys.executable, "-m", "kubegpu_tpu_torch.models.worker", *argv]
    t0 = time.monotonic()
    proc = subprocess.Popen(cmd, cwd=os.path.dirname(os.path.abspath(
        __file__)), stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    watchdog = threading.Timer(timeout, proc.kill)
    watchdog.start()
    lines, out, first_at = {}, [], None
    try:
        for line in proc.stdout:
            out.append(line)
            if line.startswith("FIRST_STEP_DONE") and first_at is None:
                first_at = time.monotonic() - t0
            if line.strip():
                lines.setdefault(line.split()[0], line.strip())
        proc.wait()
    finally:
        watchdog.cancel()
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode == 0, "".join(out)[-3000:]
    return lines, first_at


def phase_resnet_sample(device: str = "cuda",
                        argv=RESNET_SAMPLE_ARGV) -> dict:
    """Phase 53: ``samples/jax-resnet.yaml``'s command through the port's
    worker in a subprocess, at its defaults."""
    import torch

    zero_counts()
    lines, spawn_s = read_worker(
        argv + (["--device", "cpu"] if device != "cuda" else []))
    assert_no_kernel("resnet sample (this process)")
    first = fields(lines["FIRST_STEP_DONE"])
    steady = fields(lines["steady_state"])
    launches = fields(lines["KERNEL_LAUNCHES"])
    model = argv[argv.index("--model") + 1] if "--model" in argv else \
        "resnet50"
    assert launches.pop("model") == model, lines["KERNEL_LAUNCHES"]
    launches.pop("device")
    assert set(launches.values()) == {"0"}, launches
    peak = lines["PEAK_MEM_GIB"].split()[1]
    log(f"resnet sample ({' '.join(argv)}: {model} at the worker's "
        f"defaults): FIRST_STEP_DONE {first['seconds']} s after the worker's "
        f"start ({spawn_s:.2f} s after the spawn), first loss "
        f"{first['loss']}; steady {steady['images_per_sec']} images/s, "
        f"loss {steady['loss']}; peak device memory {peak} GiB; worker "
        f"kernel launches {launches}; cuDNN autotuning "
        f"{'on' if torch.backends.cudnn.benchmark else 'off'} "
        "(PyTorch's default; the worker sets nothing, so no first step "
        "waits on an algorithm search)")
    window = resnet_window(argv) if device == "cuda" else None
    return dict(first_s=float(first["seconds"]), spawn_s=spawn_s,
                images_per_sec=float(steady["images_per_sec"]),
                peak_gib=None if peak == "not" else float(peak),
                window=window)


def resnet_window(argv: list, steps: int = 40, split: int = 20,
                  profiled: int = 5) -> dict:
    """Phase 53's model and batches (the worker's builder on ``argv``)
    stepped ``steps`` times in this process on the card, with no sync
    between steps but the first, as the worker's ``_train`` steps them:
    images/s on the device's clock (CUDA events at each step's end) over
    steps 2..``split``, ``split``+1..``steps`` and 2..``steps``; then
    ``profiled`` more steps under the profiler (the card's activity
    only, so the host is not slowed): the device's busy ms a step (its
    kernels' and copies' device time) against a step of 2..``steps``,
    and so its idle share."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from kubegpu_tpu_torch.models import worker
    from kubegpu_tpu_torch.models.train import resnet_step

    args = worker.build_parser().parse_args(argv)
    state, next_batch = worker.build_resnet_trainer(args)
    rows = max(args.batch_per_chip, 1)
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(steps)]
    losses = []
    for i in range(steps):
        losses.append(resnet_step(state, *next_batch()))
        ends[i].record()
        if i == 0:
            float(losses[0])  # the worker waits for its first step
    losses = torch.stack(losses).tolist()
    out = {}
    for a, b in ((1, split), (split, steps), (1, steps)):
        span = ends[a - 1].elapsed_time(ends[b - 1])
        out[f"{a + 1}-{b}"] = dict(images_per_sec=rows * (b - a) / span * 1e3,
                                   loss=losses[b - 1])
    step_ms = rows / out[f"2-{steps}"]["images_per_sec"] * 1e3
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(profiled):
            loss = resnet_step(state, *next_batch())
        float(loss)
    busy = sum(getattr(ev, "self_device_time_total", None)
               or getattr(ev, "self_cuda_time_total", 0)
               for ev in prof.key_averages()) / 1e3 / profiled
    out["profile"] = dict(step_ms=step_ms, busy_ms=busy,
                          idle=1 - busy / step_ms)
    log(f"resnet sample's window (its model and batches, {steps} steps in "
        f"this process, no sync between them; {rows} images a step): "
        + "; ".join(f"steps {k}: {v['images_per_sec']:.1f} images/s on the "
                    f"device's clock, loss {v['loss']:.4f}"
                    for k, v in out.items() if k != "profile")
        + f"; {profiled} more steps profiled: the device busy {busy:.2f} ms "
        f"a step of {step_ms:.2f} (idle {out['profile']['idle'] * 100:.1f}%"
        ")")
    del state
    torch.cuda.empty_cache()
    return out


def resnet_breakdown(prof) -> dict:
    """Device time (ms) of a profile by operation: convolutions,
    BatchNorm/ReLU/elementwise passes, casts and copies, pooling, the
    head's matmul, the optimizer's foreach passes."""
    cats = dict(conv=0.0, bn_relu_elementwise=0.0, cast_copy=0.0, pool=0.0,
                head_matmul=0.0, optimizer=0.0)
    for ev in prof.key_averages():
        if not ev.key.startswith("aten::"):
            continue
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = getattr(ev, "self_cuda_time_total", 0)
        name = ev.key
        if "conv" in name:
            cat = "conv"
        elif "_foreach" in name:
            cat = "optimizer"
        elif "copy_" in name or "_to_copy" in name:
            cat = "cast_copy"
        elif "max_pool" in name:
            cat = "pool"
        elif name in ("aten::mm", "aten::addmm", "aten::bmm"):
            cat = "head_matmul"
        else:
            cat = "bn_relu_elementwise"
        cats[cat] += us / 1e3
    return cats


def phase_resnet_steady(device: str = "cuda", batch: int = 256,
                        size: int = 224, warm: int = 5, timed: int = 15,
                        pool: int = 3, profiled: int = 3,
                        stages=(3, 4, 6, 3)) -> dict:
    """Phase 54: ``bench.py``'s ``steady_state_resnet`` on the port: the
    unrolled ResNet-50 at ``batch`` on a device pool of ``pool``
    synthetic batches; cuDNN autotuning off (the worker's setting), then
    on; a profile of ``profiled`` steps with it off."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from kubegpu_tpu_torch.models.data import (
        device_pool_batches,
        synthetic_image_batches,
    )
    from kubegpu_tpu_torch.models.params import init_resnet_params
    from kubegpu_tpu_torch.models.resnet import ResNet50
    from kubegpu_tpu_torch.models.train import (
        create_train_state,
        resnet_step,
    )

    zero_counts()
    model = ResNet50(num_classes=1000, stage_sizes=stages)
    params, stats = init_resnet_params(
        model, torch.Generator(device=device).manual_seed(0), device)
    state = create_train_state(model, params, batch_stats=stats)
    batches = device_pool_batches(synthetic_image_batches(batch, size=size),
                                  device, pool=pool)
    # torch's flop counter over one image's forward (2 x the MACs of
    # every conv and of the head); a step is 3 forwards of the batch
    counter = FlopCounterMode(display=False)
    with counter, torch.no_grad():
        model(torch.zeros((1, size, size, 3), device=device), train=False)
    step_flops = 3 * counter.get_total_flops() * batch

    def run(n: int) -> tuple:
        if device == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            loss = resnet_step(state, *next(batches))
        value = loss.item()   # forces the chain
        return (time.perf_counter() - t0) / n, value

    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    out = {}
    old = torch.backends.cudnn.benchmark
    try:
        for autotune in (False, True):
            torch.backends.cudnn.benchmark = autotune
            first_s, _ = run(1)
            run(warm - 1)
            dt, loss = run(timed)
            out[autotune] = dict(first_s=first_s, step_s=dt, loss=loss)
            log(f"resnet50-unrolled b{batch} {size}px steady (cuDNN "
                f"autotuning {'on' if autotune else 'off'}): first step "
                f"in this mode {first_s * 1e3:.1f} ms; {dt * 1e3:.2f} ms a "
                f"step over {timed} ({batch / dt:.1f} images/s), "
                f"{flop_str(step_flops)} a step -> "
                f"{step_flops / dt / BF16_PEAK_FLOPS * 100:.1f}% of the "
                f"dense bf16 peak; loss {loss:.4f}")
        torch.backends.cudnn.benchmark = False
        if device == "cuda":
            from torch.profiler import ProfilerActivity, profile

            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                run(profiled)
            wall_ms = (time.perf_counter() - t0) * 1e3 / profiled
            cats = {k: v / profiled for k, v in resnet_breakdown(prof).items()}
            busy = sum(cats.values())
            log(f"resnet50-unrolled b{batch} profile ({profiled} steps, "
                f"autotuning off): {wall_ms:.2f} ms a step profiled, device "
                f"busy {busy:.2f} ms (idle {100 - busy / wall_ms * 100:.1f}%"
                "); by operation, ms a step: " + ", ".join(
                    f"{k} {v:.2f} ({v / busy * 100:.1f}%)"
                    for k, v in sorted(cats.items(), key=lambda kv: -kv[1])))
            out["profile"] = dict(wall_ms=wall_ms, busy_ms=busy, **cats)
            out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
            log(f"resnet50-unrolled b{batch}: peak device memory "
                f"{out['peak_gib']:.2f} GiB")
    finally:
        torch.backends.cudnn.benchmark = old
    assert_no_kernel("resnet steady state")
    out["step_flops"] = step_flops
    return out


def phase_resnet_gang(device: str = "cuda", flagship: dict = RESNET50,
                      rows: int = 32, size: int = 224,
                      steps: int = 3, gang=None) -> dict:
    """Phase 55: resnet-tiny at float32 in a two-rank ``{"data": 2}``
    gang (``gang``, else its own) against one device; ResNet-50 at
    ``rows`` a rank against one device at twice that."""
    import numpy as np

    cases = resnet_cases()
    # a gang of its own boots beside the one-device runs
    with shared_gang(gang, {"data": 2}, device,
                     "chip-smoke-resnet-") as gang:
        gang.start()
        params, stats = resnet_tree(RESNET_TINY, seed=4)
        images, labels = resnet_batches(32, 8)
        one = cases.train(None, RESNET_TINY, params, stats, images,
                          labels, device=device)
        ref = cases.timed_steps(None, flagship, 2 * rows, 1, size,
                                device=device)
        two = gang.run(cases.train, RESNET_TINY, params, stats, images,
                       labels)
        big = gang.run(cases.timed_steps, flagship, rows, steps, size)
    np.testing.assert_allclose(two["losses"], one["losses"], rtol=TRAIN_TOL,
                               atol=TRAIN_TOL)
    grads = tree_close("resnet-tiny dp 2 gradients", two["grads"],
                       one["grads"], TRAIN_TOL)
    stats1 = tree_close("resnet-tiny dp 2 batch_stats", two["stats1"],
                        one["stats1"], TRAIN_TOL)
    log(f"resnet-tiny fp32 dp 2 (gloo on the card) vs one device: loss "
        f"diffs {np.abs(np.subtract(two['losses'], one['losses'])).tolist()}"
        f", worst step-1 gradient diff {grads:.3e}, batch_stats "
        f"{stats1:.3e}")
    first, want = big["losses"][0], ref["losses"][0]
    assert all(np.isfinite(big["losses"])), big["losses"]
    assert abs(first - want) <= FLAGSHIP_LOSS_TOL, (first, want)
    step = np.median(big["step_s"][1:] or big["step_s"])
    mean = np.median(big["mean_s"][1:] or big["mean_s"])
    log(f"resnet50 dp 2 (gloo on the card, {rows} images a rank): losses "
        f"{[round(x, 4) for x in big['losses']]}, first against one "
        f"device's at {2 * rows}: {want:.4f} (diff {abs(first - want):.2e})"
        f"; steps {[round(x, 3) for x in big['step_s']]} s, median "
        f"{step:.3f} s, of which the gradient mean of "
        f"{big['mean_bytes']} B a rank {mean:.3f} s "
        f"({mean / step * 100:.1f}%), forward and backward "
        f"{np.median(big['grad_s']):.3f} s, optimizer "
        f"{np.median(big['opt_s']):.3f} s (host-staged: not a "
        f"data-parallel speed); one device at {2 * rows}: "
        f"{ref['step_s'][0]:.3f} s (its first step)")
    return dict(step_s=float(step), mean_s=float(mean))


RESNET_CKPT_ARGV = ["--model", "resnet50", "--batch-per-chip", "32",
                    "--ckpt-every", "0"]


def phase_resnet_ckpt(device: str = "cuda", argv=RESNET_CKPT_ARGV) -> dict:
    """Phase 56: ResNet-50 trained 2 steps with ``--ckpt-dir``, resumed
    for 2 more, against 4 uninterrupted steps (cuDNN deterministic for
    the phase, restored after)."""
    import os

    import numpy as np
    import torch

    from kubegpu_tpu_torch.models import worker

    model = argv[argv.index("--model") + 1]

    def run(extra):
        return worker.run_resnet(worker.build_parser().parse_args(
            argv + ["--device", device] + extra))

    old = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    root = tempfile.mkdtemp(prefix="chip-smoke-resnet-ckpt-")
    try:
        a, b = os.path.join(root, "resumed"), os.path.join(root, "whole")
        first = run(["--steps", "2", "--ckpt-dir", a])
        resumed = run(["--steps", "2", "--ckpt-dir", a])
        whole = run(["--steps", "4", "--ckpt-dir", b])
        assert resumed["checkpoint"]["resumed_step"] == 2
        assert resumed["step"] == whole["step"] == 4
        worst, n_stats = 0.0, 0
        with np.load(os.path.join(a, model, "4", "state.npz")) as got, \
                np.load(os.path.join(b, model, "4", "state.npz")) as want:
            assert sorted(got.files) == sorted(want.files)
            n_leaves = len(want.files)
            for key in want.files:
                n_stats += key.startswith("batch_stats/")
                worst = max(worst, float(np.abs(
                    got[key].astype(np.float64) - want[key]).max(initial=0)))
        assert n_stats > 0 and worst <= RESUME_TOL, (n_stats, worst)
        ck = resumed["checkpoint"]
        log(f"{model} checkpoint ({' '.join(argv)}): step 4 resumed vs "
            f"uninterrupted, largest leaf difference {worst:.3e} over "
            f"{n_leaves} leaves ({n_stats} batch_stats); a step "
            f"{ck['ckpt_bytes']} B; saves "
            f"{[round(x, 3) for x in first['checkpoint']['save_s']]} and "
            f"{[round(x, 3) for x in ck['save_s']]} s, the resume's restore "
            f"{ck['restore_s']:.3f} s; losses {first['losses']} then "
            f"{resumed['losses']} (uninterrupted {whole['losses']})")
        return dict(bytes=ck["ckpt_bytes"], restore_s=ck["restore_s"],
                    save_s=ck["save_s"])
    finally:
        torch.backends.cudnn.deterministic = old
        shutil.rmtree(root, ignore_errors=True)


# -- the MoE family (phases 57-60) ----------------------------------------------

# phase 57's small model: 2 layers, hidden 64 (4 heads of 16), 4 experts
MOE_SMALL = dict(vocab_size=256, num_layers=2, num_heads=4, hidden=64,
                 max_seq=129, num_experts=4)
MOE_SMALL_RUN = dict(batch=4, seq=128)
MOE_ROUTES = (("top1", "einsum"), ("top1", "gather"), ("top2", "einsum"),
              ("top2", "gather"), ("expert_choice", "einsum"))
# bench.py's steady_state_moe (bench.py:5009-5054): b8, s1024, vocab
# 32768, hidden 2048, 16 heads of 128, 4 layers, 4 experts, capacity
# factor 2, flash attention on both the MoE rows and the dense twin
MOE_BENCH = dict(vocab_size=32768, num_layers=4, num_heads=16, hidden=2048,
                 max_seq=1025, num_experts=4)
MOE_BENCH_RUN = dict(batch=8, seq=1024, warm=2, timed=5, pool=2)
# its six MoE rows: (label, router, fast_dispatch, dispatch)
MOE_ROWS = (("top1 fp32-dispatch", "top1", False, "einsum"),
            ("top1 fast-dispatch", "top1", True, "einsum"),
            ("top2 fast-dispatch", "top2", True, "einsum"),
            ("expert-choice fast-dispatch", "expert_choice", True, "einsum"),
            ("top1 gather-dispatch", "top1", True, "gather"),
            ("top2 gather-dispatch", "top2", True, "gather"))
MOE_DEFAULT_ROW = "top1 fast-dispatch"
# a routing decision whose deciding gates lie closer than this may flip
# between two devices' float32 rounding
MOE_NEAR_TIE = 1e-5
MOE_WORKER_ARGV = ["--model", "moe", "--num-experts", "4", "--steps", "10"]
MOE_CKPT_ARGV = ["--model", "moe", "--num-experts", "4",
                 "--batch-per-chip", "8", "--ckpt-every", "100"]
MOE_CKPT_TOL = 1e-6


def moe_cases():
    """The rank bodies of the port's MoE tests
    (``tests/torch_moe_cases.py``)."""
    tp_cases()   # puts tests/ on the path
    import torch_moe_cases

    return torch_moe_cases


def moe_init_cfg(cfg: dict) -> dict:
    """``init_moe_params``' cfg of a model cfg (no head count)."""
    return {k: v for k, v in cfg.items() if k != "num_heads"}


def moe_gate_margin(model, tokens) -> float:
    """The closest routing decision of a forward of ``tokens``: the
    smallest gap between a token's two largest gates and, under expert
    choice, between the gates at each expert's capacity edge."""
    import torch

    from kubegpu_tpu_torch.models.moe import capacity_of

    gaps = []

    def hook(mlp, _inputs, logits):
        gates = torch.softmax(logits.float(), dim=-1)
        top = gates.topk(2, dim=-1).values
        gaps.append((top[..., 0] - top[..., 1]).min().item())
        if model.router_type == "expert_choice":
            s = gates.shape[1]
            c = capacity_of(s, model.num_experts, model.capacity_factor)
            if c < s:
                ranked = gates.transpose(1, 2).sort(-1, descending=True).values
                gaps.append((ranked[..., c - 1] - ranked[..., c]).min().item())

    hooks = [blk.moe_mlp.router.register_forward_hook(hook)
             for blk in model.blocks()]
    try:
        with torch.no_grad():
            model(tokens)
    finally:
        for h in hooks:
            h.remove()
    return min(gaps)


def phase_moe_card_vs_cpu(device: str = "cuda", cfg: dict = MOE_SMALL,
                          run: dict = MOE_SMALL_RUN) -> None:
    """Phase 57: the small MoE model at float32 with flash attention,
    card against CPU, each router with each dispatch: three carried
    nesterov SGD steps from one fresh tree on one token stream."""
    import numpy as np
    import torch

    from kubegpu_tpu_torch.models.data import synthetic_token_batches
    from kubegpu_tpu_torch.models.moe import MoeTransformerLM, moe_router_stats
    from kubegpu_tpu_torch.models.params import init_moe_params, tree_map
    from kubegpu_tpu_torch.models.train import (
        create_train_state,
        moe_loss,
        moe_step,
    )

    t0 = time.monotonic()
    params = init_moe_params(moe_init_cfg(cfg),
                             torch.Generator().manual_seed(7), "cpu")
    source = synthetic_token_batches(run["batch"], run["seq"] + 1,
                                     cfg["vocab_size"], seed=2)
    batches = [torch.from_numpy(next(source)) for _ in range(3)]
    for router, dispatch in MOE_ROUTES:
        runs = {}
        for dev in ("cpu", device):
            kernels = flash_counts_to_zero()
            model = MoeTransformerLM(dtype=torch.float32, attn_impl="flash",
                                     router_type=router,
                                     dispatch_impl=dispatch, **cfg)
            state = create_train_state(
                model, tree_map(lambda t: t.to(dev).clone(), params))
            # step 1 by hand, to read its gradients before the optimizer
            # (torch's multi-tensor nesterov SGD adds the momentum into
            # them)
            loss, aux = moe_loss(model, batches[0].to(dev))
            loss.backward()
            grads = {n: p.grad.detach().cpu().clone()
                     for n, p in model.named_parameters()}
            state.opt.step()
            state.opt.zero_grad(set_to_none=True)
            state.step += 1
            steps = [moe_step(state, t.to(dev)) for t in batches[1:]]
            losses = [loss.item()] + [v[0].item() for v in steps]
            auxes = [aux.item()] + [v[1].item() for v in steps]
            launches = [fn.launches for fn in kernels]
            _, drop = moe_router_stats(model, batches[0][:, :-1].to(dev))
            runs[dev] = dict(losses=np.asarray(losses), auxes=auxes,
                             grads=grads, drop=drop.item(), model=model)
            want = 3 * cfg["num_layers"] if dev != "cpu" else 0
            # the float32 K4 and K5 take delta from out: no pre-pass
            assert launches == [want] * 3 + [0], (router, dispatch, dev,
                                                  launches)
        cpu, card = runs["cpu"], runs[device]
        label = f"moe {router}/{dispatch} fp32"
        np.testing.assert_allclose(card["losses"], cpu["losses"],
                                   rtol=TRAIN_TOL, atol=0, err_msg=label)
        np.testing.assert_allclose(card["auxes"], cpu["auxes"],
                                   rtol=TRAIN_TOL, atol=TRAIN_TOL,
                                   err_msg=label)
        worst = 0.0
        for n, want in cpu["grads"].items():
            torch.testing.assert_close(card["grads"][n], want,
                                       rtol=TRAIN_TOL, atol=TRAIN_TOL,
                                       msg=lambda m: f"{label} {n}: {m}")
            worst = max(worst, (card["grads"][n] - want).abs().max().item())
        tie = ""
        if card["drop"] != cpu["drop"]:
            margin = moe_gate_margin(cpu["model"], batches[0][:, :-1])
            assert margin < MOE_NEAR_TIE, (label, card["drop"], cpu["drop"],
                                           margin)
            tie = (f"; drop rates differ at a near-tie (closest gate gap "
                   f"{margin:.2e})")
        log(f"{label} card vs cpu: losses "
            f"{[round(float(x), 6) for x in card['losses']]}, diffs "
            f"{np.abs(card['losses'] - cpu['losses']).tolist()}; aux "
            f"{[round(x, 6) for x in card['auxes']]}; worst step-1 gradient "
            f"diff {worst:.3e} over {len(cpu['grads'])} leaves; drop card "
            f"{card['drop']:.6f} cpu {cpu['drop']:.6f}{tie}; K3/K4/K5 "
            f"launched {3 * cfg['num_layers']} times each on the card")
    log(f"moe card vs cpu: {time.monotonic() - t0:.1f} s")


def moe_flash_flops(cfg: dict, batch: int, seq: int) -> int:
    """The flash kernels' FLOPs in one training step, from their shapes
    (``FlopCounterMode`` does not see a kernel launched through ctypes):
    causal, so half the score matrix: the forward's two products 2 b h
    s^2 d, the backward's five (recomputed scores, dV, dP, dQ, dK)
    5 b h s^2 d, over every layer."""
    hd = cfg["hidden"] // cfg["num_heads"]
    return (7 * batch * cfg["num_heads"] * seq * seq * hd
            * cfg["num_layers"])


MOE_CLASSES = ("router", "dispatch_combine", "experts", "attention_kernels",
               "attention", "head", "optimizer", "other")


def moe_labelled(model, state):
    """A profiling label around each part of a MoE step: each method
    and module forward wrapped in ``record_function("moe::<class>")``
    for the time of the ``with``; returns the context manager."""
    import contextlib

    from torch.profiler import record_function

    from kubegpu_tpu_torch.models import moe, train
    from kubegpu_tpu_torch.models.transformer import CausalSelfAttention

    def wrap(fn, label):
        def run(*a, **kw):
            with record_function(f"moe::{label}"):
                return fn(*a, **kw)
        return run

    targets = [(moe.MoEMLP, name, "router")
               for name in ("_gates", "_top1", "_top2", "_expert_choice")]
    targets += [(moe.MoEMLP, "_dense", "dispatch_combine"),
                (moe.MoEMLP, "_gather", "dispatch_combine"),
                (moe.MoEMLP, "_experts", "experts"),
                (CausalSelfAttention, "forward", "attention"),
                (train, "cross_entropy", "head"),
                (model.lm_head, "forward", "head"),
                (model.ln_f, "forward", "head"),
                (state.opt, "step", "optimizer")]

    @contextlib.contextmanager
    def labelled():
        saved = [(obj, name, getattr(obj, name)) for obj, name, _ in targets]
        try:
            for obj, name, label in targets:
                setattr(obj, name, wrap(getattr(obj, name), label))
            yield
        finally:
            for obj, name, fn in saved:
                if isinstance(obj, type) or obj is train:
                    setattr(obj, name, fn)
                else:
                    delattr(obj, name)   # the instance's own wrapper

    return labelled()


def moe_breakdown(prof) -> tuple:
    """Device time (ms) of a profile of labelled MoE steps by class
    (:data:`MOE_CLASSES`), and the device's busy time: each kernel goes
    to its name's class (the flash kernels), else to the label of the
    forward op it ran under, and a backward kernel to the label of the
    forward op whose autograd node ran it (the same sequence number)."""
    from collections import defaultdict

    from torch.autograd import DeviceType

    flash = ("flash_forward", "flash_backward")
    evs = list(prof.events())

    def ancestor(e, test):
        while e is not None:
            if test(e.name):
                return e
            e = e.cpu_parent
        return None

    def label(e):
        a = ancestor(e, lambda n: n.startswith("moe::"))
        return a.name[len("moe::"):] if a is not None else None

    def backward_node(e):
        return ancestor(e, lambda n: n.startswith(
            "autograd::engine::evaluate_function"))

    fwd = {}
    for e in evs:
        if (e.device_type == DeviceType.CPU
                and getattr(e, "sequence_nr", -1) >= 0
                and backward_node(e) is None):
            lab = label(e)
            if lab is not None:
                fwd.setdefault(e.sequence_nr, lab)
    cats = defaultdict(float)
    busy = 0.0
    for e in evs:
        if e.device_type == DeviceType.CUDA and not getattr(
                e, "is_user_annotation", False):
            busy += e.time_range.elapsed_us() / 1e3
        if e.device_type != DeviceType.CPU:
            continue
        for k in e.kernels:
            if any(f in k.name for f in flash):
                cat = "attention_kernels"
            else:
                node = backward_node(e)
                cat = (fwd.get(node.sequence_nr, "other") if node is not None
                       else label(e) or "other")
            cats[cat] += k.duration / 1e3
    return {c: cats.get(c, 0.0) for c in MOE_CLASSES}, busy


def moe_row(label: str, model, params, step_fn, batches, run: dict,
            flash_flops: int, device: str, profile_step: bool = False
            ) -> dict:
    """One row of the reference's MoE bench on the card: a fresh train
    state, the warm-up steps (the first under ``FlopCounterMode``), the
    timed steps with K3/K4/K5 counted from 0, the peak memory; with
    ``profile_step`` one more step profiled by class."""
    import numpy as np
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from kubegpu_tpu_torch.models.train import create_train_state

    card = device != "cpu"
    if card:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    state = create_train_state(model, params)
    i = 0

    def step():
        nonlocal i
        out = step_fn(state, batches[i % len(batches)])
        i += 1
        return out[0] if isinstance(out, tuple) else out

    counter = FlopCounterMode(display=False)
    with counter:
        first = step().item()
    flops = counter.get_total_flops() + flash_flops
    for _ in range(run["warm"] - 1):
        step()
    sync(device)
    kernels = flash_counts_to_zero()
    t0 = time.perf_counter()
    for _ in range(run["timed"]):
        loss = step()
    last = loss.item()   # forces the chain
    sync(device)
    dt = (time.perf_counter() - t0) / run["timed"]
    launches = {fn.__name__: fn.launches for fn in kernels}
    peak = torch.cuda.max_memory_allocated() / 2**30 if card else 0.0
    tokens = run["batch"] * run["seq"]
    out = dict(first_loss=first, last_loss=last, step_s=dt,
               tokens_per_s=tokens / dt, flops=flops,
               peak_share=flops / dt / BF16_PEAK_FLOPS, peak_gib=peak,
               launches=launches, state=state)
    want = model.num_layers * run["timed"] if card else 0
    for name in ("flash_forward", "flash_backward_dkdv", "flash_backward_dq",
                 "flash_backward_delta"):
        assert launches[name] == want, (label, launches, want)
    assert np.isfinite([first, last]).all(), (label, first, last)
    if profile_step and card:
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        with moe_labelled(model, state):
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA],
                         acc_events=True) as prof:
                t1 = time.perf_counter()
                step()
                torch.cuda.synchronize()
                wall = (time.perf_counter() - t1) * 1e3
        cats, busy = moe_breakdown(prof)
        out["profile"] = dict(wall_ms=wall, busy_ms=busy, **cats)
        shown = sum(cats.values())
        log(f"moe [{label}] one profiled step: {wall:.2f} ms wall, device "
            f"busy {busy:.2f} ms (idle {100 - busy / wall * 100:.1f}%); by "
            f"class, ms: " + ", ".join(
                f"{k} {v:.2f} ({v / max(shown, 1e-9) * 100:.1f}%)"
                for k, v in sorted(cats.items(), key=lambda kv: -kv[1]))
            + f"; classified {shown:.2f} ms of {busy:.2f}")
    return out


def phase_moe_bench(device: str = "cuda", cfg: dict = MOE_BENCH,
                    run: dict = MOE_BENCH_RUN, rows=MOE_ROWS) -> dict:
    """Phase 58: ``bench.py``'s ``steady_state_moe`` on one card: the
    dense twin and the six MoE rows in bf16 with flash attention, each
    ``run["warm"]`` warm and ``run["timed"]`` timed steps on a device
    pool of ``run["pool"]`` batches of the reference's stream; one
    profiled step of the default row."""
    import torch

    from kubegpu_tpu_torch.models.data import synthetic_token_batches
    from kubegpu_tpu_torch.models.moe import MoeTransformerLM, moe_router_stats
    from kubegpu_tpu_torch.models.params import init_moe_params, init_params
    from kubegpu_tpu_torch.models.train import lm_step, moe_step
    from kubegpu_tpu_torch.models.transformer import TransformerLM

    t0 = time.monotonic()
    b, s = run["batch"], run["seq"]
    source = synthetic_token_batches(b, s + 1, cfg["vocab_size"])
    host = [next(source) for _ in range(run["pool"])]
    batches = [torch.from_numpy(t).to(device) for t in host]
    flash_flops = moe_flash_flops(cfg, b, s)
    dims = {k: v for k, v in cfg.items() if k != "num_experts"}
    dense = TransformerLM(dtype=torch.bfloat16, attn_impl="flash", **dims)
    gen = torch.Generator(device=device).manual_seed(0)
    init = moe_init_cfg(dims)
    out = {"dense": moe_row("dense twin", dense,
                            init_params(init, gen, torch.float32, device),
                            lm_step, batches, run, flash_flops, device)}
    dense_s = out["dense"]["step_s"]
    del dense
    out["dense"].pop("state")
    log(f"moe bench dense twin (h{cfg['hidden']} L{cfg['num_layers']} "
        f"b{b} s{s} bf16 flash): {dense_s * 1e3:.2f} ms a step, "
        f"{out['dense']['tokens_per_s']:.1f} tokens/s, "
        f"{flop_str(out['dense']['flops'])} a step -> "
        f"{out['dense']['peak_share'] * 100:.1f}% of the dense bf16 peak; "
        f"peak {out['dense']['peak_gib']:.2f} GiB; first loss "
        f"{out['dense']['first_loss']:.4f}")
    for label, router, fast, dispatch in rows:
        model = MoeTransformerLM(dtype=torch.bfloat16, attn_impl="flash",
                                 router_type=router, fast_dispatch=fast,
                                 dispatch_impl=dispatch,
                                 capacity_factor=2.0, **cfg)
        params = init_moe_params(moe_init_cfg(cfg), torch.Generator(
            device=device).manual_seed(0), device)
        r = moe_row(label, model, params, moe_step, batches, run,
                    flash_flops, device,
                    profile_step=label == MOE_DEFAULT_ROW)
        # the reference reads the router's health after its steps, on its
        # first sample
        aux, drop = moe_router_stats(model, batches[0][:, :-1])
        r.update(aux=aux.item(), drop=drop.item())
        r.pop("state")
        del model, params
        out[label] = r
        log(f"moe bench [{label}] ({cfg['num_experts']} local experts, "
            f"h{cfg['hidden']} L{cfg['num_layers']}) b{b} s{s}: "
            f"{r['step_s'] * 1e3:.2f} ms a step, {r['tokens_per_s']:.1f} "
            f"tokens/s, {flop_str(r['flops'])} a step -> "
            f"{r['peak_share'] * 100:.1f}% of the dense bf16 peak, "
            f"overhead vs dense {(r['step_s'] / dense_s - 1) * 100:+.1f}%; "
            f"aux {r['aux']:.4f}, token drop {r['drop'] * 100:.2f}%; peak "
            f"{r['peak_gib']:.2f} GiB; K3/K4/K5/pre-pass launched "
            f"{r['launches']['flash_forward']} times each in "
            f"{run['timed']} steps; first loss {r['first_loss']:.4f}")
    if device != "cpu":
        # the flash kernels at the shape the rows gave them, against their
        # plain versions; outside the counted steps
        heads = cfg["num_heads"]
        out["flash_errs"] = check_flash(*flash_inputs(
            b, s, s, heads, cfg["hidden"] // heads, torch.bfloat16,
            torch.Generator(device=device).manual_seed(58)), True)
        torch.cuda.empty_cache()
    log(f"moe bench: {time.monotonic() - t0:.1f} s")
    out["tokens"] = host
    return out


def phase_moe_gang(bench: dict, device: str = "cuda",
                   small: dict = MOE_SMALL, run: dict = MOE_SMALL_RUN,
                   wide: dict = MOE_BENCH, wide_steps: int = 2,
                   gangs=(None, None)) -> dict:
    """Phase 59: fp32 dp 2 x ep 2 and ep 2 x tp 2 gangs on the card
    against one device at the small size, each route; the bench width at
    ep 2 in a two-rank gang against phase 58's first loss.  ``gangs``
    (four ranks, two ranks) are laid out as each mesh; without them the
    phase starts its own."""
    import numpy as np
    import torch

    from kubegpu_tpu_torch.models.data import synthetic_token_batches
    from kubegpu_tpu_torch.models.params import init_moe_params, tree_map

    cases = moe_cases()
    t0 = time.monotonic()
    # two meshes of four ranks, one of two for the bench width; gangs of
    # its own boot at once, beside the one-device runs
    mesh_axes = ({"data": 2, "expert": 2},
                 {"data": 1, "expert": 2, "model": 2},
                 {"data": 1, "expert": 2})
    four, two = gangs
    with contextlib.ExitStack() as stack:
        four, two = (stack.enter_context(shared_gang(
            gang, axes, device, "chip-smoke-moe-")).start()
            for gang, axes in ((four, mesh_axes[0]), (two, mesh_axes[2])))
        params = init_moe_params(moe_init_cfg(small),
                                 torch.Generator().manual_seed(8), "cpu")
        tree = tree_map(lambda t: t.numpy(), params)
        tokens = next(synthetic_token_batches(run["batch"], run["seq"] + 1,
                                              small["vocab_size"], seed=3))
        routes = [dict(router_type=r, dispatch_impl=d, attn_impl="flash")
                  for r, d in (("top1", "einsum"), ("top2", "gather"),
                               ("expert_choice", "einsum"))]
        # one device on the card, through the gangs' own body
        ones = [cases.moe_grads(None, dict(params=tree, cfg=small,
                                           model=route, tokens=[tokens],
                                           device=device))
                for route in routes]
        # the two meshes of four ranks, each route against one device
        for axes in mesh_axes[:2]:
            for route, one in zip(routes, ones):
                got = four.run(cases.moe_grads, dict(
                    params=tree, cfg=small, model=route, axes=axes,
                    tokens=[tokens]))
                label = (f"moe {axes} {route['router_type']}/"
                         f"{route['dispatch_impl']} fp32")
                np.testing.assert_allclose(got["loss"], one["loss"],
                                           rtol=TRAIN_TOL,
                                           atol=TRAIN_TOL, err_msg=label)
                np.testing.assert_allclose(got["aux"], one["aux"],
                                           rtol=TRAIN_TOL,
                                           atol=TRAIN_TOL, err_msg=label)
                worst = tree_close(label, got["grads"], one["grads"],
                                   TRAIN_TOL)
                n = small["num_layers"] * (device != "cpu")
                assert all(v == (0 if k == "flash_backward_delta" else n)
                           for k, v in got["launches"].items()), (
                    label, got["launches"])
                log(f"{label} (gloo on the card) vs one device: loss "
                    f"diff {abs(got['loss'] - one['loss']):.2e}, aux "
                    f"diff {abs(got['aux'] - one['aux']):.2e}, worst "
                    f"gradient diff {worst:.3e}; each rank launched "
                    f"K3/K4/K5 {n} times")
        # the bench width at ep 2: each rank holds two of the four experts
        spec = dict(params={"init": moe_init_cfg(wide), "seed": 0}, cfg=wide,
                    model=dict(attn_impl="flash"), dtype=torch.bfloat16,
                    axes=mesh_axes[2], tokens=bench["tokens"],
                    steps=wide_steps)
        ranks = two.run(cases.moe_bench_width, spec)
    want = bench[MOE_DEFAULT_ROW]["first_loss"]
    whole = 2 * wide["num_layers"] * wide["num_experts"] * 4 * \
        wide["hidden"] ** 2 * 4   # w_up and w_down, float32
    for r, mine in enumerate(ranks):
        first = mine["losses"][0]
        assert np.isfinite(mine["losses"]).all(), mine["losses"]
        assert abs(first - want) <= FLAGSHIP_LOSS_TOL, (r, first, want)
        assert 2 * mine["expert_bytes"] == whole, (mine["expert_bytes"],
                                                   whole)
        n = wide["num_layers"] * wide_steps * (device != "cpu")
        assert all(v == n for v in mine["launches"].values()), mine
        log(f"moe bench width ep 2 rank {r} (gloo on the card, "
            f"{mine['coords']}): losses "
            f"{[round(x, 4) for x in mine['losses']]}, first against one "
            f"device's {want:.4f} (diff {abs(first - want):.2e}); expert "
            f"bytes {mine['expert_bytes']} of {whole} (half), all "
            f"parameters {mine['param_bytes']} B; steps "
            f"{[round(x, 3) for x in mine['seconds']]} s (host-staged: not "
            f"an expert-parallel speed); peak "
            f"{(mine['peak_bytes'] or 0) / 2**30:.2f} GiB")
    log(f"moe gangs: {time.monotonic() - t0:.1f} s")
    return dict(ranks=ranks)


def moe_worker(label: str, argv: list, device: str) -> tuple:
    """``worker.main`` in this process with every kernel count (K1-K5 and
    the pre-pass) set to 0 just before; returns its output and the
    counts after it."""
    from kubegpu_tpu_torch.models import worker

    zero_counts()
    code, out = captured(worker.main, argv + ["--device", device])
    assert code == 0, (label, code)
    return out, {k: getattr(fn, a) for k, (fn, a) in kernel_counts().items()}


def moe_npz(root: str, step: int) -> dict:
    import os

    import numpy as np

    with np.load(os.path.join(root, "moe", str(step), "state.npz")) as z:
        return {k: z[k] for k in z.files}


def phase_moe_worker(device: str = "cuda", base: list = MOE_WORKER_ARGV,
                     ckpt: list = MOE_CKPT_ARGV) -> dict:
    """Phase 60: the worker's ``--model moe`` at its defaults (einsum
    attention: no kernel of the port), with ``--moe-router top2
    --moe-dispatch gather``, and a ``--ckpt-dir`` run resumed against an
    uninterrupted one."""
    import numpy as np

    t0 = time.monotonic()
    out = {}
    for label, extra in (("default", []),
                         ("top2-gather", ["--moe-router", "top2",
                                          "--moe-dispatch", "gather"])):
        text, launches = moe_worker(label, base + extra, device)
        lines = {ln.split()[0]: ln for ln in text.splitlines() if ln}
        first = fields(lines["FIRST_STEP_DONE"])
        steady = fields(lines["steady_state"])
        assert not any(launches.values()), (label, launches)
        assert np.isfinite(float(steady["loss"])), steady
        out[label] = dict(first_s=float(first["seconds"]),
                          tokens_per_s=float(steady["tokens_per_sec"]))
        log(f"moe worker [{label}] (--model moe at its defaults, "
            f"{' '.join(extra) or 'top1 einsum'}): FIRST_STEP_DONE "
            f"{first['seconds']} s, steady {steady['tokens_per_sec']} "
            f"tokens/s, loss {steady['loss']}; "
            f"{lines['PEAK_MEM_GIB']}; kernel launches {launches} (einsum "
            "attention)")
    with tempfile.TemporaryDirectory() as root:
        straight, resumed = f"{root}/straight", f"{root}/resumed"
        moe_worker("ckpt straight", ckpt + ["--steps", "4", "--ckpt-dir",
                                            straight], device)
        moe_worker("ckpt first", ckpt + ["--steps", "2", "--ckpt-dir",
                                         resumed], device)
        text, launches = moe_worker("ckpt resumed", ckpt + [
            "--steps", "2", "--ckpt-dir", resumed], device)
        assert not any(launches.values()), launches
        assert "RESUMED step=2" in text and "CHECKPOINT_SAVED step=4" in text
        a, b = moe_npz(resumed, 4), moe_npz(straight, 4)
        assert a.keys() == b.keys()
        worst = max(float(np.abs(a[k].astype(np.float64)
                                 - b[k].astype(np.float64)).max())
                    for k in a)
        assert worst <= MOE_CKPT_TOL, worst
        log(f"moe worker --ckpt-dir: 2 steps, a resumed 2, against 4: "
            f"{len(a)} leaves, largest difference {worst:.3e}")
    log(f"moe worker: {time.monotonic() - t0:.1f} s")
    return out


# pipeline-parallel LM training (models/pipeline_lm.py): phase 61's small
# pipeline, the worker's defaults (62) and its width in a gang (63)
PP_SMALL = dict(vocab_size=512, hidden=64, num_heads=4, layers_per_stage=2,
                max_seq=65, num_microbatches=4)
PP_SMALL_RUN = dict(batch=8, seq=64, steps=3)
PP_TOL = 1e-5
PP_WORKER_ARGV = ["--model", "pp", "--steps", "5"]
# phase 62's windows a microbatch where the worker's defaults (32) do not
# fit the card
PP_FIT_BATCH = 16
PP_WIDTH = dict(vocab_size=32000, hidden=512, num_heads=8,
                layers_per_stage=4, max_seq=1025, num_microbatches=4)
PP_WIDTH_RUN = dict(batch_per_chip=8, seq=1024, steps=3)
# the flash kernels' IDs in kernel_counts()
FLASH_IDS = {"flash_forward": "K3", "flash_backward_dkdv": "K4",
             "flash_backward_dq": "K5", "flash_backward_delta": "DELTA"}


def pp_cases():
    """The rank bodies of the port's pipeline tests
    (``tests/torch_pp_cases.py``)."""
    tp_cases()   # puts tests/ on the path
    import torch_pp_cases

    return torch_pp_cases


def pp_widths(cfg: dict) -> dict:
    """``init_pipeline_lm``'s widths of a model cfg."""
    return {k: v for k, v in cfg.items()
            if k not in ("num_heads", "num_microbatches")}


def pp_tree(cfg: dict, stages: int, lead: tuple) -> dict:
    """A whole float32 tree of ``stages`` stages drawn on the CPU from
    seed 3, as numpy, its blocks re-stacked to lead with ``lead``."""
    import torch

    from kubegpu_tpu_torch.models.params import tree_map
    from kubegpu_tpu_torch.models.pipeline_lm import init_pipeline_lm

    tree = tree_map(lambda t: t.numpy(), init_pipeline_lm(
        torch.Generator().manual_seed(3), num_stages=stages, device="cpu",
        **pp_widths(cfg)))
    tree["blocks"] = {k: a.reshape(lead + a.shape[1:])
                      for k, a in tree["blocks"].items()}
    return tree


def pp_worst(label: str, got: dict, want: dict, tol: float) -> float:
    """The largest difference of two results' losses, first-step
    gradients, weights and momentum (each leaf in ``want``'s layout);
    fails past ``tol`` (rtol = atol)."""
    import numpy as np

    worst = 0.0

    def walk(path, g, w):
        nonlocal worst
        if isinstance(w, dict):
            assert g.keys() == w.keys(), (label, path)
            for k in w:
                walk(f"{path}/{k}", g[k], w[k])
            return
        w = np.asarray(w, dtype=np.float64)
        g = np.asarray(g, dtype=np.float64).reshape(w.shape)
        np.testing.assert_allclose(g, w, rtol=tol, atol=tol,
                                   err_msg=f"{label} {path}")
        worst = max(worst, float(np.abs(g - w).max()))

    for key in ("losses", "grads", "params", "trace"):
        walk(key, got[key], want[key])
    assert got["step"] == want["step"] and not any(got["launches"].values())
    return worst


def phase_pp_card_vs_cpu(gang2, device: str = "cuda", cfg: dict = PP_SMALL,
                         run: dict = PP_SMALL_RUN, gang4=None) -> None:
    """Phase 61: the small pipeline at float32, three carried SGD steps
    on the card, at one device and in gloo gangs on ``cuda:0`` (two
    ranks, ``gang2``, laid out as ``{"pipe": 2}``; four, ``gang4`` or
    its own, as ``{"pipe": 2, "model": 2}``), against the CPU's one
    device at the same depth."""
    from kubegpu_tpu_torch.models.data import synthetic_token_batches

    cases = pp_cases()
    t0 = time.monotonic()
    # a four-rank gang of its own boots beside the one-device runs
    with shared_gang(gang4, {"pipe": 2, "model": 2}, device,
                     "chip-smoke-pp4-") as gang4:
        gang4.start()
        source = synthetic_token_batches(run["batch"], run["seq"] + 1,
                                         cfg["vocab_size"], seed=5)
        tokens = [next(source) for _ in range(run["steps"])]

        def one(stages: int, dev: str) -> dict:
            # the stack as `stages` rounds over one stage
            return cases.pp_steps(None, dict(
                params=pp_tree(cfg, stages, (stages, 1)), tokens=tokens,
                device=dev, cfg=dict(cfg, num_stages=stages,
                                     num_rounds=stages)))

        cpu = {2: one(2, "cpu"), 4: one(4, "cpu")}
        worst = pp_worst("pp one device", one(2, device), cpu[2], PP_TOL)
        log(f"pp one device card vs cpu (fp32): losses "
            f"{[round(x, 6) for x in cpu[2]['losses']]}, worst difference "
            f"{worst:.3e} over losses, step-1 gradients, weights and "
            "momentum")
        for label, axes, rounds, model_axis in (
                ("gpipe", {"pipe": 2}, 1, None),
                ("circular v2", {"pipe": 2}, 2, None),
                ("pp x tp", {"pipe": 2, "model": 2}, 1, "model")):
            stages = 2 * rounds
            lead = (rounds, 2) if rounds > 1 else (stages,)
            spec = dict(params=pp_tree(cfg, stages, lead), tokens=tokens,
                        axes=axes,
                        cfg=dict(cfg, num_stages=stages, num_rounds=rounds,
                                 model_axis=model_axis))
            got = (gang4 if "model" in axes else gang2).run(cases.pp_steps,
                                                            spec)
            worst = pp_worst(f"pp {label}", got, cpu[stages], PP_TOL)
            log(f"pp {label} {axes} (gloo on the card) vs the cpu's one "
                f"device at {stages} stages: losses "
                f"{[round(x, 6) for x in got['losses']]}, worst difference "
                f"{worst:.3e}; no kernel launched")
    log(f"pp card vs cpu: {time.monotonic() - t0:.1f} s")


def pp_worker(label: str, argv: list, device: str) -> dict:
    """``worker.main`` in this process with every kernel count set to 0
    just before: its lines, the counts after it (all 0) and the peak
    device memory of the run."""
    import numpy as np
    import torch

    from kubegpu_tpu_torch.models import worker

    zero_counts()
    code, out = captured(worker.main, argv + ["--device", device])
    assert code == 0, (label, code)
    launches = {k: getattr(fn, a) for k, (fn, a) in kernel_counts().items()}
    assert not any(launches.values()), (label, launches)
    lines = {ln.split()[0]: ln for ln in out.splitlines() if ln}
    first = fields(lines["FIRST_STEP_DONE"])
    steady = fields(lines["steady_state"])
    assert np.isfinite(float(steady["loss"])), steady
    peak = (torch.cuda.max_memory_allocated() if device == "cuda" else None)
    log(f"pp worker [{label}]: FIRST_STEP_DONE {first['seconds']} s, "
        f"steady {steady['tokens_per_sec']} tokens/s, loss {steady['loss']}; "
        f"peak {peak} B; kernel launches {launches} (einsum attention)")
    return dict(first_s=float(first["seconds"]),
                tokens_per_s=float(steady["tokens_per_sec"]),
                peak_bytes=peak, launches=launches)


def phase_pp_worker(device: str = "cuda", argv: list = PP_WORKER_ARGV,
                    fit_batch: int = PP_FIT_BATCH) -> dict:
    """Phase 62: the worker's ``--model pp`` at its defaults on one card.
    Where they do not fit, the peak they reached (the worker resets the
    peak at its start) and the run at ``--batch-per-chip fit_batch``."""
    import gc

    import torch

    t0 = time.monotonic()
    if device == "cuda":
        torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated() if device == "cuda" else 0
    out = {"held_bytes": held}
    try:
        out["defaults"] = pp_worker("defaults", argv, device)
    except torch.cuda.OutOfMemoryError as e:
        reason = str(e).splitlines()[0]
        out["defaults"] = None
    if out["defaults"] is None:
        peak = torch.cuda.max_memory_allocated()
        out["defaults_peak_bytes"] = peak
        log(f"pp worker at its defaults does NOT fit the card: the run "
            f"reached {peak} B ({peak / 2**30:.2f} GiB, {held} B of it held "
            f"by this process before) and then: {reason}")
        gc.collect()
        torch.cuda.empty_cache()
        out["fit"] = pp_worker(f"--batch-per-chip {fit_batch}",
                               argv + ["--batch-per-chip", str(fit_batch)],
                               device)
    log(f"pp worker: {time.monotonic() - t0:.1f} s")
    return out


def phase_pp_width(gang2, device: str = "cuda", cfg: dict = PP_WIDTH,
                   run: dict = PP_WIDTH_RUN) -> dict:
    """Phase 63: the worker's width in a gang of two ranks on the card
    (``gang2``, laid out as ``{"pipe": 2}``), GPipe and circular V 2:
    each rank's block bytes, the first loss against one device's on the
    same weights (drawn from seed 0 on the card), seconds a step and the
    hops' bytes."""
    import gc

    import numpy as np
    import torch

    from kubegpu_tpu_torch.models.data import synthetic_token_batches
    from kubegpu_tpu_torch.models.params import bind_params
    from kubegpu_tpu_torch.models.pipeline_lm import (
        PipelineLM,
        leaf_shapes,
        pipeline_lm_loss,
    )

    cases = pp_cases()
    t0 = time.monotonic()
    batch = run["batch_per_chip"] * cfg["num_microbatches"]
    source = synthetic_token_batches(batch, run["seq"] + 1,
                                     cfg["vocab_size"], seed=6)
    tokens = [next(source) for _ in range(run["steps"])]
    dev = "cuda:0" if device == "cuda" else device
    out = {}
    for label, rounds in (("gpipe", 1), ("circular v2", 2)):
        stages = 2 * rounds
        init = dict(pp_widths(cfg), num_stages=stages)
        # one device: the same draw, as `stages` rounds over one stage
        with torch.no_grad():
            model = PipelineLM(**dict(cfg, num_stages=stages,
                                      num_rounds=stages))
            bind_params(model, cases.weights(
                {"init": dict(init, devices=1, num_rounds=stages),
                 "seed": 0}, torch.device(dev)))
            want = pipeline_lm_loss(model, torch.from_numpy(tokens[0]).to(
                dev)).item()
        del model
        gc.collect()
        if device == "cuda":
            torch.cuda.empty_cache()
        ranks = gang2.run(cases.pp_width, dict(
            params={"init": dict(init, devices=2, num_rounds=rounds),
                    "seed": 0},
            cfg=dict(cfg, num_stages=stages, num_rounds=rounds),
            axes={"pipe": 2}, tokens=tokens, steps=run["steps"]))
        whole = 4 * sum(int(np.prod(shape)) for path, shape in leaf_shapes(
            **init).items() if path.startswith("blocks/"))
        for r, mine in enumerate(ranks):
            assert np.isfinite(mine["losses"]).all(), mine["losses"]
            assert abs(mine["losses"][0] - want) <= PP_TOL * (1 + abs(want)), (
                label, r, mine["losses"][0], want)
            assert 2 * mine["block_bytes"] == whole, (mine["block_bytes"],
                                                      whole)
            assert not any(mine["launches"].values()), mine["launches"]
            log(f"pp width {label} rank {r} (gloo on the card, "
                f"{mine['coords']}): losses "
                f"{[round(x, 5) for x in mine['losses']]}, first against one "
                f"device's {want:.6f} (diff "
                f"{abs(mine['losses'][0] - want):.2e}); block bytes "
                f"{mine['block_bytes']} of {whole} (half), all parameters "
                f"{mine['param_bytes']} B; steps "
                f"{[round(x, 3) for x in mine['seconds']]} s, of which in "
                f"the hops {[round(x, 3) for x in mine['hop_seconds']]} s "
                f"(host-staged: not a pipeline speed); hops sent "
                f"{mine['hop_bytes']} B, "
                f"staged through the host {mine['staged_bytes']} B in "
                f"{run['steps']} steps; peak "
                f"{(mine['peak_bytes'] or 0) / 2**30:.2f} GiB")
        out[label] = dict(ranks=ranks, one_device_loss=want)
    log(f"pp width: {time.monotonic() - t0:.1f} s")
    return out


def gang_cases():
    """The pods of a gang as OS processes (``tests/torch_gang_cases.py``,
    shared with the CPU tests)."""
    tp_cases()   # puts tests/ on the path
    import torch_gang_cases

    return torch_gang_cases


# the pods of a gang on this host are named after loopback addresses, one
# a pod (as pod IPs would be), so the CRI shim's coordinator address, the
# first pod's hostname and the rendezvous port, reaches every pod
GANG_POD_NAMES = "127.0.0.{}"


def gang_provider(device: str):
    """The node's device provider: NVML on the card; a fake host of one
    card in a CPU rehearsal."""
    if device == "cuda":
        from kubegpu_tpu_torch.plugins.discovery import NvmlGpuProvider

        return NvmlGpuProvider()
    from kubegpu_tpu_torch.plugins.fake import FakeGpuHost

    return FakeGpuHost("cpu-rehearsal", cards=1).provider()


def gang_pods(name: str, pods: int, node: str) -> list:
    """The Pod objects of a gang of ``pods`` pods of the sample ``name``
    (its pod group, one container ``worker`` asking for one card), each
    bound by a one-card assignment annotation to card 0 of ``node``: on
    one card the pods share it, which a real allocator would not do."""
    from kubegpu_tpu_torch.types import annotations
    from kubegpu_tpu_torch.types.info import Assignment, ChipRef
    from kubegpu_tpu_torch.types.resource import RES_TPU

    card = ChipRef(host=node, device_index=0, chip_id=0, coords=(0,))
    assignment = annotations.encode_assignment(Assignment(
        node=node, slice_id=node, per_container={"worker": [card]}))
    return [{
        "metadata": {"name": GANG_POD_NAMES.format(i + 1),
                     "namespace": "default",
                     "annotations": {
                         annotations.POD_GROUP: name,
                         annotations.POD_GROUP_SIZE: str(pods),
                         annotations.POD_ASSIGNMENT: assignment}},
        "spec": {"nodeName": node, "containers": [{
            "name": "worker", "resources": {"limits": {RES_TPU: "1"}}}]},
    } for i in range(pods)]


def gang_pod_envs(name: str, pods: int, provider, port: int) -> list:
    """The env of each pod of :func:`gang_pods` on ``provider``'s node as
    the port's CRI shim injects it (``compute_injection`` over the gang's
    member names): card 0's UUID in ``CUDA_VISIBLE_DEVICES`` and
    ``NVIDIA_VISIBLE_DEVICES``, and the rendezvous table, its coordinator
    the first pod's hostname at ``port`` (a free loopback port, none
    fixed)."""
    from kubegpu_tpu_torch.crishim.inject import compute_injection
    from kubegpu_tpu_torch.types import annotations

    frag = provider.enumerate()
    assert frag is not None and frag.chips[0].healthy, frag
    objs = gang_pods(name, pods, frag.node_name)
    names = [o["metadata"]["name"] for o in objs]
    envs = []
    for obj in objs:
        pod = annotations.pod_from_k8s(obj)
        envs.append(dict(compute_injection(
            pod, "worker", provider, member_names=names,
            subdomain=pod.subdomain, coordinator_port=port).env))
    return envs


def check_pod_envs(outs: list, envs: list) -> None:
    """Each pod ran on exactly its injection: the variables it printed
    (``POD_ENV``) equal the shim's, byte for byte."""
    g = gang_cases()
    for p, ((_, out, _, _), env) in enumerate(zip(outs, envs)):
        got = g.pod_env_of(out)
        assert got == env, (p, got, env)


def pod_lines(out: str) -> dict:
    """A pod's output lines by their first word (the last of each)."""
    return {ln.split()[0]: ln for ln in out.splitlines() if ln.strip()}


# samples/jax-resnet.yaml: 4 pods of the worker's command, 3 of its 100
# steps
GANG_PODS = 4
GANG_RESNET_ARGV = ["--steps", "3"]
# samples/jax-lm-tp.yaml's shape at phase 10's small widths
GANG_LM_ARGV = ["--model", "lm", "--tp", "2", "--vocab", "256", "--hidden",
                "256", "--heads", "4", "--layers", "2", "--seq", "128",
                "--batch-per-chip", "4", "--steps", "3"]
GANG_LM_TOL = 1e-5


def phase_gang_resnet(device: str = "cuda", argv=GANG_RESNET_ARGV,
                      pods: int = GANG_PODS) -> dict:
    """Phase 64: the north star's gang, ``pods`` pods of the sample's
    worker command on one card."""
    g = gang_cases()
    zero_counts()
    extra = [] if device == "cuda" else ["--device", "cpu"]
    envs = gang_pod_envs("jax-resnet", pods, gang_provider(device),
                         g.free_port())
    t0 = time.monotonic()
    outs = g.run_commands(
        [g.worker_command(argv + extra, echo_env=sorted(envs[0]))] * pods,
        envs, timeout_s=900)
    wall = time.monotonic() - t0
    assert_no_kernel("resnet gang (this process)")
    check_pod_envs(outs, envs)
    rows = []
    for p, (_, out, _, secs) in enumerate(outs):
        lines = pod_lines(out)
        seen = fields(lines["WORKER_DEVICES"])["visible_devices"]
        assert seen == envs[p]["CUDA_VISIBLE_DEVICES"], lines["WORKER_DEVICES"]
        mesh = fields(lines["TRAINING_MESH"])
        assert (mesh["data"], mesh["process"], mesh["backend"]) == (
            str(pods), f"{p}/{pods}", "gloo"), lines["TRAINING_MESH"]
        launches = fields(lines["KERNEL_LAUNCHES"])
        assert launches.pop("rank") == str(p), lines["KERNEL_LAUNCHES"]
        for key in ("model", "device"):
            launches.pop(key)
        launches = {k: int(v) for k, v in launches.items()}
        assert not any(launches.values()), launches
        first = fields(lines["FIRST_STEP_DONE"])
        steady = fields(lines["steady_state"])
        peak = lines["PEAK_MEM_GIB"].split()[1]
        rows.append(dict(first_s=float(first["seconds"]), wall_s=secs,
                         launches=launches,
                         first_loss=first["loss"], last_loss=steady["loss"],
                         images_per_sec=float(steady["images_per_sec"]),
                         peak_gib=None if peak == "not" else float(peak)))
    losses = {(r["first_loss"], r["last_loss"]) for r in rows}
    assert len(losses) == 1, losses
    ref = gang_reference_losses(argv + extra, pods)
    first = float(rows[0]["first_loss"])
    near, alone = abs(first - ref["gang"]), abs(first - ref["stream0"])
    assert near <= FLAGSHIP_LOSS_TOL and near < alone, (first, ref)
    log(f"resnet gang's first loss {first} against one device's step from "
        f"the same weights: on the gang's global batch (each pod's rows of "
        f"its own stream) {ref['gang']:.6f} (diff {near:.2e}, tolerance "
        f"{FLAGSHIP_LOSS_TOL}); on as many rows of stream 0 alone "
        f"{ref['stream0']:.6f} (diff {alone:.2e})")
    steps = int(argv[argv.index("--steps") + 1])
    batch = 32 if "--batch-per-chip" not in argv else int(
        argv[argv.index("--batch-per-chip") + 1])
    rate = rows[0]["images_per_sec"]
    step_s = batch * pods / rate
    for p, r in enumerate(rows):
        log(f"resnet gang pod {p}/{pods}: FIRST_STEP_DONE {r['first_s']:.2f}"
            f" s after the worker's start, the pod's process {r['wall_s']:.1f}"
            f" s in all; peak device memory {r['peak_gib']} GiB; steady "
            f"{r['images_per_sec']} images/s")
    log(f"resnet gang's env: each pod's {sorted(envs[0])} as the port's "
        f"shim injected it (card 0, {envs[0]['CUDA_VISIBLE_DEVICES']}; "
        f"coordinator {envs[0]['JAX_COORDINATOR_ADDRESS']})")
    log(f"resnet gang ({pods} pods of `{' '.join(argv)}` on one card over "
        f"gloo, host-staged): losses {rows[0]['first_loss']} -> "
        f"{rows[0]['last_loss']} on every pod; {step_s:.3f} s a step of "
        f"{batch * pods} images over {steps - 1} steady steps; phase "
        f"{wall:.1f} s")
    return dict(pods=rows, step_s=step_s, wall_s=wall, reference=ref)


def gang_reference_losses(argv: list, pods: int) -> dict:
    """One device's first loss (the worker's builder: its initial weights,
    here on ``argv``'s device) on the global batch of a gang of ``pods``
    pods of one device on ``argv`` (``gang``: each pod's first step's
    rows from its own process id's stream, in process order) and on as
    many rows of stream 0 (``stream0``: one process of ``pods``
    devices)."""
    import numpy as np
    import torch

    from kubegpu_tpu_torch.models import worker
    from kubegpu_tpu_torch.models.data import synthetic_image_batches
    from kubegpu_tpu_torch.models.train import resnet_step

    # a resident batch: the state without drawing the worker's pool
    args = worker.build_parser().parse_args(argv + ["--data", "resident"])
    rows = max(args.batch_per_chip, 1)
    device = worker.resolve_device(args.device)
    out = {}
    for name in ("gang", "stream0"):
        state, _ = worker.build_resnet_trainer(args)
        # the first draw sizes the worker's init; its step 0 takes the
        # next
        draws = []
        for stream, n in ([(p, rows) for p in range(pods)] if name == "gang"
                          else [(0, rows * pods)]):
            source = synthetic_image_batches(
                n, size=state.model.image_size,
                num_classes=state.model.num_classes, worker_id=stream)
            next(source)
            draws.append(next(source))
        images, labels = (torch.from_numpy(np.concatenate(x)).to(device)
                          for x in zip(*draws))
        out[name] = float(resnet_step(state, images, labels))
        del state, images, labels
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    return out


def phase_gang_lm(device: str = "cuda", argv=GANG_LM_ARGV) -> dict:
    """Phase 65: an LM gang of 2 pods of 1 rank on the card, float32,
    against the same gang on the CPU in one process."""
    g = gang_cases()
    pods = 2
    envs = gang_pod_envs("jax-lm-tp", pods, gang_provider(device),
                         g.free_port())
    t0 = time.monotonic()
    pod_argv = argv + ([] if device == "cuda" else ["--device", "cpu"])
    outs = g.run_commands(
        [g.pod_script("run_lm", pod_argv, fp32=True,
                      echo_env=sorted(envs[0]))] * pods,
        envs,
        g.pod_script("run_lm", argv + ["--device", "cpu", "--cpu-ranks",
                                       str(pods)], fp32=True),
        timeout_s=900)
    wall = time.monotonic() - t0
    check_pod_envs(outs[:pods], envs)
    cpu = g.losses_of(outs[pods][1])
    steps = int(argv[argv.index("--steps") + 1])
    layers = int(argv[argv.index("--layers") + 1])
    launches, worst = [], 0.0
    for p, (_, out, _, _) in enumerate(outs[:pods]):
        got = g.losses_of(out)
        worst = max([worst] + [abs(a - b) for a, b in zip(got, cpu)])
        assert len(got) == len(cpu) == steps and worst <= GANG_LM_TOL, (
            got, cpu)
        lines = pod_lines(out)
        assert fields(lines["TRAINING_MESH"])["process"] == f"{p}/{pods}"
        assert "FIRST_STEP_DONE" in lines, out
        mine = {}
        for kname, key in FLASH_IDS.items():
            line = fields(lines[f"{key}_LAUNCHES"])
            assert line["rank"] == str(p), lines[f"{key}_LAUNCHES"]
            mine[kname] = int(line[kname])
        if device == "cuda":
            for kname in ("flash_forward", "flash_backward_dkdv",
                          "flash_backward_dq"):
                assert mine[kname] == steps * layers, (p, mine)
        launches.append(mine)
    log(f"lm gang ({pods} pods, `{' '.join(argv)}`, float32, flash, "
        f"{device} over gloo) vs the CPU's --cpu-ranks {pods}: losses "
        f"{cpu}, worst diff {worst:.3e} (tolerance {GANG_LM_TOL}); each "
        f"pod's launches {launches}; phase {wall:.1f} s")
    return dict(launches=launches, worst=worst, wall_s=wall)


# a card no host has: the worker given only it must find no card
BOGUS_UUID = "GPU-00000000-0000-0000-0000-000000000000"
BOGUS_WORKER_ARGV = ["--steps", "1"]


def bogus_env() -> dict:
    """This process's env but for the rendezvous variables, with
    ``CUDA_VISIBLE_DEVICES`` only :data:`BOGUS_UUID`."""
    import os

    from kubegpu_tpu_torch.types.resource import ENV_VISIBLE_DEVICES

    env = {k: v for k, v in os.environ.items()
           if k not in gang_cases().RENDEZVOUS_ENV}
    env[ENV_VISIBLE_DEVICES] = BOGUS_UUID
    return env


def torch_uuid(index: int) -> str:
    """Card ``index``'s UUID as CUDA reports it, in NVML's ``GPU-`` form."""
    import torch

    u = str(torch.cuda.get_device_properties(index).uuid)
    return u if u.startswith("GPU-") else "GPU-" + u


def phase_device_layer() -> dict:
    """Phase 69: the GPU device layer on the card: NVML's cards against
    torch's, their health and device nodes, the node annotation, the
    device plugin's Allocate on request bytes, and a worker whose
    ``CUDA_VISIBLE_DEVICES`` names a card the host lacks."""
    import os

    import torch

    from kubegpu_tpu_torch.plugins.deviceplugin import DevicePluginServer
    from kubegpu_tpu_torch.plugins.provider import (
        CONTROL_DEVICES,
        ENV_NVIDIA_VISIBLE_DEVICES,
        ENV_VISIBLE_DEVICES,
    )
    from kubegpu_tpu_torch.types import annotations
    from kubegpu_tpu_torch.utils import protowire as pw

    t0 = time.monotonic()
    provider = gang_provider("cuda")
    probe = provider.probe()
    assert probe is not None, "libnvidia-ml.so.1 did not load"
    n = torch.cuda.device_count()
    assert len(probe.cards) == n, (len(probe.cards), n)
    by_uuid = {torch_uuid(i): i for i in range(n)}
    for card in probe.cards:
        assert card.error is None, card
        assert card.uuid in by_uuid, (
            f"NVML card {card.index}'s UUID is none of torch's cards'")
        props = torch.cuda.get_device_properties(by_uuid[card.uuid])
        assert card.name == props.name, (card.name, props.name)
        # CUDA offers a process NVML's total less the driver's reserve
        assert card.memory_usable == props.total_memory, (
            card.memory_total, card.memory_reserved, props.total_memory)
        node = provider.device_node(card.minor)
        assert os.path.exists(node) and provider.card_healthy(card), node
        log(f"NVML card {card.index} (driver {probe.driver_version}): "
            f"{card.name}, {card.uuid} = torch's cuda:{by_uuid[card.uuid]}; "
            f"total {card.memory_total} B less reserved "
            f"{card.memory_reserved} B = torch's {props.total_memory} B; "
            f"{node} (minor {card.minor}) opens read-write; PCI bus id "
            f"{card.pci_bus_id or 'not exposed by this driver'}")
    frag = provider.enumerate()
    assert [c.healthy for c in frag.chips] == [True] * n, frag
    assert provider.healthy_device_indices() == list(range(n))
    payload = annotations.encode_node_topology(frag.to_node_info())
    log(f"node annotation {annotations.NODE_TOPOLOGY}={payload}")
    # the device plugin's inventory and Allocate, request bytes in and
    # response bytes out, no gRPC
    plugin = DevicePluginServer(provider)
    assert plugin._inventory() == {str(i): True for i in range(n)}
    ids = [str(i) for i in range(n)]
    req = pw.encode_len_field(1, b"".join(pw.encode_string_field(1, d)
                                          for d in ids))
    (resp,) = pw.get_all(plugin.allocate(req, None), 1)
    env = pw.decode_string_map(pw.get_all(bytes(resp), 1))
    uuids = ",".join(c.uuid for c in probe.cards)
    assert env == {ENV_VISIBLE_DEVICES: uuids,
                   ENV_NVIDIA_VISIBLE_DEVICES: uuids}, env
    devices = [bytes(pw.get_field(bytes(d), 2)).decode()
               for d in pw.get_all(bytes(resp), 3)]
    want = [provider.device_node(c.minor) for c in probe.cards]
    want += [p for p in (f"/dev/{c}" for c in CONTROL_DEVICES)
             if os.path.exists(p)]
    assert devices == want, devices
    log(f"device plugin Allocate({ids}): env {env}, devices {devices}")
    try:
        plugin.allocate(pw.encode_len_field(1, pw.encode_string_field(
            1, str(n))), None)
    except ValueError as e:
        log(f"device plugin Allocate(['{n}']) refused: {e}")
    else:
        raise AssertionError(f"Allocate of card {n} on a host of {n} passed")
    # a worker given only a card the host lacks finds no card, and does
    # not train on the CPU
    assert BOGUS_UUID not in by_uuid
    proc = early_run("bogus", BOGUS_WORKER_ARGV, bogus_env())
    assert proc.returncode != 0, proc.stdout[-2000:]
    assert "no CUDA device is available" in proc.stderr, proc.stderr[-2000:]
    assert f"visible_devices={BOGUS_UUID}" in proc.stdout, proc.stdout
    assert "FIRST_STEP_DONE" not in proc.stdout, proc.stdout[-2000:]
    last = proc.stderr.strip().splitlines()[-1]
    log(f"worker with CUDA_VISIBLE_DEVICES={BOGUS_UUID}: exit "
        f"{proc.returncode}, {last}")
    wall = time.monotonic() - t0
    log(f"device layer: {n} card(s), phase {wall:.1f} s")
    return dict(cards=n, annotation=payload, wall_s=wall)


# phase 70: samples/jax-serve-gateway.yaml's decode replicas on this
# machine.  Their container command with the port's worker for the JAX
# one, its 256 steps cut to 8 and without --serve-http=8700 (phase 71's
# replica, the pod bound again, serves over HTTP) and --ckpt-dir=/ckpt (a
# volume this machine does not mount: the worker serves fresh weights
# from its seed, as it does where the directory holds no checkpoint)
DECODE_REPLICA_ARGV = ["--model=decode", "--serving=paged",
                       "--batch-per-chip=8", "--prompt-len=128", "--steps=8",
                       "--vocab=32768", "--layers=4", "--heads=32",
                       "--hidden=4096", "--seq=1023"]
DECODE_REPLICA_GANG = ("decode-replicas", 3)


def replica_pod(name: str, gang: bool, argv=DECODE_REPLICA_ARGV) -> dict:
    """A ``decode-replica`` Pod object of the sample: its container
    ``server`` asking one card, its serving group and, with ``gang``,
    the sample's pod group of 3."""
    from kubegpu_tpu_torch.types import annotations
    from kubegpu_tpu_torch.types.resource import RES_TPU

    ann = {annotations.POD_SERVING_GROUP: "decode"}
    if gang:
        ann[annotations.POD_GROUP] = DECODE_REPLICA_GANG[0]
        ann[annotations.POD_GROUP_SIZE] = str(DECODE_REPLICA_GANG[1])
    return {"metadata": {"name": name, "namespace": "default",
                         "uid": f"uid-{name}",
                         "labels": {"app": "decode-replica"},
                         "annotations": ann},
            "spec": {"restartPolicy": "Always", "containers": [{
                "name": "server", "image": "kubegpu-tpu:latest",
                "command": ["python", "-m", "kubegpu_tpu_torch.models.worker",
                            *argv],
                "resources": {"limits": {RES_TPU: "1"}}}]}}


def extender_call(base: str, path: str, body=None) -> dict:
    """One call to the extender on loopback (POST with a body, else GET):
    its JSON answer."""
    import urllib.request

    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(base + path, data=data,
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=30) as resp:
        assert resp.status == 200, (path, resp.status)
        return json.loads(resp.read())


def schedule_pod(api, base: str, pod: dict, node: str) -> tuple:
    """kube-scheduler's cycle for ``pod`` against the extender at
    ``base``, the pod created first: filter, prioritize, bind to
    ``node``.  Returns (the host's milliseconds from filter to bind, the
    bound Pod object)."""
    name = pod["metadata"]["name"]
    api.create_pod(pod)
    t0 = time.perf_counter()
    f = extender_call(base, "/filter", {"Pod": pod, "NodeNames": [node]})
    assert f["NodeNames"] == [node] and not f["Error"], f
    prio = extender_call(base, "/prioritize",
                         {"Pod": pod, "NodeNames": f["NodeNames"]})
    assert [e["Host"] for e in prio] == [node], prio
    b = extender_call(base, "/bind", {"PodNamespace": "default",
                                      "PodName": name, "Node": node})
    ms = (time.perf_counter() - t0) * 1e3
    assert b == {"Error": ""}, b
    stored = api.get_pod("default", name)
    assert stored["spec"]["nodeName"] == node, stored["spec"]
    return ms, stored


def control_plane_bind(provider, argv=DECODE_REPLICA_ARGV) -> dict:
    """Phase 70, its first half, on the host: the node advertised, the
    extender listening, the replicas' gang refused whole, one replica
    bound and its container's env from the shim.  Returns the phase's
    state (the API server, the extender and its address, the node, the
    pod, its worker's arguments, its assignment and env, the
    milliseconds)."""
    import os

    from kubegpu_tpu_torch.crishim.inject import compute_injection
    from kubegpu_tpu_torch.plugins.advertiser import Advertiser
    from kubegpu_tpu_torch.scheduler import ExtenderServer, Scheduler
    from kubegpu_tpu_torch.types import annotations
    from kubegpu_tpu_torch.types.resource import (
        ENV_NVIDIA_VISIBLE_DEVICES,
        ENV_VISIBLE_DEVICES,
    )
    from kubegpu_tpu_torch.utils.apiserver import InMemoryApiServer
    from kubegpu_tpu_torch.utils.metrics import Metrics

    t0 = time.monotonic()
    api = InMemoryApiServer()
    node = Advertiser(provider, api).advertise_once()
    assert node is not None, "the advertiser found no card"
    server = ExtenderServer(Scheduler(api, metrics=Metrics()),
                            listen=("127.0.0.1", 0), resync_interval_s=3600.0)
    server.start()
    base = "http://%s:%d" % server.address
    try:
        cards = extender_call(base, "/state")["slices"][node]["free"]
        # the sample's gang of three one-card replicas: refused whole by
        # a node of fewer cards, nothing planned, reserved or bound
        gang = [replica_pod(f"decode-replica-{i}", True, argv)
                for i in range(DECODE_REPLICA_GANG[1])]
        for pod in gang:
            api.create_pod(pod)
        for pod in gang:
            f = extender_call(base, "/filter", {"Pod": pod,
                                                "NodeNames": [node]})
            assert f["NodeNames"] == [] and node in f["FailedNodes"], f
        state = extender_call(base, "/state")
        assert (state["gang_plans"], state["assumed"],
                state["slices"][node]["used"]) == ({}, [], []), state
        assert not any(o["spec"].get("nodeName")
                       or annotations.assignment_from_pod(o)
                       for o in api.list_pods())
        refusal = f["FailedNodes"][node]
        for pod in gang:
            api.delete_pod("default", pod["metadata"]["name"])
        # one replica alone: bound to a card, its container's env
        pod = replica_pod("decode-replica-0", False, argv)
        ms, stored = schedule_pod(api, base, pod, node)
        command = stored["spec"]["containers"][0]["command"]
        assert command[:3] == ["python", "-m",
                               "kubegpu_tpu_torch.models.worker"], command
        a = annotations.assignment_from_pod(stored)
        (chip,) = a.per_container["server"]
        inj = compute_injection(annotations.pod_from_k8s(stored), "server",
                                provider)
        assert (inj.env[ENV_VISIBLE_DEVICES]
                == inj.env[ENV_NVIDIA_VISIBLE_DEVICES]), inj.env
        env = {k: v for k, v in os.environ.items()
               if k not in gang_cases().RENDEZVOUS_ENV
               and k not in inj.env}
        env.update(inj.env)
    except BaseException:
        server.stop()
        raise
    log(f"control plane: node advertised, extender up, gang refused, pod "
        f"bound and its env made in {time.monotonic() - t0:.2f} s")
    return dict(api=api, server=server, base=base, node=node, pod=pod,
                argv=command[3:], cards=cards, refusal=refusal, chip=chip,
                inj=inj, env=env, bind_ms=[ms], provider=provider)


def stop_control_plane(cp: dict) -> None:
    """Stop the extender (once)."""
    server = cp.pop("server", None)
    if server is not None:
        server.stop()


def phase_control_plane(cp: dict, uuid=None, rebind_argv=None,
                        serve_gate=None) -> dict:
    """Phase 70, its second half: the bound pod's worker (begun early
    under ``"pod"``, or else now) to its end (its card, every kernel's
    launches: K1 once a layer of each decode step, no other), then the
    pod deleted and bound again to the same card.  ``uuid`` is the
    card's UUID as CUDA names it (None in a CPU rehearsal).  With
    ``rebind_argv`` the pod bound again runs the worker on those
    arguments (phase 71's serving replica); ``serve_gate``, a file made
    once the worker has exited, lets that replica's process serve."""
    from kubegpu_tpu_torch.types import annotations
    from kubegpu_tpu_torch.types.resource import ENV_VISIBLE_DEVICES

    try:
        t0 = time.monotonic()
        proc = early_run("pod", cp["argv"], cp["env"])
        wall = time.monotonic() - t0
        if serve_gate is not None:
            open(serve_gate, "w").close()
        assert proc.returncode == 0, proc.stderr[-3000:]
        lines = pod_lines(proc.stdout)
        seen = fields(lines["WORKER_DEVICES"])["visible_devices"]
        assert seen == cp["env"][ENV_VISIBLE_DEVICES], lines["WORKER_DEVICES"]
        if uuid is not None:
            assert seen == uuid, (seen, uuid)
        k1 = fields(lines["K1_LAUNCHES"])
        want = int(k1["decode_steps"]) * int(k1["layers"])
        every = fields(lines["KERNEL_LAUNCHES"])
        assert every.pop("serving") == "paged", lines["KERNEL_LAUNCHES"]
        on_card = every.pop("device").startswith("cuda")
        launches = {k: int(v) for k, v in every.items()}
        assert launches == dict.fromkeys(launches, 0) | {
            "K1": want if on_card else 0} and want > 0, launches
        assert launches["K1"] == int(k1["paged_decode_attention"]), k1
        # the pod deleted: the extender's pod watch returns its card, and
        # the same pod binds to it again
        api, base, node = cp["api"], cp["base"], cp["node"]
        name = cp["pod"]["metadata"]["name"]
        api.delete_pod("default", name)
        deadline = time.monotonic() + 30
        while extender_call(base, "/state")["slices"][node]["used"]:
            assert time.monotonic() < deadline, "the card was not returned"
            time.sleep(0.02)
        assert extender_call(base, "/state")["slices"][node]["free"] == (
            cp["cards"])
        if rebind_argv is not None:
            pod = replica_pod(name, False, rebind_argv)
        else:
            pod = {k: v for k, v in cp["pod"].items() if k != "status"}
            pod["spec"] = {k: v for k, v in pod["spec"].items()
                           if k != "nodeName"}
            meta = dict(pod["metadata"])
            meta["annotations"] = {
                k: v for k, v in meta["annotations"].items()
                if k != annotations.POD_ASSIGNMENT}
            pod["metadata"] = meta
        ms, again = schedule_pod(api, base, pod, node)
        cp["rebound"] = again
        a = annotations.assignment_from_pod(again)
        assert a.per_container["server"] == [cp["chip"]], (a, cp["chip"])
        cp["bind_ms"].append(ms)
    finally:
        stop_control_plane(cp)
    log(f"control plane: the replicas' gang of {DECODE_REPLICA_GANG[1]} "
        f"refused whole on {cp['node']} ({len(cp['cards'])} card(s)): "
        f"{cp['refusal']}")
    log(f"control plane: decode-replica-0 bound to {cp['node']} card "
        f"{cp['chip'].device_index}; the shim's env {cp['inj'].env}; its "
        f"worker (`{' '.join(cp['pod']['spec']['containers'][0]['command'][3:])}`) "
        f"under that env: WORKER_DEVICES {seen}, K1 launches "
        f"{launches['K1']} = decode steps {k1['decode_steps']} x layers "
        f"{k1['layers']}, every kernel's {launches}, its "
        f"process {wall:.1f} s after the build; deleted, the card came "
        f"back and the pod bound to it again")
    log(f"control plane: filter -> prioritize -> bind over loopback HTTP, "
        f"host time on this machine: {cp['bind_ms'][0]:.3f} ms, after the "
        f"delete {cp['bind_ms'][1]:.3f} ms")
    return dict(launches=launches, bind_ms=cp["bind_ms"], wall_s=wall)


# phase 71: samples/jax-serve-gateway.yaml's gateway in front of its
# replica.  The replica is decode-replica-0 as phase 70 binds it again:
# the sample's container command with --serve-http=0 in place of 8700
# (the port is read from its REPLICA_HTTP_SERVING line) and its steps cut
# as in phase 70; the gateway takes the sample's flags
# (--queue-capacity=256 --deadline=30 --hedge-after=1.0, --group=decode;
# --dispatchers at the gateway's default, 8) and is wired as the gateway's
# in-cluster mode wires it
SERVE_REPLICA_ARGV = (DECODE_REPLICA_ARGV[:2] + ["--serve-http=0"]
                      + DECODE_REPLICA_ARGV[2:])
GATEWAY_FLAGS = dict(queue_capacity=256, deadline_s=30.0, hedge_after_s=1.0,
                     dispatchers=8)
# greedy requests of the replica's prompt length: a few alone, then a
# burst of 16 sent 8 at a time (the replica's 8 slots)
GATEWAY_TRAFFIC = dict(singles=3, burst=16, at_once=8, new_tokens=32)


class ProcLines:
    """A subprocess's output as it comes: threads pump its stdout lines
    (``out``) and its stderr (``err``), so neither pipe fills while it
    runs."""

    def __init__(self, proc) -> None:
        import queue
        import threading

        self.proc, self.out, self.err = proc, [], []
        self._lines: "queue.Queue" = queue.Queue()

        def pump_out():
            for line in proc.stdout:
                self._lines.put(line)
            self._lines.put(None)

        def pump_err():
            for line in proc.stderr:
                self.err.append(line)

        self._threads = [threading.Thread(target=f, daemon=True)
                         for f in (pump_out, pump_err)]
        for th in self._threads:
            th.start()

    def until(self, prefix: str, timeout: float) -> str:
        """The next stdout line that starts with ``prefix``."""
        import queue

        deadline = time.monotonic() + timeout
        while True:
            try:
                line = self._lines.get(
                    timeout=max(0.0, deadline - time.monotonic()))
            except queue.Empty:
                raise AssertionError(f"no {prefix} in {timeout} s: "
                                     f"{self.out[-10:]} {self.tail()}")
            if line is None:
                raise AssertionError(f"exited {self.proc.wait()} before "
                                     f"{prefix}: {self.out[-10:]} "
                                     f"{self.tail()}")
            self.out.append(line.rstrip())
            if line.startswith(prefix):
                return line.strip()

    def wait(self, timeout: float) -> int:
        """The exit code, once both pipes are read to their end."""
        rc = self.proc.wait(timeout=timeout)
        for th in self._threads:
            th.join(timeout)
        while True:
            line = self._lines.get()
            if line is None:
                return rc
            self.out.append(line.rstrip())

    def tail(self) -> str:
        return "".join(self.err)[-3000:]

    def kill(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()


def http_status(port: int, path: str) -> int:
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        conn.request("GET", path)
        r = conn.getresponse()
        r.read()
        return r.status
    finally:
        conn.close()


def set_pod_status(api, namespace: str, name: str, status: dict) -> None:
    """The kubelet's status write once a pod's container runs (its IP,
    its phase), which the in-memory API server does not model: merged
    into the stored pod and announced to its watchers as an update."""
    with api._lock:
        pod = api._pods[api._key(namespace, name)]
        pod.setdefault("status", {}).update(status)
        api._emit("pod-updated", pod)


def metric_samples(text: str) -> dict:
    """Every sample of a Prometheus exposition: series -> value."""
    out = {}
    for line in text.splitlines():
        if line and not line.startswith("#"):
            name, _, value = line.rpartition(" ")
            out[name] = float(value)
    return out


def mean_between(before: dict, after: dict, name: str) -> tuple:
    """(mean, count) of a histogram's observations between two
    snapshots."""
    n = after.get(name + "_count", 0.0) - before.get(name + "_count", 0.0)
    s = after.get(name + "_sum", 0.0) - before.get(name + "_sum", 0.0)
    return (s / n if n else float("nan")), int(n)


def wait_until(predicate, timeout: float, what: str) -> float:
    """Poll ``predicate`` until it holds; the seconds it took."""
    t0 = time.monotonic()
    while not predicate():
        assert time.monotonic() - t0 < timeout, f"timed out: {what}"
        time.sleep(0.02)
    return time.monotonic() - t0


def gateway_subprocess(replica_port: int, prompt: list, want: list,
                       new_tokens: int) -> dict:
    """``python -m kubegpu_tpu_torch.gateway.server --replica-endpoint``
    in front of the replica: it announces its port, serves one stream
    with the replica's tokens, and exits 0 on SIGTERM after its drain."""
    import os
    import signal

    t0 = time.monotonic()
    proc = subprocess.Popen(
        [sys.executable, "-m", "kubegpu_tpu_torch.gateway.server",
         "--replica-endpoint", f"127.0.0.1:{replica_port}",
         "--listen", "127.0.0.1:0", "--drain-grace", "30"],
        cwd=os.path.dirname(os.path.abspath(__file__)),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    lines = ProcLines(proc)
    try:
        line = lines.until("GATEWAY_HTTP_SERVING", 120)
        up_s = time.monotonic() - t0
        port = int(fields(line)["port"])
        wait_until(lambda: http_status(port, "/readyz") == 200, 60,
                   "the --replica-endpoint gateway's /readyz")
        events = sse_request(port, "/v1/generate", {
            "prompt": prompt, "max_new_tokens": new_tokens,
            "stream": True})
        (got,), _ = check_streams({0: events}, [new_tokens])
        assert got == want, (got, want)
        proc.send_signal(signal.SIGTERM)
        rc = lines.wait(120)
        assert rc == 0, lines.tail()
        assert "drain complete" in lines.tail(), lines.tail()
        return dict(up_s=up_s, replica=events[-1][1]["replica"])
    finally:
        lines.kill()


def phase_gateway(cp: dict, smi: str = "", traffic: dict = GATEWAY_TRAFFIC,
                  argv=SERVE_REPLICA_ARGV) -> dict:
    """Phase 71: the port's gateway, wired as its in-cluster mode wires
    it (``ReplicaRegistry`` over phase 70's API server, the group
    ``decode``; ``HttpReplicaClient`` resolving podIP:port, its probe the
    registry's; the sample's queue, deadline and hedge), in front of
    ``decode-replica-0`` as phase 70 bound it again, whose process (begun
    early under ``"replica"``, or else now) runs the pod's command under
    the shim's env.  ``smi`` is the card's name and power limit."""
    import concurrent.futures
    import signal

    import numpy as np

    from kubegpu_tpu_torch.crishim.inject import compute_injection
    from kubegpu_tpu_torch.gateway import (
        AdmissionQueue,
        FailoverPolicy,
        Gateway,
        GatewayServer,
        HttpReplicaClient,
        ReplicaRegistry,
    )
    from kubegpu_tpu_torch.types import annotations
    from kubegpu_tpu_torch.utils.metrics import Metrics

    api, name = cp["api"], "decode-replica-0"
    pod = cp["rebound"]
    command = pod["spec"]["containers"][0]["command"]
    assert command[3:] == list(argv), (command, argv)
    inj = compute_injection(annotations.pod_from_k8s(pod), "server",
                            cp["provider"])
    assert inj.env == cp["inj"].env, (inj.env, cp["inj"].env)
    proc = _EARLY.pop("replica", None) or worker_popen(argv, cp["env"])
    replica = ProcLines(proc)
    registry = ReplicaRegistry(api, group="decode")
    endpoint = {}

    def resolve(key):
        info = registry.get(key)
        if info is None or not info.addr or "port" not in endpoint:
            return None
        return f"{info.addr}:{endpoint['port']}"

    client = HttpReplicaClient(resolver=resolve)
    registry.probe = client.probe
    registry.subscribe(client.sync_live)
    metrics = Metrics()
    gateway = Gateway(
        registry, client, metrics=metrics,
        dispatchers=GATEWAY_FLAGS["dispatchers"],
        queue=AdmissionQueue(GATEWAY_FLAGS["queue_capacity"]),
        policy=FailoverPolicy(deadline_s=GATEWAY_FLAGS["deadline_s"],
                              hedge_after_s=GATEWAY_FLAGS["hedge_after_s"]))
    server = GatewayServer(gateway, listen=("127.0.0.1", 0))
    server.start()
    gport = server.address[1]
    try:
        # not ready while the replica does not answer its probe
        assert http_status(gport, "/readyz") == 503
        line = replica.until("REPLICA_HTTP_SERVING", 300)
        # the worker's own seconds from its start (the gate's opening)
        serving_s = float(fields(line)["seconds"])
        endpoint["port"] = rport = int(fields(line)["port"])
        set_pod_status(api, "default", name,
                       {"podIP": "127.0.0.1", "phase": "Running"})

        def ready():
            registry.refresh()
            return http_status(gport, "/readyz") == 200

        ready_s = wait_until(ready, 60, "the gateway's /readyz")
        flags = dict(a[2:].split("=", 1) for a in argv if "=" in a)
        plen, vocab = int(flags["prompt-len"]), int(flags["vocab"])
        new = traffic["new_tokens"]
        rng = np.random.RandomState(71)
        prompts = [rng.randint(0, vocab, size=plen).tolist()
                   for _ in range(traffic["singles"] + traffic["burst"])]
        # each single: straight to the replica twice (the first seals its
        # prompt pages, so both later sends read them from the prefix
        # cache), then through the gateway, each sent alone
        singles, direct_ttft, gw_ttft = [], [], []
        for i, p in enumerate(prompts[:traffic["singles"]]):
            body = {"prompt": p, "max_new_tokens": new}
            for rep in range(2):
                ev = sse_request(rport, "/v1/submit",
                                 dict(body, request_id=f"direct-{i}-{rep}"))
                (want,), (ttft,) = check_streams({0: ev}, [new])
            ev = sse_request(gport, "/v1/generate", dict(body, stream=True))
            (got,), (gttft,) = check_streams({0: ev}, [new])
            assert got == want, (i, got, want)
            assert ev[-1][1]["replica"] == f"default/{name}", ev[-1][1]
            singles.append(want)
            direct_ttft.append(ttft)
            gw_ttft.append(gttft)
        # the burst, 8 at a time, with both sides' metrics around it
        g0 = metric_samples(http_get(gport, "/metrics"))
        r0 = metric_samples(http_get(rport, "/metrics"))
        t1 = time.monotonic()
        with concurrent.futures.ThreadPoolExecutor(traffic["at_once"]) as ex:
            burst = list(ex.map(lambda p: sse_request(
                gport, "/v1/generate",
                {"prompt": p, "max_new_tokens": new, "stream": True}),
                prompts[traffic["singles"]:]))
        burst_s = time.monotonic() - t1
        _, burst_ttft = check_streams(dict(enumerate(burst)),
                                      [new] * traffic["burst"])
        g1 = metric_samples(http_get(gport, "/metrics"))
        r1 = metric_samples(http_get(rport, "/metrics"))
        n_ok = traffic["singles"] + traffic["burst"]
        assert g1.get('gateway_requests_total{outcome="ok"}') == n_ok, g1
        for series in ("gateway_retries_total", "gateway_hedges_total",
                       "gateway_stream_hedges_total",
                       'gateway_requests_total{outcome="rejected"}',
                       "gateway_shed_total", "gateway_failures_total"):
            assert g1.get(series, 0.0) == 0.0, (series, g1.get(series))
        figures = {
            "gateway_ttft_s": mean_between(g0, g1, "gateway_ttft_seconds"),
            "gateway_itl_s": mean_between(g0, g1, "gateway_itl_seconds"),
            "gateway_queue_wait_s": mean_between(
                g0, g1, "gateway_queue_wait_seconds"),
            "serve_ttft_s": mean_between(r0, r1, "serve_ttft_seconds"),
            "serve_itl_s": mean_between(r0, r1, "serve_itl_seconds"),
        }
        assert figures["gateway_ttft_s"][1] == traffic["burst"], figures
        assert figures["serve_ttft_s"][1] == traffic["burst"], figures
        # the gateway's entry point in front of the same replica
        sub = gateway_subprocess(rport, prompts[0], singles[0], new)
        # the pod deleted: its replica leaves the registry at the pod
        # watch's event, well within one refresh (10 s)
        api.delete_pod("default", name)
        gone_s = wait_until(lambda: http_status(gport, "/readyz") == 503,
                            server.refresh_interval_s,
                            "/readyz after the pod's delete")
        proc.send_signal(signal.SIGTERM)
        assert replica.wait(120) == 0, replica.tail()
    finally:
        replica.kill()
        server.stop()
        client.stop()
    lines = {x.split()[0]: x for x in replica.out if x}
    assert "error=False" in lines["REPLICA_HTTP_STOPPED"], lines
    every = fields(lines["KERNEL_LAUNCHES"])
    assert every.pop("serving") == "paged", lines["KERNEL_LAUNCHES"]
    on_card = every.pop("device").startswith("cuda")
    want_k1 = int(every.pop("decode_steps")) * int(every.pop("layers"))
    launches = {k: int(v) for k, v in every.items()}
    assert want_k1 > 0 and launches == dict.fromkeys(launches, 0) | {
        "K1": want_k1 if on_card else 0}, (launches, want_k1)
    ms = lambda v: f"{v * 1e3:.3f} ms"  # noqa: E731
    log(f"gateway: decode-replica-0 bound again runs `{' '.join(argv)}` "
        f"under the shim's env; REPLICA_HTTP_SERVING {serving_s:.2f} s "
        f"after its worker started (phase 70's worker exited), /readyz 503 before its probe and "
        f"200 {ready_s:.2f} s after its podIP; {traffic['singles']} prompts "
        f"of {plen} tokens, {new} new, alone: the gateway's SSE stream "
        f"equals the replica's own /v1/submit stream; {traffic['burst']} "
        f"more {traffic['at_once']} at a time through the gateway in "
        f"{burst_s:.2f} s, every stream {new} tokens, no retry, hedge or "
        f"429; K1 launches {launches['K1']} = decode steps x layers, every "
        f"kernel's {launches}; the --replica-endpoint gateway announced its "
        f"port {sub['up_s']:.1f} s after its start, served the replica's "
        f"tokens and exited 0 on SIGTERM; the pod deleted, /readyz 503 "
        f"{gone_s:.3f} s later")
    log(f"gateway added latency ({smi}): alone, client TTFT (first SSE "
        f"token) straight {', '.join(ms(v) for v in direct_ttft)} vs "
        f"through the gateway {', '.join(ms(v) for v in gw_ttft)}; burst of "
        f"{traffic['burst']}: gateway_ttft_seconds (enqueue -> full "
        f"response) mean {ms(figures['gateway_ttft_s'][0])}, "
        f"gateway_queue_wait_seconds mean "
        f"{ms(figures['gateway_queue_wait_s'][0])}, "
        f"gateway_itl_seconds mean {ms(figures['gateway_itl_s'][0])} beside "
        f"the replica's serve_ttft_seconds mean "
        f"{ms(figures['serve_ttft_s'][0])}, serve_itl_seconds mean "
        f"{ms(figures['serve_itl_s'][0])} ({figures['serve_itl_s'][1]} "
        f"emissions); client TTFT mean "
        f"{ms(sum(burst_ttft) / len(burst_ttft))}")
    return dict(launches=launches, figures=figures, ready_s=ready_s,
                gone_s=gone_s, direct_ttft=direct_ttft, gw_ttft=gw_ttft,
                burst_ttft=burst_ttft, serving_s=serving_s)


def _timed(fn):
    """``fn`` that prints its seconds after it, as ``[name N s]``."""
    @functools.wraps(fn)
    def run(*args, **kwargs):
        t = time.monotonic()
        try:
            return fn(*args, **kwargs)
        finally:
            log(f"[{fn.__name__} {time.monotonic() - t:.1f} s]")
    return run


GROUPS = ("all", "serving", "training", "gang", "device")
# the gangs the training phases share, by label: their meshes' axes
SMOKE_GANGS = {"train": TRAIN_AXES, "cp2": {"data": 1, "seq": CP},
               "cp4": {"data": 2, "seq": CP}, "3d": AXES_3D,
               "gang2": {"data": 2}, "gang4": {"data": 2, "expert": 2}}


def main(argv=None) -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--group", choices=GROUPS, default="all",
                    help="the phases to run (default: every one)")
    group = ap.parse_args(argv).group
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    # the port must be importable before anything is printed: a copy of
    # this script without the repo fails here, with no result
    import kubegpu_tpu_torch.models.worker  # noqa: F401
    mod = sys.modules[__name__]
    for fname in [n for n in vars(mod) if n.startswith("phase_")]:
        setattr(mod, fname, _timed(getattr(mod, fname)))
    return _run(group, torch)


def _run(group: str, torch) -> int:
    with contextlib.ExitStack() as stack:
        stack.callback(stop_early)
        return _run_phases(group, torch, stack)


def _run_phases(group: str, torch, stack) -> int:
    import os

    serving = group in ("all", "serving")
    training = group in ("all", "training")
    gangs = {}

    def start_gangs(*labels) -> list:
        """The gangs ``labels`` of :data:`SMOKE_GANGS`, each started here
        unless it was already, and closed when the run ends."""
        for label in labels:
            if label not in gangs:
                gangs[label] = stack.enter_context(cp_gang(
                    SMOKE_GANGS[label], tempfile.mkdtemp(
                        prefix=f"chip-smoke-{label}-"), "cuda"))
                gangs[label].start()
        return [gangs[label] for label in labels]

    t0 = time.monotonic()
    name, smi = phase_device()
    device = group in ("all", "device")
    # the refused workers' interpreters boot beside the build, as does
    # the pod that phase 70's extender binds now, and the serving
    # replica that pod runs once bound again (phase 71), which serves
    # only after phase 70's worker has exited
    start_refused(["bogus"] * device
                  + ["tp_serve"] * serving + ["tp_train", "cp"] * training)
    if device:
        cp = control_plane_bind(gang_provider("cuda"))
        stack.callback(stop_control_plane, cp)
        gate_dir = tempfile.mkdtemp(prefix="chip-smoke-pod-")
        stack.callback(shutil.rmtree, gate_dir, ignore_errors=True)
        gate = os.path.join(gate_dir, "built")
        served = os.path.join(gate_dir, "served")
        _EARLY["pod"] = worker_popen(cp["argv"], cp["env"], gate)
        _EARLY["replica"] = worker_popen(SERVE_REPLICA_ARGV, cp["env"],
                                         served)
    phase_build()
    if device:
        open(gate, "w").close()
        # the device layer: NVML's cards, the plugin, a worker refused;
        # the control plane: the pod's worker serves beside it, then the
        # pod is bound again with the sample's serving command
        phase_device_layer()
        bound = phase_control_plane(cp, torch_uuid(cp["chip"].device_index),
                                    rebind_argv=SERVE_REPLICA_ARGV,
                                    serve_gate=served)
        # the sample's gateway in front of that replica
        fronted = phase_gateway(cp, smi)
    if serving:
        k1 = phase_k1()
        phase_k1(geo=DEFAULT_PAGED)
        k2 = phase_k2()
        phase_k2(geo=DEFAULT_PAGED, spec_k=DEFAULT_SPEC_K)
        flag = phase_flagship()
        spec = phase_spec_flagship()
        small = phase_card_vs_cpu()
        phase_spec_card(small)
    if training:
        flash = phase_flash()
        train = phase_train_flagship()
        phase_train_card_vs_cpu()
        # ResNet, MoE and pipeline training: first the phases that time
        # the card or read its memory, each with no other process on it
        # (no gang has started yet): ResNet card vs CPU at fp32, the
        # sample's command, the reference's steady state, the reference's
        # MoE bench row, the MoE worker, the pipeline worker at its
        # defaults
        t3 = time.monotonic()
        phase_resnet_card_vs_cpu()
        phase_resnet_sample()
        phase_resnet_steady()
        moe = phase_moe_bench()
        phase_moe_worker()
        pp = phase_pp_worker()
        log(f"resnet, moe and pipeline phases alone on the card "
            f"{time.monotonic() - t3:.1f} s")
    if serving:
        k1q = phase_k1(quant=True)
        phase_k1(quant=True, geo=DEFAULT_PAGED)
        k2q = phase_k2(quant=True)
        phase_k2(quant=True, geo=DEFAULT_PAGED, spec_k=DEFAULT_SPEC_K)
        flag_q = phase_flagship(int8=True)
        spec_q = phase_spec_flagship(int8=True)
        phase_int8_card_vs_cpu(small)
        # the worker at its own defaults: plain, speculative at k 8, int8
        # pool
        phase_flagship(base=DEFAULT_ARGV, name="worker at its defaults")
        phase_spec_flagship(base=DEFAULT_ARGV, name="worker at its defaults",
                            spec_k=DEFAULT_SPEC_K)
        phase_flagship(int8=True, base=DEFAULT_ARGV,
                       name="worker at its defaults")
        # the HTTP replica: flagship plain and speculative over loopback,
        # card against CPU over the wire, the worker's --serve-http entry
        # point
        phase_http_flagship()
        phase_http_flagship(speculate=True)
        phase_http_card_vs_cpu(small)
        phase_http_worker()
        # sampling: the PRNG, the sampled flagship, card against CPU
        phase_prng()
        phase_sampled_flagship(flag, spec)
        phase_sampled_card_vs_cpu(small)
        # migration and disaggregation: the reference's migration bench,
        # live migration card to card and card to CPU, and the wire verbs
        phase_migration_bench()
        phase_live_migration(small)
        phase_wire_migration()
        # the dense serving slice: the decode sample's static mode,
        # continuous against static and paged, chunked against monolithic
        # ITL, the speculative batcher, card against CPU, the worker's
        # dense modes
        phase_static_sample()
        phase_dense_serving()
        phase_prefill_itl()
        phase_spec_serving()
        phase_dense_card_vs_cpu(small)
        phase_dense_worker()
        # tensor-parallel serving: the sharded kernels at one rank's heads,
        # then a two-rank gang on the card; the training gangs of 42-44
        # and 49-50 boot beside it
        if training:
            start_gangs("train", "cp2", "cp4", "3d")
        tp_k = phase_tp_kernels()
        tp = phase_tp(small)
    if training:
        # data x tensor-parallel training: the flash kernels at one rank's
        # heads, then the four-rank gang on the card
        tp_flash = phase_tp_flash()
        # the rest of the gangs boot beside phases 42-44 (those not
        # started beside 36-40): two, four and eight ranks for phases
        # 49-50 and, laid out anew, the flagship's 3-D mesh (67), ZeRO-1
        # (68) and the eight's 66; two and four for the ResNet gang (55),
        # the expert meshes (59) and the pipeline's (61, 63)
        cp2, cp4, cp8, gang2, gang4 = start_gangs(
            "cp2", "cp4", "3d", "gang2", "gang4")
        ckpt_root = tempfile.mkdtemp(prefix="chip-smoke-ckpt-")
        stack.callback(shutil.rmtree, ckpt_root, ignore_errors=True)
        tp_train = phase_tp_train(ckpt_root=ckpt_root,
                                  gang=gangs.get("train"))
        # checkpoints: the flagship trained, saved, resumed and served
        # from its checkpoint (phase 47's mesh half ran in the training
        # gang), beside the idle gangs
        t1 = time.monotonic()
        ck = phase_ckpt_train(ckpt_root)
        phase_ckpt_serve(ck)
        phase_ckpt_resume(ckpt_root)
        shutil.rmtree(ckpt_root, ignore_errors=True)
        log(f"checkpoint phases {time.monotonic() - t1:.1f} s")
        # context-parallel training: the ring block's kernels, the small
        # float32 gangs, the flagship at seq 8192 in a two-rank gang, the
        # 3-D meshes and ZeRO-1, the worker's lm-cp
        t2 = time.monotonic()
        cp_k = phase_cp_kernels()
        phase_cp_small(gangs=(cp2, cp4))
        cp_flag = phase_cp_flagship(gang=cp2)
        flag_3d = phase_3d_flagship(cp_flag["ref"], gang=cp4)
        zero1 = phase_zero1_flagship(gang=cp2)
        small_3d = phase_3d_small(gang=cp8)
        for gang in (cp2, cp4, cp8):
            gang.close()
        phase_cp_worker()
        log(f"context-parallel, 3-D and ZeRO-1 phases "
            f"{time.monotonic() - t2:.1f} s")
        # the ResNet checkpoints and the MoE card vs CPU, then the ResNet
        # gang (55), the expert meshes (59) and the pipeline's (61, 63),
        # each laid out anew in the shared gangs of two and four
        t4 = time.monotonic()
        phase_resnet_ckpt()
        phase_moe_card_vs_cpu()
        phase_resnet_gang(gang=gang2)
        phase_moe_gang(moe, gangs=(gang4, gang2))
        phase_pp_card_vs_cpu(gang2, gang4=gang4)
        phase_pp_width(gang2)
        gang2.close(), gang4.close()
        log(f"resnet, moe and pipeline phases beside the shared gangs "
            f"{time.monotonic() - t4:.1f} s")
    if group in ("all", "gang"):
        # the rendezvous of a gang of pods: the north star's 4 ResNet-50
        # pods on the card and, at the same time, an LM gang against the
        # CPU
        t6 = time.monotonic()
        with concurrent.futures.ThreadPoolExecutor(1) as pool:
            lm_gang = pool.submit(phase_gang_lm)
            gang_resnet = phase_gang_resnet()
            gang_lm = lm_gang.result()
        log(f"gang phases {time.monotonic() - t6:.1f} s")
    if group != "all":
        log(f"chip_smoke: the {group} phases passed in "
            f"{time.monotonic() - t0:.1f} s (no per-kernel record)")
        log(smi)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": name,
            "count": torch.cuda.device_count()}}), flush=True)
        return 0
    log(f"chip_smoke: all phases passed in {time.monotonic() - t0:.1f} s")
    pp_launches = (pp["defaults"] or pp["fit"])["launches"]
    source = "kubegpu_tpu_torch/ops/csrc/paged_attention.cu"
    kernels = []
    # each paged entry point launches its walk and then the merge pass;
    # its launches, times and bound cover both
    for kname, replaces, rec, run, walk, tp_key in (
        ("paged_decode_attention", "kubegpu_tpu/ops/paged_attention.py:135",
         k1, flag, "paged_decode_walk_kernel", "K1"),
        ("paged_chunk_attention", "kubegpu_tpu/ops/paged_attention.py:390",
         k2, spec, "paged_chunk_walk_kernel", "K2"),
        ("paged_decode_attention_int8",
         "kubegpu_tpu/ops/paged_attention.py:135", k1q, flag_q,
         "paged_decode_walk_kernel", "K1q"),
        ("paged_chunk_attention_int8",
         "kubegpu_tpu/ops/paged_attention.py:390", k2q, spec_q,
         "paged_chunk_walk_kernel", "K2q"),
    ):
        bf = rec["bfloat16"]
        kernels.append({
            "name": kname,
            "route": "cuda",
            "source": source,
            "replaces": replaces,
            "launches": run["launches"],
            "max_abs_err": bf["max_abs_err"],
            "ms": bf["ms"],
            "plain_ms": bf["plain_ms"],
            "bound_ms": bf["bound_ms"],
            "bound_by": bf.get("bound_by", "bytes"),
            "library_ms": None,
            "passes": [walk, "paged_merge_kernel"],
            "pages_per_split": bf["split"],
            # tensor parallelism: each rank's launches in the flagship TP 2
            # wave, and the kernel at one rank's 16 heads
            "tp_launches": tp["launches"][tp_key],
            # the north star's gang of pods (phase 64): each pod's launches
            "gang_launches": [p["launches"][tp_key]
                              for p in gang_resnet["pods"]],
            # the pipeline (phase 62's worker): einsum attention, none
            "pp_launches": pp_launches[tp_key],
            # the pod the port's extender bound (phase 70): its worker's
            # launches
            "bound_pod_launches": bound["launches"][tp_key],
            # that pod bound again, serving behind the port's gateway
            # (phase 71): its replica's launches
            "gateway_launches": fronted["launches"][tp_key],
            "tp_ms": tp_k[kname]["ms"],
            "tp_bound_ms": tp_k[kname]["bound_ms"],
        })
    for kname, replaces in (
        ("flash_forward", "kubegpu_tpu/ops/attention.py:72"),
        ("flash_backward_dkdv", "kubegpu_tpu/ops/attention.py:233"),
        ("flash_backward_dq", "kubegpu_tpu/ops/attention.py:280"),
        # delta = rowsum(dO * O), inside the Pallas backward's _bwd_block
        ("flash_backward_delta", "kubegpu_tpu/ops/attention.py:212"),
    ):
        bf = flash[kname]["bfloat16"]
        shard = tp_flash[kname]
        kernels.append({
            "name": kname,
            "route": "cuda",
            "source": "kubegpu_tpu_torch/ops/csrc/flash_attention.cu",
            "replaces": replaces,
            "launches": train["launches"][kname],
            "max_abs_err": bf["max_abs_err"],
            "ms": bf["ms"],
            "plain_ms": bf["plain_ms"],
            "bound_ms": bf["bound_ms"],
            "bound_by": bf["bound_by"],
            "library_ms": bf["library_ms"],
            # data x tensor parallelism: each rank's launches in the
            # flagship dp 2 x tp 2 run, and the kernel at one rank's 16
            # heads
            "tp_launches": [n[kname] for n in tp_train["launches"]],
            "tp_ms": shard["ms"],
            "tp_plain_ms": shard["plain_ms"],
            "tp_bound_ms": shard["bound_ms"],
            "tp_library_ms": shard["library_ms"],
            "tp_max_abs_err": shard["max_abs_err"],
            # context parallelism: each rank's launches in the flagship cp
            # 2 gang (ring, then Ulysses), and the kernel at one ring block
            # of it (4096 rows), unmasked (an earlier rank's block) and
            # causal (the diagonal)
            "cp_launches": [n[kname] for n in cp_flag["launches"]["ring"]],
            "cp_ulysses_launches": [
                n[kname] for n in cp_flag["launches"]["ulysses"]],
            "cp_ms": cp_k[kname]["unmasked"]["ms"],
            "cp_bound_ms": cp_k[kname]["unmasked"]["bound_ms"],
            "cp_plain_ms": cp_k[kname]["unmasked"]["plain_ms"],
            "cp_library_ms": cp_k[kname]["unmasked"]["library_ms"],
            "cp_max_abs_err": cp_k[kname]["unmasked"]["max_abs_err"],
            "cp_causal_ms": cp_k[kname]["causal"]["ms"],
            "cp_causal_bound_ms": cp_k[kname]["causal"]["bound_ms"],
            # the MoE bench row (phase 58): the default row's launches in
            # its timed steps, 4 layers x 5 steps
            "moe_launches": moe[MOE_DEFAULT_ROW]["launches"][kname],
            "pp_launches": pp_launches[FLASH_IDS[kname]],
            "moe_max_abs_err": moe["flash_errs"][kname],
            # the LM gang of pods (phase 65): each pod's launches, float32
            "gang_launches": [n[kname] for n in gang_lm["launches"]],
            # data x tensor x context parallelism: each rank's launches
            # in the flagship's tp 2 x cp 2 gang (phase 67) and in the
            # float32 dp 2 x tp 2 x cp 2 gang of eight (phase 66), ring
            # then Ulysses
            "cp3d_launches": [n[kname] for n in flag_3d["launches"]["ring"]],
            "cp3d_ulysses_launches": [
                n[kname] for n in flag_3d["launches"]["ulysses"]],
            "cp3d_small_launches": [n[kname] for n in small_3d["ring"]],
            "cp3d_small_ulysses_launches": [
                n[kname] for n in small_3d["ulysses"]],
            # ZeRO-1 at the flagship's width (phase 68): each rank's
            # launches in the ZeRO-1 run
            "zero1_launches": [n[kname] for n in zero1["launches"]["zero1"]],
        })
    # the card and its power limit again beside the results, where the
    # end of a long output still holds them
    log(smi)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
