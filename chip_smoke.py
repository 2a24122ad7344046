#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``chainermn_tpu_torch``) on one card.

    python3 chip_smoke.py

Phases, each printing one JSON line:

1. device: the card's name and power limit (``nvidia-smi``), and the
   kernels built from ``chainermn_tpu_torch/csrc`` (build seconds,
   registers and spill bytes per kernel instantiation from ptxas, and per
   Hopper instantiation the counts of ``HGMMA`` (wgmma) and ``UTMALDG``
   (TMA tile loads) in the library's SASS, which every bf16 forward and
   backward instantiation must have);
2. kernel check: the flash kernel against its plain PyTorch version on
   the card (bf16 causal at B 1, H 12, D 64, T in {16, 128, 200, 1024},
   one non-causal and one fp32 case),
   and times of the kernel (per call, on
   the device, and the host's cost of one launch), the plain version and
   ``torch.nn.functional.scaled_dot_product_attention`` (per call and its
   kernels' device time; timed as a yardstick only, the port never calls
   it) at T in {128, 256, 512, 1024};
3. serving: a GPT-2-small-class ``TransformerLM`` (vocab 32768, d 768,
   12 heads of 64, 12 layers, random weights from seed 0, bf16) served by
   ``ServingEngine`` (512 pages of 16, batch 8, context 1024): 16 chat
   requests from 4 tenants (a fixed 64-token system prompt per tenant
   ahead of a random tail, 80-900 prompt tokens, 32 new tokens each);
   the kernel's launch count is read around this run alone; then the
   first 8 of the requests again under the profiler (``serving_profile``);
4. decode parity: prefill plus 8 decode steps through the engine's
   programs against the one-shot forward, within the bf16 band;
5. kernel check, training: the lse forward, the delta pass and the fused
   backward against their plain versions (the backward also against torch
   autograd through ``xla_attention``, and its dq epilogue bitwise against
   the scale and cast of its fp32 accumulator) at bf16 causal B 2, H 12,
   D 64, T in {1, 16, 200, 1024}, non-causal Tq 128 / Tk 200, D 128, fp32,
   a non-zero lse cotangent, and at the training shape (B 8, T 1024) on
   q/k/v sliced out of one projection with a transposed cotangent, as the
   model hands them over; then times of both kernels there (per call,
   device, the whole call's device time ``call_device_ms``: for the
   backward the delta pass, kernel and epilogue; host cost per launch), of
   their plain versions and of SDPA's forward and backward (per call and
   device; yardsticks only);
6. kernel check, split backward (``kernel_check_split``): the dq and dk/dv
   kernels against their plain versions, against torch autograd through
   ``xla_attention`` and against the fused kernel, on the cases of phase
   5 and at scales 0, -0.125 and 0.0625; then their times, the device
   time of the whole split backward call (delta pass and both passes) and
   each of its device ops by name (``ops_us``), their plain versions'
   times, SDPA's backward (the pair's yardstick) and their bounds at the
   training shape;
7. train: the same model (bf16, Adam alpha 3e-4) trained through
   ``Trainer`` -> ``StandardUpdater`` -> ``Adam.update`` on a
   ``SerialIterator`` of 16 random token rows (batch 8 x T 1024): step
   time, tokens/s, MFU, losses, peak memory and the kernels' launch
   counts, read around this run alone (12 lse forwards, 12 delta passes
   and 12 fused backwards per step); one no-grad eval forward; then 3
   steps under the profiler (``train_profile``);
8. train_dp: the same model and data trained data-parallel, as ChainerMN
   does: ``create_communicator("pure_nccl", allreduce_grad_dtype=
   "bfloat16")`` over NCCL in a world of one process (one card), then
   ``bcast_data``, ``scatter_dataset`` and ``Trainer`` ->
   ``StandardUpdater`` -> ``create_multi_node_optimizer(Adam)``, with the
   backward on the split kernels (``_FLASH_BWD = "split"`` for this phase
   only): step time, tokens/s, MFU, losses, peak memory, launches (12 lse
   forwards, 12 delta passes, 12 dq and 12 dk/dv passes per step) and the
   gradient
   allreduces (one flat bf16 bucket per step); then 3 profiled steps
   (``train_dp_profile``); the process group is torn down after it;
9. train parity: one step of a small fp32 model (2 layers, d 256, 4 heads
   of 64, T 256) through the kernels against the same step with attention
   forced through ``xla_attention``: the loss and every gradient;
10. train_dp_parity, on that small model: (a) a world-of-one DP step with
    a lossless wire leaves every parameter bitwise equal to the
    single-card Adam step, (b) the bf16 wire leaves each gradient equal to
    the fp32 one rounded to bf16 and back, bitwise, (c) the DP step
    through the split kernels matches the step through ``xla_attention``
    within the parity tolerance.

11. train_resnet: bench.py's flagship, ``Classifier(ResNet50(n_classes=
    1000, compute_dtype=torch.bfloat16, seed=0, layout="NHWC"))`` trained
    data-parallel through ``Trainer`` -> ``StandardUpdater`` ->
    ``create_multi_node_optimizer(MomentumSGD(lr=0.1, momentum=0.9))``
    over ``create_communicator("pure_nccl", allreduce_grad_dtype=
    "bfloat16")`` (a world of one NCCL process, one flat bucket), batch
    64 of 224 x 224 x 3 NHWC fp32 N(0, 1) images and random labels from
    numpy seed 0 (bench.py's data, two batches repeated), 12 steps of
    which 2 warm up: images/s per card, MFU (bench.py's 12.3 GFLOP per
    image), losses (finite), peak memory, the gradient allreduces (one
    per step) and the bucket's bytes, and the cuDNN autotuner flag it ran
    with (the package sets none); the flash kernels' counts stay 0; then
    the same steps with ``cudnn.benchmark`` on (``train_resnet_cudnn_
    benchmark``), and 3 profiled steps (``train_resnet_profile``: device
    busy and idle share, the top device ops, their time by class --
    convolution, elementwise, reduction, host copies, optimizer -- and
    any cuDNN layout conversion), and ``train_resnet_parts``: the device
    time of one step's gradient exchange and of its update, each timed
    alone by CUDA events while a spin kernel holds the queue back
    (``queued_device_ms``);
12. resnet_parity: the CPU tests' small fp32 ResNet (one block per stage,
    16 x 16, batch 8, NHWC) with TF32 off: (a) a world-of-one DP step is
    bitwise the single-card step (``cudnn.deterministic`` on for this
    check), (b) 3 DP steps on the card match the same steps on the CPU;
13. train_resnet_db, train_resnet_rs, train_resnet_zero: ``train_resnet``'s
    step with only the exchange changed -- ``double_buffering=True``,
    ``exchange="reduce_scatter"``, ``zero_sharding=True`` -- each run
    once, in turns around a second run of the plain exchange
    (``train_resnet_plain``), each with
    images/s, MFU, losses, peak memory and the collectives, 3 profiled
    steps (device idle share), the device time of the exchange and of
    the update (the sharded ones: chunk rule, all-gather and unpack),
    and ``train_resnet``'s numbers from this call beside them; the
    double-buffered one also lists the streams its NCCL kernels and its
    compute kernels ran on;
14. exchange_parity: the small fp32 ResNet of phase 12 with each exchange:
    (a) at a world of one the reduce-scatter and ZeRO runs are bitwise
    the plain DP run and the double-buffered run's parameters after
    step 2 are bitwise the plain run's after step 1
    (``cudnn.deterministic`` on), (b) each exchange's 3 steps on the card
    match the same exchange's 3 steps on the CPU (a gloo group beside
    the NCCL world) within phase 12's tolerances;
15. train_mnist: ``python -m chainermn_tpu_torch.examples.train_mnist``'s
    trainer at its defaults (-b 100 -u 100, synthetic MNIST 6000/1000)
    for 2 epochs with a snapshot after epoch 1; a fresh trainer loads
    that snapshot and runs epoch 2, whose log entry must equal the
    uninterrupted run's (bitwise); the wall time per epoch and the last
    log entry;
16. train_mnist_dp: the data-parallel twin's trainer (NCCL, a world of
    one) with ``create_multi_node_evaluator`` and an
    ``ObservationAggregator`` for 1 epoch; its last log entry;
17. train_imagenet: the ImageNet twin's trainer (``chainermn_tpu_torch.
    examples.train_imagenet.make_trainer``) for AlexNet, NIN, VGG16 and
    GoogLeNet at the example's defaults (224 x 224, 1000 classes, batch
    32 per card, lr 0.01, thread loader and device prefetch, pure_nccl
    with the bf16 wire in a world of one), fp32 under PyTorch's TF32
    defaults (printed), 12 timed iterations (2 warm up) and 3 profiled
    over 512 images: images/s, MFU against the TF32 peak with the
    training flops per image counted from the layer shapes, device idle
    share, peak memory, device time by op class, losses (finite);
18. train_imagenet_pipeline: ``train_resnet``'s model through the twin
    (batch 64, NHWC bf16) with ``--uint8-input --device-prefetch 2``
    under each of ``--loader thread``, ``native`` and ``multiprocess``,
    then ``--fused 4``: images/s, idle share, the bytes copied to the
    card a step and whether a pageable copy is left in the profile,
    beside ``train_resnet``'s reading from this call;
19. resnet_remat: ``train_resnet``'s model with ``remat`` off and on in
    turns (step time, peak memory, device busy per step); then the small
    fp32 ResNet with and without remat, losses, parameters and running
    statistics within 1e-5 relative, and a finetune batch norm's ``N``
    moved once a step;
20. convnet_parity: each convnet small (10 classes, batch 2) on the card
    against the CPU under ``train=False``, TF32 off; then 3 training
    steps on the card twice from one seed (bitwise equal losses, dropout
    live);
21. train_resnet_hier, _hier_rs, _hier_db, _q_int8, _hier_rs_fp8:
    ``train_resnet``'s step through ``create_communicator("hierarchical",
    allreduce_grad_dtype={"dcn": "bfloat16"})`` (plain, with
    ``exchange="reduce_scatter"``, with ``double_buffering=True``),
    through ``create_communicator("pure_nccl", allreduce_grad_dtype=
    "int8")`` and through ``"hierarchical"`` with ``{"dcn":
    "float8_e4m3"}`` and the reduce-scatter update, in turns with a
    second reading of the plain bf16 exchange (``train_resnet_plain``).
    A world of one: a 1 x 1 split on two NCCL subgroups of one rank, so
    the rows show the device cost of the pack, pad, cast, quantize,
    dequantize and residual at full width, not a wire.  Each row:
    images/s, MFU, idle share, peak memory, the residual's bytes, the
    exchange's and the update's device ms, the collectives by hop (one of
    each per step), the split, and the per-rank wire bytes by hop for
    this world and for an illustrative 4 x 8 split (accounting, not a
    measurement);
22. train_imagenet_hier: the ImageNet twin with ``--arch resnet50 -c
    hierarchical`` (its default bf16 wire on both hops) at phase 18's
    settings, beside phase 18's thread-loader reading;
23. hier_parity: the small fp32 ResNet of phase 12, TF32 off: (1) at a
    world of one the hierarchical exchange and its reduce-scatter update
    bitwise the plain DP step and the reduce-scatter step
    (``cudnn.deterministic`` on); (2) ``quantize_symmetric``,
    ``quantize_with_feedback`` and ``dequantize_sum`` on the card bitwise
    the CPU's (a gradient buffer per wire, all-zero buffers, +-inf and
    NaN); (3) over 3 int8 steps the applied means plus the final residual
    equal the true gradients' sum per element within fp32 rounding; (4)
    each of phase 21's exchanges, 3 steps on the card against the same on
    the CPU (a gloo group beside the NCCL world) within phase 12's
    tolerances; then the int8 wire's device cost at ResNet-50's 25.6 M
    parameters beside an fp32 copy of them.  The flash kernels' counts
    stay 0 in phases 21-23;
24-27. train_resnet_striped, _striped_rs, _striped_db_dcn,
    _striped_q_int8: ``train_resnet``'s step through
    ``create_communicator("hierarchical", stripe_ratio=0.25,
    allreduce_grad_dtype={"dcn": "bfloat16"})`` (the allreduce exchange,
    ``exchange="reduce_scatter"``, ``double_buffering="dcn"``) and with
    ``{"dcn": "int8"}``: a 1 x 1 split on two pairs of NCCL subgroups.
    Each row: images/s, idle share, peak memory, the exchange's (and the
    update's) device ms, each striped op's count a step (one each), the
    sharded update's ``{"ici", "dcn"}`` state sizes, the stale DCN
    buffer's bytes (4 x ``grad_dcn_stale_len``), the residual's (4 x
    ``grad_residual_len``), and from one step profiled under
    ``CHAINERMN_TPU_TRACE=full`` the streams each path's kernels and
    copies ran on (one side stream per path, two distinct, neither the
    step's own, or the phase fails) and how long the two paths' device
    intervals overlapped;
28. train_resnet_traced: ``train_resnet`` on that striped communicator
    untraced and with ``CHAINERMN_TPU_TRACE=events`` in turns: images/s
    of each, the trainer's shard valid with one ``train/optimizer_update``,
    ``train/input_stall``, step phase span and its device twin per
    iteration, the exchange span tagged with the planned payload; then
    one step under
    ``full`` in the profiler: the device work inside the
    ``train.grad_exchange.bucket*`` ranges (some, or the phase fails);
29. striped_parity: the small fp32 ResNet of phase 12, TF32 off: (1) at a
    world of one, ratio 0 bitwise the hierarchical exchange and its
    reduce-scatter update, ratios 1 and 0.25 (both flavors) bitwise the
    plain DP step; (2) each exchange of phases 24-27, 3 steps on the card
    against the same on the CPU within phase 12's tolerances.  The flash
    kernels' counts stay 0 in phases 24-29.
30. autotune: startup tuning (``create_communicator(..., autotune=True)``)
    on a flat communicator and on a 1 x 1 hierarchical one (every hop of
    size 1: the plan, its fallback notes, its fingerprint and the seconds
    ``measure_fabric`` took); a recorded plan dict equal to the hand knobs
    gives the small fp32 ResNet of phase 12 bitwise the hand-knobbed
    communicator's 3 steps; ``create_multi_node_optimizer(...,
    autotune=3)`` on ``train_resnet``'s step under
    ``CHAINERMN_TPU_TRACE=events`` re-tunes after 3 updates from the
    card's own ``train/grad_exchange`` spans (what it measured for the
    ``world`` hop, the plan it derived), with the tuned step's images/s
    beside ``train_resnet``'s;
31. seq2seq_dp: BASELINE config #3 at the width of Chainer's
    ``examples/seq2seq`` (3 LSTM layers of 1024 units, vocabularies of
    40,000, sentences of up to 50 tokens from
    ``make_synthetic_translation_data``, random weights from seed 0, fp32)
    through ``create_multi_node_optimizer(Adam(), comm,
    double_buffering=True)`` and ``Trainer``, batch 64, 12 steps (2 warm
    up) over 2 batches: sentences/s, target tokens/s, losses (falling),
    peak memory, then 3 profiled steps (idle share, top device ops) and
    greedy ``translate`` of 8 sentences (tokens/s);
32. seq2seq_mp: BASELINE config #4 in a world of one:
    ``ModelParallelSeq2seq(rank_encoder=0, rank_decoder=0)`` at phase 31's
    width (the encoder-decoder edge a self-edge): its loss and gradients
    on one batch against ``Seq2seq``'s on the same weights, then 12 steps
    of plain ``Adam`` on each in turns (mp, plain, plain, mp; steps/s
    beside phase 31's); ``gpipe_apply`` and
    ``one_f_one_b`` at S = 1 with 4 microbatches over a 3-layer stage
    stack against the plain microbatched step;
33. model_parallel_parity: a small fp32 seq2seq (the CPU tests') through
    ``ModelParallelSeq2seq`` and the split MLP of the model-parallel MNIST
    twin, 3 Adam steps on the card against the same on the CPU (a gloo
    group beside the NCCL world) within the CPU tests' tolerance.  The
    flash kernels' counts stay 0 in phases 30-33.
34. train_dcgan: BASELINE config #5 at the width of Chainer's
    ``examples/dcgan`` (``Generator(n_hidden=100, ch=512)``, 3,599,363
    parameters, and ``Discriminator(ch=512)``, 2,660,097; fp32, TF32 off)
    on batch 50 of synthetic CIFAR-10 (``get_cifar10(withlabel=False)``)
    through ``create_multi_node_optimizer(Adam(alpha=2e-4, beta1=0.5))``
    for each net over ``create_communicator("pure_nccl")`` (a world of
    one) and ``Trainer`` -> ``DCGANUpdater``, 12 iterations (2 warm up)
    over 2 batches: images/s, iterations/s, MFU against the fp32 peak
    (``dcgan_flops_per_image``), the two losses, peak memory, the
    gradient allreduces (two an iteration); then 3 profiled iterations
    (``train_dcgan_profile``: idle share, device time by op class);
35. dcgan_checkpoint: the multi-node checkpointer at that width: a
    snapshot after iterations 2 and 4 (bytes on disk and uncompressed,
    each save's ms), ``_scan`` with ``_verify`` of the 2, the consensus
    ``maybe_load`` of a new trainer and 4 more iterations bitwise the
    uninterrupted 8 (``cudnn.deterministic`` on, the noise drawn per
    iteration from a seed: the snapshot carries no noise key); a flipped
    byte in the newest snapshot makes the consensus fall back to the one
    before; the same resume through the per-rank DCP sibling
    (``create_multi_node_orbax_checkpointer``), bitwise, with its bytes
    and times;
36. train_dcgan_twin: ``python -m chainermn_tpu_torch.examples.
    train_dcgan --device cuda`` at its defaults for 1 epoch, then for 2
    into the same ``-o``: the second prints ``resumed from iteration
    32``;
37. dcgan_parity: the CPU tests' small DCGAN (n_hidden 16, ch 32, batch
    8), TF32 off: (a) a world-of-one DP iteration bitwise the plain
    ``Adam`` iteration (``cudnn.deterministic`` on); (b) 3 iterations on
    the card against the CPU within ``DCGAN_PARITY_TOL``.  The flash
    kernels' counts stay 0 in phases 34-37, whose seconds are printed
    together (``dcgan_phases``);
38. train_sp: the LM of phase 7 (``MODEL``, bf16, batch 8 x T 1024, Adam
    alpha 3e-4 through ``create_multi_node_optimizer`` over NCCL in a
    world of one) without sequence parallelism, then through
    ``TransformerLM(sp_comm=..., sp_mode=...)`` for ``ring`` (one
    diagonal block), ``zigzag`` (three half-blocks merged) and
    ``ulysses`` (an identity all-to-all), 6 steps each on the same seeded
    weights (checked bitwise) and batches, then 2 profiled: step ms,
    tokens/s, MFU, idle share, peak memory, launches (12 lse forwards,
    backwards and delta passes a step, 36 for zigzag; the no-grad forward
    0), each mode's losses against the non-SP run's, and its first step
    on the first batch (last hidden states and every gradient) against
    the non-SP model's;
39. ring_replay: a 4-rank ring over one sequence (B 2, H 12, D 64, T
    4096: chunks of 1024, half-chunks of 512; bf16, causal) replayed in
    one process (``parallel.ring_attention._ring_replay``: every rank's
    chunk against every step's KV chunk, merged), for the naive and
    zigzag schedules, with the fused and then the split backward, and
    one ``_FlashDiff`` call over the whole sequence: out, dq, dk, dv
    against the plain attention on the card (fp32, autograd) in segments
    of 512 rows, each in the 2-norm relative to its own, and the
    launches; then
    each branch's kernels at its chunk shapes (device us of the lse
    forward, the fused backward, the dq and dk/dv passes, each beside its
    bound, timed after phase 6: late profiles miss launches);
40. train_moe: bench.py's MoE vertical (``MoETransformerLM(32768, d 512,
    8 heads, 6 layers, T 512, capacity factor 1.25, top-1, bf16)``,
    batch 8, Adam alpha 3e-4 through the multi-node optimizer) on the
    dispatch route over NCCL in a world of one (one expert), 8 steps then
    2 profiled: tokens/s, MFU, idle share, peak memory, ``moe_aux`` (1)
    and ``moe_dropped`` (0) each step, the all-to-alls and the
    attention's launches;
41. sp_moe_parity: the CPU tests' small models at head width 64, fp32,
    TF32 off: the SP LM in each mode, the MoE LM's dispatch and its dense
    route with 4 experts, 3 SGD steps on the card against the CPU (a gloo
    group beside the NCCL world) within ``SP_PARITY_TOL``.  The seconds
    of phases 38-41 are printed together (``sp_moe_phases``), and the
    script's (``total``) after them.

Right after phase 4, on its model (the serving options; their seconds
printed together as ``a13a_phases``), each serving row with tokens/s,
wall, the engine's counters, B3's launches, the gaps between a request's
tokens (p50, p99) and the token agreement with phase 3's streams (bf16
flips near-ties: reported, not gated):

44. serving_chunked: phase 3's load with ``chunk_tokens=256``; B3 launches
    exactly 12 a full prefill (chunks launch none);
45. serving_spec: the load with ``spec_k=4`` and the n-gram self-draft:
    acceptance, tokens a verify dispatch, ``ngram_propose``'s host ms a
    window; ``spec_emitted`` is the generated tokens less one first
    token an admission;
46. serving_spec_draft_chunked: ``spec_k=4`` with the model as its own
    draft, and ``chunk_tokens=256``: B3 launches 12 a full prefill plus
    12 an admission (the draft's prefill, never chunked);
47. spec_verify_parity: one ``spec_verify_program`` over 5 tokens after a
    100-token prefill against 5 ``decode_program`` steps, and a 900-token
    prompt in chunks of 256 against the one-shot flash prefill: the
    logits within ``BF16_BAND``.

Then, on the same model and load (their seconds printed together as
``a13b_phases``):

48. serving_disagg: phase 3's load with ``disagg=True``: the prefill
    device is the same card, the scratch pool its own allocation and a
    ship a device copy.  Gates: every token stream equal to phase 3's
    (the same kernel, shapes and weights write the same bytes into the
    scratch pages), B3's launches equal to phase 3's, one ship a full
    prefill, ``transferred_page_bytes`` the sum over the ships of their
    bucketed page count times 12 layers times a page's K and V; then one
    ship of each block size timed on the device beside its copy bound
    (its bytes read and written at the HBM rate);
49. serving_disagg_chunked: phase 44's options with ``disagg=True``: a
    prefix-miss chunk stream runs on the scratch pool and ships after its
    last chunk, a second one waits at admission (``deferred_admissions``).
    Gates: B3's launches equal to phase 44's, one ship a one-shot prefill
    and one a completed chunked miss, at its last chunk; at the program
    level (``disagg_chunk_parity``) a 900-token prompt's chunks on a
    scratch pool, shipped, bitwise the same chunks run on a decode pool
    (pages and logits).  The deferral changes the schedule: a miss that
    waits is admitted after its tenant's provider has registered the
    system prompt, a prefix hit that chunks only its suffix, and the
    decode batches differ.  So the chunk counters are printed beside
    phase 44's, and a stream may part from phase 44's only where bf16 can
    flip a greedy token: at a top-two gap of the one-shot logits within
    ``FLIP_BAND``, a few bf16 ulps of the top logit (gated);
50. serving_tp: phase 3's load with ``tp=1`` over a world-of-one NCCL
    communicator (NCCL cannot put two ranks on one card): the
    tensor-parallel path (the head slice, one all-gather of the attention
    output a layer, one token broadcast a dispatch) at a group of one.
    Gates: the streams equal to phase 3's, the all-gathers counted (12 a
    dispatch), B3's launches equal to phase 3's; the gathers' and the
    broadcast's host and device milliseconds a dispatch.

Then the serving fleet, on the same model and load (its seconds printed
as ``a13c_phases``); each replica or joiner an engine with phase 3's
options over a full-width model of its own (a copy of phase 3's, or a
cold one from seed 123):

51. serving_fleet: phase 3's load routed over a ``ReplicaFleet`` of two
    replicas, replica 1 killed at its 4th decode step and the fleet
    drained.  Gates: every request completes once, one shed, the
    reroutes equal to what replica 1 held (its ledger entries and its
    engine's queued and running requests, read as it is shed), the
    survivors' pools returned, B3 at 12 launches a flash prefill of the
    replicas, and every stream equal to phase 3's or parting from it at
    a top-two gap within ``FLIP_BAND`` (the replicas' batches and a
    replay's one-shot prefill over folded tokens are another schedule).
    Prints tokens/s, the detection seconds, the router's spills and the
    token gaps (p50, p99) of the rerouted requests beside the others'.
    Then ``serving_fleet_join``: a cold replica joins (tree sync, then
    ``warmup``): one round of exactly the payload's bytes, its weights
    bitwise replica 0's; then 8 requests more, placed on it among others,
    complete, B3 exact, streams as above;
52. serving_capacity: the JAX bench's diurnal arc on one card: a fleet
    of one replica under ``QueueDepthScalePolicy`` (``CAPACITY_POLICY``)
    and a ``CapacityBroker`` over a ``LocalTrainGroup`` of two, its
    converting rank served by a cold engine; phase 3's 16 requests at
    once, each step's decision applied, and on the conversion the same
    16 prompts again over both replicas.  Gates: one convert of rank 1
    then one retire, the joiner bitwise the root after the sync, every
    request once, the training view (0, 1), the live fleet [0], the
    journal empty and ``chainermn_tpu_role_world_size`` 2 and 1 at the
    end, the pools returned, B3 exact, streams as above.  Prints the
    conversion and sync seconds and tokens/s.
53. train_resnet_files (after phase 20): ``train_resnet``'s model
    (on-device normalization of uint8 pixels) fed from 384 seeded uint8
    CHW 224^2 ``.npy`` files and a ``<path> <label>`` list through
    ``LabeledImageDataset`` -> ``scatter_dataset`` ->
    ``MultithreadIterator`` (4 reader threads) -> the device-feed stage,
    6 steps of 64, then 3 profiled; then the same run fed the same arrays
    from memory.  cuDNN deterministic in both: the losses must be
    bitwise equal.  Prints images/s beside ``train_resnet``'s, the
    host's read milliseconds a batch and the card's idle share;
54. surface_parity: every function and link of the port's last slice
    (the rest of ``F``, ``DepthwiseConvolution2D``, ``GroupNormalization``,
    ``Highway``, ``Maxout``, ``Scale`` and a ``Sequential`` of four
    layers), forward and backward in fp32 with TF32 off, on the card
    against the CPU on the same inputs at ResNet-50's stage-1 output at
    batch 8 ([8, 256, 56, 56]; [8, 2048] for the losses, ``Highway`` and
    ``Maxout``), each within ``SURFACE_TOL``; prints the count checked;
55. dlpack_bridge: one 64 x 3 x 224 x 224 uint8 batch to the card through
    ``utils.dlpack.from_numpy`` and back through ``to_numpy``, bitwise,
    with its bytes and the median microseconds each way;
56. trace_merge (after phase 28): ``train_resnet_traced``'s two traced
    shards merged by the port's ``tools/trace_merge.py`` (its command's
    ``main``, in this process, which imports no JAX): the merged file
    validates and keeps every event but the copies one shard repeats of
    the other's and the span ends its balance repair drops or adds.
    ``a14_phases`` prints the seconds of phases 53-56.
    None of them launches a flash kernel.

Then the kernels line (launches, error, times, the whole call's device
time and bound of all five kernels) and, last, ``{"ok": true, "device": {...}}``.  Any failed check
exits non-zero before the last line.  Needs one CUDA card; fails without
one.
"""

import collections
import copy
import importlib
import json
import os
import re
import shutil
import subprocess
import sys
import threading
import time

import numpy as np
import torch

# H100 SXM peaks (NVIDIA data sheet, dense): bf16 tensor cores, fp32 on
# CUDA cores, HBM3 bandwidth.  The bound is the larger of bytes / rate
# and operations / peak for the inputs' type.
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
HBM_BYTES_PER_S = 3.35e12

# the kernel against its plain version: bf16 rounds p and the output at
# different points (a few bf16 ulps of |out| <= 4); fp32 only reorders sums
TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}
BF16_BAND = 0.25   # logits, paged decode vs one-shot (decode-parity suite)
# a greedy token that another schedule may flip: a top-two gap of the
# one-shot logits within a few bf16 ulps of the top logit (an ulp is 2^-6
# for |logit| in [2, 4), 2^-5 in [4, 8)); the flips measured on an H100
# read 0.016-0.031 (PERF.md)
FLIP_BAND = 0.0625
# backward against its plain version.  bf16: each of dq, dk, dv relative
# to its own largest |ref| (bwd_errs); both sides round p and ds to bf16
# before the dots, but dq's tiles add in another order and a last-bit
# difference of an fp32 value can flip a rounding.  fp32: absolute (sum
# order, expf).
BWD_TOL = {torch.bfloat16: 5e-3, torch.float32: 2e-4}
# backward against torch autograd through xla_attention, same measure:
# autograd keeps ds in fp32 where the kernel (as the JAX kernel) casts it
# to bf16 before the dk and dq dots, a difference that sums over the keys
LSE_TOL = 1e-4     # lse is fp32 on both sides: log of a sum in another order
# the delta pass: fp32 rowsums of D products of order 1 on both sides, in
# another order (|delta| < 64, a few fp32 ulps)
DELTA_TOL = 1e-4
AUTOGRAD_TOL = {torch.bfloat16: 2e-2, torch.float32: 2e-4}
# training parity, fp32 model: loss absolute, gradients relative to each
# parameter's largest |grad| (summation order and expf through 2 layers)
PARITY_TOL = {"loss": 1e-5, "grad": 1e-4}

MODEL = dict(n_vocab=32768, d_model=768, n_heads=12, n_layers=12,
             max_len=1024, seed=0)
ENGINE = dict(num_pages=512, page_size=16, max_batch=8, max_context=1024)
N_REQUESTS, N_TENANTS, SYS_PROMPT, MAX_NEW = 16, 4, 64, 32
# serving_profile profiles the first 8 of those requests (a full batch):
# the profiler's trace of all 16 took 47 s of the script's time
N_PROFILED_REQUESTS = 8
# training: bench.py's transformer configuration (batch 8 x T 1024, Adam
# alpha 3e-4); 2 warm-up steps, then the timed ones
TRAIN_BATCH, TRAIN_ROWS, TRAIN_STEPS, TRAIN_WARMUP = 8, 16, 10, 2
# ResNet-50: bench.py's flagship (BENCH_MODEL=resnet50: bs 64 per chip,
# 224^2, NHWC, bf16, MomentumSGD lr 0.1 momentum 0.9), cut to 12 steps (2
# warm-up) over 2 batches
RESNET = dict(n_classes=1000, seed=0, layout="NHWC")
RESNET_BATCH, RESNET_IMAGE, RESNET_STEPS, RESNET_WARMUP = 64, 224, 12, 2
# resnet_parity: the CPU tests' small fp32 ResNet.  The card and the CPU
# sum convolutions and batch moments in other orders; a ReLU kink crossed
# on one side only moves a few weights (tests/test_torch_resnet.py), so
# lr 1e-3 and: losses 1e-4 relative, parameters and statistics 1e-3
RESNET_PARITY = dict(blocks=[1, 1, 1, 1], n_classes=10, batch=8, size=16,
                     lr=1e-3)
RESNET_PARITY_TOL = {"loss_rel": 1e-4, "state_abs": 1e-3}
# seq2seq (BASELINE configs #3 and #4): Chainer's examples/seq2seq width
# (3 layers of 1024 units), the WMT'15 En-Fr vocabularies of 40,000 that
# its preprocessing keeps, sentences of up to 50 tokens, batch 64 a rank;
# 12 steps (2 warm up) over 2 batches, fp32
SEQ2SEQ = dict(n_source_vocab=40000, n_target_vocab=40000, n_units=1024,
               n_layers=3, seed=0)
SEQ2SEQ_BATCH, SEQ2SEQ_LEN, SEQ2SEQ_STEPS, SEQ2SEQ_WARMUP = 64, 50, 12, 2
# the one-batch loss and gradients of ModelParallelSeq2seq (a self-edge)
# against Seq2seq: the same operations in the same order, plus a zero and
# a one-rank mean; 1e-6 relative if they are not bitwise
SEQ2SEQ_MP_TOL = 1e-6
# the pipelines at S = 1 against the plain microbatched step: per
# microbatch means averaged in another order, fp32
PIPELINE_TOL = 1e-5
# the small models of the CPU tests (tests/test_torch_model_parallel.py),
# the card against the CPU: 3 Adam steps, 2e-5 absolute (its tolerance)
SMALL_SEQ2SEQ = dict(n_source_vocab=40, n_target_vocab=40, n_units=16,
                     n_layers=2, seed=0)
MP_PARITY_TOL = 2e-5
# DCGAN (BASELINE config #5): Chainer's examples/dcgan width (net.py ch
# 512, bottom width 4; train_dcgan.py --n_hidden 100 --batchsize 50),
# which ChainerMN's examples/dcgan uses; 12 iterations (2 warm up) over 2
# batches of synthetic CIFAR-10, fp32, TF32 off as main() sets it
DCGAN = dict(n_hidden=100, ch=512)
DCGAN_BATCH, DCGAN_STEPS, DCGAN_WARMUP = 50, 12, 2
# the bitwise resume: 8 iterations against 4 (a snapshot every 2), a
# consensus load and 4
DCGAN_RESUME_STEPS, DCGAN_SAVE_EVERY = 8, 2
# the CPU tests' small DCGAN; the card against the CPU over 3 Adam(2e-4,
# beta1 0.5) iterations: the discriminator's first loss comes before any
# update (1e-5); one Adam step moves a weight by at most alpha, and a
# gradient at the rounding-noise level (the biases ahead of a batch
# normalization have an exact gradient of 0) picks its direction, so
# parameters, moments and running statistics within 2 alpha a step and
# the later losses 1e-4 relative
DCGAN_SMALL = dict(n_hidden=16, ch=32)
DCGAN_SMALL_BATCH, DCGAN_ALPHA = 8, 2e-4
DCGAN_PARITY_TOL = {"first_dis_loss_rel": 1e-5, "loss_rel": 1e-4,
                    "state_abs": 3 * 2 * DCGAN_ALPHA}
# phase 30's recorded plan: the JAX autotune test's fixed measurements,
# whose plan is the hand knobs {"stripe_ratio": 0.25, "dcn": bfloat16}
AUTOTUNE_MEASUREMENTS = {
    "source": "startup", "probe_mb": 1.0, "iters": 4,
    "hops": {"ici": {"size": 4, "gbps": 3.0, "lat_us": 50.0},
             "dcn": {"size": 2, "gbps": 1.0, "lat_us": 200.0}}}


def fail(msg):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


#: the script's start: each phase row carries ``t_s``, the seconds since
T_START = time.perf_counter()


def emit(obj):
    if "phase" in obj:
        obj = {**obj, "t_s": time.perf_counter() - T_START}
    print(json.dumps(obj), flush=True)


def kernel_label(mangled):
    """A readable name for one of the library's kernel instantiations:
    ``flash_fwd_sm90_kernel<bf16,D64,BK128,lse>`` (D and key tile of the
    bf16 forward), ``flash_bwd_sm90_kernel<bf16,D64,dq>`` (the bf16
    backward, fused with dq or the dk/dv pass ``dkv``),
    ``flash_bwd_dq_sm90_kernel<bf16,D64>`` (the bf16 dq pass),
    ``flash_bwd_kernel<fp32,D64>``; other names as they are."""
    k = re.search(r"(flash_(?:fwd_sm90|fwd|bwd_sm90|bwd_dq_sm90|bwd_dq|"
                  r"bwd_dkv|bwd)_kernel)I", mangled)
    if not k:
        return mangled
    args = mangled[k.end():]
    ints = re.findall(r"Li(\d+)E", args)
    lse = ",lse" if "Lb1E" in args else ""
    if k.group(1) == "flash_fwd_sm90_kernel" and len(ints) == 2:
        return f"{k.group(1)}<bf16,D{ints[0]},BK{ints[1]}{lse}>"
    if k.group(1) == "flash_bwd_sm90_kernel" and ints:
        part = "dq" if "Lb1E" in args else "dkv"
        return f"{k.group(1)}<bf16,D{ints[0]},{part}>"
    if k.group(1) == "flash_bwd_dq_sm90_kernel" and ints:
        return f"{k.group(1)}<bf16,D{ints[0]}>"
    dtype = "bf16" if "bfloat16" in args else "fp32"
    return f"{k.group(1)}<{dtype},D{ints[0] if ints else '?'}{lse}>"


def ptxas_report(log):
    """Registers and spill bytes per kernel instantiation, from nvcc's
    ``-Xptxas -v`` output (empty when the library was built earlier)."""
    report, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = kernel_label(m.group(1))
            report[name] = {}
        elif name is not None:
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", line)
            if m:
                report[name]["spill_stores"] = int(m.group(1))
                report[name]["spill_loads"] = int(m.group(2))
            m = re.search(r"Used (\d+) registers", line)
            if m:
                report[name]["registers"] = int(m.group(1))
    return report


#: the kernels whose bf16 instantiations must run on wgmma and TMA
SM90_KERNELS = ("flash_fwd_sm90_kernel<bf16", "flash_bwd_sm90_kernel<bf16",
                "flash_bwd_dq_sm90_kernel<bf16")


def sass_counts(lib):
    """Per Hopper kernel instantiation of the built library (the bf16
    forward and backward), the counts of ``HGMMA`` (wgmma) and ``UTMALDG``
    (TMA tile load) instructions in ``cuobjdump -sass``."""
    from chainermn_tpu_torch._build import cuda_tool
    sass = subprocess.run([cuda_tool("cuobjdump"), "-sass", str(lib)],
                          capture_output=True, text=True, check=True,
                          timeout=300).stdout
    counts, name = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            label = kernel_label(m.group(1))
            name = label if label.startswith(SM90_KERNELS) else None
            if name:
                counts[name] = {"HGMMA": 0, "UTMALDG": 0}
        elif name:
            for op in ("HGMMA", "UTMALDG"):
                counts[name][op] += op in line
    return counts


def host_us(fn, n=50):
    """Host wall time of ``n`` launches enqueued without a sync, per
    launch, in microseconds: the wrapper's and the launch's cost on the
    CPU."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    per = (time.perf_counter() - t0) / n
    torch.cuda.synchronize()
    return per * 1e6


def time_ms(fn, iters=20, warmup=3):
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


#: how many of kernel_device_ms's profiles missed how many launches of
#: their kernel (``{missed: profiles}``), reported in the last row
PROFILE_MISSED = collections.Counter()


def profiled(fn):
    """``(prof, wall seconds of fn)`` with ``fn`` run under
    ``torch.profiler``."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return prof, wall


def device_profile(fn):
    """Run ``fn`` under ``torch.profiler``: wall seconds, the device's
    busy seconds (union of kernel intervals) and per-kernel device
    microseconds by name."""
    prof, wall = profiled(fn)
    busy, by_name = profile_summary(prof)
    return wall, busy, by_name


def profile_summary(prof):
    """Device busy seconds (union of kernel intervals) and per-op device
    microseconds by name, from a finished profiler."""
    spans, by_name = [], {}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        a, b = e.time_range.start, e.time_range.end
        spans.append((a, b))
        by_name[e.name] = by_name.get(e.name, 0.0) + (b - a)
    busy, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy * 1e-6, by_name


def qkv(T, dtype, seed, H=12, D=64, B=1):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return [torch.randn((B, H, T, D), generator=g, device="cuda")
            .to(dtype) for _ in range(3)]


def bound(T, dtype, causal, H=12, D=64):
    from chainermn_tpu_torch.ops.flash_attention import (attention_bytes,
                                                         attention_flops)
    itemsize = torch.finfo(dtype).bits // 8
    t_bytes = attention_bytes(1, H, T, T, D, itemsize) / HBM_BYTES_PER_S
    t_ops = attention_flops(1, H, T, T, D, causal) / PEAK_FLOPS[dtype]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


#: the profiler's names of the port's kernels, template arguments and
#: parameters stripped (``kernel_base_name``): compared whole, so that
#: PyTorch's own ``pytorch_flash::flash_fwd_kernel`` never matches
FWD_KERNEL = "(anonymous namespace)::flash_fwd_sm90_kernel"
# one bf16 body for B2 (its dq flag on) and B4's dk/dv pass (off)
BWD_KERNEL = "(anonymous namespace)::flash_bwd_sm90_kernel"
SPLIT_KERNELS = {"dq": "(anonymous namespace)::flash_bwd_dq_sm90_kernel",
                 "dkv": BWD_KERNEL}


def kernel_base_name(name):
    """``void ns::f<a, b>(args)`` -> ``ns::f``."""
    anon = "(anonymous namespace)"
    base = name.removeprefix("void ").replace(anon, "\0")
    return re.split(r"[<(]", base, maxsplit=1)[0].replace("\0", anon)


def kernel_device_ms(fn, kernel, iters=20):
    """Mean device time of one kernel alone (profiler), without the
    host-side cost of each call that the event timing includes.  ``fn``
    launches ``kernel`` once a call.  A profile can miss launches at the
    start of its window (on the H100 0-2 early in this script, up to
    every launch after phases 1-37), so the window opens with ``warm``
    more calls and the time is the mean of the kernel's last ``iters``
    events; None (not measured) when fewer were recorded."""
    warm = 4
    fn()
    prof, _ = profiled(lambda: [fn() for _ in range(warm + iters)])
    events = sorted((e.time_range.start, e.time_range.end - e.time_range.start)
                    for e in prof.events()
                    if e.device_type == torch.autograd.DeviceType.CUDA
                    and kernel_base_name(e.name) == kernel)
    PROFILE_MISSED[warm + iters - len(events)] += 1
    if len(events) < iters:
        return None
    return sum(us for _, us in events[-iters:]) / iters * 1e-3


def device_ops_us(fn, iters=20):
    """Every kernel and memset that one call of ``fn`` puts on the card:
    ``[name, device microseconds per call]`` (the mean over ``iters``
    calls, the same kind of window as ``kernel_device_ms``; names cut to
    80 characters), largest first."""
    fn()
    _, _, by_name = device_profile(lambda: [fn() for _ in range(iters)])
    return sorted(([n[:80], us / iters] for n, us in by_name.items()),
                  key=lambda kv: -kv[1])


def library_device_ms(fn, iters=20):
    """Mean device time of one library call (a yardstick): the sum of
    ``device_ops_us``; None when the profiler recorded no device event
    (not measured)."""
    us = sum(t for _, t in device_ops_us(fn, iters))
    return us * 1e-3 if us else None


def phase_kernel():
    from chainermn_tpu_torch.ops import flash_attention, xla_attention
    checks = []
    # B 1 takes 128-key tiles (PERF.md); kernel_check_train's B 8 takes 64
    for B, T, causal, dtype in [(1, 16, True, torch.bfloat16),
                                (1, 128, True, torch.bfloat16),
                                (1, 200, True, torch.bfloat16),
                                (1, 1024, True, torch.bfloat16),
                                (1, 1024, False, torch.bfloat16),
                                (1, 200, True, torch.float32)]:
        q, k, v = qkv(T, dtype, seed=T, B=B)
        out = flash_attention(q, k, v, causal=causal)
        torch.cuda.synchronize()
        ref = xla_attention(q, k, v, causal=causal)
        err = (out.float() - ref.float()).abs().max().item()
        ok = bool(torch.isfinite(out.float()).all()) and err < TOL[dtype]
        checks.append({"B": B, "T": T, "causal": causal,
                       "dtype": str(dtype), "max_abs_err": err,
                       "tol": TOL[dtype], "ok": ok})
    times = []
    for T in (128, 256, 512, 1024):
        q, k, v = qkv(T, torch.bfloat16, seed=T + 1)
        b_ms, b_by = bound(T, torch.bfloat16, True)
        kernel = lambda: flash_attention(q, k, v, causal=True)
        sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(
            q, k, v, is_causal=True)
        times.append({
            "T": T, "B": 1, "H": 12, "D": 64, "dtype": "bfloat16",
            "causal": True, "ms": time_ms(kernel),
            "plain_ms": time_ms(
                lambda: xla_attention(q, k, v, causal=True), iters=10),
            "library_ms": time_ms(sdpa),
            "device_ms": kernel_device_ms(kernel, FWD_KERNEL),
            "library_device_ms": library_device_ms(sdpa),
            "call_device_ms": library_device_ms(kernel),
            "host_us": host_us(kernel),
            "bound_ms": b_ms, "bound_by": b_by})
    emit({"phase": "kernel_check", "checks": checks, "times": times})
    bad = [c for c in checks if not c["ok"]]
    if bad:
        fail(f"flash kernel disagrees with its plain version: {bad}")
    return checks, times


def chat_requests(Request, n_vocab):
    rng = np.random.RandomState(0)
    sys_prompts = [rng.randint(0, n_vocab, SYS_PROMPT)
                   for _ in range(N_TENANTS)]
    reqs = []
    for i in range(N_REQUESTS):
        ten = rng.randint(N_TENANTS)
        tail = rng.randint(0, n_vocab, rng.randint(16, 837))
        reqs.append(Request(np.concatenate([sys_prompts[ten], tail]),
                            max_new_tokens=MAX_NEW, tenant=f"tenant{ten}",
                            request_id=i))
    return reqs


def phase_serving(model):
    """Phase 3: the chat load, then the first N_PROFILED_REQUESTS of it
    under the profiler.  Returns B3's launches and the requests' token
    streams (phases 44-46 compare theirs with them)."""
    from chainermn_tpu_torch.serving import Request
    engine, row, streams = run_serving_load("serving", model)
    if row["flash_launches"] <= 0:
        fail("serving: the flash prefill never launched")
    # where the time goes: the first N_PROFILED_REQUESTS of the load again
    # (prefix pages now cold, so every tenant's first request misses
    # again) under the profiler
    for r in chat_requests(Request, MODEL["n_vocab"])[:N_PROFILED_REQUESTS]:
        engine.submit(r)
    wall, busy, by_name = device_profile(engine.drain)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    emit({"phase": "serving_profile", "requests": N_PROFILED_REQUESTS,
          "wall_s": wall, "device_busy_s": busy,
          "device_idle_share": 1.0 - busy / wall,
          "top_kernels_us": [[name[:80], us] for name, us in top]})
    return row["flash_launches"], streams


def phase_decode_parity(model):
    from chainermn_tpu_torch.serving import (PagedKVCache, decode_program,
                                             prefill_program)
    blk = model.blocks[0].attn
    kv = PagedKVCache(MODEL["n_layers"], 64, 16, blk.n_heads, blk.d_head,
                      device="cuda")
    prompt = np.random.RandomState(1).randint(0, MODEL["n_vocab"], 100)
    bt = torch.arange(64, device="cuda")
    tokens = torch.zeros((1, 128), dtype=torch.long, device="cuda")
    tokens[0, :100] = torch.from_numpy(prompt).cuda()
    logits = prefill_program(model, kv, tokens, 100, bt)
    seq = list(prompt)
    diffs = []
    for step in range(9):
        with torch.no_grad():
            ref = model.logits(torch.tensor([seq], device="cuda"))[0, -1]
        diffs.append((logits - ref.float()).abs().max().item())
        if step == 8:
            break
        tok = int(torch.argmax(logits))
        seq.append(tok)
        logits, _ = decode_program(
            model, kv, torch.tensor([tok], device="cuda"),
            torch.tensor([len(seq) - 1], device="cuda"), bt[None],
            mode="paged")
        logits = logits[0]
    emit({"phase": "decode_parity", "max_abs_diff_per_step": diffs,
          "band": BF16_BAND})
    if not max(diffs) < BF16_BAND:
        fail(f"paged decode logits leave the bf16 band: {diffs}")


#: phases 44-47 (run after phase 4, on its model): chunks of 256 tokens (a
#: page multiple, which 15 of the 16 chat prompts exceed) and 4
#: proposals a verify step
CHUNK_TOKENS, SPEC_K = 256, 4


def token_streams(done, prompt_len):
    """Each request's generated tokens: the ones an eviction folded into
    its prompt, then the rest."""
    return {i: [int(t) for t in r.prompt[prompt_len[i]:]] + list(r.tokens)
            for i, r in done.items()}


def agreement(streams, ref):
    """Token agreement with phase 3's streams: the requests whose streams
    are equal, and the first position where each other request's
    differs.  bf16 breaks bit-identity (the verify's and the chunks'
    products have other shapes than decode's and the one-shot prefill's,
    so a top-two near-tie can flip an argmax): reported, not gated."""
    firsts = {}
    for i, want in ref.items():
        got = streams.get(i, [])
        if got != want:
            firsts[i] = next((j for j, (a, b) in enumerate(zip(got, want))
                              if a != b), min(len(got), len(want)))
    return {"requests_equal": len(ref) - len(firsts),
            "first_divergence": firsts}


def run_serving_load(name, model, ref_streams=None, extra=None, watch=None,
                     ref_name="serving", **engine_kw):
    """Phase 3's chat load through a fresh engine with ``engine_kw``, the
    launch counters read around the drain alone.  The row (with
    ``extra(engine)``'s fields, and the token agreement with
    ``ref_streams`` when given) is printed, then the gates: every request
    complete with MAX_NEW tokens in the vocabulary, the pool returned, B3
    at 12 launches a flash prefill (a draft model's included, one per
    admission; chunks launch none) and, under speculation, one first
    token an admission and every other token a verified one.
    ``watch(engine)`` runs before the drain (to wrap what the phase
    observes); ``ref_name`` names the run ``ref_streams`` came from.
    Returns ``(engine, row, streams)``."""
    from chainermn_tpu_torch.serving import Request, ServingEngine
    engine = ServingEngine(model, device="cuda", **ENGINE, **engine_kw)
    reqs = chat_requests(Request, MODEL["n_vocab"])
    prompt_len = {r.request_id: int(r.prompt.size) for r in reqs}
    for r in reqs:
        engine.submit(r)
    if watch is not None:
        watch(engine)
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    steps = engine.drain()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    done = {r.request_id: r for r in engine.completed}
    # an evicted request's early tokens were folded into its prompt
    streams = token_streams(done, prompt_len)
    generated = {i: len(t) for i, t in streams.items()}
    n_gen = sum(generated.values())
    # the gaps between a request's tokens on the engine's clock (tokens of
    # one verify window share a stamp)
    gaps = np.concatenate([np.diff(r.token_times) for r in done.values()])
    row = {"phase": name, "requests": len(done), "steps": steps,
           "generated_tokens": n_gen, "tokens_per_s": n_gen / wall,
           "wall_s": wall, "prefill_s": engine.prefill_s,
           "decode_s": engine.decode_s, "draft_s": engine.draft_s,
           "decode_steps": engine.decode_steps,
           "admissions": engine.admissions,
           "full_prefills": engine.full_prefills,
           "prefix_hits": engine.prefix_hits,
           "prefix_tokens_matched": engine.prefix_tokens_matched,
           "forks": engine.forks, "evictions": engine.evictions,
           "flash_launches": launches["fwd"],
           **{k: getattr(engine, k) for k in (
               "chunk_prefills", "chunked_admissions", "spec_steps",
               "spec_lane_steps", "spec_proposed", "spec_accepted",
               "spec_emitted", "draft_dispatches")},
           "prompt_tokens": sum(prompt_len.values()),
           "kv_pool_bytes": engine.kv.pool_bytes,
           "token_gap_ms_p50": float(np.percentile(gaps, 50)) * 1e3,
           "token_gap_ms_p99": float(np.percentile(gaps, 99)) * 1e3}
    if ref_streams is not None:
        row[f"agreement_with_{ref_name}"] = agreement(streams, ref_streams)
    if extra is not None:
        row.update(extra(engine))
    emit(row)
    if sorted(done) != list(range(N_REQUESTS)):
        fail(f"{name}: completed {sorted(done)}, expected all "
             f"{N_REQUESTS}")
    if any(n != MAX_NEW for n in generated.values()):
        fail(f"{name}: generated token counts {generated}, expected "
             f"{MAX_NEW}")
    if not all(0 <= t < MODEL["n_vocab"] for r in done.values()
               for t in r.tokens):
        fail(f"{name}: a generated token lies outside the vocabulary")
    if not engine.allocator.check() or engine.allocator.used_pages:
        fail(f"{name}: page pool not returned in full")
    n_layers = MODEL["n_layers"]
    prefills = engine.full_prefills + (
        engine.admissions if engine.draft_model is not None else 0)
    if launches != expected_launches(fwd=n_layers * prefills):
        fail(f"{name}: flash kernel launches {launches}, expected "
             f"{n_layers} x {prefills} flash prefills of the no-grad "
             f"forward")
    if engine.spec_k and engine.spec_emitted != n_gen - engine.admissions:
        fail(f"{name}: spec_emitted {engine.spec_emitted} != generated "
             f"{n_gen} - one first token for each of "
             f"{engine.admissions} admissions")
    return engine, row, streams


def phase_serving_chunked(model, ref_streams):
    """Phase 44: phase 3's load with chunked prefill (CHUNK_TOKENS).
    Returns its row and streams (phase 49 compares with them)."""
    engine, row, streams = run_serving_load(
        "serving_chunked", model, ref_streams, chunk_tokens=CHUNK_TOKENS)
    if not engine.chunked_admissions:
        fail("serving_chunked: no prompt was admitted in chunks")
    return row, streams


def spec_economics(engine):
    """Acceptance, tokens a verify dispatch (the batch's, and a lane's),
    and the host milliseconds of drafting a window (``ngram_propose``
    for the n-gram draft)."""
    steps = max(engine.spec_steps, 1)
    return {"acceptance": engine.spec_accepted
            / max(engine.spec_proposed, 1),
            "emitted_per_dispatch": engine.spec_emitted / steps,
            "emitted_per_lane_dispatch": engine.spec_emitted
            / max(engine.spec_lane_steps, 1),
            "draft_ms_per_window": engine.draft_s / steps * 1e3}


def phase_serving_spec(model, ref_streams):
    """Phase 45: phase 3's load with speculative decoding (SPEC_K) and
    the n-gram self-draft."""
    engine, _, _ = run_serving_load("serving_spec", model, ref_streams,
                                    extra=spec_economics, spec_k=SPEC_K)
    if not engine.spec_steps or engine.draft_dispatches:
        fail(f"serving_spec: {engine.spec_steps} verify steps and "
             f"{engine.draft_dispatches} draft dispatches (n-gram: none)")


def phase_serving_spec_draft_chunked(model, ref_streams):
    """Phase 46: speculation with the target as its own draft model, and
    chunked prefill: each admission runs one (unchunked) draft prefill."""
    engine, _, _ = run_serving_load(
        "serving_spec_draft_chunked", model, ref_streams,
        extra=spec_economics, spec_k=SPEC_K, draft_model=model,
        chunk_tokens=CHUNK_TOKENS)
    if not (engine.spec_steps and engine.draft_dispatches
            and engine.chunked_admissions):
        fail("serving_spec_draft_chunked: no verify step, draft dispatch "
             "or chunked admission")
    del engine
    torch.cuda.empty_cache()


def phase_spec_verify_parity(model):
    """Phase 47: (a) one prompt of 100 tokens prefilled, then one
    ``spec_verify_program`` over 5 known tokens against 5 sequential
    ``decode_program`` steps over the same tokens (two caches from one
    prefill); (b) a 900-token prompt in chunks of CHUNK_TOKENS through the
    engine's chunk program against the one-shot flash prefill: the final
    logits.  Both within ``BF16_BAND``."""
    from chainermn_tpu_torch.serving import (PagedKVCache, decode_program,
                                             prefill_program,
                                             prefix_prefill_program,
                                             spec_verify_program)
    blk = model.blocks[0].attn
    rng = np.random.RandomState(2)
    V = MODEL["n_vocab"]

    def cache():
        return PagedKVCache(MODEL["n_layers"], 64, 16, blk.n_heads,
                            blk.d_head, device="cuda")

    bt = torch.arange(64, device="cuda")
    prompt = rng.randint(0, V, 100)
    span = rng.randint(0, V, 5)
    kv_v = cache()
    tokens = torch.zeros((1, 128), dtype=torch.long, device="cuda")
    tokens[0, :100] = torch.from_numpy(prompt).cuda()
    prefill_program(model, kv_v, tokens, 100, bt)
    kv_d = cache()
    kv_d.k_store.copy_(kv_v.k_store)
    kv_d.v_store.copy_(kv_v.v_store)
    verify, _ = spec_verify_program(
        model, kv_v, torch.from_numpy(span)[None].cuda(),
        torch.tensor([100], device="cuda"),
        torch.tensor([5], device="cuda"), bt[None])
    diffs, argmax_equal = [], []
    for j, tok in enumerate(span):
        logits, nxt = decode_program(
            model, kv_d, torch.tensor([int(tok)], device="cuda"),
            torch.tensor([100 + j], device="cuda"), bt[None], mode="paged")
        diffs.append((verify[0, j] - logits[0]).abs().max().item())
        argmax_equal.append(int(torch.argmax(verify[0, j])) == int(nxt[0]))
    long_prompt = rng.randint(0, V, 900)
    kv_o, kv_c = cache(), cache()
    tokens = torch.zeros((1, 1024), dtype=torch.long, device="cuda")
    tokens[0, :900] = torch.from_numpy(long_prompt).cuda()
    oneshot = prefill_program(model, kv_o, tokens, 900, bt)
    start = 0
    while start < 900:
        n = min(CHUNK_TOKENS, 900 - start)
        chunk = torch.zeros((1, CHUNK_TOKENS), dtype=torch.long,
                            device="cuda")
        chunk[0, :n] = torch.from_numpy(long_prompt[start:start + n]).cuda()
        chunked = prefix_prefill_program(model, kv_c, chunk, n, start, bt)
        start += n
    chunk_diff = (chunked - oneshot).abs().max().item()
    emit({"phase": "spec_verify_parity",
          "verify_vs_decode_max_abs_diff": diffs,
          "chunked_vs_oneshot_max_abs_diff": chunk_diff,
          "verify_argmax_equal": argmax_equal,
          "band": BF16_BAND})
    if not (max(diffs) < BF16_BAND and chunk_diff < BF16_BAND):
        fail(f"spec_verify_parity: verify {diffs} or chunked admission "
             f"{chunk_diff} leaves the bf16 band")


#: one page's K and V at phase 3's width (16 slots x 12 heads x 64, bf16)
PAGE_BYTES = 2 * ENGINE["page_size"] * MODEL["n_heads"] \
    * (MODEL["d_model"] // MODEL["n_heads"]) * 2


def watch_ships(log):
    """A ``watch`` for :func:`run_serving_load` that wraps the engine's ship
    and chunk steps: ``log["ships"]`` gets each ship's pages, its bucketed
    block (the smallest transfer bucket that holds them) and whether a
    chunk stream's last chunk sent it; ``log["scratch_last_chunks"]``
    counts the last chunks run on the scratch pool."""
    log.update(ships=[], scratch_last_chunks=0)

    def watch(engine):
        ship, run_chunk = engine._ship_pages, engine._run_chunk

        def recorded_ship(req, L):
            n = engine.allocator.pages_for(L)
            log["ships"].append({
                "pages": n,
                "block": next(b for b in engine.transfer_buckets if b >= n),
                "chunked": req in engine.prefilling,
                "at_last_chunk": req._chunk_pos == L})
            return ship(req, L)

        def recorded_chunk(req, startp, size, final, clock):
            log["scratch_last_chunks"] += bool(final and req._chunk_scratch)
            return run_chunk(req, startp, size, final, clock)

        engine._ship_pages, engine._run_chunk = recorded_ship, recorded_chunk
    return watch


def ship_times(engine, blocks):
    """Device µs of one ship of each block size in ``blocks``: the two
    scatters of an ``nb``-page block of the scratch pool into ``nb``
    distinct pages of the decode pool (after the drain: the pool is free),
    beside its copy bound, its bytes read once and written once at the
    HBM rate."""
    from chainermn_tpu_torch.serving.kv_cache import (extract_pages,
                                                      insert_pages)
    pairs = ((engine._kv_prefill.k_store, engine.kv.k_store),
             (engine._kv_prefill.v_store, engine.kv.v_store))
    out = {}
    for nb in sorted(set(blocks)):
        rows = torch.arange(nb, device="cuda")

        def ship(nb=nb, rows=rows):
            for scratch, store in pairs:
                insert_pages(store, extract_pages(scratch, nb).to("cuda"),
                             rows)
        nbytes = nb * MODEL["n_layers"] * PAGE_BYTES
        us = time_ms(ship) * 1e3
        bound = 2 * nbytes / HBM_BYTES_PER_S * 1e6
        out[nb] = {"bytes": nbytes, "device_us": us, "bound_us": bound,
                   "x_bound": us / bound}
    return out


def check_ships(name, engine, log, one_shot):
    """The ships' gates: one a one-shot full prefill (``one_shot``), one
    a completed chunked miss at its last chunk, and
    ``transferred_page_bytes`` the blocks' pages at PAGE_BYTES a layer."""
    ships = log["ships"]
    chunked = [s for s in ships if s["chunked"]]
    want = sum(s["block"] for s in ships) * MODEL["n_layers"] * PAGE_BYTES
    if engine.transfers != len(ships) \
            or len(ships) - len(chunked) != one_shot:
        fail(f"{name}: {engine.transfers} transfers, {len(ships)} ships "
             f"({len(chunked)} chunked), expected one a full prefill "
             f"({one_shot})")
    if len(chunked) != log["scratch_last_chunks"] \
            or not all(s["at_last_chunk"] for s in chunked):
        fail(f"{name}: chunked ships {chunked}, expected one at each of "
             f"{log['scratch_last_chunks']} last chunks on the scratch pool")
    if engine.transferred_page_bytes != want:
        fail(f"{name}: transferred_page_bytes "
             f"{engine.transferred_page_bytes}, expected {want}")


def check_streams(name, streams, ref_streams, ref_name):
    if streams != ref_streams:
        fail(f"{name}: token streams differ from {ref_name}'s: "
             f"{agreement(streams, ref_streams)}")


def phase_serving_disagg(model, ref_streams, ref_launches):
    """Phase 48: phase 3's load with disaggregated prefill on the same
    card."""
    log = {}

    def ships(engine):
        times = ship_times(engine, [s["block"] for s in log["ships"]])
        return {"transfers": engine.transfers,
                "transferred_page_bytes": engine.transferred_page_bytes,
                "ship_blocks": [s["block"] for s in log["ships"]],
                "ship_device_us": times}
    engine, row, streams = run_serving_load(
        "serving_disagg", model, ref_streams, extra=ships,
        watch=watch_ships(log), disagg=True)
    check_streams("serving_disagg", streams, ref_streams, "serving")
    if row["flash_launches"] != ref_launches:
        fail(f"serving_disagg: B3 launches {row['flash_launches']}, "
             f"phase 3's {ref_launches}")
    check_ships("serving_disagg", engine, log, engine.full_prefills)


def near_tie_gaps(model, streams, ref_streams):
    """For each request whose stream parts from ``ref_streams``, the gap
    between the top two logits of the one-shot forward over its prompt
    and the reference tokens before the first difference, and the top
    logit: a greedy token that bf16 can flip sits where that gap is
    within ``FLIP_BAND``."""
    from chainermn_tpu_torch.serving import Request
    prompts = {r.request_id: [int(t) for t in r.prompt]
               for r in chat_requests(Request, MODEL["n_vocab"])}
    gaps = {}
    for i, want in ref_streams.items():
        got = streams[i]
        if got == want:
            continue
        j = next((j for j, (a, b) in enumerate(zip(got, want)) if a != b),
                 min(len(got), len(want)))
        seq = torch.tensor([prompts[i] + want[:j]], device="cuda")
        with torch.inference_mode():
            top2 = torch.topk(model.logits(seq)[0, -1].float(), 2).values
        gaps[i] = {"gap": (top2[0] - top2[1]).item(),
                   "top": top2[0].item()}
    return gaps


def disagg_chunk_parity(model):
    """The disaggregated chunk path at the program level, on the same
    shapes: a 900-token prompt in chunks of CHUNK_TOKENS through
    ``prefix_prefill_program`` against a scratch pool (the identity block
    table), its pages shipped into a decode pool at scattered page ids,
    against the same chunks run on a decode pool through those page ids.
    Returns whether the shipped pages and the last chunk's logits are
    bitwise the direct run's."""
    from chainermn_tpu_torch.serving import (PagedKVCache, insert_pages,
                                             prefix_prefill_program)
    from chainermn_tpu_torch.serving.kv_cache import extract_pages
    blk = model.blocks[0].attn
    S = ENGINE["page_size"]
    N, P, L = ENGINE["max_context"] // S, 128, 900
    used = -(-L // S)

    def cache(pages):
        return PagedKVCache(MODEL["n_layers"], pages, S, blk.n_heads,
                            blk.d_head, device="cuda")
    prompt = torch.from_numpy(
        np.random.RandomState(3).randint(0, MODEL["n_vocab"], L)).to("cuda")
    ids = torch.from_numpy(
        np.random.RandomState(4).permutation(P)[:N]).to("cuda")

    def chunks(kv, bt):
        for start in range(0, L, CHUNK_TOKENS):
            n = min(CHUNK_TOKENS, L - start)
            toks = torch.zeros((1, CHUNK_TOKENS), dtype=torch.long,
                               device="cuda")
            toks[0, :n] = prompt[start:start + n]
            logits = prefix_prefill_program(model, kv, toks, n, start, bt)
        return logits
    scratch, direct, shipped = cache(N), cache(P), cache(P)
    via_scratch = chunks(scratch, torch.arange(N, device="cuda"))
    via_pool = chunks(direct, ids)
    nb = 1 << (used - 1).bit_length()
    rows = torch.full((nb,), P, dtype=torch.long, device="cuda")
    rows[:used] = ids[:used]
    for src, dst in ((scratch.k_store, shipped.k_store),
                     (scratch.v_store, shipped.v_store)):
        insert_pages(dst, extract_pages(src, nb), rows)
    real = ids[:used]
    return {"pages_bitwise": bool(
                torch.equal(shipped.k_store[:, real], direct.k_store[:, real])
                and torch.equal(shipped.v_store[:, real],
                                direct.v_store[:, real])),
            "logits_bitwise": bool(torch.equal(via_scratch, via_pool))}


def phase_serving_disagg_chunked(model, ref_row, ref_streams):
    """Phase 49: phase 44's options (chunks of CHUNK_TOKENS) with
    disaggregated prefill."""
    log = {}
    engine, row, streams = run_serving_load(
        "serving_disagg_chunked", model, ref_streams, ref_name="chunked",
        extra=lambda e: {
            "transfers": e.transfers,
            "transferred_page_bytes": e.transferred_page_bytes,
            "deferred_admissions": e.deferred_admissions,
            "chunked_ships": sum(s["chunked"] for s in log["ships"]),
            "chunked_row": {k: ref_row[k] for k in (
                "chunk_prefills", "chunked_admissions", "prefix_hits")}},
        watch=watch_ships(log), disagg=True, chunk_tokens=CHUNK_TOKENS)
    gaps = near_tie_gaps(model, streams, ref_streams)
    parity = disagg_chunk_parity(model)
    emit({"phase": "disagg_chunk_parity", **parity,
          "near_tie_gaps": gaps, "band": FLIP_BAND})
    if not all(parity.values()):
        fail(f"serving_disagg_chunked: the scratch pool's chunks and ship "
             f"differ from the decode pool's: {parity}")
    if not all(g["gap"] < FLIP_BAND for g in gaps.values()):
        fail(f"serving_disagg_chunked: streams part from serving_chunked's "
             f"away from a near-tie: top-two gaps {gaps}")
    if row["flash_launches"] != ref_row["flash_launches"]:
        fail(f"serving_disagg_chunked: B3 launches {row['flash_launches']}, "
             f"serving_chunked's {ref_row['flash_launches']}")
    if not row["chunked_ships"]:
        fail("serving_disagg_chunked: no chunk stream ran on the scratch "
             "pool")
    check_ships("serving_disagg_chunked", engine, log, engine.full_prefills)


def phase_serving_tp(model, ref_streams, ref_launches):
    """Phase 50: phase 3's load with ``tp=1`` over a world-of-one NCCL
    communicator, each all-gather and broadcast timed on the host and by
    CUDA events around the call (the device's span from the call's start
    to its end: its kernels, and the wait for the host in between)."""
    import torch.distributed as dist
    from chainermn_tpu_torch import create_communicator
    comm = create_communicator("pure_nccl")
    timed = {"allgather": [], "bcast": []}
    for op, calls in timed.items():
        def timed_op(*args, _fn=getattr(comm, op), _calls=calls, **kw):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            t0 = time.perf_counter()
            out = _fn(*args, **kw)
            _calls.append((time.perf_counter() - t0, start, end))
            end.record()
            return out
        setattr(comm, op, timed_op)

    def costs(engine):
        torch.cuda.synchronize()
        dispatches = engine.decode_steps + engine.admissions
        out = {"dispatches": dispatches, "collectives": dict(comm.calls)}
        for op, calls in timed.items():
            out[f"{op}_host_ms_per_dispatch"] = \
                sum(c[0] for c in calls) * 1e3 / dispatches
            out[f"{op}_event_ms_per_dispatch"] = \
                sum(a.elapsed_time(b) for _, a, b in calls) / dispatches
        return out
    try:
        comm.calls.clear()
        engine, row, streams = run_serving_load(
            "serving_tp", model, ref_streams, extra=costs, tp=1,
            tp_comm=comm)
    finally:
        comm.finalize()
    check_streams("serving_tp", streams, ref_streams, "serving")
    if row["flash_launches"] != ref_launches:
        fail(f"serving_tp: B3 launches {row['flash_launches']}, phase 3's "
             f"{ref_launches}")
    want = {"allgather": MODEL["n_layers"] * row["dispatches"],
            "bcast": row["dispatches"]}
    if {k: row["collectives"].get(k, 0) for k in want} != want:
        fail(f"serving_tp: collectives {row['collectives']}, expected "
             f"{want} (one all-gather a layer and one broadcast a "
             f"dispatch)")
    if dist.is_initialized():
        fail("serving_tp: the process group outlived the phase")


def phases_a13b(model, streams, launches, chunked_row, chunked_streams):
    """Phases 48-50 against phase 3's streams and B3 launches and phase
    44's row and streams, their seconds emitted as ``a13b_phases``."""
    t0 = time.perf_counter()
    phase_serving_disagg(model, streams, launches)
    phase_serving_disagg_chunked(model, chunked_row, chunked_streams)
    phase_serving_tp(model, streams, launches)
    emit({"phase": "a13b_phases", "seconds": time.perf_counter() - t0})


#: phase 52's policy: the JAX bench's water marks, the high one cut from 8
#: to 4 because phase 3's load cannot cross 8 (its deepest tenant holds 7
#: requests, 5 still queued after the first step's 8 admissions)
CAPACITY_POLICY = dict(scale_up_depth=4, scale_down_depth=0, min_replicas=1,
                       max_replicas=2)
#: the cold joiners' weights
COLD_SEED = 123


def replica_engine(model=None, seed=COLD_SEED):
    """A full-width engine with ``ENGINE``'s options over a model of its
    own: a copy of ``model`` (the same weights), or, without one, a fresh
    ``TransformerLM`` from ``MODEL`` (bf16) with the weights of ``seed``.
    Adoption writes a joiner's weights in place, so replicas never share a
    module."""
    import copy

    from chainermn_tpu_torch.models import TransformerLM
    from chainermn_tpu_torch.serving import ServingEngine
    if model is not None:
        own = copy.deepcopy(model)
    else:
        own = TransformerLM(compute_dtype=torch.bfloat16, device="cuda",
                            **dict(MODEL, seed=seed))
    return ServingEngine(own, device="cuda", **ENGINE)


def same_weights(a, b):
    """Whether two engines' models hold bitwise the same state."""
    sa, sb = a.model.state_dict(), b.model.state_dict()
    return list(sa) == list(sb) and all(
        x.dtype == y.dtype and torch.equal(x, y)
        for x, y in zip(sa.values(), sb.values()))


def fleet_streams(fleet, prompt_len, offset=0):
    """The token streams (an eviction's and a reroute's folded tokens
    first) of the fleet's completed requests with ids ``offset`` to
    ``offset + N_REQUESTS - 1``: phase 3's requests sent again under ids
    moved by ``offset``, keyed by their phase 3 id."""
    done = {r.request_id - offset: r for r in fleet.completed
            if 0 <= r.request_id - offset < N_REQUESTS}
    return token_streams(done, prompt_len)


def gap_ms(requests):
    """The p50 and p99 gaps (ms) between consecutive tokens of
    ``requests`` on the engines' clock, or None without two tokens."""
    gaps = [np.diff(r.token_times) for r in requests
            if len(r.token_times) > 1]
    if not gaps:
        return None
    gaps = np.concatenate(gaps) * 1e3
    return [float(np.percentile(gaps, 50)), float(np.percentile(gaps, 99))]


def check_fleet_streams(name, model, streams, ref_streams):
    """Every request's stream equals phase 3's, or parts from it at a
    top-two gap within FLIP_BAND (other batches than phase 3's, and a
    replay's one-shot prefill over folded tokens).  Returns the gaps."""
    gaps = near_tie_gaps(model, streams, ref_streams)
    if not all(g["gap"] < FLIP_BAND for g in gaps.values()):
        fail(f"{name}: streams part from phase 3's away from a near-tie: "
             f"{gaps}")
    return gaps


def check_fleet_launches(name, engines, launches, before=None):
    """B3 launched 12 times a flash prefill of ``engines`` (their
    ``full_prefills`` less ``before``), and no other kernel ran."""
    prefills = sum(e.full_prefills for e in engines) - sum(
        (before or {}).get(id(e), 0) for e in engines)
    if launches != expected_launches(fwd=MODEL["n_layers"] * prefills):
        fail(f"{name}: flash kernel launches {launches}, expected "
             f"{MODEL['n_layers']} x {prefills} flash prefills")


def check_pools(name, engines):
    for e in engines:
        if not e.allocator.check() or e.allocator.used_pages:
            fail(f"{name}: a replica's page pool was not returned in full")


def phase_serving_fleet(model, ref_streams):
    """Phase 51: phase 3's load through a ReplicaFleet of two replicas,
    replica 1 killed at its 4th decode step; then a cold replica joined
    (tree sync, warm-up) and 8 requests more."""
    from chainermn_tpu_torch import observability
    from chainermn_tpu_torch.serving import ReplicaFleet, Request
    from chainermn_tpu_torch.serving.fleet import serialize_state
    observability.reset_registry()
    reqs = chat_requests(Request, MODEL["n_vocab"])
    prompts = {r.request_id: int(r.prompt.size) for r in reqs}
    fleet = ReplicaFleet(engines={0: replica_engine(model),
                                  1: replica_engine(model)})
    engines = [r.engine for r in fleet.replicas.values()]
    placed = [fleet.submit(r) for r in reqs]
    victim = fleet.replicas[1]
    victim.kill_at = 4
    held = {}
    drain_victim = victim.drain_for_reroute

    def counted(now=None):
        # what replica 1 held when it was shed, read before the drain
        eng = victim.engine
        held["ledger"] = len(fleet.router.placements(1))
        held["engine"] = (len(eng.running) + len(eng.prefilling)
                          + eng.scheduler.pending())
        return drain_victim(now=now)
    victim.drain_for_reroute = counted
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    steps = fleet.drain()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    ids = sorted(r.request_id for r in fleet.completed)
    streams = fleet_streams(fleet, prompts)
    n_gen = sum(len(t) for t in streams.values())
    rerouted = [r for r in fleet.completed if r.preemptions]
    stats = fleet.stats()
    row = {"phase": "serving_fleet", "requests": len(ids), "steps": steps,
           "placements": placed, "generated_tokens": n_gen,
           "tokens_per_s": n_gen / wall, "wall_s": wall,
           "sheds": stats["sheds"], "reroutes": stats["reroutes"],
           "held_by_replica_1": held,
           "last_detection_s": stats["last_detection_s"],
           "spills": stats["spills"], "flash_launches": launches["fwd"],
           "full_prefills": [e.full_prefills for e in engines],
           "rerouted_gap_ms_p50_p99": gap_ms(rerouted),
           "other_gap_ms_p50_p99": gap_ms(
               [r for r in fleet.completed if not r.preemptions])}
    gaps = check_fleet_streams("serving_fleet", model, streams, ref_streams)
    row["near_tie_gaps"] = gaps
    emit(row)
    if ids != list(range(N_REQUESTS)) or len(fleet.completed) != N_REQUESTS:
        fail(f"serving_fleet: completed {ids}, expected each of "
             f"{N_REQUESTS} once")
    if any(len(t) != MAX_NEW for t in streams.values()):
        fail("serving_fleet: a request did not generate MAX_NEW tokens")
    if stats["sheds"] != 1 or not (
            stats["reroutes"] == held.get("ledger") == held.get("engine")
            >= 1):
        fail(f"serving_fleet: sheds {stats['sheds']}, reroutes "
             f"{stats['reroutes']}, replica 1 held {held}")
    check_pools("serving_fleet", [r.engine for r in fleet.live_replicas()])
    check_fleet_launches("serving_fleet", engines, launches)

    # a cold joiner (other weights), synced over the tree and warmed up
    joiner = replica_engine()
    root = fleet.replicas[0].engine
    if same_weights(joiner, root):
        fail("serving_fleet: the cold joiner already holds the root's "
             "weights")
    payload_bytes = len(serialize_state(root.model))
    t0 = time.perf_counter()
    fleet.join(engines={2: joiner}, warmup=True)
    torch.cuda.synchronize()
    join_s = time.perf_counter() - t0
    stats = fleet.stats()
    bitwise = same_weights(joiner, root)
    more = chat_requests(Request, MODEL["n_vocab"])[:8]
    for i, r in enumerate(more):
        r.request_id = 100 + i
    before = {id(e): e.full_prefills for e in engines + [joiner]}
    reset_launches()
    placed = [fleet.submit(r) for r in more]
    fleet.drain()
    torch.cuda.synchronize()
    launches = read_launches()
    done = sorted(r.request_id for r in fleet.completed
                  if r.request_id >= 100)
    streams = fleet_streams(fleet, prompts, offset=100)
    row = {"phase": "serving_fleet_join", "join_s": join_s,
           "weight_sync_s": stats["weight_sync_s"],
           "weight_sync_bytes": stats["weight_sync_bytes"],
           "payload_bytes": payload_bytes,
           "weight_sync_rounds": stats["weight_sync_rounds"],
           "bitwise": bitwise, "placements": placed, "completed": done,
           "flash_launches": launches["fwd"],
           "joiner_full_prefills": joiner.full_prefills}
    gaps = check_fleet_streams("serving_fleet_join", model, streams,
                               {i: ref_streams[i] for i in streams})
    row["near_tie_gaps"] = gaps
    emit(row)
    if not (stats["weight_sync_rounds"] == 1
            and stats["weight_sync_bytes"] == payload_bytes and bitwise):
        fail(f"serving_fleet_join: not one round of the payload's "
             f"{payload_bytes} bytes landing bitwise: {row}")
    if 2 not in placed or done != [100 + i for i in range(len(more))]:
        fail(f"serving_fleet_join: placements {placed}, completed {done}")
    check_pools("serving_fleet_join",
                [r.engine for r in fleet.live_replicas()])
    check_fleet_launches("serving_fleet_join", engines + [joiner],
                         launches, before)


def phase_serving_capacity(model, ref_streams):
    """Phase 52: the JAX bench's diurnal arc on one card: a fleet of one
    replica under QueueDepthScalePolicy, a CapacityBroker over a training
    group of two; phase 3's 16 requests at once, each step's decision
    applied; on the conversion the same 16 prompts again (ids 100-115),
    routed over both replicas."""
    from chainermn_tpu_torch import observability
    from chainermn_tpu_torch.elastic import CapacityBroker, LocalTrainGroup
    from chainermn_tpu_torch.serving import (QueueDepthScalePolicy,
                                             ReplicaFleet, Request)
    observability.reset_registry()
    reqs = chat_requests(Request, MODEL["n_vocab"])
    prompts = {r.request_id: int(r.prompt.size) for r in reqs}
    fleet = ReplicaFleet(engines={0: replica_engine(model)},
                         scale_policy=QueueDepthScalePolicy(
                             **CAPACITY_POLICY))
    train = LocalTrainGroup(world=2)
    broker = CapacityBroker(train, fleet, engine_factory=lambda r:
                            replica_engine(), min_world=1)
    for r in reqs:
        fleet.submit(r)
    torch.cuda.synchronize()
    reset_launches()
    actions, synced, steps = [], None, 0
    t0 = time.perf_counter()
    while fleet.pending() and steps < 10000:
        st = fleet.step()
        steps += 1
        res = broker.apply(st["scale_decision"])
        if res is None:
            continue
        actions.append([*res, steps])
        if res[0] == "convert":
            rid = broker.converted[res[1]]
            synced = same_weights(fleet.replicas[rid].engine,
                                  fleet.replicas[0].engine)
            for i, r in enumerate(chat_requests(Request, MODEL["n_vocab"])):
                r.request_id = 100 + i
                fleet.submit(r)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    engines = [r.engine for r in fleet.replicas.values()]
    ids = sorted(r.request_id for r in fleet.completed)
    first = fleet_streams(fleet, prompts)
    second = fleet_streams(fleet, prompts, offset=100)
    n_gen = sum(len(t) for t in [*first.values(), *second.values()])
    gauge = observability.registry().gauge("chainermn_tpu_role_world_size")
    roles = {role: gauge.value(role=role) for role in ("elastic", "fleet")}
    row = {"phase": "serving_capacity", "actions": actions, "steps": steps,
           "requests": len(ids), "generated_tokens": n_gen,
           "tokens_per_s": n_gen / wall, "wall_s": wall,
           "convert_s": broker.stats["convert_s"],
           "weight_sync_s": fleet.weight_sync_s,
           "weight_sync_bytes": fleet.weight_sync_bytes,
           "stats": {k: v for k, v in broker.stats.items()
                     if k != "convert_s"},
           "reroutes": fleet.reroutes, "joiner_bitwise": synced,
           "served_by": {r.rid: len(r.engine.completed)
                         for r in fleet.replicas.values()},
           "training_view": list(train.current_view().members),
           "fleet_live": [r.rid for r in fleet.live_replicas()],
           "journal": train.scan_conversions(), "role_world_size": roles,
           "flash_launches": launches["fwd"],
           "policy": CAPACITY_POLICY}
    gaps = {"first": check_fleet_streams("serving_capacity", model, first,
                                         ref_streams),
            "second": check_fleet_streams("serving_capacity", model, second,
                                          ref_streams)}
    row["near_tie_gaps"] = gaps
    emit(row)
    want_ids = list(range(N_REQUESTS)) + [100 + i for i in range(N_REQUESTS)]
    if ids != want_ids or len(fleet.completed) != len(want_ids):
        fail(f"serving_capacity: completed {ids}, expected each of "
             f"{want_ids} once")
    if [a[:2] for a in actions] != [["convert", 1], ["retire", 1]]:
        fail(f"serving_capacity: actions {actions}, expected one convert "
             f"of rank 1 then one retire")
    s = broker.stats
    if (s["conversions"], s["retires"], s["role_transfers"]) != (1, 1, 2)             or not synced:
        fail(f"serving_capacity: stats {s}, joiner bitwise {synced}")
    if not (row["training_view"] == [0, 1] and row["fleet_live"] == [0]
            and row["journal"] == {}
            and roles == {"elastic": 2, "fleet": 1}):
        fail(f"serving_capacity: the role groups are not whole at the end: "
             f"{row}")
    check_pools("serving_capacity", engines)
    check_fleet_launches("serving_capacity", engines, launches)


def phases_a13c(model, streams, launches):
    """Phases 51-52 on phase 3's model and load (``launches``: phase 3's B3
    count, each phase counting its own), their seconds emitted as
    ``a13c_phases``."""
    t0 = time.perf_counter()
    phase_serving_fleet(model, streams)
    torch.cuda.empty_cache()
    phase_serving_capacity(model, streams)
    torch.cuda.empty_cache()
    emit({"phase": "a13c_phases", "seconds": time.perf_counter() - t0,
          "phase3_flash_launches": launches})


def flash_module():
    """``chainermn_tpu_torch.ops.flash_attention``, the module (the
    package's ``ops.flash_attention`` name is the function)."""
    return importlib.import_module("chainermn_tpu_torch.ops.flash_attention")


def train_inputs(B, Tq, Tk, D, dtype, seed, H=12, strided=False):
    """q, k, v and an output cotangent g.  ``strided``: q/k/v sliced out
    of one ``[B, T, 3, H, D]`` projection and g a transposed
    ``[B, T, H, D]`` tensor, the layouts the model hands the kernels."""
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    if strided:
        qkv = randn(B, Tq, 3, H, D)
        q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
        return q, k, v, randn(B, Tq, H, D).transpose(1, 2)
    return randn(B, H, Tq, D), randn(B, H, Tk, D), randn(B, H, Tk, D), \
        randn(B, H, Tq, D)


def bwd_errs(got, ref, dtype):
    """The errors of dq, dk and dv in BWD_TOL's measure.  bf16: each
    relative to its own largest |ref|, floored at 2 ** -8 of the largest
    |ref| of the three (at T 1, dq and dk are rounding noise around 0 and
    have no scale of their own)."""
    errs = [(a.float() - b.float()).abs().max().item()
            for a, b in zip(got, ref)]
    if dtype == torch.float32:
        return errs
    scales = [b.float().abs().max().item() for b in ref]
    floor = 2.0 ** -8 * max(scales)
    return [e / max(s, floor) for e, s in zip(errs, scales)]


def check_train_kernels(q, k, v, g, causal, g_lse=None):
    """B1 against its plain version (out, lse), B2 against its plain
    version and against torch autograd through xla_attention."""
    fa = flash_module()
    dtype = q.dtype
    out, lse = fa.flash_attention_fwd(q, k, v, causal=causal)
    ref_out, ref_lse = fa._flash_fwd_lse_plain(q, k, v, causal=causal)
    grads = fa.flash_attention_bwd(q, k, v, out, lse, g, causal=causal,
                                   g_lse=g_lse)
    got_delta = fa.flash_attention_bwd_delta(g, out, g_lse)
    # the epilogue alone: dq is its fp32 accumulator scaled and cast
    scale = fa._scale(None, q.shape[-1])
    acc, dq = fa._fused_bwd(q, k, v, out, lse, g, causal, scale, g_lse)[:2]
    torch.cuda.synchronize()
    delta = fa._bwd_delta_plain(g, out, g_lse)
    ref = fa._flash_bwd_plain(q, k, v, g, lse, delta, causal=causal)
    row = {"B": q.shape[0], "Tq": q.shape[2], "Tk": k.shape[2],
           "D": q.shape[3], "causal": causal, "dtype": str(dtype),
           "strided": not q.is_contiguous(), "g_lse": g_lse is not None,
           "out_err": (out.float() - ref_out.float()).abs().max().item(),
           "lse_err": (lse - ref_lse).abs().max().item(),
           "bwd_err_dq_dk_dv": bwd_errs(grads, ref, dtype),
           "bwd_abs_err": max((a.float() - b.float()).abs().max().item()
                              for a, b in zip(grads, ref)),
           "delta_err": (got_delta - delta).abs().max().item(),
           "epilogue_bitwise": torch.equal(dq, (acc * scale).to(dtype)),
           "finite": all(bool(torch.isfinite(x.float()).all())
                         for x in (out, lse, *grads))}
    if g_lse is None:
        leaves = [x.detach().clone().requires_grad_() for x in (q, k, v)]
        torch.autograd.backward(
            fa.xla_attention(*leaves, causal=causal), g)
        row["autograd_err_dq_dk_dv"] = bwd_errs(
            grads, [x.grad for x in leaves], dtype)
    row["ok"] = (row["finite"] and row["out_err"] < TOL[dtype]
                 and row["lse_err"] < LSE_TOL
                 and row["delta_err"] < DELTA_TOL
                 and row["epilogue_bitwise"]
                 and max(row["bwd_err_dq_dk_dv"]) < BWD_TOL[dtype]
                 and max(row.get("autograd_err_dq_dk_dv", [0.0]))
                 < AUTOGRAD_TOL[dtype])
    return row


def train_cases():
    """The backward kernels' cases: ``(q, k, v, g, causal, g_lse)``, bf16
    causal at T 1, 16, 200, 1024, non-causal Tq 128 / Tk 200, D 128, fp32,
    a non-zero lse cotangent, strided T 300, and last the training shape
    (B 8, T 1024) in the layouts the model hands over."""
    bf16 = torch.bfloat16
    cases = [(*train_inputs(2, T, T, 64, bf16, T), True, None)
             for T in (1, 16, 200, 1024)]
    cases.append((*train_inputs(2, 128, 200, 64, bf16, 7), False, None))
    cases.append((*train_inputs(2, 200, 200, 128, bf16, 8), True, None))
    cases.append((*train_inputs(2, 200, 200, 64, torch.float32, 9), True,
                  None))
    g_lse = torch.randn((2, 12, 200), device="cuda",
                        generator=torch.Generator(device="cuda")
                        .manual_seed(11))
    cases.append((*train_inputs(2, 200, 200, 64, bf16, 10), True, g_lse))
    cases.append((*train_inputs(2, 300, 300, 64, bf16, 12, strided=True),
                  True, None))
    B, T = TRAIN_BATCH, MODEL["max_len"]
    cases.append((*train_inputs(B, T, T, 64, bf16, 13, strided=True), True,
                  None))
    return cases


def bound_of(nbytes, ops, dtype=torch.bfloat16):
    """The larger of bytes over the HBM rate and operations over the
    dtype's peak, in ms, and which of the two it is."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / PEAK_FLOPS[dtype]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def sdpa_backward(q, k, v, g):
    """SDPA's backward alone, on a retained graph (a yardstick; the port
    never calls it)."""
    lq, lk, lv = (x.detach().clone().requires_grad_() for x in (q, k, v))
    out = torch.nn.functional.scaled_dot_product_attention(
        lq, lk, lv, is_causal=True)
    return lambda: torch.autograd.grad(out, (lq, lk, lv), g,
                                       retain_graph=True)


def phase_kernel_train():
    fa = flash_module()
    cases = train_cases()
    checks = [check_train_kernels(q, k, v, g, causal, g_lse=g_lse)
              for q, k, v, g, causal, g_lse in cases]
    main = checks[-1]
    emit({"phase": "kernel_check_train", "checks": checks})
    bad = [c for c in checks if not c["ok"]]
    if bad:
        fail(f"training kernels disagree with their plain versions: {bad}")

    q, k, v, g = cases[-1][:4]
    B, H, T, D = q.shape
    out, lse = fa.flash_attention_fwd(q, k, v, causal=True)
    delta = fa._bwd_delta_plain(g, out)
    fwd_bytes = fa.attention_bytes(B, H, T, T, D, 2) + B * H * T * 4
    fwd_ops = fa.attention_flops(B, H, T, T, D, True)
    bwd_bytes = fa.attention_bwd_bytes(B, H, T, T, D, 2)
    bwd_ops = fa.attention_bwd_flops(B, H, T, T, D, True)

    fwd = lambda: fa.flash_attention_fwd(q, k, v, causal=True)
    bwd = lambda: fa.flash_attention_bwd(q, k, v, out, lse, g, causal=True)
    sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(
        q, k, v, is_causal=True)
    sdpa_bwd = sdpa_backward(q, k, v, g)
    times = {
        "B": B, "H": H, "T": T, "D": D, "dtype": "bfloat16",
        "causal": True, "strided": True,
        "fwd_lse": {
            "ms": time_ms(fwd),
            "device_ms": kernel_device_ms(fwd, FWD_KERNEL),
            "host_us": host_us(fwd),
            "plain_ms": time_ms(lambda: fa._flash_fwd_lse_plain(
                q, k, v, causal=True), iters=5, warmup=1),
            "call_device_ms": library_device_ms(fwd),
            "library_ms": time_ms(sdpa),
            "library_device_ms": library_device_ms(sdpa),
            "max_abs_err": max(main["out_err"], main["lse_err"]),
        },
        "bwd": {
            "ms": time_ms(bwd),
            "device_ms": kernel_device_ms(bwd, BWD_KERNEL),
            # the whole call: delta pass (with the dq accumulator's
            # zeroing), kernel and dq epilogue, beside SDPA's whole call
            "call_device_ms": library_device_ms(bwd),
            "host_us": host_us(bwd),
            "plain_ms": time_ms(lambda: fa._flash_bwd_plain(
                q, k, v, g, lse, delta, causal=True), iters=5, warmup=1),
            "library_ms": time_ms(sdpa_bwd),
            "library_device_ms": library_device_ms(sdpa_bwd),
            "max_abs_err": main["bwd_abs_err"],
        },
    }
    (times["fwd_lse"]["bound_ms"],
     times["fwd_lse"]["bound_by"]) = bound_of(fwd_bytes, fwd_ops)
    times["bwd"]["bound_ms"], times["bwd"]["bound_by"] = bound_of(
        bwd_bytes, bwd_ops)
    emit({"phase": "kernel_check_train_times", **times})
    return times


def check_split_kernels(q, k, v, g, causal, g_lse=None, scale=None):
    """The dq and dk/dv kernels against their plain versions, against
    torch autograd through xla_attention and against the fused kernel,
    each of dq, dk, dv in BWD_TOL's measure."""
    fa = flash_module()
    dtype = q.dtype
    kw = {"causal": causal, "scale": scale}
    out, lse = fa._flash_fwd_lse_plain(q, k, v, **kw)
    delta = (g.float() * out.float()).sum(-1)
    if g_lse is not None:
        delta = delta - g_lse
    got = (fa.flash_attention_bwd_dq(q, k, v, g, lse, delta, **kw),
           *fa.flash_attention_bwd_dkv(q, k, v, g, lse, delta, **kw))
    torch.cuda.synchronize()
    ref = (fa._flash_bwd_dq_plain(q, k, v, g, lse, delta, **kw),
           *fa._flash_bwd_dkv_plain(q, k, v, g, lse, delta, **kw))
    fused = fa.flash_attention_bwd(q, k, v, out, lse, g, g_lse=g_lse, **kw)
    row = {"B": q.shape[0], "Tq": q.shape[2], "Tk": k.shape[2],
           "D": q.shape[3], "causal": causal, "dtype": str(dtype),
           "strided": not q.is_contiguous(), "g_lse": g_lse is not None,
           "scale": fa._scale(scale, q.shape[3]),
           "err_dq_dk_dv": bwd_errs(got, ref, dtype),
           "abs_err_dq_dk_dv": [(a.float() - b.float()).abs().max().item()
                                for a, b in zip(got, ref)],
           "fused_err_dq_dk_dv": bwd_errs(got, fused, dtype),
           "finite": all(bool(torch.isfinite(x.float()).all())
                         for x in got)}
    if g_lse is None:
        leaves = [x.detach().clone().requires_grad_() for x in (q, k, v)]
        torch.autograd.backward(fa.xla_attention(*leaves, **kw), g)
        row["autograd_err_dq_dk_dv"] = bwd_errs(
            got, [x.grad for x in leaves], dtype)
    row["ok"] = (row["finite"]
                 and max(row["err_dq_dk_dv"]) < BWD_TOL[dtype]
                 and max(row["fused_err_dq_dk_dv"]) < BWD_TOL[dtype]
                 and max(row.get("autograd_err_dq_dk_dv", [0.0]))
                 < AUTOGRAD_TOL[dtype])
    return row


def phase_kernel_split():
    fa = flash_module()
    cases = train_cases()
    checks = [check_split_kernels(q, k, v, g, causal, g_lse=g_lse)
              for q, k, v, g, causal, g_lse in cases]
    main = checks[-1]
    # any finite scale (0, below 0, above 0) at D 128 and on the strided
    # T 300 case
    checks += [check_split_kernels(*cases[i][:4], True, scale=scale)
               for i in (5, -2) for scale in (0.0, -0.125, 0.0625)]
    emit({"phase": "kernel_check_split", "checks": checks})
    bad = [c for c in checks if not c["ok"]]
    if bad:
        fail(f"split backward kernels disagree: {bad}")

    q, k, v, g = cases[-1][:4]
    B, H, T, D = q.shape
    out, lse = fa.flash_attention_fwd(q, k, v, causal=True)
    delta = fa.flash_attention_bwd_delta(g, out)
    args = (q, k, v, g, lse, delta)
    sdpa_bwd = sdpa_backward(q, k, v, g)
    library_ms = time_ms(sdpa_bwd)
    library_dev_ms = library_device_ms(sdpa_bwd)
    saved = fa._FLASH_BWD
    fa._FLASH_BWD = "split"
    try:   # one split flash_attention_bwd call: delta pass, dq, dk/dv
        ops = device_ops_us(lambda: fa.flash_attention_bwd(
            q, k, v, out, lse, g, causal=True))
    finally:
        fa._FLASH_BWD = saved
    call_dev_ms = sum(us for _, us in ops) * 1e-3 or None
    times = {"B": B, "H": H, "T": T, "D": D, "dtype": "bfloat16",
             "causal": True, "strided": True,
             "library": "SDPA backward (dq, dk and dv: the pair's work)",
             "call_device_ms": call_dev_ms, "ops_us": ops}
    for part, kernel, plain, i in (
            ("dq", fa.flash_attention_bwd_dq, fa._flash_bwd_dq_plain, [0]),
            ("dkv", fa.flash_attention_bwd_dkv, fa._flash_bwd_dkv_plain,
             [1, 2])):
        call = lambda: kernel(*args, causal=True)
        ms, by = bound_of(fa.attention_bwd_bytes(B, H, T, T, D, 2, part),
                          fa.attention_bwd_flops(B, H, T, T, D, True, part))
        times[part] = {
            "ms": time_ms(call),
            "device_ms": kernel_device_ms(call, SPLIT_KERNELS[part]),
            "call_device_ms": call_dev_ms,
            "host_us": host_us(call),
            "plain_ms": time_ms(lambda: plain(*args, causal=True),
                                iters=5, warmup=1),
            "library_ms": library_ms,
            "library_device_ms": library_dev_ms,
            "bound_ms": ms, "bound_by": by,
            "max_abs_err": max(main["abs_err_dq_dk_dv"][j] for j in i)}
    emit({"phase": "kernel_check_split_times", **times})
    return times


def transformer_flops_per_token(d_model, n_layers, n_vocab, seq_len):
    """bench.py's analytic train-step flops per token for the causal LM:
    matmul fwd = 2 (12 L d^2 + d V), attention fwd = 4 T d L (causal
    halving ignored), train = 3x fwd."""
    matmul = 2.0 * (12.0 * n_layers * d_model ** 2 + d_model * n_vocab)
    attn = 4.0 * seq_len * d_model * n_layers
    return 3.0 * (matmul + attn)


#: the wrappers' launch counters, by short name
LAUNCH_COUNTERS = {"fwd": "flash_attention", "fwd_lse": "flash_attention_fwd",
                   "bwd": "flash_attention_bwd",
                   "bwd_delta": "flash_attention_bwd_delta",
                   "bwd_dq": "flash_attention_bwd_dq",
                   "bwd_dkv": "flash_attention_bwd_dkv"}


def reset_launches():
    fa = flash_module()
    for fn in LAUNCH_COUNTERS.values():
        getattr(fa, fn).launches = 0


def read_launches():
    fa = flash_module()
    return {key: getattr(fa, fn).launches
            for key, fn in LAUNCH_COUNTERS.items()}


def expected_launches(**counts):
    """The expected launch counts: the given ones, every other kernel 0."""
    return {key: counts.get(key, 0) for key in LAUNCH_COUNTERS}


def train_rows(n_vocab=MODEL["n_vocab"], n_rows=TRAIN_ROWS,
               T=MODEL["max_len"], seed=0):
    """bench.py's transformer data, cut: 16 random token rows (numpy seed
    0) and their next-token targets, repeating every 2 steps."""
    rows = np.random.RandomState(seed).randint(
        0, n_vocab, (n_rows, T)).astype(np.int64)
    return rows, [(x, np.roll(x, -1)) for x in rows]


def timed_trainer_run(opt, dataset, batch, steps, out):
    """``Trainer`` -> ``StandardUpdater`` -> ``opt`` for ``steps`` steps
    of ``batch`` examples, the launch counts read around this run alone:
    ``(updater, step_ms, losses, peak_bytes, launches)``, each step's
    time from CUDA events recorded after it (no host sync in the loop)."""
    from chainermn_tpu_torch.dataset import SerialIterator
    from chainermn_tpu_torch.training import StandardUpdater, Trainer
    updater = StandardUpdater(
        SerialIterator(dataset, batch, shuffle=False), opt)
    trainer = Trainer(updater, (steps, "iteration"),
                      out=os.path.join("build", out))
    losses, marks = [], []

    def record(tr):   # no sync: tensors and events, read after the run
        losses.append(tr.observation["main/loss"])
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        marks.append(ev)

    trainer.extend(record, name="record")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    start = torch.cuda.Event(enable_timing=True)
    start.record()
    trainer.run()
    torch.cuda.synchronize()
    launches = read_launches()
    step_ms = [start.elapsed_time(marks[0])] + [
        a.elapsed_time(b) for a, b in zip(marks, marks[1:])]
    return (updater, step_ms, [float(x) for x in losses],
            torch.cuda.max_memory_allocated(), launches)


def run_training(opt, dataset, out):
    """``Trainer`` -> ``StandardUpdater`` -> ``opt`` for TRAIN_STEPS
    steps of TRAIN_BATCH rows, the launch counts read around this run
    alone: ``(updater, row)`` with the step times, tokens/s, MFU, losses,
    peak memory and launches."""
    T = MODEL["max_len"]
    updater, step_ms, losses, peak, launches = timed_trainer_run(
        opt, dataset, TRAIN_BATCH, TRAIN_STEPS, out)
    median_ms = float(np.median(step_ms[TRAIN_WARMUP:]))
    tokens_per_s = TRAIN_BATCH * T / (median_ms * 1e-3)
    flops_tok = transformer_flops_per_token(
        MODEL["d_model"], MODEL["n_layers"], MODEL["n_vocab"], T)
    return updater, {
        "batch": TRAIN_BATCH, "T": T, "steps": TRAIN_STEPS,
        "step_ms": step_ms, "median_step_ms": median_ms,
        "tokens_per_s": tokens_per_s, "flops_per_token": flops_tok,
        "mfu": flops_tok * tokens_per_s / PEAK_FLOPS[torch.bfloat16],
        "losses": losses, "peak_bytes": peak, "launches": launches}


def check_losses(name, losses):
    if not all(np.isfinite(losses)) or len(losses) != TRAIN_STEPS:
        fail(f"{name} losses {losses}")
    if not losses[-1] < losses[0]:
        fail(f"{name}: the loss did not fall on repeated data: {losses}")


def profile_steps(name, updater, top_n=12, **extra):
    """3 more steps under the profiler: wall, device busy and idle share,
    and the top kernels by device time; each ``extra`` is a function of
    the per-kernel times whose value joins the row.  Returns the row."""
    wall, busy, by_name = device_profile(
        lambda: [updater.update() for _ in range(3)])
    top = sorted(by_name.items(), key=lambda kv: -kv[1])
    row = {"phase": name, "steps": 3, "wall_s": wall, "device_busy_s": busy,
           "device_idle_share": 1.0 - busy / wall,
           "nccl_us": sum(us for n, us in by_name.items()
                          if "nccl" in n.lower()),
           "top_kernels_us": [[n[:80], us] for n, us in top[:top_n]],
           **{k: fn(by_name) for k, fn in extra.items()}}
    emit(row)
    return row


def phase_train():
    from chainermn_tpu_torch.core.optimizer import Adam
    from chainermn_tpu_torch.models import TransformerLM
    n_layers = MODEL["n_layers"]
    model = TransformerLM(compute_dtype=torch.bfloat16, remat=False,
                          device="cuda", **MODEL)
    opt = Adam(alpha=3e-4)
    opt.setup(model)
    rows, data = train_rows()
    updater, row = run_training(opt, data, "chip_smoke_train")
    launches = row["launches"]
    # one eval forward without a gradient: the plain forward kernel only
    reset_launches()
    with torch.no_grad():
        model.logits(torch.from_numpy(rows[:TRAIN_BATCH]).cuda())
    torch.cuda.synchronize()
    eval_launches = read_launches()
    emit({"phase": "train", **row, "eval_launches": eval_launches})
    check_losses("training", row["losses"])
    want = expected_launches(fwd_lse=n_layers * TRAIN_STEPS,
                             bwd_delta=n_layers * TRAIN_STEPS,
                             bwd=n_layers * TRAIN_STEPS)
    if launches != want:
        fail(f"training launches {launches}, expected {want}")
    if eval_launches != expected_launches(fwd=n_layers):
        fail(f"eval launches {eval_launches}, expected {n_layers} of the "
             "no-grad forward only")
    profile_steps("train_profile", updater)
    return launches, row["median_step_ms"]


def phase_train_dp():
    """The data-parallel step on the card: NCCL world of one, bf16 flat
    bucket, split backward."""
    import torch.distributed as dist
    from chainermn_tpu_torch import (create_communicator,
                                     create_multi_node_optimizer,
                                     scatter_dataset)
    from chainermn_tpu_torch.core.optimizer import Adam
    from chainermn_tpu_torch.models import TransformerLM
    fa = flash_module()
    n_layers = MODEL["n_layers"]
    comm = create_communicator("pure_nccl", allreduce_grad_dtype="bfloat16")
    saved = fa._FLASH_BWD
    try:
        model = TransformerLM(compute_dtype=torch.bfloat16, remat=False,
                              device="cuda", **MODEL)
        comm.bcast_data(model)
        opt = create_multi_node_optimizer(Adam(alpha=3e-4), comm)
        opt.setup(model)
        _, data = train_rows()
        shard = scatter_dataset(data, comm)
        buckets = comm.grad_buckets_for(model)
        fa._FLASH_BWD = "split"
        comm.calls.clear()
        updater, row = run_training(opt, shard, "chip_smoke_train_dp")
        row.update({
            "phase": "train_dp", "communicator": comm.name,
            "world": comm.size, "backend": dist.get_backend(),
            "wire_dtype": str(comm.allreduce_grad_dtype),
            "buckets": len(buckets),
            "bucket_bytes": 2 * sum(p.numel() for p in model.parameters()),
            "grad_allreduces": comm.calls["allreduce_grad"],
            "collectives": dict(comm.calls)})
        emit(row)
        profile_steps("train_dp_profile", updater)
        # one gradient exchange alone (cast, pack, allreduce, divide,
        # unpack), every device op by name
        wall, busy, by_name = device_profile(
            lambda: comm.multi_node_mean_grad(model))
        emit({"phase": "train_dp_exchange", "wall_ms": wall * 1e3,
              "device_ms": busy * 1e3,
              "ops_us": sorted(([n[:80], us] for n, us in by_name.items()),
                               key=lambda kv: -kv[1])})
    finally:
        fa._FLASH_BWD = saved
        comm.finalize()
    check_losses("data-parallel training", row["losses"])
    want = expected_launches(fwd_lse=n_layers * TRAIN_STEPS,
                             bwd_delta=n_layers * TRAIN_STEPS,
                             bwd_dq=n_layers * TRAIN_STEPS,
                             bwd_dkv=n_layers * TRAIN_STEPS)
    if row["launches"] != want:
        fail(f"data-parallel launches {row['launches']}, expected {want}")
    if len(buckets) != 1 or row["grad_allreduces"] != TRAIN_STEPS \
            or comm.allreduce_grad_dtype != torch.bfloat16:
        fail(f"expected one flat bf16 gradient allreduce per step: "
             f"{len(buckets)} buckets, {row['grad_allreduces']} allreduces "
             f"over {TRAIN_STEPS} steps, wire {comm.allreduce_grad_dtype}")
    if dist.is_initialized():
        fail("the process group outlived the data-parallel phase")
    return row["launches"], row["median_step_ms"]


#: train_parity's small fp32 model
PARITY_MODEL = dict(n_vocab=1000, d_model=256, n_heads=4, n_layers=2,
                    max_len=256, seed=0, device="cuda")


def parity_batch():
    rows = np.random.RandomState(2).randint(0, PARITY_MODEL["n_vocab"],
                                            (2, 256))
    return (torch.from_numpy(rows).cuda(),
            torch.from_numpy(np.roll(rows, -1, axis=1)).cuda())


def grad_rel_err(grads, ref_grads):
    """Worst gradient error, relative to each parameter's largest |grad|."""
    return max((grads[p] - g).abs().max().item()
               / max(g.abs().max().item(), 1e-30)
               for p, g in ref_grads.items())


def phase_train_parity():
    """One step of a small fp32 model through the kernels against the
    same step with attention through the plain xla_attention."""
    from chainermn_tpu_torch.models import TransformerLM
    from chainermn_tpu_torch.models import transformer as tm
    from chainermn_tpu_torch.ops import xla_attention
    x, t = parity_batch()

    def step():
        model = TransformerLM(**PARITY_MODEL)
        loss = model(x, t)
        loss.backward()
        return loss.item(), {p: v.grad for p, v in model.namedparams()}

    reset_launches()
    loss, grads = step()
    launches = read_launches()
    kernel_attention = tm.fused_attention
    tm.fused_attention = xla_attention
    try:
        ref_loss, ref_grads = step()
    finally:
        tm.fused_attention = kernel_attention
    grad_err = grad_rel_err(grads, ref_grads)
    row = {"phase": "train_parity", "loss": loss, "ref_loss": ref_loss,
           "loss_err": abs(loss - ref_loss), "grad_rel_err": grad_err,
           "tol": PARITY_TOL, "launches": launches}
    emit(row)
    if launches != expected_launches(fwd_lse=2, bwd_delta=2, bwd=2):
        fail(f"parity step launches {launches}, expected 2 + 2 + 2")
    if not (row["loss_err"] < PARITY_TOL["loss"]
            and grad_err < PARITY_TOL["grad"]):
        fail(f"training through the kernels leaves the plain step: {row}")


def phase_train_dp_parity():
    """On train_parity's model, with the split backward: (a) a world-of-
    one DP step (lossless wire) is bitwise the single-card Adam step, (b)
    the bf16 wire rounds each gradient to bf16 and back, bitwise, (c) the
    DP step through the split kernels matches the one through
    xla_attention within PARITY_TOL."""
    import torch.distributed as dist
    from chainermn_tpu_torch import (create_communicator,
                                     create_multi_node_optimizer)
    from chainermn_tpu_torch.core.optimizer import Adam
    from chainermn_tpu_torch.models import TransformerLM
    from chainermn_tpu_torch.models import transformer as tm
    from chainermn_tpu_torch.ops import xla_attention
    fa = flash_module()
    x, t = parity_batch()
    saved = fa._FLASH_BWD
    fa._FLASH_BWD = "split"
    comm = create_communicator("pure_nccl")
    try:
        wire = create_communicator("pure_nccl",
                                   allreduce_grad_dtype="bfloat16")

        def step(data_parallel):
            model = TransformerLM(**PARITY_MODEL)
            opt = Adam(alpha=3e-4)
            if data_parallel:
                opt = create_multi_node_optimizer(opt, comm)
            opt.setup(model)
            loss = opt.update(model, x, t).item()
            return loss, dict(model.namedparams())

        # (a) the DP wrapper over a lossless world of one changes nothing
        loss, single = step(False)
        reset_launches()
        dp_loss, dp = step(True)
        launches = read_launches()
        a_equal = loss == dp_loss and all(
            torch.equal(dp[p], v) for p, v in single.items())
        # (b) the bf16 wire on one backward's gradients
        model = TransformerLM(**PARITY_MODEL)
        model(x, t).backward()
        raw = {p: v.grad.clone() for p, v in model.namedparams()}
        wire.multi_node_mean_grad(model)
        torch.cuda.synchronize()
        b_equal = all(v.grad.dtype == torch.float32
                      and torch.equal(v.grad, raw[p].bfloat16().float())
                      for p, v in model.namedparams())
        # (c) split kernels against plain attention, through the DP step
        kernel_attention = tm.fused_attention
        tm.fused_attention = xla_attention
        try:
            ref_loss, ref = step(True)
        finally:
            tm.fused_attention = kernel_attention
        grad_err = grad_rel_err({p: v.grad for p, v in dp.items()},
                                {p: v.grad for p, v in ref.items()})
        calls = dict(comm.calls)
    finally:
        fa._FLASH_BWD = saved
        comm.finalize()
    row = {"phase": "train_dp_parity", "a_bitwise_equal": a_equal,
           "loss": dp_loss, "single_card_loss": loss,
           "b_bf16_wire_bitwise": b_equal, "c_ref_loss": ref_loss,
           "c_loss_err": abs(dp_loss - ref_loss), "c_grad_rel_err": grad_err,
           "tol": PARITY_TOL, "launches": launches, "collectives": calls}
    emit(row)
    if launches != expected_launches(fwd_lse=2, bwd_delta=2, bwd_dq=2,
                                     bwd_dkv=2):
        fail(f"DP parity step launches {launches}, expected 2 x 4")
    if not (a_equal and b_equal and row["c_loss_err"] < PARITY_TOL["loss"]
            and grad_err < PARITY_TOL["grad"]):
        fail(f"the data-parallel step leaves its references: {row}")
    if dist.is_initialized():
        fail("the process group outlived the DP parity phase")


def resnet50_train_flops_per_image(image_size):
    """bench.py's analytic model: forward ~4.1 GFLOP at 224^2 (scaling
    with the area), train = 3x forward."""
    return 3.0 * 4.1e9 * (image_size / 224.0) ** 2


def resnet_data():
    """bench.py's ResNet data, cut to 2 batches: NHWC fp32 N(0, 1) images
    and labels in [0, 1000) from numpy seed 0."""
    from chainermn_tpu_torch.dataset import TupleDataset
    rng = np.random.RandomState(0)
    n = 2 * RESNET_BATCH
    x = rng.normal(0, 1, (n, RESNET_IMAGE, RESNET_IMAGE, 3)).astype(
        np.float32)
    return TupleDataset(x, rng.randint(0, 1000, n).astype(np.int32))


#: cuDNN's layout-conversion kernels: none may run on the NHWC path
LAYOUT_CONVERSIONS = ("nchwToNhwc", "nhwcToNchw")
#: classes of the ResNet step's device ops, by the first pattern its
#: name matches (case-insensitive); the rest is "other"
OP_CLASSES = [("optimizer", r"multi_tensor_apply"),
              ("host_copy", r"^memcpy|^memset"),
              ("reduction", r"reduce_kernel"),
              ("elementwise", r"elementwise|copy_kern|direct_copy"),
              ("nccl", r"nccl"),
              ("convolution", r"conv|xmma|cudnn|sm\d\d_|implicit|gemm|"
                              r"nvjet|cutlass|wgrad|dgrad|fprop")]


def op_class(name):
    return next((c for c, pat in OP_CLASSES
                 if re.search(pat, name, re.IGNORECASE)), "other")


def op_classes_us(by_name):
    """Device microseconds per OP_CLASSES class (sums over the run)."""
    out = {name: 0.0 for name, _ in OP_CLASSES}
    out["other"] = 0.0
    for n, us in by_name.items():
        out[op_class(n)] += us
    return out


def phase_train_resnet():
    """bench.py's ResNet-50 step, data-parallel over a world of one NCCL
    process with the bf16 flat bucket, through Trainer/StandardUpdater."""
    import torch.distributed as dist
    from chainermn_tpu_torch import (create_communicator,
                                     create_multi_node_optimizer,
                                     scatter_dataset)
    from chainermn_tpu_torch.core.optimizer import MomentumSGD
    from chainermn_tpu_torch.models import Classifier, ResNet50
    comm = create_communicator("pure_nccl", allreduce_grad_dtype="bfloat16")
    benchmark = torch.backends.cudnn.benchmark
    try:
        model = Classifier(ResNet50(compute_dtype=torch.bfloat16,
                                    device="cuda", **RESNET))
        comm.bcast_data(model)
        opt = create_multi_node_optimizer(
            MomentumSGD(lr=0.1, momentum=0.9), comm).setup(model)
        shard = scatter_dataset(resnet_data(), comm)
        buckets = comm.grad_buckets_for(model)
        n_params = sum(p.numel() for p in model.parameters())
        comm.calls.clear()
        updater, step_ms, losses, peak, launches = timed_trainer_run(
            opt, shard, RESNET_BATCH, RESNET_STEPS, "chip_smoke_resnet")
        median_ms = float(np.median(step_ms[RESNET_WARMUP:]))
        images_per_s = RESNET_BATCH / (median_ms * 1e-3)
        flops = resnet50_train_flops_per_image(RESNET_IMAGE)
        row = {
            "phase": "train_resnet", "model": "ResNet50", **RESNET,
            "compute_dtype": "bfloat16", "batch": RESNET_BATCH,
            "image": RESNET_IMAGE, "steps": RESNET_STEPS,
            "step_ms": step_ms, "median_step_ms": median_ms,
            "images_per_s": images_per_s, "flops_per_image": flops,
            "mfu": flops * images_per_s / PEAK_FLOPS[torch.bfloat16],
            "losses": losses, "peak_bytes": peak, "launches": launches,
            "cudnn_benchmark": benchmark,
            "communicator": comm.name, "world": comm.size,
            "backend": dist.get_backend(),
            "wire_dtype": str(comm.allreduce_grad_dtype),
            "buckets": len(buckets), "bucket_bytes": 2 * n_params,
            "params": n_params,
            "grad_allreduces": comm.calls["allreduce_grad"],
            "collectives": dict(comm.calls)}
        emit(row)
        # the same steps with the cuDNN autotuner on (a reading, not the
        # phase's configuration)
        torch.backends.cudnn.benchmark = True
        _, bench_ms, bench_losses, _, _ = timed_trainer_run(
            opt, shard, RESNET_BATCH, RESNET_STEPS, "chip_smoke_resnet_b")
        bench_median = float(np.median(bench_ms[RESNET_WARMUP:]))
        emit({"phase": "train_resnet_cudnn_benchmark", "step_ms": bench_ms,
              "median_step_ms": bench_median,
              "images_per_s": RESNET_BATCH / (bench_median * 1e-3),
              "losses": bench_losses})
        torch.backends.cudnn.benchmark = benchmark
        prof = profile_steps(
            "train_resnet_profile", updater, top_n=15,
            layout_conversions_us=lambda by_name: sum(
                us for n, us in by_name.items()
                if any(c in n for c in LAYOUT_CONVERSIONS)),
            classes_us=op_classes_us,
            conv_and_other_top_us=lambda by_name: sorted(
                ([n[:80], us] for n, us in by_name.items()
                 if op_class(n) in ("convolution", "other")),
                key=lambda kv: -kv[1])[:8])
        emit({"phase": "train_resnet_parts",
              **exchange_parts(opt, model, shard)})
    finally:
        torch.backends.cudnn.benchmark = benchmark
        comm.finalize()
    if not all(np.isfinite(losses + bench_losses)) \
            or len(losses) != RESNET_STEPS:
        fail(f"ResNet-50 losses {losses}, {bench_losses}")
    if launches != expected_launches():
        fail(f"the ResNet-50 step launched flash kernels: {launches}")
    if len(buckets) != 1 or row["grad_allreduces"] != RESNET_STEPS \
            or comm.allreduce_grad_dtype != torch.bfloat16:
        fail(f"expected one flat bf16 gradient allreduce per step: "
             f"{len(buckets)} buckets, {row['grad_allreduces']} allreduces "
             f"over {RESNET_STEPS} steps, wire {comm.allreduce_grad_dtype}")
    if prof["device_busy_s"] <= 0 or not prof["classes_us"]["convolution"]:
        fail(f"the profiled ResNet-50 steps ran no convolution on the card: "
             f"{prof['classes_us']}")
    if dist.is_initialized():
        fail("the process group outlived the ResNet-50 phase")
    return {**row, "device_idle_share": prof["device_idle_share"]}


def queued_device_ms(fn, spin_cycles=int(1e8)):
    """``fn``'s time on the card with its launches queued behind a spin
    kernel (~50 ms), so that its kernels run back to back whatever the
    host's speed: CUDA events around ``fn``, recorded while the card
    spins.  Returns ``(ms, host_ms, fn's result)``; ``host_ms``, the
    host's time to enqueue ``fn``, must stay below the spin for the
    reading to hold."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(spin_cycles)
    t0 = time.perf_counter()
    start.record()
    out = fn()
    end.record()
    host_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    return start.elapsed_time(end), host_ms, out


def exchange_parts(opt, model, shard):
    """The device time of one step's gradient exchange and of its
    update, on the gradients of one batch (each part once untimed
    first): ``opt._exchange`` (plain: cast, pack, allreduce, divide,
    unpack; double-buffered: pack, launch, wait for the previous step's
    exchange and unpack it; sharded: pack, reduce-scatter, cast, divide)
    and ``opt._apply_update`` (the rule; sharded: pack the parameters,
    the rule on the chunk, all-gather, unpack)."""
    from chainermn_tpu_torch.dataset import concat_examples
    x, t = concat_examples([shard[i] for i in range(RESNET_BATCH)], "cuda")
    model.cleargrads()
    grads = opt._gradients(model(x, t))
    opt._apply_update(opt._exchange(grads))
    ex_ms, ex_host, exchanged = queued_device_ms(lambda: opt._exchange(grads))
    up_ms, up_host, _ = queued_device_ms(lambda: opt._apply_update(exchanged))
    if max(ex_host, up_host) > 40:
        fail(f"enqueueing a part took {ex_host}, {up_host} ms: the spin "
             "no longer covers it")
    return {"exchange_device_ms": ex_ms, "update_device_ms": up_ms,
            "exchange_host_ms": ex_host, "update_host_ms": up_host}


def kernel_streams(fn):
    """The CUDA streams the kernels of ``fn`` ran on, from the profiler's
    trace: ``{"nccl": [...], "other": [...]}`` (NCCL's kernels by name)
    and the number of NCCL kernels."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    path = os.path.join("build", "chip_smoke_streams.json")
    os.makedirs("build", exist_ok=True)
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    streams = {"nccl": set(), "other": set()}
    n_nccl = 0
    for e in events:
        if e.get("cat") != "kernel":
            continue
        nccl = "nccl" in e.get("name", "").lower()
        n_nccl += nccl
        streams["nccl" if nccl else "other"].add(
            e.get("args", {}).get("stream"))
    return {"nccl_kernels": n_nccl,
            "nccl_streams": sorted(streams["nccl"], key=str),
            "compute_streams": sorted(streams["other"], key=str)}


#: the exchanges phase 13 runs beside train_resnet's
RESNET_EXCHANGES = {"train_resnet_db": dict(double_buffering=True),
                    "train_resnet_rs": dict(exchange="reduce_scatter"),
                    "train_resnet_zero": dict(zero_sharding=True),
                    "train_resnet_plain": {}}
#: their order: each exchange once, in turns around a second reading of
#: the plain one (phase 21 takes a third), so that a drift of the host
#: over the call shows
RESNET_EXCHANGE_ORDER = ["train_resnet_db", "train_resnet_rs",
                         "train_resnet_plain", "train_resnet_zero"]


def phase_train_resnet_exchange(phase, plain_row, reading=1):
    """``train_resnet``'s step with only the exchange changed (world of
    one NCCL process, bf16 wire), beside ``plain_row`` from this call;
    ``reading`` numbers the runs of one exchange."""
    import torch.distributed as dist
    from chainermn_tpu_torch import (create_communicator,
                                     create_multi_node_optimizer,
                                     scatter_dataset)
    from chainermn_tpu_torch.core.optimizer import MomentumSGD
    from chainermn_tpu_torch.models import Classifier, ResNet50
    exchange = RESNET_EXCHANGES[phase]
    comm = create_communicator("pure_nccl", allreduce_grad_dtype="bfloat16")
    try:
        model = Classifier(ResNet50(compute_dtype=torch.bfloat16,
                                    device="cuda", **RESNET))
        comm.bcast_data(model)
        opt = create_multi_node_optimizer(
            MomentumSGD(lr=0.1, momentum=0.9), comm, **exchange).setup(model)
        shard = scatter_dataset(resnet_data(), comm)
        comm.calls.clear()
        updater, step_ms, losses, peak, launches = timed_trainer_run(
            opt, shard, RESNET_BATCH, RESNET_STEPS, f"chip_smoke_{phase}")
        calls = dict(comm.calls)
        median_ms = float(np.median(step_ms[RESNET_WARMUP:]))
        images_per_s = RESNET_BATCH / (median_ms * 1e-3)
        flops = resnet50_train_flops_per_image(RESNET_IMAGE)
        prof = profile_steps(f"{phase}_profile", updater, top_n=10,
                             classes_us=op_classes_us)
        row = {"phase": phase, "reading": reading, "exchange": exchange,
               "steps": RESNET_STEPS,
               "step_ms": step_ms, "median_step_ms": median_ms,
               "images_per_s": images_per_s,
               "mfu": flops * images_per_s / PEAK_FLOPS[torch.bfloat16],
               "losses": losses, "peak_bytes": peak, "launches": launches,
               "device_idle_share": prof["device_idle_share"],
               "collectives": calls,
               **exchange_parts(opt, model, shard),
               "train_resnet": {k: plain_row[k] for k in (
                   "median_step_ms", "images_per_s", "mfu", "peak_bytes",
                   "device_idle_share")}}
        if exchange.get("double_buffering"):
            row["streams"] = kernel_streams(
                lambda: [updater.update() for _ in range(2)])
        if opt._sharded_update:
            n, n_pad, lo, hi = opt._flat_layout()
            row["flat_layout"] = {"n": n, "n_pad": n_pad, "chunk": [lo, hi]}
        opt._reset_exchange()
        emit(row)
    finally:
        comm.finalize()
    sharded = phase in ("train_resnet_rs", "train_resnet_zero")
    want = ({"reduce_scatter_grad": RESNET_STEPS,
             "allgather_flat": RESNET_STEPS} if sharded
            else {"allreduce_grad": RESNET_STEPS})
    if not all(np.isfinite(losses)) or len(losses) != RESNET_STEPS:
        fail(f"{phase} losses {losses}")
    if launches != expected_launches():
        fail(f"{phase} launched flash kernels: {launches}")
    if calls != want:
        fail(f"{phase}: expected the collectives {want}, got {calls}")
    if dist.is_initialized():
        fail(f"the process group outlived {phase}")
    return row


def resnet_parity_run(device, data_parallel, comm=None, steps=3,
                      **exchange):
    """RESNET_PARITY's model for ``steps`` MomentumSGD steps on
    ``device``, plain or through ``create_multi_node_optimizer(.., comm,
    **exchange)``: (losses, state on the host)."""
    from chainermn_tpu_torch import create_multi_node_optimizer
    from chainermn_tpu_torch.core.optimizer import MomentumSGD
    from chainermn_tpu_torch.models import Classifier, ResNet
    cfg = RESNET_PARITY
    model = Classifier(ResNet(cfg["blocks"], n_classes=cfg["n_classes"],
                              seed=0, layout="NHWC", device=device))
    opt = MomentumSGD(lr=cfg["lr"], momentum=0.9)
    if data_parallel:
        opt = create_multi_node_optimizer(opt, comm, **exchange)
    opt.setup(model)
    rng = np.random.RandomState(4)
    losses = []
    for _ in range(steps):
        x = rng.normal(0, 1, (cfg["batch"], cfg["size"], cfg["size"], 3))
        t = rng.randint(0, cfg["n_classes"], cfg["batch"])
        losses.append(opt.update(
            model, torch.from_numpy(x.astype(np.float32)).to(device),
            torch.from_numpy(t).to(device)).item())
    state = {p: v.detach().cpu() for p, v in model.namedparams()}
    state.update((p, v.cpu()) for p, v in model.namedpersistent())
    return losses, state


def phase_resnet_parity():
    """(a) a world-of-one DP step of the small fp32 ResNet is bitwise the
    single-card step (cudnn.deterministic on for it); (b) 3 DP steps on
    the card match 3 steps on the CPU within RESNET_PARITY_TOL.  TF32 is
    off for this phase and restored after it."""
    import torch.distributed as dist
    from chainermn_tpu_torch import create_communicator
    flags = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.deterministic)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    comm = create_communicator("pure_nccl")
    try:
        torch.backends.cudnn.deterministic = True
        single = resnet_parity_run("cuda", False)
        dp = resnet_parity_run("cuda", True, comm)
        torch.backends.cudnn.deterministic = flags[2]
        a_equal = single[0] == dp[0] and all(
            torch.equal(v, single[1][p]) for p, v in dp[1].items())
        card = resnet_parity_run("cuda", True, comm)
        cpu = resnet_parity_run("cpu", False)
        calls = dict(comm.calls)
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.deterministic) = flags
        comm.finalize()
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(card[0], cpu[0]))
    state_err = max((card[1][p] - v).abs().max().item()
                    for p, v in cpu[1].items())
    row = {"phase": "resnet_parity", "a_bitwise_equal": a_equal,
           "losses": card[0], "cpu_losses": cpu[0],
           "b_loss_rel_err": loss_err, "b_state_abs_err": state_err,
           "tol": RESNET_PARITY_TOL, "collectives": calls,
           "tf32_restored": (torch.backends.cudnn.allow_tf32,
                             torch.backends.cuda.matmul.allow_tf32)}
    emit(row)
    if not (a_equal and loss_err < RESNET_PARITY_TOL["loss_rel"]
            and state_err < RESNET_PARITY_TOL["state_abs"]
            and sorted(card[1]) == sorted(cpu[1])):
        fail(f"the small ResNet on the card leaves its references: {row}")
    if dist.is_initialized():
        fail("the process group outlived the ResNet parity phase")


def phase_exchange_parity():
    """The small fp32 ResNet through each exchange: (a) on the card at a
    world of one, reduce-scatter and ZeRO bitwise the plain DP run, and
    the double-buffered run's parameters after step 2 bitwise the plain
    run's after step 1; (b) each exchange's 3 steps on the card against
    its 3 steps on the CPU (a gloo group beside the NCCL world), within
    RESNET_PARITY_TOL."""
    import torch.distributed as dist
    from chainermn_tpu_torch import create_communicator
    from chainermn_tpu_torch.communicators import MeshCommunicator
    flags = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.deterministic)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    exchanges = {"plain": {}, "rs": dict(exchange="reduce_scatter"),
                 "zero": dict(zero_sharding=True),
                 "db": dict(double_buffering=True)}
    comm = create_communicator("pure_nccl")
    try:
        cpu_comm = MeshCommunicator(device="cpu",
                                    group=dist.new_group(backend="gloo"),
                                    name="pure_nccl")
        torch.backends.cudnn.deterministic = True
        det = {k: resnet_parity_run("cuda", True, comm, **kw)
               for k, kw in exchanges.items()}
        plain1 = resnet_parity_run("cuda", True, comm, steps=1)
        db2 = resnet_parity_run("cuda", True, comm, steps=2,
                                double_buffering=True)
        torch.backends.cudnn.deterministic = flags[2]
        card = {k: resnet_parity_run("cuda", True, comm, **kw)
                for k, kw in exchanges.items()}
        cpu = {k: resnet_parity_run("cpu", True, cpu_comm, **kw)
               for k, kw in exchanges.items()}
        calls = dict(comm.calls)
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.deterministic) = flags
        comm.finalize()

    def equal(a, b, params_only=False):
        keys = [p for p in b[1] if not params_only
                or not p.rsplit("/", 1)[1] in ("avg_mean", "avg_var", "N")]
        return all(torch.equal(a[1][p], b[1][p]) for p in keys)

    def max_diff(a, b):
        return max((a[1][p] - v).abs().max().item() for p, v in b[1].items()
                   if v.is_floating_point())

    a = {"rs_bitwise_plain": det["rs"][0] == det["plain"][0]
         and equal(det["rs"], det["plain"]),
         "zero_bitwise_plain": det["zero"][0] == det["plain"][0]
         and equal(det["zero"], det["plain"]),
         "db_step2_bitwise_plain_step1": equal(db2, plain1,
                                               params_only=True)}
    a_diff = {"rs": max_diff(det["rs"], det["plain"]),
              "zero": max_diff(det["zero"], det["plain"]),
              "db": max((db2[1][p] - v).abs().max().item()
                        for p, v in plain1[1].items()
                        if not p.rsplit("/", 1)[1] in (
                            "avg_mean", "avg_var", "N"))}
    b = {k: {"loss_rel_err": max(abs(x - y) / abs(y) for x, y in zip(
                 card[k][0], cpu[k][0])),
             "state_abs_err": max_diff(card[k], cpu[k]),
             "losses": card[k][0], "cpu_losses": cpu[k][0]}
         for k in exchanges}
    row = {"phase": "exchange_parity", "a": a, "a_max_abs_diff": a_diff,
           "b": b, "tol": RESNET_PARITY_TOL, "collectives": calls}
    emit(row)
    if not all(a.values()):
        fail(f"exchange parity (a), largest differences {a_diff}: the "
             f"exchanges differ from the plain step at a world of one")
    for k, errs in b.items():
        if not (errs["loss_rel_err"] < RESNET_PARITY_TOL["loss_rel"]
                and errs["state_abs_err"] < RESNET_PARITY_TOL["state_abs"]):
            fail(f"exchange parity (b): {k} on the card leaves the CPU's "
                 f"run: {errs}")
    if dist.is_initialized():
        fail("the process group outlived the exchange parity phase")


#: what the MNIST phases compare and print
MNIST_METRICS = ("main/loss", "main/accuracy", "validation/main/loss",
                 "validation/main/accuracy")


def mnist_trainer(out):
    """The single-process twin's trainer at its defaults (seeded
    shuffles) for 2 epochs, with a snapshot after epoch 1 too."""
    from chainermn_tpu_torch.examples import train_mnist
    from chainermn_tpu_torch.training import extensions
    args = train_mnist.parse_args(
        ["-e", "2", "-o", os.path.join("build", out), "--device", "cuda"])
    trainer = train_mnist.make_trainer(args, seed=0)
    trainer.extend(extensions.snapshot(), trigger=(1, "epoch"))
    return trainer


def phase_train_mnist():
    from chainermn_tpu_torch.serializers import load_npz
    reset_launches()
    trainer = mnist_trainer("chip_smoke_mnist")
    trainer.run()
    torch.cuda.synchronize()
    launches = read_launches()
    log = trainer.get_extension("LogReport").log
    per_epoch = trainer.updater.iteration // 2
    resumed = mnist_trainer("chip_smoke_mnist_resumed")
    load_npz(os.path.join(trainer.out, f"snapshot_iter_{per_epoch}"),
             resumed)
    resumed.run()
    rlog = resumed.get_extension("LogReport").log
    diffs = {k: abs(rlog[-1][k] - log[-1][k]) for k in MNIST_METRICS}
    epoch_s = [log[0]["elapsed_time"]] + [
        b["elapsed_time"] - a["elapsed_time"] for a, b in zip(log, log[1:])]
    emit({"phase": "train_mnist", "iterations": trainer.updater.iteration,
          "epoch_wall_s": epoch_s, "last_log": log[-1],
          "resumed_last_log": rlog[-1],
          "resume_bitwise": all(d == 0 for d in diffs.values()),
          "resume_max_abs_diff": max(diffs.values()),
          "launches": launches})
    if any(d != 0 for d in diffs.values()):
        print(f"train_mnist: the resumed epoch differs from the "
              f"uninterrupted one by up to {max(diffs.values())} {diffs}",
              flush=True)
    if not all(np.isfinite([e[k] for e in log + rlog
                            for k in MNIST_METRICS])):
        fail(f"train_mnist log {log} {rlog}")
    if launches != expected_launches():
        fail(f"train_mnist launched flash kernels: {launches}")
    if not (log[1]["validation/main/loss"] < log[0]["validation/main/loss"]
            and log[1]["validation/main/accuracy"]
            >= log[0]["validation/main/accuracy"]
            and log[1]["main/accuracy"] > log[0]["main/accuracy"]):
        fail(f"train_mnist did not learn: {log}")
    if max(diffs.values()) > 1e-6 or rlog[0] != log[0]:
        fail(f"train_mnist: the resumed run left the uninterrupted one: "
             f"{diffs}")


def phase_train_mnist_dp():
    import torch.distributed as dist
    from chainermn_tpu_torch.examples import train_mnist_dp
    from chainermn_tpu_torch.extensions import ObservationAggregator
    from chainermn_tpu_torch.training import PRIORITY_WRITER
    args = train_mnist_dp.parse_args(
        ["-e", "1", "-o", os.path.join("build", "chip_smoke_mnist_dp"),
         "--device", "cuda"])
    reset_launches()
    trainer, comm = train_mnist_dp.make_trainer(args, seed=0)
    try:
        # ahead of LogReport: the aggregator's own priority (EDITOR, as
        # in the JAX package) runs it after LogReport, a WRITER there
        trainer.extend(ObservationAggregator(comm, "main/loss",
                                             "main/loss_aggregated"),
                       priority=PRIORITY_WRITER + 1)
        t0 = time.perf_counter()
        trainer.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_launches()
        calls = dict(comm.calls)
        world, backend = comm.size, dist.get_backend()
    finally:
        comm.finalize()
    log = trainer.get_extension("LogReport").log
    emit({"phase": "train_mnist_dp", "world": world, "backend": backend,
          "iterations": trainer.updater.iteration, "wall_s": wall,
          "last_log": log[-1], "collectives": calls, "launches": launches})
    keys = MNIST_METRICS + ("main/loss_aggregated",)
    if not all(np.isfinite([log[-1][k] for k in keys])):
        fail(f"train_mnist_dp log {log}")
    if abs(log[-1]["main/loss_aggregated"] - log[-1]["main/loss"]) > 1e-6:
        fail(f"train_mnist_dp: the aggregated loss is not the loss at a "
             f"world of one: {log[-1]}")
    if launches != expected_launches():
        fail(f"train_mnist_dp launched flash kernels: {launches}")
    if dist.is_initialized():
        fail("the process group outlived the MNIST data-parallel phase")


# -- the ImageNet example's path (the twin's trainer) -------------------------

#: the twin's convnets at the example's defaults: per-card batch 32 at
#: 224^2, 1000 classes, lr 0.01, cut to 12 timed iterations (2 warm up)
#: and 3 profiled ones over --n-train 512
IMAGENET_ARCHS = ("alex", "nin", "vgg16", "googlenet")
IMAGENET_BATCH, IMAGENET_STEPS, IMAGENET_WARMUP, IMAGENET_PROFILED = \
    32, 12, 2, 3
IMAGENET_N_TRAIN = 512
#: the input pipeline: train_resnet's model through the twin (batch 64)
PIPELINE_BATCH = 64
PIPELINE_RUNS = [("thread", []), ("native", []), ("multiprocess", []),
                 ("fused", ["--fused", "4"])]
#: H100 SXM dense TF32 tensor-core peak: cuDNN runs fp32 convolutions on
#: TF32 by PyTorch's default (cudnn.allow_tf32), which the port keeps
PEAK_TF32_FLOPS = 495e12
#: remat: train_resnet's model, each setting twice in turns
REMAT_STEPS, REMAT_ORDER = 8, (False, True, True, False)
#: remat against no remat, the small fp32 model on the card (TF32 off,
#: deterministic cuDNN): the same kernels on the same inputs
REMAT_TOL = 1e-5
#: the convnets on the card against the CPU, TF32 off: fp32 logits and
#: loss, fp64 gradients (phase_convnet_parity says why); summation order
CONVNET_PARITY = {"alex": 67, "nin": 67, "vgg16": 64, "googlenet": 64}
CONVNET_TOL = 1e-4


def tf32_flags():
    return {"cudnn.allow_tf32": torch.backends.cudnn.allow_tf32,
            "cuda.matmul.allow_tf32": torch.backends.cuda.matmul.allow_tf32}


def set_tf32(cudnn, matmul):
    torch.backends.cudnn.allow_tf32 = cudnn
    torch.backends.cuda.matmul.allow_tf32 = matmul


def twin_args(*flags):
    from chainermn_tpu_torch.examples import train_imagenet
    return train_imagenet.parse_args(
        ["--device", "cuda", "--communicator", "pure_nccl",
         "--grad-dtype", "bfloat16", "-o",
         os.path.join("build", "chip_smoke_imagenet"), *flags])


def forward_flops(model, x):
    """2 x the multiply-adds of the convolutions, transposed convolutions
    and linears of one forward of ``x``, from their shapes (hooks on a
    no-grad forward)."""
    from chainermn_tpu_torch.nn import links as L
    total = [0]

    def conv(link, inputs, y):
        w = link.W
        total[0] += 2 * y.numel() * w.shape[1] * w.shape[2] * w.shape[3]

    def linear(link, inputs, y):
        total[0] += 2 * y.numel() * link.W.shape[1]

    def deconv(link, inputs, y):   # each input element times its taps
        w = link.W
        total[0] += 2 * inputs[0].numel() * w.shape[1] * w.shape[2] \
            * w.shape[3]

    kinds = {L.Convolution2D: conv, L.Deconvolution2D: deconv,
             L.Linear: linear}
    hooks = [m.register_forward_hook(kinds[type(m)])
             for m in model.modules() if type(m) in kinds]
    from chainermn_tpu_torch.core.config import using_config
    try:
        with torch.no_grad(), using_config("train", False):
            model(x)
    finally:
        for h in hooks:
            h.remove()
    return total[0]


def run_twin(trainer, n_fused=1, steps=IMAGENET_STEPS,
             profiled=IMAGENET_PROFILED):
    """Run the twin's trainer (its stop trigger at ``steps`` +
    ``profiled`` updates' iterations), the launch counts read around the
    run: the first ``steps`` updates timed by CUDA events (per step: an
    update's time / n_fused), the last ``profiled`` under the profiler;
    one loss per update (a fused update reports the mean of its K
    steps).  Returns a dict."""
    from torch.profiler import ProfilerActivity, profile
    losses, marks, out = [], [], {}
    timed = steps // n_fused

    def record(tr):
        losses.append(tr.observation["main/loss"])
        k = len(losses)
        if k <= timed:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            marks.append(ev)
        if k == timed:
            torch.cuda.synchronize()
            out["peak_bytes"] = torch.cuda.max_memory_allocated()
            out["prof"] = profile(activities=[ProfilerActivity.CPU,
                                              ProfilerActivity.CUDA])
            out["prof"].__enter__()
            out["t0"] = time.perf_counter()
        elif k == timed + profiled:
            torch.cuda.synchronize()
            out["wall_s"] = time.perf_counter() - out["t0"]
            out["prof"].__exit__(None, None, None)

    trainer.extend(record, name="record")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    start = torch.cuda.Event(enable_timing=True)
    start.record()
    trainer.run()
    torch.cuda.synchronize()
    launches = read_launches()
    update_ms = [start.elapsed_time(marks[0])] + [
        a.elapsed_time(b) for a, b in zip(marks, marks[1:])]
    busy, by_name = profile_summary(out.pop("prof"))
    step_ms = [u / n_fused for u in update_ms]
    median = float(np.median(step_ms[max(1, IMAGENET_WARMUP // n_fused):]))
    return {"step_ms": step_ms, "median_step_ms": median,
            "losses": [float(x) for x in losses],
            "peak_bytes": out["peak_bytes"], "launches": launches,
            "profiled_steps": profiled * n_fused,
            "wall_s": out["wall_s"], "device_busy_s": busy,
            "device_idle_share": 1.0 - busy / out["wall_s"],
            "classes_us": op_classes_us(by_name),
            "pageable_h2d_us": sum(us for n, us in by_name.items()
                                   if "Pageable" in n and "HtoD" in n),
            "pinned_h2d_us": sum(us for n, us in by_name.items()
                                 if "Pinned" in n and "HtoD" in n),
            "top_kernels_us": [[n[:80], us] for n, us in sorted(
                by_name.items(), key=lambda kv: -kv[1])[:8]]}


def check_twin_row(name, row, n_losses):
    if not (all(np.isfinite(row["losses"]))
            and len(row["losses"]) == n_losses):
        fail(f"{name} losses {row['losses']}")
    if row["launches"] != expected_launches():
        fail(f"{name} launched flash kernels: {row['launches']}")
    if row["device_busy_s"] <= 0 or not row["classes_us"]["convolution"]:
        fail(f"{name}: the profiled steps ran no convolution on the card: "
             f"{row['classes_us']}")


def phase_train_imagenet():
    """The twin's trainer for each convnet arch at the example's
    defaults, under PyTorch's TF32 defaults (the port sets none)."""
    import torch.distributed as dist
    from torch.nn.parameter import is_lazy

    from chainermn_tpu_torch import create_communicator, scatter_dataset
    from chainermn_tpu_torch.dataset import get_synthetic_imagenet
    from chainermn_tpu_torch.examples import train_imagenet
    flags = tf32_flags()
    set_tf32(True, False)
    comm = create_communicator("pure_nccl", allreduce_grad_dtype="bfloat16")
    rows = []
    try:
        shard = scatter_dataset(get_synthetic_imagenet(n=IMAGENET_N_TRAIN),
                                comm, shuffle=True, seed=0)
        for arch in IMAGENET_ARCHS:
            torch.cuda.empty_cache()
            args = twin_args(
                "--arch", arch, "-b", str(IMAGENET_BATCH), "--lr", "0.01",
                "--n-train", str(IMAGENET_N_TRAIN), "--iterations",
                str(IMAGENET_STEPS + IMAGENET_PROFILED))
            model = train_imagenet.Classifier(train_imagenet.make_model(args))
            flops = 3 * forward_flops(
                model.predictor, torch.zeros(1, 3, 224, 224, device="cuda"))
            trainer, _ = train_imagenet.make_trainer(args, comm=comm,
                                                     data=shard, model=model)
            row = run_twin(trainer)
            images_per_s = IMAGENET_BATCH / (row["median_step_ms"] * 1e-3)
            row = {"phase": "train_imagenet", "arch": arch,
                   "batch": IMAGENET_BATCH, "image": 224,
                   "params": sum(p.numel() for p in model.parameters()
                                 if not is_lazy(p)),
                   "images_per_s": images_per_s,
                   "train_flops_per_image": flops,
                   "mfu_tf32_peak": flops * images_per_s / PEAK_TF32_FLOPS,
                   "tf32": tf32_flags(), **row}
            del trainer, model
            emit(row)
            check_twin_row(f"train_imagenet {arch}", row,
                           IMAGENET_STEPS + IMAGENET_PROFILED)
            rows.append(row)
    finally:
        set_tf32(*flags.values())
        comm.finalize()
    if dist.is_initialized():
        fail("the process group outlived the train_imagenet phase")
    return rows


def phase_train_imagenet_pipeline(resnet_row):
    """train_resnet's model through the twin with --uint8-input
    --device-prefetch 2 under each loader, then --fused 4, beside
    train_resnet's reading from this call."""
    import torch.distributed as dist
    from chainermn_tpu_torch import create_communicator
    from chainermn_tpu_torch.examples import train_imagenet
    comm = create_communicator("pure_nccl", allreduce_grad_dtype="bfloat16")
    rows = []
    x_bytes = PIPELINE_BATCH * 3 * RESNET_IMAGE ** 2   # uint8 images
    try:
        for label, extra in PIPELINE_RUNS:
            torch.cuda.empty_cache()
            n_fused = int(extra[1]) if extra else 1
            loader = "thread" if label == "fused" else label
            args = twin_args(
                "--arch", "resnet50", "-b", str(PIPELINE_BATCH),
                "--uint8-input", "--device-prefetch", "2", "--loader",
                loader, "--n-train", str(IMAGENET_N_TRAIN), "--iterations",
                str(IMAGENET_STEPS + IMAGENET_PROFILED * n_fused), *extra)
            trainer, _ = train_imagenet.make_trainer(args, comm=comm,
                                                     seed=0)
            it = trainer.updater.get_iterator()
            row = run_twin(trainer, n_fused)
            if hasattr(it, "h2d_bytes"):
                h2d = it.h2d_bytes / it.h2d_batches
            else:   # the fused updater's converter copies each batch
                h2d = x_bytes + PIPELINE_BATCH * 4
            row = {"phase": "train_imagenet_pipeline", "run": label,
                   "loader": loader, "fused": n_fused,
                   "device_prefetch": 0 if n_fused > 1 else 2,
                   "iterator": type(it).__name__,
                   "images_per_s": PIPELINE_BATCH
                   / (row["median_step_ms"] * 1e-3),
                   "h2d_bytes_per_step": h2d,
                   "fp32_h2d_bytes_per_step": 4 * x_bytes,
                   "pageable_h2d_in_profile": row["pageable_h2d_us"] > 0,
                   "train_resnet": {k: resnet_row[k] for k in (
                       "images_per_s", "device_idle_share", "peak_bytes")},
                   **row}
            del trainer, it
            emit(row)
            check_twin_row(f"train_imagenet_pipeline {label}", row,
                           IMAGENET_STEPS // n_fused + IMAGENET_PROFILED)
            rows.append(row)
    finally:
        comm.finalize()
    if dist.is_initialized():
        fail("the process group outlived the pipeline phase")
    return rows


def finetune_bn(device):
    """A convolution and a batch norm called with ``finetune=True``,
    whose ``N`` counts the training forwards."""
    from chainermn_tpu_torch.core.link import Chain
    from chainermn_tpu_torch.nn import links as L

    class FinetuneBN(Chain):
        # two pairs: a recompute may stop after the last saved tensor,
        # before the last batch norm's update, but not before the first's
        def __init__(self):
            super().__init__()
            self.conv = L.Convolution2D(3, 8, 3, pad=1, seed=1,
                                        device=device)
            self.bn = L.BatchNormalization(8, device=device)
            self.conv2 = L.Convolution2D(8, 8, 3, pad=1, seed=2,
                                         device=device)
            self.bn2 = L.BatchNormalization(8, device=device)

        def forward(self, x):
            h = torch.relu(self.bn(self.conv(x), finetune=True))
            return self.bn2(self.conv2(h), finetune=True)

    return FinetuneBN()


def remat_small_run(device, remat, steps=3):
    """RESNET_PARITY's model (fp32, MomentumSGD) with or without remat
    for ``steps`` steps, and a batch norm with finetune checkpointed the
    same way: (losses, state, N of the finetune batch norm)."""
    from chainermn_tpu_torch.core.optimizer import MomentumSGD
    from chainermn_tpu_torch.models import Classifier, ResNet
    from chainermn_tpu_torch.models.resnet import checkpoint_link
    cfg = RESNET_PARITY
    model = Classifier(ResNet(cfg["blocks"], n_classes=cfg["n_classes"],
                              seed=0, layout="NHWC", remat=remat,
                              device=device))
    opt = MomentumSGD(lr=cfg["lr"], momentum=0.9).setup(model)
    ft = finetune_bn(device)
    rng = np.random.RandomState(4)
    losses = []
    for _ in range(steps):
        x = rng.normal(0, 1, (cfg["batch"], cfg["size"], cfg["size"], 3))
        t = rng.randint(0, cfg["n_classes"], cfg["batch"])
        losses.append(opt.update(
            model, torch.from_numpy(x.astype(np.float32)).to(device),
            torch.from_numpy(t).to(device)).item())
        xf = torch.from_numpy(x.astype(np.float32)).to(device) \
            .permute(0, 3, 1, 2).contiguous()
        y = checkpoint_link(ft, xf) if remat else ft(xf)
        y.sum().backward()
    state = {p: v.detach().cpu() for p, v in model.namedparams()}
    state.update((p, v.cpu()) for p, v in model.namedpersistent())
    return losses, state, int(ft.bn.N)


def phase_resnet_remat():
    """ResNet-50 (train_resnet's model and data) with remat off and on in
    turns: step time and peak memory; then the small fp32 ResNet with
    and without remat, held equal (TF32 off, cudnn.deterministic on)."""
    import torch.distributed as dist
    from chainermn_tpu_torch import (create_communicator,
                                     create_multi_node_optimizer,
                                     scatter_dataset)
    from chainermn_tpu_torch.core.optimizer import MomentumSGD
    from chainermn_tpu_torch.models import Classifier, ResNet50
    comm = create_communicator("pure_nccl", allreduce_grad_dtype="bfloat16")
    runs = []
    try:
        shard = scatter_dataset(resnet_data(), comm)
        for remat in REMAT_ORDER:
            torch.cuda.empty_cache()
            model = Classifier(ResNet50(compute_dtype=torch.bfloat16,
                                        device="cuda", remat=remat,
                                        **RESNET))
            opt = create_multi_node_optimizer(
                MomentumSGD(lr=0.1, momentum=0.9), comm).setup(model)
            updater, step_ms, losses, peak, launches = timed_trainer_run(
                opt, shard, RESNET_BATCH, REMAT_STEPS, "chip_smoke_remat")
            wall, busy, _ = device_profile(
                lambda: [updater.update() for _ in range(3)])
            runs.append({"remat": remat, "step_ms": step_ms,
                         "median_step_ms": float(np.median(
                             step_ms[RESNET_WARMUP:])),
                         "peak_bytes": peak, "losses": losses,
                         "device_busy_ms_per_step": busy / 3 * 1e3,
                         "device_idle_share": 1.0 - busy / wall,
                         "launches": launches})
            del model, opt
    finally:
        comm.finalize()
    flags = tf32_flags()
    deterministic = torch.backends.cudnn.deterministic
    set_tf32(False, False)
    torch.backends.cudnn.deterministic = True
    try:
        off = remat_small_run("cuda", False)
        on = remat_small_run("cuda", True)
    finally:
        set_tf32(*flags.values())
        torch.backends.cudnn.deterministic = deterministic
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(on[0], off[0]))
    state_err = max(((on[1][p] - v).abs().max()
                     / max(v.abs().max(), 1e-30)).item()
                    for p, v in off[1].items() if v.is_floating_point())
    ints_equal = all(torch.equal(on[1][p], v) for p, v in off[1].items()
                     if not v.is_floating_point())
    row = {"phase": "resnet_remat", "batch": RESNET_BATCH, "runs": runs,
           "small": {"losses": on[0], "no_remat_losses": off[0],
                     "loss_rel_err": loss_err, "state_rel_err": state_err,
                     "int_state_equal": ints_equal,
                     "finetune_N": [on[2], off[2]], "tol": REMAT_TOL}}
    emit(row)
    for r in runs:
        if not all(np.isfinite(r["losses"])) \
                or r["launches"] != expected_launches():
            fail(f"resnet_remat run {r}")
    if not (loss_err < REMAT_TOL and state_err < REMAT_TOL and ints_equal
            and on[2] == off[2] == 3):
        fail(f"remat leaves the plain step: {row['small']}")
    if dist.is_initialized():
        fail("the process group outlived the remat phase")
    return row


def small_convnet(arch, device):
    """The arch at 10 classes, weights from seed 0, in a Classifier."""
    from chainermn_tpu_torch import models
    cls = {"alex": models.AlexNet, "nin": models.NIN, "vgg16": models.VGG16,
           "googlenet": models.GoogLeNet}[arch]
    return models.Classifier(cls(n_classes=10, seed=0, device=device))


def convnet_eval_grads(arch, device, x, t, dtype=torch.float32):
    """The small arch's logits, loss and parameter gradients under
    train=False on ``device``, in ``dtype`` (the lazy layers made in
    fp32 first, from the seed)."""
    from chainermn_tpu_torch.core.config import using_config
    model = small_convnet(arch, device)
    x, t = torch.from_numpy(x).to(device), torch.from_numpy(t).to(device)
    with torch.no_grad(), using_config("train", False):
        model.predictor(x)
    model = model.to(dtype)
    with using_config("train", False):
        logits = model.predictor(x.to(dtype))
        loss = model(x.to(dtype), t)
    loss.backward()
    grads = {p: v.grad.detach().cpu() for p, v in model.namedparams()
             if v.grad is not None}
    return logits.detach().cpu(), loss.item(), grads


def grad_errs(grads, ref):
    """The worst gradient error relative to each parameter's largest
    |reference|, and how many elements are off by more than CONVNET_TOL
    of it."""
    worst, n_off = 0.0, 0
    for p, g in ref.items():
        scale = max(g.abs().max().item(), 1e-30)
        diff = (grads[p] - g).abs()
        worst = max(worst, diff.max().item() / scale)
        n_off += int((diff > CONVNET_TOL * scale).sum())
    return worst, n_off


def convnet_train_losses(arch, x, t, steps=3):
    from chainermn_tpu_torch.core.optimizer import MomentumSGD
    model = small_convnet(arch, "cuda")
    opt = MomentumSGD(lr=0.01, momentum=0.9)
    opt.seed = 0
    opt.setup(model)
    x, t = torch.from_numpy(x).cuda(), torch.from_numpy(t).cuda()
    return [opt.update(model, x, t).item() for _ in range(steps)]


def phase_convnet_parity():
    """Each convnet, small (10 classes, batch 2): the card against the
    CPU under train=False (dropout the identity), TF32 off: the fp32
    logits and loss, and the parameter gradients in fp64.  An fp32
    whole-model gradient of a ReLU and max-pool network moves a channel
    by a share of its largest value wherever a pre-activation or a
    window's runner-up lies within the rounding of 0 or of the maximum,
    which either side crosses at its own places (PERF.md, Findings); fp64
    leaves no such element, so it holds the card's gradient to the
    CPU's.  The fp32 gradients' distance is printed beside it.  Then 3
    fp32 training steps on the card, twice from one seed."""
    flags = tf32_flags()
    deterministic = torch.backends.cudnn.deterministic
    set_tf32(False, False)
    torch.backends.cudnn.deterministic = True
    rows = {}
    try:
        for arch, size in CONVNET_PARITY.items():
            rng = np.random.RandomState(3)
            x = rng.normal(0, 1, (2, 3, size, size)).astype(np.float32)
            t = rng.randint(0, 10, 2).astype(np.int64)
            reset_launches()
            lc, loss_c, gc = convnet_eval_grads(arch, "cuda", x, t)
            lh, loss_h, gh = convnet_eval_grads(arch, "cpu", x, t)
            _, _, gc64 = convnet_eval_grads(arch, "cuda", x, t,
                                            torch.float64)
            _, _, gh64 = convnet_eval_grads(arch, "cpu", x, t,
                                            torch.float64)
            first = convnet_train_losses(arch, x, t)
            again = convnet_train_losses(arch, x, t)
            torch.cuda.synchronize()
            launches = read_launches()
            dropout = arch != "nin"
            rows[arch] = {
                "size": size,
                "logit_rel_err": ((lc - lh).abs().max()
                                  / max(lh.abs().max(), 1e-30)).item(),
                "loss_rel_err": abs(loss_c - loss_h) / abs(loss_h),
                "grad64_rel_err": grad_errs(gc64, gh64)[0],
                "grad32_rel_err_and_elements_off": grad_errs(gc, gh),
                "card32_vs_64": grad_errs(
                    gc, {p: g.float() for p, g in gc64.items()}),
                "cpu32_vs_64": grad_errs(
                    gh, {p: g.float() for p, g in gh64.items()}),
                "grads": len(gh),
                "same_grad_paths": sorted(gc) == sorted(gh),
                "eval_loss": loss_c, "cpu_eval_loss": loss_h,
                "train_losses": first, "again_bitwise": first == again,
                "dropout_live": first[0] != loss_c if dropout
                else first[0] == loss_c, "launches": launches}
    finally:
        set_tf32(*flags.values())
        torch.backends.cudnn.deterministic = deterministic
    emit({"phase": "convnet_parity", "tol": CONVNET_TOL, **rows})
    for arch, r in rows.items():
        if not (r["logit_rel_err"] < CONVNET_TOL
                and r["loss_rel_err"] < CONVNET_TOL
                and r["grad64_rel_err"] < CONVNET_TOL
                and r["same_grad_paths"]
                and all(np.isfinite(r["train_losses"]))
                and r["again_bitwise"] and r["dropout_live"]
                and r["launches"] == expected_launches()):
            fail(f"convnet_parity {arch}: {r}")


#: train_resnet_files: train_resnet's model fed from image files, the
#: reference's ImageNet input (file paths scattered, not tensors):
#: seeded uint8 CHW 224^2 .npy images and a "<path> <label>" list ->
#: LabeledImageDataset -> scatter_dataset -> MultithreadIterator -> the
#: device-feed stage; one epoch of 64-image steps (timed) and 3 more
#: (profiled), then the same run fed the same arrays from memory (losses
#: bitwise, cuDNN deterministic)
FILES_N, FILES_STEPS, FILES_PROFILED, FILES_THREADS = 384, 6, 3, 4
#: surface_parity: the port's last F and L surface on the card against
#: the CPU in fp32 (TF32 off) at ResNet-50's stage-1 output at batch 8,
#: [8, 2048] for the losses, Highway and Maxout.  Each output and each
#: input gradient relative to its largest |CPU value|: exact for the
#: functions that only move or select elements; 1e-5 for elementwise
#: functions (CUDA's and the CPU's transcendental kernels round the last
#: ulps differently); 1e-4 where a sum runs over hundreds to thousands
#: of terms in another order (reductions, scans, products, convolutions,
#: the resize and normalization layers)
SURFACE_SHAPE, SURFACE_WIDE = (8, 256, 56, 56), (8, 2048)
SURFACE_TOL = {"exact": 0.0, "elementwise": 1e-5, "sum": 1e-4}
#: dlpack_bridge: one uint8 input batch of the ImageNet pipeline
BRIDGE_SHAPE, BRIDGE_ROUNDS = (64, 3, 224, 224), 20


def _nhwc(example):
    """(image CHW, label) -> (image HWC, label), as the ImageNet twin's
    NHWC feed."""
    return example[0].transpose(1, 2, 0), example[1]


class TimedReads:
    """A dataset whose reads are timed: the host seconds spent in
    ``get_example`` summed over the reader threads."""

    def __init__(self, dataset):
        self.dataset = dataset
        self.seconds = 0.0
        self.reads = 0
        self._lock = threading.Lock()

    def __len__(self):
        return len(self.dataset)

    def __getitem__(self, i):
        t0 = time.perf_counter()
        example = self.dataset[i]
        dt = time.perf_counter() - t0
        with self._lock:
            self.seconds += dt
            self.reads += 1
        return example


def write_image_files(root, n, size=RESNET_IMAGE, seed=0):
    """``n`` seeded uint8 CHW ``.npy`` images and their list file under
    ``root``; returns ``(list path, images, labels)``."""
    rng = np.random.RandomState(seed)
    images = rng.randint(0, 256, (n, 3, size, size)).astype(np.uint8)
    labels = rng.randint(0, RESNET["n_classes"], n).astype(np.int32)
    lines = []
    for i in range(n):
        name = f"img{i:04d}.npy"
        np.save(os.path.join(root, name), images[i])
        lines.append(f"{name} {labels[i]}\n")
    listfile = os.path.join(root, "train.txt")
    with open(listfile, "w") as f:
        f.writelines(lines)
    return listfile, images, labels


def files_run(comm, dataset):
    """train_resnet's model (with on-device input normalization of the
    uint8 pixels) on ``dataset`` through scatter_dataset ->
    MultithreadIterator -> DevicePrefetchIterator -> StandardUpdater:
    FILES_STEPS steps timed, then FILES_PROFILED under the profiler
    (``run_twin``).  Returns its dict with images/s and the feed's
    bytes and stall."""
    from chainermn_tpu_torch import (create_multi_node_optimizer,
                                     scatter_dataset)
    from chainermn_tpu_torch.core.optimizer import MomentumSGD
    from chainermn_tpu_torch.dataset import (DevicePrefetchIterator,
                                             MultithreadIterator,
                                             concat_examples,
                                             identity_converter)
    from chainermn_tpu_torch.models import Classifier, ResNet50
    from chainermn_tpu_torch.training import StandardUpdater, Trainer
    model = Classifier(ResNet50(compute_dtype=torch.bfloat16, device="cuda",
                                input_norm="imagenet", **RESNET))
    comm.bcast_data(model)
    opt = create_multi_node_optimizer(
        MomentumSGD(lr=0.1, momentum=0.9), comm).setup(model)
    shard = scatter_dataset(dataset, comm, shuffle=True, seed=0)
    host = MultithreadIterator(shard, RESNET_BATCH, n_threads=FILES_THREADS,
                               seed=0)
    feed = DevicePrefetchIterator(host, size=2, device="cuda",
                                  converter=concat_examples)
    trainer = Trainer(StandardUpdater(feed, opt,
                                      converter=identity_converter),
                      (FILES_STEPS + FILES_PROFILED, "iteration"),
                      out=os.path.join("build", "chip_smoke_files"))
    row = run_twin(trainer, steps=FILES_STEPS, profiled=FILES_PROFILED)
    return {**row, "images_per_s": RESNET_BATCH
            / (row["median_step_ms"] * 1e-3),
            "h2d_bytes_per_step": feed.h2d_bytes / max(feed.h2d_batches, 1),
            "input_stall_ms": feed.input_stall_ms}


def phase_train_resnet_files(resnet_row):
    """train_resnet's model fed from image files (the reference's
    ImageNet input) beside the same run fed the same arrays from memory,
    both with cuDNN deterministic: the losses bitwise.  Images/s beside
    train_resnet's from this call, the host's read time a batch and the
    card's idle share."""
    import tempfile

    import torch.distributed as dist
    from chainermn_tpu_torch import create_communicator
    from chainermn_tpu_torch.dataset import (LabeledImageDataset,
                                             TransformDataset, TupleDataset)
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    reset_launches()
    comm = create_communicator("pure_nccl", allreduce_grad_dtype="bfloat16")
    try:
        with tempfile.TemporaryDirectory(dir="build") as root:
            t0 = time.perf_counter()
            listfile, images, labels = write_image_files(root, FILES_N)
            write_s = time.perf_counter() - t0
            reads = TimedReads(TransformDataset(
                LabeledImageDataset(listfile, root=root, dtype=np.uint8),
                _nhwc))
            files = files_run(comm, reads)
            torch.cuda.empty_cache()
            memory = files_run(comm, TransformDataset(
                TupleDataset(images, labels), _nhwc))
            one = time.perf_counter()
            batch = [reads.dataset[i] for i in range(RESNET_BATCH)]
            serial_read_ms = (time.perf_counter() - one) * 1e3
            del batch
            files_bytes = sum(os.path.getsize(os.path.join(root, f))
                              for f in os.listdir(root))
    finally:
        torch.backends.cudnn.deterministic = deterministic
        comm.finalize()
    launches = check_no_flash("train_resnet_files")
    row = {"phase": "train_resnet_files", "images": FILES_N,
           "image_bytes_on_disk": files_bytes, "write_s": write_s,
           "batch": RESNET_BATCH, "steps": FILES_STEPS,
           "reader_threads": FILES_THREADS,
           "cudnn_deterministic": True,
           "read_ms_per_batch": reads.seconds / max(reads.reads, 1)
           * RESNET_BATCH * 1e3,
           "reads": reads.reads,
           "serial_read_ms_per_batch_warm": serial_read_ms,
           "files": files, "memory": memory,
           "losses_bitwise": files["losses"] == memory["losses"],
           "train_resnet": {k: resnet_row[k] for k in (
               "images_per_s", "device_idle_share", "median_step_ms")},
           "launches": launches}
    emit(row)
    check_twin_row("train_resnet_files", files, FILES_STEPS + FILES_PROFILED)
    if not row["losses_bitwise"]:
        fail(f"train_resnet_files: the file-fed losses {files['losses']} "
             f"are not the memory-fed {memory['losses']}")
    if dist.is_initialized():
        fail("the process group outlived train_resnet_files")
    return row


def surface_cases(g):
    """``(name, F or L name, group, fn, inputs)`` for every function and
    link the port's last slice added, at ResNet-50's stage-1 widths;
    ``g`` is a seeded numpy Generator.  ``inputs`` are fp32 (or int)
    host arrays; the floating ones are differentiated."""
    from chainermn_tpu_torch.nn import functions as F
    a = g.standard_normal(SURFACE_SHAPE, dtype=np.float32)
    a2 = g.standard_normal(SURFACE_SHAPE, dtype=np.float32)
    pos = np.abs(a) + np.float32(0.1)
    unit = np.tanh(a) * np.float32(0.99)
    near1 = 1 + np.float32(0.01) * a
    w = g.standard_normal(SURFACE_WIDE, dtype=np.float32)
    w2 = g.standard_normal(SURFACE_WIDE, dtype=np.float32)
    labels = g.integers(0, SURFACE_WIDE[1], SURFACE_WIDE[0])
    n, c, h, wd = SURFACE_SHAPE
    hw = h * wd
    vec = g.standard_normal(c, dtype=np.float32)
    sq = g.standard_normal((wd, wd), dtype=np.float32)
    dw = g.standard_normal((1, c, 3, 3), dtype=np.float32) * 0.3
    mat = g.standard_normal((hw, 64), dtype=np.float32) * 0.02
    bmat = g.standard_normal((n, hw, 64), dtype=np.float32) * 0.02
    pad = ((0, 0), (0, 0), (1, 2), (2, 1))
    E, S, X = "elementwise", "sum", "exact"
    cases = [
        ("elu", E, F.elu, [a]), ("softplus", E, F.softplus, [a]),
        ("silu", E, F.silu, [a]), ("swish", E, F.swish, [a]),
        ("relu6", X, lambda x: F.relu6(x * 4), [a]),
        ("hard_sigmoid", E, lambda x: F.hard_sigmoid(x * 3), [a]),
        ("softmin", S, F.softmin, [a]), ("crelu", X, F.crelu, [a]),
        ("mean_squared_error", S, F.mean_squared_error, [w, w2]),
        ("mean_absolute_error", S, F.mean_absolute_error, [w, w2]),
        ("squared_error", E, F.squared_error, [w, w2]),
        ("huber_loss", S, F.huber_loss, [w, w2]),
        ("log_softmax_cross_entropy_components", S,
         F.log_softmax_cross_entropy_components, [w, labels]),
        ("depthwise_convolution_2d", S,
         lambda x, k, b: F.depthwise_convolution_2d(x, k, b, pad=1),
         [a, dw, vec]),
        ("unpooling_2d", X, lambda x: F.unpooling_2d(x, 2, cover_all=False),
         [a]),
        ("unpooling_2d", S,
         lambda x: F.unpooling_2d(x, 3, stride=2, pad=1), [a]),
        ("resize_images", S,
         lambda x: F.resize_images(x, (2 * h, 2 * wd)), [a]),
        ("resize_images", S,
         lambda x: F.resize_images(x, (h // 2, wd // 2)), [a]),
        ("stack", X, lambda x, y: F.stack([x, y], 1), [a, a2]),
        ("hstack", X, lambda x, y: F.hstack([x, y]), [a, a2]),
        ("vstack", X, lambda x, y: F.vstack([x, y]), [a, a2]),
        ("split_axis", X, lambda x: F.split_axis(x, 4, 1), [a]),
        ("separate", X, lambda x: F.separate(x, 0), [a]),
        ("reshape", X, lambda x: F.reshape(x, (n, c, hw)), [a]),
        ("flatten", X, F.flatten, [a]),
        ("transpose", X, lambda x: F.transpose(x, (0, 2, 3, 1)), [a]),
        ("expand_dims", X, lambda x: F.expand_dims(x, 2), [a]),
        ("squeeze", X, lambda x: F.squeeze(x[:, :1]), [a]),
        ("tile", X, lambda x: F.tile(x, (1, 1, 1, 2)), [a]),
        ("broadcast_to", S,     # its gradient sums 256 copies
         lambda x: F.broadcast_to(x[:, :1], SURFACE_SHAPE), [a]),
        ("sum", S, lambda x: F.sum(x, axis=(2, 3)), [a]),
        ("mean", S, lambda x: F.mean(x, axis=(2, 3), keepdims=True), [a]),
        ("max", X, lambda x: F.max(x, axis=1), [a]),
        ("min", X, lambda x: F.min(x, axis=(2, 3)), [a]),
        ("argmax", X, lambda x: F.argmax(x, axis=1), [a]),
        ("sqrt", E, F.sqrt, [pos]), ("exp", E, F.exp, [a]),
        ("log", E, F.log, [pos]),
        ("clip", X, lambda x: F.clip(x, -0.5, 0.5), [a]),
        ("matmul", S, lambda x, m: F.matmul(x.reshape(n * c, hw), m),
         [a, mat]),
        ("batch_matmul", S,
         lambda x, m: F.batch_matmul(x.reshape(n, c, hw), m), [a, bmat]),
        ("where", X, lambda x, y: F.where(x > 0, x, y), [a, a2]),
        ("average", S, lambda x: F.average(x, axis=(2, 3)), [a]),
        ("average", S,
         lambda x, v: F.average(x, axis=1, weights=v * v + 0.1), [a, vec]),
        ("select_item", X, F.select_item, [w, labels]),
        ("absolute", X, F.absolute, [a]),
        ("maximum", X, F.maximum, [a, a2]), ("minimum", X, F.minimum, [a, a2]),
        ("normalize", S, F.normalize, [a]),
        ("sin", E, F.sin, [a]), ("cos", E, F.cos, [a]),
        ("tan", E, F.tan, [unit]), ("arcsin", E, F.arcsin, [unit]),
        ("arccos", E, F.arccos, [unit]), ("arctan", E, F.arctan, [a]),
        ("arctan2", E, F.arctan2, [a, pos]), ("sinh", E, F.sinh, [a]),
        ("cosh", E, F.cosh, [a]), ("erf", E, F.erf, [a]),
        ("erfc", E, F.erfc, [a]), ("floor", X, F.floor, [a]),
        ("ceil", X, F.ceil, [a]), ("sign", X, F.sign, [a]),
        ("square", E, F.square, [a]), ("rsqrt", E, F.rsqrt, [pos]),
        ("log2", E, F.log2, [pos]), ("log10", E, F.log10, [pos]),
        ("log1p", E, F.log1p, [pos]), ("expm1", E, F.expm1, [a]),
        ("cumsum", S, lambda x: F.cumsum(x, axis=1), [a]),
        ("cumprod", S, lambda x: F.cumprod(x, axis=1), [near1]),
        ("prod", S, lambda x: F.prod(x, axis=1), [near1]),
        ("logsumexp", S, lambda x: F.logsumexp(x, axis=1), [a]),
        ("fmod", E, lambda x: F.fmod(x * 3, 0.7), [a]),
        ("fix", X, lambda x: F.fix(x * 3), [a]),
        ("flip", X, lambda x: F.flip(x, (1, 3)), [a]),
        ("fliplr", X, F.fliplr, [a]), ("flipud", X, F.flipud, [a]),
        ("rollaxis", X, lambda x: F.rollaxis(x, 1, 4), [a]),
        ("swapaxes", X, lambda x: F.swapaxes(x, 1, 3), [a]),
        ("moveaxis", X, lambda x: F.moveaxis(x, 1, -1), [a]),
        ("repeat", X, lambda x: F.repeat(x, 2, axis=3), [a]),
        ("diagonal", X, lambda x: F.diagonal(x, 0, 2, 3), [a]),
        ("cast", X, lambda x: F.cast(x, np.float16), [a]),
        ("identity", X, F.identity, [a]),
        ("scale", E, F.scale, [a, vec]), ("bias", E, F.bias, [a, vec]),
        ("matmul_nn", S, lambda x, m: F.matmul_nn(x.reshape(n * c, hw), m),
         [a, mat]),
        ("tensordot", S, lambda x, m: F.tensordot(x, m, axes=1), [a, sq]),
        ("einsum", S, lambda x, m: F.einsum("nchw,hk->nckw", x, m), [a, sq]),
    ]
    for mode, kw in (("constant", {"constant_values": 0.5}),
                     ("edge", {}), ("reflect", {}), ("symmetric", {}),
                     ("wrap", {}), ("reflect", {"reflect_type": "odd"}),
                     ("linear_ramp", {"end_values": 1.0}),
                     ("maximum", {"stat_length": 2}),
                     ("minimum", {"stat_length": 2}),
                     ("mean", {"stat_length": 2}),
                     ("median", {"stat_length": 3}), ("empty", {})):
        group = S if mode in ("mean", "linear_ramp") else \
            E if kw.get("reflect_type") == "odd" else X
        cases.append(("pad", group, lambda x, mode=mode, kw=kw:
                      F.pad(x, pad, mode=mode, **kw), [a]))
    return [(n, "F." + n, grp, fn, inputs) for n, grp, fn, inputs in cases]


def surface_links(g, device):
    """``(label, link, input)`` for the five links and a ``Sequential``
    of four layers, built from fixed seeds on ``device``; ``g`` (a numpy
    Generator) draws the inputs."""
    from chainermn_tpu_torch.core.link import Sequential
    from chainermn_tpu_torch.nn import functions as F
    from chainermn_tpu_torch.nn import links as L
    a = g.standard_normal(SURFACE_SHAPE, dtype=np.float32)
    w = g.standard_normal(SURFACE_WIDE, dtype=np.float32)
    c, d = SURFACE_SHAPE[1], SURFACE_WIDE[1]
    scale = L.Scale(axis=1, W_shape=(c,), bias_term=True, device=device)
    with torch.no_grad():   # away from ones and zeros
        scale.W.copy_(torch.linspace(0.5, 1.5, c))
        scale.bias.copy_(torch.linspace(-0.5, 0.5, c))
    return [
        ("DepthwiseConvolution2D",
         L.DepthwiseConvolution2D(c, 1, 3, pad=1, seed=1, device=device), a),
        ("GroupNormalization", L.GroupNormalization(32, c, device=device), a),
        ("Highway", L.Highway(d, seed=2, device=device), w),
        ("Maxout", L.Maxout(d, d, 4, seed=3, device=device), w),
        ("Scale", scale, a),
        ("Sequential", Sequential(
            L.DepthwiseConvolution2D(c, 1, 3, pad=1, seed=4, device=device),
            L.GroupNormalization(32, c, device=device), F.relu,
            L.Scale(axis=1, W_shape=(c,), bias_term=True, device=device)),
         a)]


def _rel_err(got, want):
    """max |got - want| / max |want|, on ``got``'s device (the CPU value
    copied there); a gradient absent on both sides (no floating output
    to differentiate) agrees."""
    if got is None or want is None:
        return 0.0 if got is None and want is None else float("inf")
    want = want.to(got.device)
    if not got.is_floating_point():
        return 0.0 if torch.equal(got, want) else float("inf")
    return rel_err(got.float(), want.float())


def surface_run(fn, inputs, device, cot_seed):
    """``fn`` on ``inputs`` (host arrays) placed on ``device``: the
    floating outputs, and the gradients of the floating inputs under a
    seeded normal cotangent for each floating output."""
    leaves = [torch.from_numpy(x).to(device) for x in inputs]
    for t in leaves:
        if t.is_floating_point():
            t.requires_grad_(True)
    out = fn(*leaves)
    outs = list(out) if isinstance(out, (tuple, list)) else [out]
    floats = [o for o in outs if o.is_floating_point()]
    if floats:
        gen = torch.Generator().manual_seed(cot_seed)
        cots = [torch.randn(o.shape, generator=gen).to(device, o.dtype)
                for o in floats]
        torch.autograd.backward(floats, cots)
    grads = [t.grad for t in leaves if t.is_floating_point()]
    return [o.detach() for o in outs], grads


def phase_surface_parity():
    """Every function and link the port's last slice added, forward and
    backward on the card in fp32 (TF32 off) against the plain CPU result
    on the same inputs, at ResNet-50's stage-1 widths."""
    flags = tf32_flags()
    set_tf32(False, False)
    reset_launches()
    t0 = time.perf_counter()
    rows, worst = [], {}
    try:
        for i, (name, label, group, fn, inputs) in enumerate(
                surface_cases(np.random.default_rng(0))):
            t1 = time.perf_counter()
            got = surface_run(fn, inputs, "cuda", i)
            want = surface_run(fn, inputs, "cpu", i)
            errs = [_rel_err(g, w) for g, w in
                    zip(got[0] + got[1], want[0] + want[1])]
            err = max(errs) if errs else 0.0
            rows.append({"case": label, "group": group, "max_rel_err": err,
                         "outputs": len(got[0]), "grads": len(got[1]),
                         "s": time.perf_counter() - t1})
            worst[label] = max(worst.get(label, 0.0), err)
            del got, want
        g = np.random.default_rng(1)
        for i, (label, link, x) in enumerate(surface_links(g, "cpu")):
            t1 = time.perf_counter()
            card = copy.deepcopy(link).to("cuda")
            got = surface_run(card, [x], "cuda", 1000 + i)
            want = surface_run(link, [x], "cpu", 1000 + i)
            errs = [_rel_err(a, b) for a, b in
                    zip(got[0] + got[1], want[0] + want[1])]
            errs += [_rel_err(p.grad, q.grad) for p, q in
                     zip(card.parameters(), link.parameters())]
            err = max(errs)
            rows.append({"case": "L." + label, "group": "sum",
                         "max_rel_err": err, "params": sum(
                             p.numel() for p in link.parameters()),
                         "s": time.perf_counter() - t1})
            worst["L." + label] = err
            del card, got, want
    finally:
        set_tf32(*flags.values())
    launches = check_no_flash("surface_parity")
    bad = [r for r in rows if r["max_rel_err"] > SURFACE_TOL[r["group"]]]
    functions = sorted({r["case"] for r in rows if r["case"].startswith("F.")})
    row = {"phase": "surface_parity", "shape": SURFACE_SHAPE,
           "wide": SURFACE_WIDE, "tol": SURFACE_TOL,
           "functions_checked": len(functions),
           "links_checked": sum(r["case"].startswith("L.") for r in rows),
           "cases": len(rows), "seconds": time.perf_counter() - t0,
           "worst_rel_err": worst, "slowest": sorted(
               ([r["case"], r["s"]] for r in rows), key=lambda kv: -kv[1])[:8],
           "failed": bad, "launches": launches}
    emit(row)
    if bad:
        fail(f"surface_parity: {bad}")
    return row


def phase_dlpack_bridge():
    """One uint8 ImageNet batch to the card through the bridge and back:
    bitwise, with its bytes and the median microseconds each way."""
    from chainermn_tpu_torch.utils.dlpack import from_numpy, to_numpy
    reset_launches()
    x = np.random.RandomState(0).randint(0, 256, BRIDGE_SHAPE).astype(
        np.uint8)
    up, down, equal = [], [], True
    for _ in range(BRIDGE_ROUNDS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        t = from_numpy(x, device="cuda")
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        back = to_numpy(t)
        t2 = time.perf_counter()
        up.append((t1 - t0) * 1e6)
        down.append((t2 - t1) * 1e6)
        equal = equal and t.device.type == "cuda" \
            and back.dtype == x.dtype and np.array_equal(back, x)
    launches = check_no_flash("dlpack_bridge")
    bf16 = torch.linspace(-3, 3, 4096, device="cuda").bfloat16()
    bf16_equal = torch.equal(from_numpy(to_numpy(bf16), device="cuda"), bf16)
    row = {"phase": "dlpack_bridge", "shape": BRIDGE_SHAPE,
           "bytes": int(x.nbytes), "rounds": BRIDGE_ROUNDS,
           "h2d_us_median": float(np.median(up)),
           "d2h_us_median": float(np.median(down)),
           "h2d_gb_per_s": x.nbytes / (np.median(up) * 1e-6) / 1e9,
           "d2h_gb_per_s": x.nbytes / (np.median(down) * 1e-6) / 1e9,
           "bitwise": equal, "bf16_bitwise": bf16_equal,
           "launches": launches}
    emit(row)
    if not (equal and bf16_equal):
        fail(f"dlpack_bridge: the round trip is not bitwise: {row}")
    return row


def _event_key(e):
    return (e.get("pid"), e.get("tid"), e.get("ts"), e.get("ph"),
            e.get("name"))


def phase_trace_merge():
    """train_resnet_traced's shards merged by the port's tool (its
    command's ``main``, in this process, which has imported no JAX): the
    merged file loads and validates, and keeps every event of the shards
    but the copies one shard repeats of another's (its metadata) and the
    span ends its balance repair drops or adds (the two runs' shards are
    one rank's, their times on one lane)."""
    import glob
    import importlib.util

    from chainermn_tpu_torch import observability
    from chainermn_tpu_torch.tools import trace_merge
    shards = sorted(glob.glob(os.path.join(
        "build", "chip_smoke_traced_*", "trace-rank0.jsonl")))
    out = os.path.join("build", "chip_smoke_trace_merged.json")
    if os.path.exists(out):
        os.remove(out)
    # what the merge must keep: each (pid, tid, ts, ph, name) as often as
    # the shard holding it most often
    most = collections.Counter()
    for path in shards:
        most |= collections.Counter(
            _event_key(e) for e in observability.read_jsonl(path))
    t0 = time.perf_counter()
    rc = trace_merge.main(["-o", out, *shards])
    seconds = time.perf_counter() - t0
    merged = []
    if rc == 0:
        with open(out) as f:
            merged = json.load(f)
        observability.validate_events(merged)
    kept = collections.Counter(_event_key(e) for e in merged)
    added, lost = kept - most, most - kept
    row = {"phase": "trace_merge", "shards": shards,
           "shard_events": sum(len(observability.read_jsonl(p))
                               for p in shards),
           "distinct_events": sum(most.values()),
           "merged_events": len(merged),
           "lost_events": sum(lost.values()),
           "ends_added": sum(added.values()), "rc": rc,
           "seconds": seconds, "jax_imported": "jax" in sys.modules,
           "jax_installed": importlib.util.find_spec("jax") is not None}
    emit(row)
    if rc != 0 or len(shards) < 2 or row["jax_imported"] \
            or any(k[3] != "E" for k in (*added, *lost)):
        fail(f"trace_merge: {row}")
    return row


#: the two-level exchange and the quantized wires on train_resnet's step
#: (phase 21): (communicator, allreduce_grad_dtype, optimizer keywords)
RESNET_HIER = {
    "train_resnet_hier": ("hierarchical", {"dcn": "bfloat16"}, {}),
    "train_resnet_hier_rs": ("hierarchical", {"dcn": "bfloat16"},
                             dict(exchange="reduce_scatter")),
    "train_resnet_hier_db": ("hierarchical", {"dcn": "bfloat16"},
                             dict(double_buffering=True)),
    "train_resnet_q_int8": ("pure_nccl", "int8", {}),
    "train_resnet_hier_rs_fp8": ("hierarchical", {"dcn": "float8_e4m3"},
                                 dict(exchange="reduce_scatter"))}
#: their order, in turns with a reading of the plain bf16 exchange
RESNET_HIER_ORDER = ["train_resnet_hier", "train_resnet_hier_rs",
                     "train_resnet_hier_db", "train_resnet_plain",
                     "train_resnet_q_int8", "train_resnet_hier_rs_fp8"]
#: each phase's collectives per step (one bucket: the flat exchange)
RESNET_HIER_CALLS = {
    "train_resnet_hier": ("ici_reduce_scatter", "dcn_allreduce",
                          "ici_allgather"),
    "train_resnet_hier_rs": ("ici_reduce_scatter", "dcn_reduce_scatter",
                             "dcn_allgather", "ici_allgather"),
    "train_resnet_hier_db": ("ici_reduce_scatter", "dcn_allreduce",
                             "ici_allgather"),
    "train_resnet_q_int8": ("allgather_q", "allgather_scale"),
    "train_resnet_hier_rs_fp8": ("ici_reduce_scatter", "dcn_alltoall_q",
                                 "dcn_allgather_scale", "dcn_allgather",
                                 "ici_allgather")}
#: the illustrative split the byte accounting is also printed for: 4
#: nodes of 8 cards (accounting, not a measurement)
ILLUSTRATIVE_SPLIT = (4, 8)


def exchange_bytes(comm, n, inter, intra, sharded):
    """Per-rank wire bytes of one step's gradient exchange of ``n`` fp32
    gradients under ``comm``'s wires at an ``inter`` x ``intra`` split,
    by hop (``_memory_utility``'s accounting); the sharded update's
    parameter all-gather beside it."""
    from chainermn_tpu_torch.communicators import _memory_utility as mu
    world = inter * intra
    n_pad = -(-n // world) * world
    cast = comm.grad_cast_dtype
    item = (cast or torch.float32).itemsize
    q = comm.quantized_wire_dtype
    coll = "reduce_scatter" if sharded else "psum"
    if comm.hierarchy is None:   # one hop over the whole world
        hops = {"world": mu.quantized_hop_bytes(n_pad, world, coll, q)
                if q is not None else mu.exchanged_bytes(
                    n_pad * item, world, coll)}
    else:
        chunk = n_pad // intra
        dcn = comm.dcn_grad_dtype
        hops = mu.hierarchical_exchanged_bytes(
            n_pad * item, intra, inter, coll,
            dcn_n_bytes=chunk * (dcn or cast or torch.float32).itemsize)
        if q is not None:
            hops["dcn"] = mu.quantized_hop_bytes(chunk, inter, coll, q)
    out = {"grad": hops}
    if sharded:
        out["params_gather"] = mu.hierarchical_exchanged_bytes(
            n_pad * 4, intra, inter, "all_gather")
    return out


def phase_train_resnet_hier(phase, plain_row):
    """``train_resnet``'s step through the two-level communicator or a
    quantized wire (RESNET_HIER), beside ``plain_row``: a world of one
    NCCL process, so a 1 x 1 split on two NCCL subgroups of one rank;
    what it shows is the device cost of the pack, pad, cast, quantize,
    dequantize and residual at full width."""
    import torch.distributed as dist
    from chainermn_tpu_torch import (create_communicator,
                                     create_multi_node_optimizer,
                                     scatter_dataset)
    from chainermn_tpu_torch.core.optimizer import MomentumSGD
    from chainermn_tpu_torch.models import Classifier, ResNet50
    name, dtype, exchange = RESNET_HIER[phase]
    comm = create_communicator(name, allreduce_grad_dtype=dtype)
    try:
        model = Classifier(ResNet50(compute_dtype=torch.bfloat16,
                                    device="cuda", **RESNET))
        comm.bcast_data(model)
        opt = create_multi_node_optimizer(
            MomentumSGD(lr=0.1, momentum=0.9), comm, **exchange).setup(model)
        shard = scatter_dataset(resnet_data(), comm)
        comm.calls.clear()
        updater, step_ms, losses, peak, launches = timed_trainer_run(
            opt, shard, RESNET_BATCH, RESNET_STEPS, f"chip_smoke_{phase}")
        calls = dict(comm.calls)
        residual = opt._residual
        median_ms = float(np.median(step_ms[RESNET_WARMUP:]))
        images_per_s = RESNET_BATCH / (median_ms * 1e-3)
        flops = resnet50_train_flops_per_image(RESNET_IMAGE)
        prof = profile_steps(f"{phase}_profile", updater, top_n=10,
                             classes_us=op_classes_us)
        n = sum(p.numel() for p in model.parameters())
        sharded = opt._sharded_update
        row = {"phase": phase, "communicator": name,
               "wire": {"ici": str(comm.allreduce_grad_dtype),
                        "dcn": str(comm.dcn_grad_dtype)},
               "exchange": exchange, "steps": RESNET_STEPS,
               "split": [comm.dcn_size, comm.ici_size]
               if comm.hierarchy else None,
               "subgroup_backends": [dist.get_backend(g)
                                     for g in comm._hop_groups],
               "step_ms": step_ms, "median_step_ms": median_ms,
               "images_per_s": images_per_s,
               "mfu": flops * images_per_s / PEAK_FLOPS[torch.bfloat16],
               "losses": losses, "peak_bytes": peak, "launches": launches,
               "device_idle_share": prof["device_idle_share"],
               "residual_bytes": 0 if residual is None
               else residual.numel() * residual.element_size(),
               "collectives": calls, "params": n,
               "exchanged_bytes": exchange_bytes(
                   comm, n, comm.dcn_size, comm.ici_size, sharded),
               "exchanged_bytes_4x8_illustrative": exchange_bytes(
                   comm, n, *ILLUSTRATIVE_SPLIT, sharded),
               **exchange_parts(opt, model, shard),
               "train_resnet": {k: plain_row[k] for k in (
                   "median_step_ms", "images_per_s", "mfu", "peak_bytes",
                   "device_idle_share")}}
        if exchange.get("double_buffering"):
            row["streams"] = kernel_streams(
                lambda: [updater.update() for _ in range(2)])
        opt._reset_exchange()
        emit(row)
    finally:
        comm.finalize()
    want = {k: RESNET_STEPS for k in RESNET_HIER_CALLS[phase]}
    if not all(np.isfinite(losses)) or len(losses) != RESNET_STEPS:
        fail(f"{phase} losses {losses}")
    if launches != expected_launches():
        fail(f"{phase} launched flash kernels: {launches}")
    if calls != want:
        fail(f"{phase}: expected the collectives {want}, got {calls}")
    if name == "hierarchical" and row["subgroup_backends"] != ["nccl"] * 2:
        fail(f"{phase}: the subgroups run {row['subgroup_backends']}")
    if comm.quantized != (residual is not None):
        fail(f"{phase}: residual {row['residual_bytes']} bytes on a "
             f"{'quantized' if comm.quantized else 'lossless'} wire")
    if dist.is_initialized():
        fail(f"the process group outlived {phase}")
    return row


def phase_train_imagenet_hier(pipeline_row):
    """The ImageNet twin with ``--arch resnet50 -c hierarchical`` at the
    pipeline phase's settings (batch 64, ``--uint8-input
    --device-prefetch 2 --loader thread``), its communicator the twin's
    own (the default bf16 wire on both hops), beside the pipeline
    phase's thread-loader reading."""
    import torch.distributed as dist
    from chainermn_tpu_torch.examples import train_imagenet
    args = twin_args(
        "--arch", "resnet50", "-b", str(PIPELINE_BATCH), "--uint8-input",
        "--device-prefetch", "2", "--loader", "thread", "--n-train",
        str(IMAGENET_N_TRAIN), "--iterations",
        str(IMAGENET_STEPS + IMAGENET_PROFILED), "-c", "hierarchical")
    torch.cuda.empty_cache()
    trainer, comm = train_imagenet.make_trainer(args, seed=0)
    try:
        comm.calls.clear()
        row = run_twin(trainer)
        calls = {k: v for k, v in comm.calls.items() if k != "bcast"}
        row = {"phase": "train_imagenet_hier", "communicator": comm.name,
               "split": [comm.dcn_size, comm.ici_size],
               "wire": {"ici": str(comm.allreduce_grad_dtype),
                        "dcn": str(comm.dcn_grad_dtype)},
               "images_per_s": PIPELINE_BATCH
               / (row["median_step_ms"] * 1e-3),
               "collectives": calls,
               "train_imagenet_pipeline_thread": {k: pipeline_row[k] for k in (
                   "images_per_s", "device_idle_share", "peak_bytes")},
               **row}
        del trainer
        emit(row)
    finally:
        comm.finalize()
    n = IMAGENET_STEPS + IMAGENET_PROFILED
    check_twin_row("train_imagenet_hier", row, n)
    want = {k: n for k in RESNET_HIER_CALLS["train_resnet_hier"]}
    if comm.hierarchy is None or calls != want:
        fail(f"train_imagenet_hier: expected {want} on a hierarchical "
             f"communicator, got {calls}")
    if dist.is_initialized():
        fail("the process group outlived train_imagenet_hier")
    return row


#: hier_parity (4): the new exchanges on the small fp32 ResNet, card
#: against CPU: (communicator, allreduce_grad_dtype, optimizer keywords)
HIER_PARITY = {"hier": ("hierarchical", {"dcn": "bfloat16"}, {}),
               "hier_rs": ("hierarchical", {"dcn": "bfloat16"},
                           dict(exchange="reduce_scatter")),
               "hier_db": ("hierarchical", {"dcn": "bfloat16"},
                           dict(double_buffering=True)),
               "q_int8": ("pure_nccl", "int8", {}),
               "hier_rs_fp8": ("hierarchical", {"dcn": "float8_e4m3"},
                               dict(exchange="reduce_scatter"))}
#: (3): applied means + final residual against the true gradients' sum,
#: per element, relative to the largest |gradient|: a few fp32 roundings
#: (one int8 step is 2^-7 of it, which a lost residual would leave)
TELESCOPE_TOL = 2.0 ** -20


def quantization_cases():
    """One gradient-like buffer per wire, an all-zero one and one with
    +-inf and NaN (numpy seed 5), with a residual for each."""
    rng = np.random.RandomState(5)
    cases = [(wire, rng.normal(0, 1e-2 * (k + 1), 1 << 20))
             for k, wire in enumerate(("int8", "float8_e4m3",
                                       "float8_e5m2"))]
    cases += [(wire, np.zeros(4096)) for wire in ("int8", "float8_e4m3")]
    cases += [(wire, np.asarray([1.0, -2.0, np.inf, -np.inf, np.nan, 0.5]
                                * 100))
              for wire in ("int8", "float8_e4m3", "float8_e5m2")]
    return [(wire, v.astype(np.float32),
             rng.normal(0, 1e-4, v.shape).astype(np.float32))
            for wire, v in cases]


def quantization_cost(n):
    """The device time of the int8 wire's work on ``n`` fp32 gradients at
    a world of one: quantize with feedback (read the gradient and the
    residual, write codewords and the new residual) and dequantize-sum
    (read codewords, write fp32), beside a plain fp32 copy of the same
    vector; and the least time the bytes allow."""
    from chainermn_tpu_torch.communicators import _memory_utility as mu
    g = torch.randn(n, device="cuda") * 1e-2
    r = torch.zeros(n, device="cuda")
    q, s, _ = mu.quantize_with_feedback(g, r, "int8")
    quant = time_ms(lambda: mu.quantize_with_feedback(g, r, "int8"))
    deq = time_ms(lambda: mu.dequantize_sum(q[None], s[None]))
    copy = time_ms(lambda: g.clone())
    q_bytes, d_bytes = 13 * n, 5 * n
    return {"n": n, "quantize_with_feedback_ms": quant,
            "dequantize_sum_ms": deq, "fp32_copy_ms": copy,
            "quantize_bytes": q_bytes, "dequantize_bytes": d_bytes,
            "quantize_bound_ms": q_bytes / HBM_BYTES_PER_S * 1e3,
            "dequantize_bound_ms": d_bytes / HBM_BYTES_PER_S * 1e3,
            "passes_over_fp32": (quant + deq) / copy}


def phase_hier_parity(n_params):
    """The small fp32 ResNet of phase 12 with TF32 off: (1) at a world of
    one the hierarchical exchange and its reduce-scatter update are
    bitwise the plain DP step and the reduce-scatter step
    (``cudnn.deterministic`` on); (2) the quantization functions on the
    card bitwise the CPU's; (3) 3 int8 steps on the card: applied means
    plus the final residual equal the true gradients' sum; (4) each new
    exchange's 3 steps on the card against the same on the CPU (a gloo
    group beside the NCCL world) within RESNET_PARITY_TOL.  Then the
    int8 wire's device cost at ``n_params``."""
    import torch.distributed as dist
    from chainermn_tpu_torch import (create_communicator,
                                     create_multi_node_optimizer)
    from chainermn_tpu_torch.communicators import _memory_utility as mu
    from chainermn_tpu_torch.core.optimizer import MomentumSGD
    from chainermn_tpu_torch.models import Classifier, ResNet
    flags = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.deterministic)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    reset_launches()
    plain = create_communicator("pure_nccl")
    try:
        gloo = dist.new_group(backend="gloo")
        hier = create_communicator("hierarchical")
        torch.backends.cudnn.deterministic = True
        det = {"plain": resnet_parity_run("cuda", True, plain),
               "rs": resnet_parity_run("cuda", True, plain,
                                       exchange="reduce_scatter"),
               "hier": resnet_parity_run("cuda", True, hier),
               "hier_rs": resnet_parity_run("cuda", True, hier,
                                            exchange="reduce_scatter")}
        # (3) the telescoping identity over 3 int8 steps
        q8 = create_communicator("pure_nccl", allreduce_grad_dtype="int8")
        cfg = RESNET_PARITY
        model = Classifier(ResNet(cfg["blocks"], n_classes=cfg["n_classes"],
                                  seed=0, layout="NHWC", device="cuda"))
        opt = create_multi_node_optimizer(
            MomentumSGD(lr=cfg["lr"], momentum=0.9), q8).setup(model)
        rng = np.random.RandomState(4)
        true_sum = applied = None
        biggest = 0.0
        for _ in range(3):
            x = torch.from_numpy(rng.normal(0, 1, (
                cfg["batch"], cfg["size"], cfg["size"], 3)).astype(
                    np.float32)).cuda()
            t = torch.from_numpy(rng.randint(0, cfg["n_classes"],
                                             cfg["batch"])).cuda()
            if true_sum is None:
                opt._prepare(model, (x, t), {})
            model.cleargrads()
            model(x, t).backward()
            _, params = opt._sorted_params()
            g = torch.cat([p.grad.reshape(-1) for p in params]).double()
            opt._exchange(None)
            a = torch.cat([p.grad.reshape(-1) for p in params]).double()
            opt._apply_update(None)
            biggest = max(biggest, g.abs().max().item())
            true_sum = g if true_sum is None else true_sum + g
            applied = a if applied is None else applied + a
        # the residual's layout is the bucket's: the flat exchange packs
        # its one bucket in reverse leaf order
        sizes = [p.numel() for p in params]
        res = opt._residual.double()
        res = torch.cat(list(reversed(res.split(list(reversed(sizes))))))
        gap = (true_sum - applied - res).abs().max().item()
        telescope = {"max_gap": gap, "largest_grad": biggest,
                     "tol": TELESCOPE_TOL * biggest,
                     "residual_absmax": res.abs().max().item()}
        torch.backends.cudnn.deterministic = flags[2]
        # (4) card against CPU
        card, cpu = {}, {}
        for key, (name, dtype, kw) in HIER_PARITY.items():
            on_card = create_communicator(name, allreduce_grad_dtype=dtype)
            on_cpu = create_communicator(name, device="cpu", group=gloo,
                                         allreduce_grad_dtype=dtype)
            card[key] = resnet_parity_run("cuda", True, on_card, **kw)
            cpu[key] = resnet_parity_run("cpu", True, on_cpu, **kw)
            if key == "hier":
                backends = {"card": [dist.get_backend(g)
                                     for g in on_card._hop_groups],
                            "cpu": [dist.get_backend(g)
                                    for g in on_cpu._hop_groups]}
        torch.cuda.synchronize()
        launches = read_launches()
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.deterministic) = flags
        plain.finalize()   # the world's owner: every group goes with it
    # (2) the quantization functions, card against CPU
    functions = []
    for wire, v, r in quantization_cases():
        v_c, r_c = torch.from_numpy(v), torch.from_numpy(r)
        on_cpu = mu.quantize_with_feedback(v_c, r_c, wire)
        on_card = mu.quantize_with_feedback(v_c.cuda(), r_c.cuda(), wire)
        sym_cpu = mu.quantize_symmetric(v_c, wire)
        sym_card = mu.quantize_symmetric(v_c.cuda(), wire)
        rows = [mu.quantize_symmetric(v_c * (k + 1), wire) for k in range(4)]
        qs = torch.stack([x[0] for x in rows])
        ss = torch.stack([x[1] for x in rows])
        functions.append({
            "wire": wire, "n": int(v.size),
            "quantize_with_feedback": all(
                torch.equal(a.float(), b.cpu().float())
                for a, b in zip(on_cpu, on_card)),
            "quantize_symmetric": all(
                torch.equal(a.float(), b.cpu().float())
                for a, b in zip(sym_cpu, sym_card)),
            "dequantize_sum": torch.equal(
                mu.dequantize_sum(qs, ss),
                mu.dequantize_sum(qs.cuda(), ss.cuda()).cpu())})

    def equal(a, b):
        return a[0] == b[0] and all(torch.equal(a[1][p], b[1][p])
                                    for p in b[1])

    def max_diff(a, b):
        return max((a[1][p] - v).abs().max().item() for p, v in b[1].items()
                   if v.is_floating_point())

    a = {"hier_bitwise_plain": equal(det["hier"], det["plain"]),
         "hier_rs_bitwise_rs": equal(det["hier_rs"], det["rs"]),
         "hier_rs_bitwise_plain": equal(det["hier_rs"], det["plain"])}
    b = {k: {"loss_rel_err": max(abs(x - y) / abs(y) for x, y in zip(
                 card[k][0], cpu[k][0])),
             "state_abs_err": max_diff(card[k], cpu[k]),
             "losses": card[k][0], "cpu_losses": cpu[k][0]}
         for k in HIER_PARITY}
    row = {"phase": "hier_parity", "a": a,
           "a_max_abs_diff": {"hier": max_diff(det["hier"], det["plain"]),
                              "hier_rs": max_diff(det["hier_rs"],
                                                  det["rs"])},
           "functions": functions, "telescope": telescope, "b": b,
           "subgroup_backends": backends, "tol": RESNET_PARITY_TOL,
           "launches": launches,
           "quantization_cost": quantization_cost(n_params)}
    emit(row)
    if not all(a.values()):
        fail(f"hier_parity (1): the two-level exchange differs from the "
             f"plain step at a world of one: {row['a_max_abs_diff']}")
    if not all(f[k] for f in functions for k in (
            "quantize_with_feedback", "quantize_symmetric",
            "dequantize_sum")):
        fail(f"hier_parity (2): the card's quantization differs from the "
             f"CPU's: {functions}")
    if not (telescope["max_gap"] <= telescope["tol"]
            and telescope["residual_absmax"] > 0):
        fail(f"hier_parity (3): the int8 steps do not telescope: "
             f"{telescope}")
    for k, errs in b.items():
        if not (errs["loss_rel_err"] < RESNET_PARITY_TOL["loss_rel"]
                and errs["state_abs_err"] < RESNET_PARITY_TOL["state_abs"]):
            fail(f"hier_parity (4): {k} on the card leaves the CPU's run: "
                 f"{errs}")
    if backends != {"card": ["nccl"] * 2, "cpu": ["gloo"] * 2}:
        fail(f"hier_parity: subgroups on {backends}")
    if launches != expected_launches():
        fail(f"hier_parity launched flash kernels: {launches}")
    if dist.is_initialized():
        fail("the process group outlived the hier_parity phase")


#: phases 24-27: train_resnet's step through the striped exchange at a
#: 1 x 1 split (stripe ratio 0.25, the JAX package's default): the
#: communicator's keywords and the optimizer's
STRIPE = dict(stripe_ratio=0.25)
RESNET_STRIPED = {
    "train_resnet_striped": (dict(STRIPE, allreduce_grad_dtype={
        "dcn": "bfloat16"}), {}),
    "train_resnet_striped_rs": (dict(STRIPE, allreduce_grad_dtype={
        "dcn": "bfloat16"}), dict(exchange="reduce_scatter")),
    "train_resnet_striped_db_dcn": (dict(STRIPE, allreduce_grad_dtype={
        "dcn": "bfloat16"}), dict(double_buffering="dcn")),
    "train_resnet_striped_q_int8": (dict(STRIPE, allreduce_grad_dtype={
        "dcn": "int8"}), {})}
#: the striped schedule's ops, each once a step (one bucket); the
#: quantized DCN path needs no gather
STRIPED_OPS = ("dcn_path_scatter", "ici_path_scatter", "dcn_path_exchange",
               "ici_path_exchange", "dcn_path_gather", "ici_path_gather")


def striped_paths(events):
    """From a ``torch.profiler`` trace of a step under
    ``CHAINERMN_TPU_TRACE=full``: per striped path the streams of the
    device ops inside its ``train.grad_exchange.bucket*`` ranges (NCCL's
    kernels and copies on their groups' streams apart from the path's
    own kernels), and how long the two paths' device intervals
    overlap."""
    from chainermn_tpu_torch.communicators.mesh_communicator import \
        STRIPED_OP_PATH
    from chainermn_tpu_torch.utils import device_ops_in_ranges
    paths = {p: {"kernel_streams": set(), "copy_streams": set(),
                 "nccl_streams": set(), "ops": 0, "spans": []}
             for p in ("dcn", "ici")}
    for name, op in device_ops_in_ranges(events, "train.grad_exchange."):
        path = STRIPED_OP_PATH.get(name.rsplit(".", 1)[-1])
        if path is None:
            continue
        row = paths[path]
        kind = ("nccl_streams" if "nccl" in op["name"].lower()
                else "kernel_streams" if op.get("cat") == "kernel"
                else "copy_streams")
        row[kind].add(op["args"]["stream"])
        row["ops"] += 1
        row["spans"].append((op["ts"], op["ts"] + op.get("dur", 0)))

    def union(spans):
        out = []
        for a, b in sorted(spans):
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return out

    overlap = 0.0
    for a0, a1 in union(paths["dcn"]["spans"]):
        for b0, b1 in union(paths["ici"]["spans"]):
            overlap += max(0.0, min(a1, b1) - max(a0, b0))
    out = {p: {"ops": row["ops"],
               "device_ms": sum(b - a for a, b in union(row["spans"]))
               * 1e-3,
               **{k: sorted(row[k], key=str) for k in (
                   "kernel_streams", "copy_streams", "nccl_streams")}}
           for p, row in paths.items()}
    out["overlap_ms"] = overlap * 1e-3
    return out


def profiled_events(fn, name):
    """``fn()`` under ``torch.profiler`` (host and card): the trace's
    events, also written to ``build/<name>.json``."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    os.makedirs("build", exist_ok=True)
    path = os.path.join("build", f"{name}.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        return json.load(f)["traceEvents"]


def streams_under_full(updater, name):
    """One step of ``updater`` traced under ``CHAINERMN_TPU_TRACE=full``:
    :func:`striped_paths` of it, and the streams of the step's own work
    (the ops in the ``train.forward``, ``train.backward`` and
    ``train.rule`` ranges, but for those inside a
    ``train.grad_exchange.bucket*`` range: the sharded update's gather
    runs in the rule on the paths' streams)."""
    from chainermn_tpu_torch import observability
    from chainermn_tpu_torch.utils import device_ops_in_ranges
    prev = observability.set_mode("full")
    try:
        events = profiled_events(updater.update, name)
    finally:
        observability.set_mode(prev)
        observability.reset_tracer()
        observability.reset_registry()
    paths = striped_paths(events)
    joined = device_ops_in_ranges(events, "train.")
    on_paths = {id(op) for name, op in joined
                if name.startswith("train.grad_exchange.bucket")}
    paths["caller_streams"] = sorted(
        {op["args"]["stream"] for name, op in joined
         if name in ("train.forward", "train.backward", "train.rule")
         and id(op) not in on_paths}, key=str)
    return paths


def check_two_side_streams(phase, paths):
    """Each path's own kernels ran on one side stream of its own, neither
    the other path's nor the caller's."""
    dcn, ici = (set(paths[p]["kernel_streams"]) for p in ("dcn", "ici"))
    caller = set(paths["caller_streams"])
    if not (len(dcn) == len(ici) == 1 and dcn != ici and caller
            and not (dcn | ici) & caller):
        fail(f"{phase}: the striped paths did not run on two side streams: "
             f"{paths}")


def phase_train_resnet_striped(phase, plain_row):
    """``train_resnet``'s step through the striped exchange (RESNET_STRIPED)
    at a 1 x 1 split on NCCL subgroups, beside ``plain_row``: the device
    cost of the striped packs, splits, casts and copies at full width,
    the streams each path ran on and how long they overlapped."""
    import torch.distributed as dist
    from chainermn_tpu_torch import (create_communicator,
                                     create_multi_node_optimizer,
                                     scatter_dataset)
    from chainermn_tpu_torch.core.optimizer import MomentumSGD
    from chainermn_tpu_torch.models import Classifier, ResNet50
    comm_kw, exchange = RESNET_STRIPED[phase]
    comm = create_communicator("hierarchical", **comm_kw)
    try:
        model = Classifier(ResNet50(compute_dtype=torch.bfloat16,
                                    device="cuda", **RESNET))
        comm.bcast_data(model)
        opt = create_multi_node_optimizer(
            MomentumSGD(lr=0.1, momentum=0.9), comm, **exchange).setup(model)
        shard = scatter_dataset(resnet_data(), comm)
        comm.calls.clear()
        updater, step_ms, losses, peak, launches = timed_trainer_run(
            opt, shard, RESNET_BATCH, RESNET_STEPS, f"chip_smoke_{phase}")
        calls = dict(comm.calls)
        median_ms = float(np.median(step_ms[RESNET_WARMUP:]))
        images_per_s = RESNET_BATCH / (median_ms * 1e-3)
        flops = resnet50_train_flops_per_image(RESNET_IMAGE)
        prof = profile_steps(f"{phase}_profile", updater, top_n=10,
                             classes_us=op_classes_us)
        residual = opt._residual
        row = {"phase": phase, "communicator": comm.name,
               "topology": comm.topology, "stripe_ratio": comm.stripe_ratio,
               "wire": {"ici": str(comm.allreduce_grad_dtype),
                        "dcn": str(comm.dcn_grad_dtype)},
               "exchange": exchange, "steps": RESNET_STEPS,
               "split": [comm.dcn_size, comm.ici_size],
               "subgroup_backends": [dist.get_backend(g) for g in (
                   *comm._hop_groups, *comm._path_groups)],
               "step_ms": step_ms, "median_step_ms": median_ms,
               "images_per_s": images_per_s,
               "mfu": flops * images_per_s / PEAK_FLOPS[torch.bfloat16],
               "losses": losses, "peak_bytes": peak, "launches": launches,
               "device_idle_share": prof["device_idle_share"],
               "collectives": calls,
               "ops_per_step": {k: v / RESNET_STEPS for k, v in calls.items()},
               "residual_bytes": 0 if residual is None
               else residual.numel() * residual.element_size(),
               "grad_residual_len": comm.grad_residual_len_for(model),
               "grad_dcn_stale_len": comm.grad_dcn_stale_len_for(model),
               "params": sum(p.numel() for p in model.parameters()),
               **exchange_parts(opt, model, shard),
               "train_resnet": {k: plain_row[k] for k in (
                   "median_step_ms", "images_per_s", "mfu", "peak_bytes",
                   "device_idle_share")}}
        if opt._sharded_update:
            row["segments"] = [list(seg) for seg in opt._segments()]
            row["state_elems"] = {
                k: {slot: v.numel() for slot, v in st.items()
                    if isinstance(v, torch.Tensor)}
                for k, st in opt.actual_optimizer._state.items()}
        if opt._db_dcn:
            stale = opt._stale_dcn.wait()
            row["stale_dcn_bytes"] = stale.numel() * stale.element_size()
        row["paths"] = streams_under_full(updater, f"chip_smoke_{phase}_full")
        opt._reset_exchange()
        emit(row)
    finally:
        comm.finalize()
    ops = [op for op in STRIPED_OPS if not (
        comm.quantized and op == "dcn_path_gather")]
    want = {op: RESNET_STEPS for op in ops}
    if not all(np.isfinite(losses)) or len(losses) != RESNET_STEPS:
        fail(f"{phase} losses {losses}")
    if launches != expected_launches():
        fail(f"{phase} launched flash kernels: {launches}")
    if calls != want:
        fail(f"{phase}: expected the ops {want}, got {calls}")
    if row["subgroup_backends"] != ["nccl"] * 4 or row["split"] != [1, 1]:
        fail(f"{phase}: subgroups {row['subgroup_backends']}, split "
             f"{row['split']}")
    check_two_side_streams(phase, row["paths"])
    if comm.quantized and row["residual_bytes"] \
            != 4 * row["grad_residual_len"]:
        fail(f"{phase}: residual {row['residual_bytes']} bytes, expected "
             f"4 x {row['grad_residual_len']}")
    if opt._db_dcn and row["stale_dcn_bytes"] \
            != 4 * row["grad_dcn_stale_len"]:
        fail(f"{phase}: stale buffer {row['stale_dcn_bytes']} bytes, "
             f"expected 4 x {row['grad_dcn_stale_len']}")
    if dist.is_initialized():
        fail(f"the process group outlived {phase}")
    return row


#: the multi-node optimizer's step phases, each a span with a device twin
PHASES = ("forward", "backward", "grad_exchange", "rule", "persistent_mean",
          "global_means")


def phase_train_resnet_traced(plain_row):
    """``train_resnet`` on the striped communicator with tracing on
    (``CHAINERMN_TPU_TRACE=events``, set in-process) beside the same run
    untraced: the trainer's shard is valid, holds one
    ``train/optimizer_update``, ``train/input_stall``, each step phase's
    span and its device twin per iteration, and the exchange span's
    payload tag is the planned payload.  Then one step under ``full`` in
    the profiler:
    the device time inside the ``train.grad_exchange.bucket*`` ranges."""
    import torch.distributed as dist
    from chainermn_tpu_torch import (create_communicator,
                                     create_multi_node_optimizer,
                                     observability, scatter_dataset)
    from chainermn_tpu_torch.core.optimizer import MomentumSGD
    from chainermn_tpu_torch.models import Classifier, ResNet50
    from chainermn_tpu_torch.utils import device_ops_in_ranges
    comm_kw, _ = RESNET_STRIPED["train_resnet_striped"]
    comm = create_communicator("hierarchical", **comm_kw)
    runs = {}
    try:
        model = Classifier(ResNet50(compute_dtype=torch.bfloat16,
                                    device="cuda", **RESNET))
        comm.bcast_data(model)
        opt = create_multi_node_optimizer(
            MomentumSGD(lr=0.1, momentum=0.9), comm).setup(model)
        shard = scatter_dataset(resnet_data(), comm)
        for mode in ("off", "events", "off", "events"):
            observability.set_mode(mode)
            observability.reset_tracer()
            observability.reset_registry()
            name = f"chip_smoke_traced_{len(runs)}"
            shard_path = os.path.join("build", name, "trace-rank0.jsonl")
            if os.path.exists(shard_path):
                os.remove(shard_path)
            updater, step_ms, losses, peak, launches = timed_trainer_run(
                opt, shard, RESNET_BATCH, RESNET_STEPS, name)
            median_ms = float(np.median(step_ms[RESNET_WARMUP:]))
            run = {"mode": mode, "median_step_ms": median_ms,
                   "images_per_s": RESNET_BATCH / (median_ms * 1e-3),
                   "losses": losses, "launches": launches}
            if mode == "events":
                events = observability.read_jsonl(shard_path)
                observability.validate_events(events)
                phases = [f"train/{p}" for p in PHASES]
                run.update(
                    events=len(events),
                    spans={name: sum(e["name"] == name and e["ph"] == "B"
                                     for e in events)
                           for name in ["train/optimizer_update",
                                        "train/input_stall", *phases,
                                        *(f"{p}/device" for p in phases)]},
                    payload_bytes=sorted({
                        e["args"]["payload_bytes"] for e in events
                        if e["ph"] == "B"
                        and e["name"] == "train/grad_exchange"}),
                    planned_payload_bytes=opt._exchange_tags()[
                        "payload_bytes"])
            else:
                run["shard_written"] = os.path.exists(shard_path)
            runs[f"{mode}_{len(runs)}"] = run
        observability.set_mode("full")
        observability.reset_tracer()
        events = profiled_events(updater.update, "chip_smoke_traced_full")
        observability.set_mode("off")
        observability.reset_tracer()
        observability.reset_registry()
        in_buckets = device_ops_in_ranges(events, "train.grad_exchange."
                                          "bucket")
        full = {"bucket_ops": len(in_buckets),
                "bucket_device_ms": sum(op.get("dur", 0)
                                        for _, op in in_buckets) * 1e-3,
                "ops_by_range": {}}
        for name, op in in_buckets:
            key = name.rsplit(".", 1)[-1]
            full["ops_by_range"][key] = full["ops_by_range"].get(key, 0) + 1
        opt._reset_exchange()
    finally:
        observability.set_mode("off")
        comm.finalize()
    traced = [r for r in runs.values() if r["mode"] == "events"]
    untraced = [r for r in runs.values() if r["mode"] == "off"]
    row = {"phase": "train_resnet_traced", "runs": runs, "full": full,
           "images_per_s_traced": [r["images_per_s"] for r in traced],
           "images_per_s_untraced": [r["images_per_s"] for r in untraced],
           "train_resnet": {k: plain_row[k] for k in (
               "median_step_ms", "images_per_s", "device_idle_share")}}
    emit(row)
    for r in runs.values():
        if not all(np.isfinite(r["losses"])) \
                or r["launches"] != expected_launches():
            fail(f"train_resnet_traced: {r}")
    for r in untraced:
        if r["shard_written"]:
            fail("train_resnet_traced: an untraced run wrote a shard")
    for r in traced:
        if r["spans"] != {k: RESNET_STEPS for k in r["spans"]} \
                or r["payload_bytes"] != [r["planned_payload_bytes"]] \
                or not r["planned_payload_bytes"]:
            fail(f"train_resnet_traced: the shard or the payload tag is "
                 f"off: {r}")
    if not full["bucket_ops"]:
        fail("train_resnet_traced: no kernel or copy inside a "
             "train.grad_exchange.bucket range under full")
    if dist.is_initialized():
        fail("the process group outlived train_resnet_traced")
    return row


def phase_striped_parity():
    """The small fp32 ResNet of phase 12 with TF32 off: (1) at a world of
    one, ratio 0 is bitwise the hierarchical exchange and its
    reduce-scatter update; ratios 1 and 0.25 (the allreduce and the
    reduce-scatter flavors) bitwise the plain DP step
    (``cudnn.deterministic`` on); (2) each striped flavor of phases
    24-27, 3 steps on the card against the same on the CPU (a gloo group
    beside the NCCL world) within RESNET_PARITY_TOL."""
    import torch.distributed as dist
    from chainermn_tpu_torch import create_communicator
    flags = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.deterministic)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    reset_launches()
    rs = dict(exchange="reduce_scatter")
    plain = create_communicator("pure_nccl")
    try:
        gloo = dist.new_group(backend="gloo")
        torch.backends.cudnn.deterministic = True
        hier = create_communicator("hierarchical")
        det = {"plain": resnet_parity_run("cuda", True, plain),
               "hier": resnet_parity_run("cuda", True, hier),
               "hier_rs": resnet_parity_run("cuda", True, hier, **rs)}
        for ratio in (0.0, 1.0, 0.25):
            comm = create_communicator("hierarchical", stripe_ratio=ratio)
            det[f"r{ratio}"] = resnet_parity_run("cuda", True, comm)
            det[f"r{ratio}_rs"] = resnet_parity_run("cuda", True, comm, **rs)
        torch.backends.cudnn.deterministic = flags[2]
        card, cpu = {}, {}
        for key, (comm_kw, kw) in RESNET_STRIPED.items():
            on_card = create_communicator("hierarchical", **comm_kw)
            on_cpu = create_communicator("hierarchical", device="cpu",
                                         group=gloo, **comm_kw)
            card[key] = resnet_parity_run("cuda", True, on_card, **kw)
            cpu[key] = resnet_parity_run("cpu", True, on_cpu, **kw)
        torch.cuda.synchronize()
        launches = read_launches()
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.deterministic) = flags
        plain.finalize()   # the world's owner: every group goes with it

    def equal(a, b):
        return a[0] == b[0] and all(torch.equal(a[1][p], b[1][p])
                                    for p in b[1])

    def max_diff(a, b):
        return max((a[1][p] - v).abs().max().item() for p, v in b[1].items()
                   if v.is_floating_point())

    a = {"r0_bitwise_hier": equal(det["r0.0"], det["hier"]),
         "r0_rs_bitwise_hier_rs": equal(det["r0.0_rs"], det["hier_rs"])}
    for ratio in ("r1.0", "r0.25"):
        a[f"{ratio}_bitwise_plain"] = equal(det[ratio], det["plain"])
        a[f"{ratio}_rs_bitwise_plain"] = equal(det[f"{ratio}_rs"],
                                               det["plain"])
    b = {k: {"loss_rel_err": max(abs(x - y) / abs(y) for x, y in zip(
                 card[k][0], cpu[k][0])),
             "state_abs_err": max_diff(card[k], cpu[k]),
             "losses": card[k][0], "cpu_losses": cpu[k][0]}
         for k in RESNET_STRIPED}
    row = {"phase": "striped_parity", "a": a,
           "a_max_abs_diff": {k: max_diff(det[k], det["plain"])
                              for k in det if k.startswith("r")},
           "b": b, "tol": RESNET_PARITY_TOL, "launches": launches}
    emit(row)
    if not all(a.values()):
        fail(f"striped_parity (1): the striped exchange differs from the "
             f"plain step at a world of one: {row['a_max_abs_diff']}")
    for k, errs in b.items():
        if not (errs["loss_rel_err"] < RESNET_PARITY_TOL["loss_rel"]
                and errs["state_abs_err"] < RESNET_PARITY_TOL["state_abs"]):
            fail(f"striped_parity (2): {k} on the card leaves the CPU's "
                 f"run: {errs}")
    if launches != expected_launches():
        fail(f"striped_parity launched flash kernels: {launches}")
    if dist.is_initialized():
        fail("the process group outlived the striped_parity phase")


def check_no_flash(phase):
    launches = read_launches()
    if launches != expected_launches():
        fail(f"{phase} launched flash kernels: {launches}")
    return launches


def phase_autotune(plain_row):
    """Startup tuning on a flat and a 1 x 1 hierarchical communicator; a
    recorded plan equal to the hand knobs, bitwise the hand-knobbed small
    ResNet's 3 steps; the online re-tune of ``train_resnet``'s step after
    3 updates from the card's own spans."""
    import torch.distributed as dist
    from chainermn_tpu_torch import (create_communicator,
                                     create_multi_node_optimizer,
                                     observability, scatter_dataset)
    from chainermn_tpu_torch.communicators import _autotune
    from chainermn_tpu_torch.core.optimizer import MomentumSGD
    from chainermn_tpu_torch.models import Classifier, ResNet50
    reset_launches()
    startup = {}
    for label, name, dtype in (("flat", "pure_nccl", "bfloat16"),
                               ("hierarchical", "hierarchical",
                                {"dcn": "bfloat16"})):
        t0 = time.perf_counter()
        comm = create_communicator(name, allreduce_grad_dtype=dtype,
                                   autotune=True)
        tune_s = time.perf_counter() - t0
        try:
            t0 = time.perf_counter()
            measurement = _autotune.measure_fabric(comm)
            measure_s = time.perf_counter() - t0
            plan = comm.autotune_plan
            startup[label] = {
                "tune_s": tune_s, "measure_fabric_s": measure_s,
                "hops": measurement["hops"],
                "plan": {k: plan[k] for k in ("bucket_mb", "stripe_ratio",
                                              "grad_dtype", "axis")},
                "notes": plan["derivation"]["notes"],
                "fingerprint": plan["fingerprint"],
                "communicator": repr(comm)}
        finally:
            comm.finalize()
        if any(h["size"] != 1 or h["gbps"] is not None
               for h in measurement["hops"].values()):
            fail(f"autotune: a hop of a world of one measured: "
                 f"{measurement}")

    # a recorded plan equal to the hand knobs: the same 3 fp32 steps
    flags = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.deterministic)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    hand = create_communicator("hierarchical", stripe_ratio=0.25,
                               allreduce_grad_dtype={"ici": None,
                                                     "dcn": "bfloat16"})
    try:
        plan = _autotune.derive_exchange_plan(
            AUTOTUNE_MEASUREMENTS, _autotune.topology_summary(hand))
        auto = create_communicator("hierarchical", autotune=plan)
        torch.backends.cudnn.deterministic = True
        golden = {"hand": resnet_parity_run("cuda", True, hand),
                  "auto": resnet_parity_run("cuda", True, auto)}
        knobs = {k: (getattr(hand, k), getattr(auto, k)) for k in (
            "stripe_ratio", "dcn_grad_dtype", "allreduce_grad_dtype")}
        auto.finalize()
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.deterministic) = flags
        hand.finalize()
    golden_equal = golden["hand"][0] == golden["auto"][0] and all(
        torch.equal(v, golden["auto"][1][p])
        for p, v in golden["hand"][1].items())

    # online: re-tuned after 3 updates from this run's spans
    prev = observability.set_mode("events")
    observability.reset_tracer()
    observability.reset_registry()
    comm = create_communicator("pure_nccl", allreduce_grad_dtype="bfloat16")
    opt = None
    try:
        model = Classifier(ResNet50(compute_dtype=torch.bfloat16,
                                    device="cuda", **RESNET))
        comm.bcast_data(model)
        opt = create_multi_node_optimizer(
            MomentumSGD(lr=0.1, momentum=0.9), comm,
            autotune=3).setup(model)
        armed = opt._autotune_online_after
        shard = scatter_dataset(resnet_data(), comm)
        updater, step_ms, losses, peak, _ = timed_trainer_run(
            opt, shard, RESNET_BATCH, RESNET_STEPS, "chip_smoke_autotune")
        online = opt.communicator.autotune_plan
    finally:
        observability.set_mode(prev)
        observability.reset_tracer()
        observability.reset_registry()
        comm.finalize()      # a re-tuned clone owns the world after it
        if opt is not None and opt.communicator is not comm:
            opt.communicator.finalize()
    tuned_ms = float(np.median(step_ms[3:]))
    row = {"phase": "autotune", "startup": startup,
           "golden_bitwise": golden_equal,
           "golden_losses": golden["auto"][0], "golden_knobs": {
               k: [str(a), str(b)] for k, (a, b) in knobs.items()},
           "recorded_plan_fingerprint": plan["fingerprint"],
           "online": {
               "armed_after": armed,
               "disarmed": opt._autotune_online_after == 0,
               "world_hop": None if online is None
               else online["measurements"]["hops"].get("world"),
               "plan": None if online is None else {
                   k: online[k] for k in ("bucket_mb", "stripe_ratio",
                                          "grad_dtype")},
               "notes": None if online is None
               else online["derivation"]["notes"],
               "fingerprint": None if online is None
               else online["fingerprint"]},
           "step_ms": step_ms, "tuned_median_step_ms": tuned_ms,
           "images_per_s": RESNET_BATCH / (tuned_ms * 1e-3),
           "losses": losses, "peak_bytes": peak,
           "train_resnet": {k: plain_row[k] for k in (
               "median_step_ms", "images_per_s", "device_idle_share")},
           "launches": check_no_flash("autotune")}
    emit(row)
    if not golden_equal:
        fail(f"autotune: a recorded plan equal to the hand knobs left the "
             f"hand-knobbed trajectory: {golden['hand'][0]} vs "
             f"{golden['auto'][0]}")
    if online is None or online["measurements"]["source"] != "online" \
            or armed != 3 or not row["online"]["disarmed"]:
        fail(f"autotune: no online re-tune after 3 updates: {row['online']}")
    if not all(np.isfinite(losses)):
        fail(f"autotune: ResNet-50 losses {losses}")
    if dist.is_initialized():
        fail("the process group outlived the autotune phase")
    return row


def seq2seq_data(n, seed=0):
    """``make_synthetic_translation_data`` at SEQ2SEQ's vocabularies and
    length: the dataset and each batch's target tokens (non-PAD)."""
    from chainermn_tpu_torch.dataset import TupleDataset
    from chainermn_tpu_torch.models import make_synthetic_translation_data
    xs, ys_in, ys_out = make_synthetic_translation_data(
        n=n, src_vocab=SEQ2SEQ["n_source_vocab"],
        tgt_vocab=SEQ2SEQ["n_target_vocab"], max_len=SEQ2SEQ_LEN, seed=seed)
    tokens = [int((ys_out[i:i + SEQ2SEQ_BATCH] != -1).sum())
              for i in range(0, n, SEQ2SEQ_BATCH)]
    return TupleDataset(xs, ys_in, ys_out), (xs, ys_in, ys_out), tokens


def seq2seq_row(name, step_ms, losses, peak, tokens):
    median_ms = float(np.median(step_ms[SEQ2SEQ_WARMUP:]))
    return {"phase": name, **SEQ2SEQ, "batch": SEQ2SEQ_BATCH,
            "max_len": SEQ2SEQ_LEN, "steps": SEQ2SEQ_STEPS,
            "step_ms": step_ms, "median_step_ms": median_ms,
            "steps_per_s": 1e3 / median_ms,
            "sentences_per_s": SEQ2SEQ_BATCH / (median_ms * 1e-3),
            "target_tokens_per_s": float(np.mean(tokens))
            / (median_ms * 1e-3),
            "target_tokens_per_batch": tokens, "losses": losses,
            "peak_bytes": peak}


def phase_seq2seq_dp():
    """BASELINE config #3 at full width: ``Seq2seq`` through the
    double-buffered multi-node Adam in a world of one NCCL process."""
    import torch.distributed as dist
    from chainermn_tpu_torch import (create_communicator,
                                     create_multi_node_optimizer,
                                     scatter_dataset)
    from chainermn_tpu_torch.core.config import using_config
    from chainermn_tpu_torch.core.optimizer import Adam
    from chainermn_tpu_torch.models import Seq2seq
    reset_launches()
    dataset, arrays, tokens = seq2seq_data(2 * SEQ2SEQ_BATCH)
    comm = create_communicator("pure_nccl")
    try:
        t0 = time.perf_counter()
        model = Seq2seq(device="cuda", **SEQ2SEQ)
        init_s = time.perf_counter() - t0
        comm.bcast_data(model)
        opt = create_multi_node_optimizer(
            Adam(), comm, double_buffering=True).setup(model)
        shard = scatter_dataset(dataset, comm)
        comm.calls.clear()
        updater, step_ms, losses, peak, _ = timed_trainer_run(
            opt, shard, SEQ2SEQ_BATCH, SEQ2SEQ_STEPS, "chip_smoke_seq2seq")
        row = {**seq2seq_row("seq2seq_dp", step_ms, losses, peak, tokens),
               "params": model.count_params(), "init_s": init_s,
               "exchange": "double_buffering", "world": comm.size,
               "collectives": dict(comm.calls)}
        emit(row)
        prof = profile_steps("seq2seq_dp_profile", updater, top_n=12,
                             classes_us=op_classes_us)
        xs = torch.from_numpy(arrays[0][:8]).cuda()
        with torch.no_grad(), using_config("train", False):
            model.translate(xs, 0, 1, max_length=SEQ2SEQ_LEN)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            toks = model.translate(xs, 0, 1, max_length=SEQ2SEQ_LEN)
            torch.cuda.synchronize()
            translate_s = time.perf_counter() - t0
        emit({"phase": "seq2seq_translate", "sentences": 8,
              "max_length": SEQ2SEQ_LEN, "seconds": translate_s,
              "tokens_per_s": toks.numel() / translate_s,
              "first_tokens": toks[0, :10].tolist()})
        opt._reset_exchange()
    finally:
        comm.finalize()
    row["device_idle_share"] = prof["device_idle_share"]
    check_no_flash("seq2seq_dp")
    if not all(np.isfinite(losses)) or len(losses) != SEQ2SEQ_STEPS \
            or not losses[-1] < losses[0]:
        fail(f"seq2seq_dp: losses {losses}")
    if dist.is_initialized():
        fail("the process group outlived seq2seq_dp")
    return row


def stage_stack(width, n_layers, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    params = []
    for _ in range(n_layers):
        params.append((torch.randn((width, width), generator=g,
                                   device="cuda") / width ** 0.5)
                      .requires_grad_())
        params.append((torch.randn((width,), generator=g, device="cuda")
                       * 0.1).requires_grad_())
    return params


def stack_fn(params, h):
    for W, b in zip(params[0::2], params[1::2]):
        h = torch.tanh(h @ W + b)
    return h


def rel_err(a, b):
    return ((a - b).abs().max() / b.abs().max().clamp_min(1e-30)).item()


def phase_seq2seq_mp(dp_row):
    """BASELINE config #4 in a world of one: the self-edge
    ``ModelParallelSeq2seq`` against ``Seq2seq`` on one batch, its
    training steps, and both pipelines at S = 1."""
    import torch.distributed as dist
    from chainermn_tpu_torch import create_communicator
    from chainermn_tpu_torch.core.optimizer import Adam
    from chainermn_tpu_torch.models import ModelParallelSeq2seq, Seq2seq
    from chainermn_tpu_torch.parallel import (gpipe_apply, one_f_one_b,
                                              split_microbatches)
    reset_launches()
    dataset, arrays, tokens = seq2seq_data(2 * SEQ2SEQ_BATCH)
    batch = [torch.from_numpy(a[:SEQ2SEQ_BATCH]).cuda() for a in arrays]
    comm = create_communicator("pure_nccl")
    try:
        mp = ModelParallelSeq2seq(comm, rank_encoder=0, rank_decoder=0,
                                  device="cuda", **SEQ2SEQ)
        ref = Seq2seq(device="cuda", **SEQ2SEQ)
        mp_params = {p[len("/mn_component_0"):]: v
                     for p, v in mp.namedparams()}
        same_init = all(torch.equal(v, mp_params[p])
                        for p, v in ref.namedparams())
        loss_mp = mp(*batch)
        loss_mp.backward()
        loss_ref = ref(*batch)
        loss_ref.backward()
        grads_equal = all(torch.equal(v.grad, mp_params[p].grad)
                          for p, v in ref.namedparams())
        grad_err = max(rel_err(mp_params[p].grad, v.grad)
                       for p, v in ref.namedparams())
        parity = {"same_init": same_init,
                  "loss": [loss_mp.item(), loss_ref.item()],
                  "loss_bitwise": bool(torch.equal(loss_mp, loss_ref)),
                  "grads_bitwise": grads_equal, "grad_rel_err": grad_err}
        # plain Adam on the chain list and on Seq2seq in turns (mp, plain,
        # plain, mp): what the list's transfers and broadcast cost a step
        opts = {"mp": Adam().setup(mp), "plain": Adam().setup(ref)}
        comm.calls.clear()
        turns = []
        for i, which in enumerate(("mp", "plain", "plain", "mp")):
            _, ms, run_losses, run_peak, _ = timed_trainer_run(
                opts[which], dataset, SEQ2SEQ_BATCH, SEQ2SEQ_STEPS,
                f"chip_smoke_seq2seq_mp_{i}")
            median = float(np.median(ms[SEQ2SEQ_WARMUP:]))
            turns.append({"model": which, "median_step_ms": median,
                          "steps_per_s": 1e3 / median})
            if i == 0:
                calls = dict(comm.calls)
                step_ms, losses, peak = ms, run_losses, run_peak
        row = {**seq2seq_row("seq2seq_mp", step_ms, losses, peak, tokens),
               "rank_encoder": 0, "rank_decoder": 0, "parity": parity,
               "collectives": calls, "turns": turns,
               "seq2seq_dp": {k: dp_row[k] for k in (
                   "steps_per_s", "sentences_per_s", "target_tokens_per_s",
                   "device_idle_share")}}
        del mp, ref, opts
        torch.cuda.empty_cache()

        # the pipelines at S = 1: 4 microbatches over a 3-layer stack
        width, M = 1024, 4
        params = stage_stack(width, 3, seed=7)
        g = torch.Generator(device="cuda").manual_seed(8)
        x = torch.randn((4 * 64, width), generator=g, device="cuda")
        y = torch.randn((4 * 64, width), generator=g, device="cuda")
        xm, ym = split_microbatches(x, M), split_microbatches(y, M)

        def loss_fn(out, t):
            return torch.mean((out - t) ** 2)

        def plain():
            for p in params:
                p.grad = None
            loss = sum(loss_fn(stack_fn(params, xm[i]), ym[i])
                       for i in range(M)) / M
            loss.backward()
            return loss.detach(), [p.grad.clone() for p in params]

        def gpipe():
            for p in params:
                p.grad = None
            out = gpipe_apply(comm, stack_fn, params, xm)
            loss = torch.mean((out - ym) ** 2)
            loss.backward()
            return loss.detach(), [p.grad.clone() for p in params]

        def fb():
            return one_f_one_b(comm, stack_fn, loss_fn, params, xm, ym)

        ref_loss, ref_grads = plain()
        pipes = {}
        for name, fn in (("gpipe", gpipe), ("one_f_one_b", fb)):
            loss, grads = fn()
            pipes[name] = {
                "loss_rel_err": abs(loss.item() - ref_loss.item())
                / abs(ref_loss.item()),
                "grad_rel_err": max(rel_err(a, b)
                                    for a, b in zip(grads, ref_grads)),
                "ms": time_ms(fn, iters=5, warmup=1)}
        pipes["plain_ms"] = time_ms(plain, iters=5, warmup=1)
        row["pipelines"] = {"S": comm.size, "M": M, "layers": 3,
                            "width": width, "microbatch": 64, **pipes}
    finally:
        comm.finalize()
    row["launches"] = check_no_flash("seq2seq_mp")
    emit(row)
    if not (same_init and (grads_equal or grad_err < SEQ2SEQ_MP_TOL)
            and abs(parity["loss"][0] - parity["loss"][1])
            <= SEQ2SEQ_MP_TOL * abs(parity["loss"][1])):
        fail(f"seq2seq_mp: ModelParallelSeq2seq leaves Seq2seq: {parity}")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        fail(f"seq2seq_mp: losses {losses}")
    for name in ("gpipe", "one_f_one_b"):
        if not (pipes[name]["loss_rel_err"] < PIPELINE_TOL
                and pipes[name]["grad_rel_err"] < PIPELINE_TOL):
            fail(f"seq2seq_mp: {name} at S = 1 leaves the plain "
                 f"microbatched step: {pipes[name]}")
    if dist.is_initialized():
        fail("the process group outlived seq2seq_mp")
    return row


def mp_parity_run(device, comm, which, steps=3):
    """The CPU tests' small fp32 models, 3 plain Adam steps on ``device``:
    (losses, parameters on the host)."""
    from chainermn_tpu_torch.core.optimizer import Adam
    from chainermn_tpu_torch.examples.train_mnist_model_parallel import \
        SplitMLP
    from chainermn_tpu_torch.models import (ModelParallelSeq2seq,
                                            make_synthetic_translation_data)
    if which == "seq2seq":
        model = ModelParallelSeq2seq(comm, rank_encoder=0, rank_decoder=0,
                                     device=device, **SMALL_SEQ2SEQ)
        batch = [torch.from_numpy(a[:8]).to(device)
                 for a in make_synthetic_translation_data()]
    else:
        model = SplitMLP(comm, 10, 10, seed=0, device=device)
        rng = np.random.RandomState(0)
        batch = [torch.from_numpy(rng.normal(0, 1, (16, 784)).astype(
                     np.float32)).to(device),
                 torch.from_numpy(rng.randint(0, 10, 16)).to(device)]
    opt = Adam().setup(model)
    losses = [opt.update(model, *batch).item() for _ in range(steps)]
    return losses, {p: v.detach().cpu() for p, v in model.namedparams()}


def phase_model_parallel_parity():
    """The small fp32 seq2seq and split MLP: 3 Adam steps on the card
    against the CPU (a gloo group beside the NCCL world), TF32 off."""
    import torch.distributed as dist
    from chainermn_tpu_torch import create_communicator
    from chainermn_tpu_torch.communicators import MeshCommunicator
    reset_launches()
    flags = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    comm = create_communicator("pure_nccl")
    try:
        cpu_comm = MeshCommunicator(device="cpu",
                                    group=dist.new_group(backend="gloo"),
                                    name="pure_nccl")
        out = {}
        for which in ("seq2seq", "split_mlp"):
            card = mp_parity_run("cuda", comm, which)
            cpu = mp_parity_run("cpu", cpu_comm, which)
            out[which] = {
                "losses": card[0], "cpu_losses": cpu[0],
                "loss_abs_err": max(abs(a - b)
                                    for a, b in zip(card[0], cpu[0])),
                "param_abs_err": max((card[1][p] - v).abs().max().item()
                                     for p, v in cpu[1].items())}
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = flags
        comm.finalize()
    row = {"phase": "model_parallel_parity", **out, "tol": MP_PARITY_TOL,
           "launches": check_no_flash("model_parallel_parity")}
    emit(row)
    for which, errs in out.items():
        if not (errs["loss_abs_err"] < MP_PARITY_TOL
                and errs["param_abs_err"] < MP_PARITY_TOL):
            fail(f"model_parallel_parity: {which} on the card leaves the "
                 f"CPU's run: {errs}")
    if dist.is_initialized():
        fail("the process group outlived model_parallel_parity")


# -- DCGAN (BASELINE config #5) and the multi-node checkpointer --------------

def dcgan_flops_per_image(gen, dis):
    """Training flops per image of one ``DCGANUpdater`` iteration, from
    the layer shapes (``forward_flops``, a transposed convolution counted
    as every input element times its kernel taps): ``3 G + 7 D``, G and
    D one forward of the generator and of the discriminator.  The
    generator runs one forward and one backward (2 G: input and weight
    gradients); the discriminator two forwards and their backwards in its
    step (2 D + 4 D) and one forward and an input-only backward through
    the frozen net in the generator's (D + D).  At n_hidden 100 and ch
    512: G = 0.206 and D = 0.544 GFLOP, 4.43 GFLOP an image, 221 GFLOP
    an iteration of 50."""
    z = gen.make_hidden(1, key=np.array([0, 0], np.uint32))
    g = forward_flops(gen, z)
    d = forward_flops(dis, torch.zeros(1, 3, 32, 32, device=z.device))
    return 3 * g + 7 * d, g, d


def dcgan_nets(device, n_hidden, ch):
    from chainermn_tpu_torch.models import Discriminator, Generator
    return (Generator(n_hidden=n_hidden, ch=ch, seed=0, device=device),
            Discriminator(ch=ch, seed=100, device=device))


def dcgan_updater(comm, gen, dis, data, batch, alpha=2e-4):
    """The DCGAN example's updater over ``data``: each net under
    ``create_multi_node_optimizer(Adam(alpha, beta1=0.5), comm)`` (plain
    ``Adam`` when ``comm`` is None)."""
    from chainermn_tpu_torch import create_multi_node_optimizer
    from chainermn_tpu_torch.core.optimizer import Adam
    from chainermn_tpu_torch.dataset import SerialIterator
    from chainermn_tpu_torch.models import DCGANUpdater

    def opt(net):
        o = Adam(alpha=alpha, beta1=0.5)
        if comm is not None:
            o = create_multi_node_optimizer(o, comm)
        return o.setup(net)

    return DCGANUpdater(SerialIterator(data, batch, shuffle=False, seed=0),
                        opt(gen), opt(dis))


def seeded_noise(updater, seed):
    """Draw the generator's noise from ``seed`` and the updater's
    iteration, so that a resumed run draws the uninterrupted run's (the
    snapshot carries no noise key)."""
    from chainermn_tpu_torch.core import rng
    gen = updater.get_optimizer("gen").target
    draw = gen.make_hidden
    gen.make_hidden = lambda n, key=None: draw(
        n, rng.fold_in(rng.make_key(seed), updater.iteration))


def dcgan_data(n):
    from chainermn_tpu_torch.dataset import get_cifar10
    return get_cifar10(withlabel=False, n_train=n, n_test=1)[0]


def dcgan_layer_ms(gen, dis):
    """Device ms of each convolution, transposed convolution and linear
    link's forward at the input shape the main path gives it (CUDA events
    around 20 calls, no grad)."""
    from chainermn_tpu_torch.nn import links as L
    inputs = {}
    links = [(f"gen{p}", m) for p, m in gen.namedlinks(skipself=True)] + \
        [(f"dis{p}", m) for p, m in dis.namedlinks(skipself=True)]
    links = [(p, m) for p, m in links
             if isinstance(m, (L.Convolution2D, L.Deconvolution2D, L.Linear))]
    def keep(path):
        def hook(mod, args, out):
            inputs.setdefault(path, args[0].detach())
        return hook

    hooks = [m.register_forward_hook(keep(p)) for p, m in links]
    try:
        with torch.no_grad():
            dis(gen(gen.make_hidden(DCGAN_BATCH,
                                    key=np.array([0, 1], np.uint32))))
    finally:
        for h in hooks:
            h.remove()
    with torch.no_grad():
        return {p: time_ms(lambda m=m, x=inputs[p]: m(x))
                for p, m in links}


def phase_train_dcgan():
    """BASELINE config #5 at full width: ``Generator(100, 512)`` and
    ``Discriminator(512)`` through the multi-node Adam of each net in a
    world of one NCCL process, ``Trainer`` -> ``DCGANUpdater``."""
    import torch.distributed as dist
    from chainermn_tpu_torch import create_communicator, scatter_dataset
    from chainermn_tpu_torch.training import Trainer
    reset_launches()
    comm = create_communicator("pure_nccl")
    try:
        gen, dis = dcgan_nets("cuda", **DCGAN)
        comm.bcast_data(gen)
        comm.bcast_data(dis)
        shard = scatter_dataset(dcgan_data(2 * DCGAN_BATCH), comm)
        updater = dcgan_updater(comm, gen, dis, shard, DCGAN_BATCH)
        trainer = Trainer(updater, (DCGAN_STEPS, "iteration"),
                          out=os.path.join("build", "chip_smoke_dcgan"))
        losses, marks = [], []

        def record(tr):   # no sync: tensors and events, read after
            losses.append((tr.observation["gen/loss"],
                           tr.observation["dis/loss"]))
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            marks.append(ev)

        trainer.extend(record, name="record")
        comm.calls.clear()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        start = torch.cuda.Event(enable_timing=True)
        start.record()
        trainer.run()
        torch.cuda.synchronize()
        launches = check_no_flash("train_dcgan")
        calls = dict(comm.calls)
        peak = torch.cuda.max_memory_allocated()
        step_ms = [start.elapsed_time(marks[0])] + [
            a.elapsed_time(b) for a, b in zip(marks, marks[1:])]
        median_ms = float(np.median(step_ms[DCGAN_WARMUP:]))
        flops, g_flops, d_flops = dcgan_flops_per_image(gen, dis)
        prof = profile_steps("train_dcgan_profile", updater, top_n=12,
                             classes_us=op_classes_us)
        layers_ms = dcgan_layer_ms(gen, dis)
        world = comm.size
    finally:
        comm.finalize()
    losses = [[float(g), float(d)] for g, d in losses]
    images_per_s = DCGAN_BATCH / (median_ms * 1e-3)
    row = {"phase": "train_dcgan", **DCGAN, "batch": DCGAN_BATCH,
           "steps": DCGAN_STEPS, "world": world,
           "params": {"gen": gen.count_params(), "dis": dis.count_params()},
           "step_ms": step_ms, "median_step_ms": median_ms,
           "images_per_s": images_per_s, "iterations_per_s":
           1e3 / median_ms, "flops_per_image": flops,
           "gen_forward_flops": g_flops, "dis_forward_flops": d_flops,
           "mfu_fp32_peak": flops * images_per_s
           / PEAK_FLOPS[torch.float32],
           "tf32": tf32_flags(), "losses": losses, "peak_bytes": peak,
           "collectives": calls, "launches": launches,
           "device_idle_share": prof["device_idle_share"],
           "device_busy_ms_per_step": prof["device_busy_s"] / 3 * 1e3,
           "layer_forward_ms": layers_ms}
    # the profiler's own cost stretches the profiled steps' wall: the
    # busy time a step against the unprofiled median step as well
    row["device_idle_share_unprofiled"] = \
        1.0 - row["device_busy_ms_per_step"] / median_ms
    emit(row)
    if not np.isfinite(losses).all() or len(losses) != DCGAN_STEPS:
        fail(f"train_dcgan: losses {losses}")
    if calls.get("allreduce_grad") != 2 * DCGAN_STEPS:
        fail(f"train_dcgan: {calls} (one gradient allreduce per net and "
             f"iteration)")
    if row["params"] != {"gen": 3599363, "dis": 2660097}:
        fail(f"train_dcgan: parameters {row['params']}")
    if not prof["classes_us"]["convolution"]:
        fail(f"train_dcgan: no convolution on the card: "
             f"{prof['classes_us']}")
    if dist.is_initialized():
        fail("the process group outlived train_dcgan")
    return row


def dcgan_state(updater):
    """Both nets' parameters, Adam leaves and running statistics, and the
    iterator's, as the updater serializes them (host arrays)."""
    from chainermn_tpu_torch.serializers.npz import DictionarySerializer
    s = DictionarySerializer()
    updater.serialize(s)
    return s.target


def dcgan_resume_trainer(comm, stop, out):
    from chainermn_tpu_torch.training import Trainer
    gen, dis = dcgan_nets("cuda", **DCGAN)
    updater = dcgan_updater(comm, gen, dis, dcgan_data(2 * DCGAN_BATCH),
                            DCGAN_BATCH)
    seeded_noise(updater, seed=13)
    return Trainer(updater, (stop, "iteration"), out=out)


def first_difference(got, want):
    keys = sorted(set(got) | set(want))
    for k in keys:
        if k not in got or k not in want \
                or not np.array_equal(got[k], want[k]):
            return k
    return None


def phase_dcgan_checkpoint():
    """The multi-node checkpointer at full width: a snapshot's bytes and
    its save (two of them), scan-and-verify and consensus-load times; a
    bitwise resume
    (8 iterations against 4, a new trainer's ``maybe_load`` and 4 more,
    ``cudnn.deterministic`` on, the noise drawn per iteration from a
    seed); a flipped byte in the newest snapshot makes the consensus fall
    back a generation; the same resume through the per-rank DCP
    sibling."""
    import shutil
    import torch.distributed as dist
    from chainermn_tpu_torch import (create_communicator,
                                     create_multi_node_checkpointer)
    from chainermn_tpu_torch.extensions import \
        create_multi_node_orbax_checkpointer
    reset_launches()
    half = DCGAN_RESUME_STEPS // 2
    base = os.path.join("build", "chip_smoke_dcgan_ckpt")
    shutil.rmtree(base, ignore_errors=True)
    flags = (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    comm = create_communicator("pure_nccl")
    try:
        golden = dcgan_resume_trainer(comm, DCGAN_RESUME_STEPS,
                                      os.path.join(base, "golden"))
        golden.run()
        want = dcgan_state(golden.updater)
        del golden
        # npz: a snapshot every DCGAN_SAVE_EVERY of the first 4
        # iterations, timed
        out = os.path.join(base, "npz")
        first = dcgan_resume_trainer(comm, half, out)
        cp = create_multi_node_checkpointer(comm, name="dcgan")
        save_ms = []

        def timed_save(tr):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            cp(tr)
            save_ms.append((time.perf_counter() - t0) * 1e3)

        first.extend(timed_save, name="checkpoint",
                     trigger=(DCGAN_SAVE_EVERY, "iteration"), priority=-100)
        first.run()
        del first
        files = sorted(f for f in os.listdir(out) if f.startswith("dcgan."))
        newest = os.path.join(out, f"dcgan.{half}.{cp.rank}")
        snapshot_bytes = os.path.getsize(newest)
        with np.load(newest) as z:
            raw_bytes = sum(z[k].nbytes for k in z.files)
        t0 = time.perf_counter()
        verified = cp._scan(out)
        scan_ms = (time.perf_counter() - t0) * 1e3
        second = dcgan_resume_trainer(comm, DCGAN_RESUME_STEPS, out)
        cp2 = create_multi_node_checkpointer(comm, name="dcgan")
        t0 = time.perf_counter()
        resumed = cp2.maybe_load(second)
        torch.cuda.synchronize()
        load_ms = (time.perf_counter() - t0) * 1e3
        second.run()
        npz_diff = first_difference(dcgan_state(second.updater), want)
        del second
        # a flipped byte in the newest snapshot: the vote falls back
        with open(newest, "r+b") as f:
            f.seek(snapshot_bytes // 2)
            byte = f.read(1)
            f.seek(snapshot_bytes // 2)
            f.write(bytes([byte[0] ^ 0xFF]))
        third = dcgan_resume_trainer(comm, DCGAN_RESUME_STEPS, out)
        cp3 = create_multi_node_checkpointer(comm, name="dcgan")
        fallback = cp3.maybe_load(third)
        verify_failures = cp3.stats["verify_failures"]
        del third
        # the DCP sibling: one snapshot after 4 iterations
        dcp_dir = os.path.join(base, "dcp")
        first = dcgan_resume_trainer(comm, half, os.path.join(base, "d1"))
        dcp = create_multi_node_orbax_checkpointer(comm, dcp_dir)
        dcp_save_ms = []

        def timed_dcp_save(tr):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            dcp(tr)
            dcp_save_ms.append((time.perf_counter() - t0) * 1e3)

        first.extend(timed_dcp_save, name="dcp", trigger=(half, "iteration"),
                     priority=-100)
        first.run()
        del first
        dcp_bytes = sum(os.path.getsize(os.path.join(d, f))
                        for d, _, fs in os.walk(dcp_dir) for f in fs)
        second = dcgan_resume_trainer(comm, DCGAN_RESUME_STEPS,
                                      os.path.join(base, "d2"))
        dcp2 = create_multi_node_orbax_checkpointer(comm, dcp_dir)
        t0 = time.perf_counter()
        dcp_resumed = dcp2.maybe_load(second)
        torch.cuda.synchronize()
        dcp_load_ms = (time.perf_counter() - t0) * 1e3
        second.run()
        dcp_diff = first_difference(dcgan_state(second.updater), want)
        del second
    finally:
        (torch.backends.cudnn.deterministic,
         torch.backends.cudnn.benchmark) = flags
        comm.finalize()
    row = {"phase": "dcgan_checkpoint", **DCGAN, "batch": DCGAN_BATCH,
           "files": files, "snapshot_bytes": snapshot_bytes,
           "uncompressed_bytes": raw_bytes, "save_ms": save_ms,
           "median_save_ms": float(np.median(save_ms)),
           "scan_verify_ms": scan_ms, "verified": sorted(verified),
           "maybe_load_ms": load_ms, "resumed": resumed,
           "resume_bitwise": npz_diff is None, "first_difference": npz_diff,
           "fallback": fallback, "verify_failures": verify_failures,
           "dcp_bytes": dcp_bytes, "dcp_save_ms": dcp_save_ms,
           "dcp_load_ms": dcp_load_ms, "dcp_resumed": dcp_resumed,
           "dcp_resume_bitwise": dcp_diff is None,
           "dcp_first_difference": dcp_diff,
           "launches": check_no_flash("dcgan_checkpoint")}
    emit(row)
    if resumed != half or npz_diff is not None:
        fail(f"dcgan_checkpoint: resumed from {resumed}, first difference "
             f"from the uninterrupted run {npz_diff}")
    if fallback != half - DCGAN_SAVE_EVERY or verify_failures != 1:
        fail(f"dcgan_checkpoint: with the newest snapshot corrupt the "
             f"consensus gave {fallback} ({verify_failures} failures)")
    if dcp_resumed != half or dcp_diff is not None:
        fail(f"dcgan_checkpoint: the DCP resume from {dcp_resumed} left "
             f"the uninterrupted run at {dcp_diff}")
    if dist.is_initialized():
        fail("the process group outlived dcgan_checkpoint")
    return row


def phase_train_dcgan_twin():
    """``python -m chainermn_tpu_torch.examples.train_dcgan --device
    cuda`` at its defaults for one epoch, then again into the same ``-o``
    for a second: it resumes from the first run's snapshot."""
    import shutil
    out = os.path.join("build", "chip_smoke_dcgan_twin")
    shutil.rmtree(out, ignore_errors=True)
    runs = []
    for epochs in ("1", "2"):
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "chainermn_tpu_torch.examples.train_dcgan",
             "--device", "cuda", "-e", epochs, "-o", out],
            capture_output=True, text=True, timeout=300,
            cwd=os.path.dirname(os.path.abspath(__file__)))
        runs.append({"epochs": int(epochs), "rc": proc.returncode,
                     "wall_s": time.perf_counter() - t0,
                     "stdout_tail": proc.stdout.strip().splitlines()[-3:],
                     "stderr_tail": proc.stderr.strip().splitlines()[-3:]})
        if proc.returncode != 0:
            emit({"phase": "train_dcgan_twin", "runs": runs})
            fail(f"train_dcgan_twin: -e {epochs} exited "
                 f"{proc.returncode}: {proc.stderr[-2000:]}")
        runs[-1]["stdout"] = proc.stdout
    resumed = [line for line in runs[1].pop("stdout").splitlines()
               if line.startswith("resumed from iteration")]
    runs[0].pop("stdout")
    emit({"phase": "train_dcgan_twin", "runs": runs, "resumed": resumed,
          "files": sorted(os.listdir(out))})
    if resumed != ["resumed from iteration 32"]:
        fail(f"train_dcgan_twin: the second run printed {resumed}")


def dcgan_small_run(device, comm, steps, z):
    """The small DCGAN from seeds, ``steps`` iterations of the noise
    ``z`` on ``device``: (losses, state)."""
    from chainermn_tpu_torch.core import reporter
    gen, dis = dcgan_nets(device, **DCGAN_SMALL)
    data = np.random.RandomState(0).normal(
        0, 0.5, (2 * DCGAN_SMALL_BATCH, 3, 32, 32)).astype(np.float32)
    updater = dcgan_updater(comm, gen, dis, data, DCGAN_SMALL_BATCH,
                            alpha=DCGAN_ALPHA)
    noise = iter(z)
    gen.make_hidden = lambda n, key=None: torch.from_numpy(
        next(noise)).to(device)
    losses = []
    for _ in range(steps):
        obs = {}
        with reporter.Reporter().scope(obs):
            updater.update()
        losses.append([float(obs["gen/loss"]), float(obs["dis/loss"])])
    return losses, dcgan_state(updater)


def phase_dcgan_parity():
    """The small DCGAN, TF32 off: (a) a world-of-one DP iteration bitwise
    the plain ``Adam`` iteration (``cudnn.deterministic`` on); (b) 3
    iterations on the card against the CPU."""
    import torch.distributed as dist
    from chainermn_tpu_torch import create_communicator
    reset_launches()
    rng = np.random.RandomState(1)
    z = [rng.normal(0, 1, (DCGAN_SMALL_BATCH, DCGAN_SMALL["n_hidden"]))
         .astype(np.float32) for _ in range(3)]
    flags = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    comm = create_communicator("pure_nccl")
    try:
        plain = dcgan_small_run("cuda", None, 1, z)
        dp = dcgan_small_run("cuda", comm, 1, z)
    finally:
        torch.backends.cudnn.deterministic = flags
        comm.finalize()
    a_diff = first_difference(dp[1], plain[1])
    card = dcgan_small_run("cuda", None, 3, z)
    cpu = dcgan_small_run("cpu", None, 3, z)
    state_err = max(float(np.abs(card[1][k] - v).max())
                    for k, v in cpu[1].items()
                    if v.dtype.kind == "f" and v.size)
    loss_rel = [[abs(a - b) / abs(b) for a, b in zip(x, y)]
                for x, y in zip(card[0], cpu[0])]
    row = {"phase": "dcgan_parity", **DCGAN_SMALL,
           "batch": DCGAN_SMALL_BATCH,
           "a_bitwise_equal": a_diff is None and dp[0] == plain[0],
           "a_first_difference": a_diff, "losses": card[0],
           "cpu_losses": cpu[0], "loss_rel_err": loss_rel,
           "state_abs_err": state_err, "tol": DCGAN_PARITY_TOL,
           "launches": check_no_flash("dcgan_parity")}
    emit(row)
    if not row["a_bitwise_equal"]:
        fail(f"dcgan_parity: the world-of-one DP iteration left the plain "
             f"one at {a_diff}")
    if loss_rel[0][1] > DCGAN_PARITY_TOL["first_dis_loss_rel"] \
            or max(max(r) for r in loss_rel) > DCGAN_PARITY_TOL["loss_rel"] \
            or state_err > DCGAN_PARITY_TOL["state_abs"]:
        fail(f"dcgan_parity: the card left the CPU: losses {loss_rel}, "
             f"state {state_err}")
    if dist.is_initialized():
        fail("the process group outlived dcgan_parity")



# -- sequence parallelism and the mixture of experts (ROADMAP A9) -------------

#: phase 38: the non-SP run and each SP mode, 6 steps each (the first a
#: warm-up) then 2 profiled
SP_MODES = ("ring", "zigzag", "ulysses")
SP_STEPS, SP_PROFILED = 6, 2
#: an SP mode's losses against the non-SP run's on the same weights and
#: batches, relative: bf16 activations; zigzag merges three half-blocks
#: in fp32 and rounds once where the plain call rounds one block, and the
#: fused backward's dq adds its tiles in a varying order, so the runs part
#: by a few bf16 ulps (2^-8 relative) over 6 Adam steps
SP_LOSS_RTOL = 1e-2
#: an SP mode's first step on the first batch against the non-SP model's
#: on the same weights, as ``rel_norm``: the last hidden states, and each
#: parameter's gradient (the worst parameter).  On random next tokens the
#: loss cannot tell a broken attention; these can (the qkv weights'
#: gradients flow only through it).  Beside them the non-SP step run again
#: (the fused backward adds dq in a varying order, and 12 bf16 layers
#: spread that: on the H100 it read 8.1e-3 on the gradients, the SP modes
#: 8.1e-3 to 1.1e-2, zigzag's hidden states 6.8e-3) and the non-SP step
#: with the mask off, what a wrong attention reads (0.31 and 0.97)
SP_FIRST_STEP_TOL = {"hidden": 3e-2, "grad": 5e-2}
#: phase 39: a 4-rank ring over one sequence of T 4096 (chunks of 1024,
#: half-chunks of 512), B 2, H 12, D 64, bf16, causal
REPLAY = dict(B=2, H=12, T=4096, D=64, n=4)
#: the replay, and one kernel call over the whole sequence, against the
#: plain attention on the card (fp32 on the upcast inputs, autograd), in
#: segments of REPLAY_SEGMENT rows, each as ``rel_norm`` (the 2-norm of
#: the error over the segment's): out is rounded to bf16 once (2^-9 of
#: each value at most); dq, dk, dv leave each block's kernel in bf16 and
#: autograd adds up to n = 4 of them in bf16.  A segment that a branch
#: left at zero reads 1
REPLAY_TOL = {"out": 1e-2, "grad": 1e-2}
REPLAY_SEGMENT = 512
#: each ring branch's kernel calls at the replay's shapes: (Tq, Tk, causal)
REPLAY_BRANCHES = {
    "naive": {"dense": [(1024, 1024, False)], "diag": [(1024, 1024, True)]},
    "zigzag": {"past": [(1024, 512, False)], "future": [(512, 1024, False)],
               "diagonal": [(512, 512, True), (512, 512, False),
                            (512, 512, True)]}}
#: the replay's lse-forward launches (= backward calls): naive, every
#: rank's live steps (1 + 2 + 3 + 4); zigzag, 3 for the diagonal and 1
#: for each of the other 3 steps on every rank
REPLAY_CALLS = {"naive": 10, "zigzag": 24}
#: phase 40: bench.py's MoE vertical (BENCH_MODEL=moe: vocab 32768, d 512,
#: heads of 64, 6 layers, seq 512, capacity factor 1.25, top-1, bf16,
#: Adam 3e-4, batch 8 a chip) in a world of one: one expert
MOE = dict(n_vocab=32768, d_model=512, n_heads=8, n_layers=6, max_len=512,
           capacity_factor=1.25, topk=1, seed=0)
MOE_BATCH, MOE_STEPS, MOE_PROFILED = 8, 8, 2
#: phase 41: the CPU tests' small models at the head width the kernels
#: take (64), fp32, TF32 off, 3 SGD steps on the card against the CPU:
#: losses relative and parameters absolute (the kernels sum and take exp
#: in another order than the plain versions)
SP_SMALL = dict(n_vocab=50, d_model=128, n_heads=2, n_layers=2, max_len=32,
                seed=7)
MOE_SMALL = dict(n_vocab=64, d_model=128, n_heads=2, n_layers=2, max_len=16,
                 seed=0)
SMALL_LR = 0.5
SP_PARITY_TOL = {"loss_rel": 1e-4, "param_abs": 1e-4}


def lm_batches(n_vocab, rows, T, batch, device="cuda", seed=0):
    """:func:`train_rows` at another size, as ``batch``-row batches on
    ``device``."""
    x, pairs = train_rows(n_vocab, rows, T, seed)
    t = np.stack([target for _, target in pairs])
    return [(torch.from_numpy(x[i:i + batch]).to(device),
             torch.from_numpy(t[i:i + batch]).to(device))
            for i in range(0, rows, batch)]


def observed_steps(opt, model, batches, steps, keys=("main/loss",)):
    """``steps`` updates of ``opt`` over ``batches`` in turn, with the
    model's reports collected and CUDA events after each step (no host
    sync in the loop), the launch counts and peak memory read around the
    run alone: ``(step_ms, {key: values}, peak_bytes, launches)``."""
    from chainermn_tpu_torch.core import reporter
    rep = reporter.Reporter()
    rep.add_observer("main", model)
    seen, marks = [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    start = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(steps):
        obs = {}
        with rep.scope(obs):
            opt.update(model, *batches[i % len(batches)])
        seen.append(obs)
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        marks.append(ev)
    torch.cuda.synchronize()
    launches = read_launches()
    step_ms = [start.elapsed_time(marks[0])] + [
        a.elapsed_time(b) for a, b in zip(marks, marks[1:])]
    return (step_ms, {k: [float(o[k]) for o in seen] for k in keys},
            torch.cuda.max_memory_allocated(), launches)


def lm_step_row(step_ms, tokens, flops_tok, peak, launches, wall, busy):
    median_ms = float(np.median(step_ms[1:]))
    tokens_per_s = tokens / (median_ms * 1e-3)
    return {"step_ms": step_ms, "median_step_ms": median_ms,
            "tokens_per_s": tokens_per_s, "flops_per_token": flops_tok,
            "mfu": flops_tok * tokens_per_s / PEAK_FLOPS[torch.bfloat16],
            "device_idle_share": 1.0 - busy / wall, "peak_bytes": peak,
            "launches": launches}


def rel_norm(got, ref):
    """``|got - ref| / |ref|`` in the 2-norm over all elements."""
    ref = ref.float()
    return ((got.float() - ref).norm() / ref.norm().clamp_min(1e-30)).item()


def first_step(model, x, t, causal=True):
    """The model's last hidden states, loss and parameter gradients on one
    batch (the loss as ``TransformerLM.forward`` takes it); the gradients
    cleared after.  ``causal=False`` runs the non-SP attention unmasked."""
    from chainermn_tpu_torch.models import transformer as tm
    from chainermn_tpu_torch.nn import functions as F
    B, T = x.shape
    masked = tm.fused_attention
    if not causal:
        tm.fused_attention = lambda q, k, v, causal: masked(q, k, v)
    try:
        h = model.hidden(x)
    finally:
        tm.fused_attention = masked
    loss = F.softmax_cross_entropy(model.head(h.reshape(B * T, -1)),
                                   t.reshape(-1), ignore_label=-1)
    loss.backward()
    grads = {p: a.grad.detach().clone() for p, a in model.namedparams()}
    model.cleargrads()
    return h.detach(), loss.item(), grads


def first_step_errs(step, ref):
    """:func:`first_step` against another: the loss's absolute error,
    ``rel_norm`` of the hidden states and of the worst parameter's
    gradient, and that parameter."""
    h, loss, grads = step
    worst = max(ref[2], key=lambda p: rel_norm(grads[p], ref[2][p]))
    return {"first_loss_abs_err": abs(loss - ref[1]),
            "first_hidden_err": rel_norm(h, ref[0]),
            "first_grad_err": rel_norm(grads[worst], ref[2][worst]),
            "first_grad_worst": worst}


def phase_train_sp():
    """Phase 38: the full-width LM through ``TransformerLM(sp_comm=...)``
    in each SP mode over NCCL in a world of one, beside the non-SP model
    on the same seeded weights and batches."""
    import torch.distributed as dist
    from chainermn_tpu_torch import (create_communicator,
                                     create_multi_node_optimizer)
    from chainermn_tpu_torch.core.optimizer import Adam
    from chainermn_tpu_torch.models import TransformerLM
    n_layers, T = MODEL["n_layers"], MODEL["max_len"]
    batches = lm_batches(MODEL["n_vocab"], TRAIN_ROWS, T, TRAIN_BATCH)
    flops_tok = transformer_flops_per_token(
        MODEL["d_model"], n_layers, MODEL["n_vocab"], T)
    comm = create_communicator("pure_nccl")
    rows = {}
    try:
        runs = [("plain", None)] + [(m, m) for m in SP_MODES]
        first = ref0 = None
        for label, mode in runs:
            kw = {} if mode is None else dict(sp_comm=comm, sp_mode=mode)
            model = TransformerLM(compute_dtype=torch.bfloat16,
                                  device="cuda", **MODEL, **kw)
            if first is None:
                first = {p: a.detach().clone()
                         for p, a in model.namedparams()}
            same = all(torch.equal(a, first[p])
                       for p, a in model.namedparams())
            step0 = first_step(model, *batches[0])
            if ref0 is None:
                ref0, step0_errs = step0, {
                    "first_step_again": first_step_errs(
                        first_step(model, *batches[0]), step0),
                    "first_step_unmasked": first_step_errs(
                        first_step(model, *batches[0], causal=False), step0)}
            else:
                step0_errs = first_step_errs(step0, ref0)
            del step0
            opt = create_multi_node_optimizer(Adam(alpha=3e-4),
                                              comm).setup(model)
            step_ms, seen, peak, launches = observed_steps(
                opt, model, batches, SP_STEPS)
            wall, busy, _ = device_profile(lambda: [
                opt.update(model, *batches[i % 2])
                for i in range(SP_PROFILED)])
            rows[label] = {"mode": mode, "same_initial_weights": same,
                           **step0_errs, "losses": seen["main/loss"],
                           **lm_step_row(step_ms, TRAIN_BATCH * T, flops_tok,
                                         peak, launches, wall, busy)}
            del model, opt
            torch.cuda.empty_cache()
    finally:
        comm.finalize()
    del ref0
    ref = rows["plain"]["losses"]
    for label in SP_MODES:
        rows[label]["loss_rel_err"] = max(
            abs(a - b) / abs(b) for a, b in zip(rows[label]["losses"], ref))
    emit({"phase": "train_sp", "batch": TRAIN_BATCH, "T": T,
          "steps": SP_STEPS, "tol": SP_LOSS_RTOL,
          "first_step_tol": SP_FIRST_STEP_TOL, **rows})
    for label, row in rows.items():
        calls = n_layers * (3 if label == "zigzag" else 1) * SP_STEPS
        want = expected_launches(fwd_lse=calls, bwd=calls, bwd_delta=calls)
        if row["launches"] != want:
            fail(f"train_sp {label}: launches {row['launches']}, expected "
                 f"{want}")
        if not row["same_initial_weights"] \
                or not np.isfinite(row["losses"]).all():
            fail(f"train_sp {label}: {row}")
        if label != "plain" and not row["loss_rel_err"] < SP_LOSS_RTOL:
            fail(f"train_sp {label}: losses {row['losses']} leave the "
                 f"non-SP run's {ref}")
        if label != "plain" and not (
                row["first_hidden_err"] < SP_FIRST_STEP_TOL["hidden"]
                and row["first_grad_err"] < SP_FIRST_STEP_TOL["grad"]):
            fail(f"train_sp {label}: the first step's hidden states or "
                 f"gradients leave the non-SP model's: {row}")
    if dist.is_initialized():
        fail("the process group outlived train_sp")
    return rows


def replay_branch_times():
    """Each ring branch's kernels at the replay's chunk shapes: device
    microseconds of the lse forward, the fused backward and the split
    backward's two passes, each beside its bound (bytes over the HBM rate
    or operations over the bf16 peak, the live (q, k) pairs only).
    ``main`` takes them after phase 6, where profiles miss few launches
    (``kernel_device_ms``), for phase 39 to report."""
    fa = flash_module()
    B, H, D = REPLAY["B"], REPLAY["H"], REPLAY["D"]
    shapes = {}
    for branches in REPLAY_BRANCHES.values():
        for calls in branches.values():
            for Tq, Tk, causal in calls:
                if (Tq, Tk, causal) in shapes:
                    continue
                q, k, v, g = train_inputs(B, Tq, Tk, D, torch.bfloat16, 43)
                out, lse = fa.flash_attention_fwd(q, k, v, causal=causal)
                delta = fa.flash_attention_bwd_delta(g, out)
                args = (q, k, v, g, lse, delta)
                kw = {"causal": causal}
                row = {}
                for part, fn, kernel in (
                        ("fwd", lambda: fa.flash_attention_fwd(
                            q, k, v, **kw), FWD_KERNEL),
                        ("bwd", lambda: fa._fused_bwd(
                            q, k, v, out, lse, g, causal,
                            fa._scale(None, D), None), BWD_KERNEL),
                        ("dq", lambda: fa.flash_attention_bwd_dq(*args, **kw),
                         SPLIT_KERNELS["dq"]),
                        ("dkv", lambda: fa.flash_attention_bwd_dkv(
                            *args, **kw), SPLIT_KERNELS["dkv"])):
                    ms = kernel_device_ms(fn, kernel)
                    row[f"{part}_us"] = None if ms is None else 1e3 * ms
                    if part == "fwd":
                        nbytes = fa.attention_bytes(B, H, Tq, Tk, D, 2) \
                            + B * H * Tq * 4
                        ops = fa.attention_flops(B, H, Tq, Tk, D, causal)
                    else:
                        w = "fused" if part == "bwd" else part
                        nbytes = fa.attention_bwd_bytes(B, H, Tq, Tk, D, 2,
                                                        part=w)
                        ops = fa.attention_bwd_flops(B, H, Tq, Tk, D, causal,
                                                     part=w)
                    ms, by = bound_of(nbytes, ops)
                    row[f"{part}_bound_us"] = ms * 1e3
                    row[f"{part}_bound_by"] = by
                shapes[(Tq, Tk, causal)] = row
    out = {}
    for schedule, branches in REPLAY_BRANCHES.items():
        for name, calls in branches.items():
            rows = [shapes[c] for c in calls]
            out[f"{schedule}.{name}"] = {
                "calls": [list(c) for c in calls],
                **{key: None if any(r[key] is None for r in rows)
                   else sum(r[key] for r in rows) for key in rows[0]
                   if key.endswith("_us")}}
    return out


def segment_err(got, ref, dim=2, rows=REPLAY_SEGMENT):
    """``got`` against ``ref`` in segments of ``rows`` along ``dim``, each
    as ``rel_norm``: the worst segment's."""
    return max(rel_norm(a, b) for a, b in zip(got.split(rows, dim),
                                              ref.split(rows, dim)))


def phase_ring_replay(branches):
    """Phase 39: a 4-rank ring over one T 4096 sequence replayed in one
    process through the lse forward and the backward kernels (Tq != Tk,
    half-chunk diagonals, a non-zero lse cotangent in every block), for
    both schedules and both backward lowerings, and one kernel call over
    the whole sequence, each against the plain attention on the card;
    reported with ``branches``, each branch's kernel times beside its
    bounds (``replay_branch_times``)."""
    fa = flash_module()
    from chainermn_tpu_torch.parallel import zigzag_shard, zigzag_unshard
    from chainermn_tpu_torch.parallel.ring_attention import _ring_replay
    B, H, T, D, n = (REPLAY[k] for k in ("B", "H", "T", "D", "n"))
    q, k, v, g = train_inputs(B, T, T, D, torch.bfloat16, 41)
    leaves = [x.float().requires_grad_() for x in (q, k, v)]
    ref = fa.xla_attention(*leaves, causal=True)
    ref.backward(g.float())
    refs = [ref.detach()] + [x.grad for x in leaves]
    del ref, leaves
    torch.cuda.empty_cache()
    saved = fa._FLASH_BWD
    runs = {}
    try:
        for bwd in ("fused", "split"):
            fa._FLASH_BWD = bwd
            for schedule in ("naive", "zigzag", "whole"):
                if schedule == "whole" and bwd == "split":
                    continue
                leaves = [x.clone().requires_grad_() for x in (q, k, v)]
                torch.cuda.synchronize()
                reset_launches()
                if schedule == "whole":
                    out = fa._FlashDiff.apply(*leaves, True, None)
                elif schedule == "zigzag":
                    out = zigzag_unshard(_ring_replay(
                        *(zigzag_shard(x, n) for x in leaves), n, schedule,
                        causal=True), n)
                else:
                    out = _ring_replay(*leaves, n, schedule, causal=True)
                out.backward(g)
                torch.cuda.synchronize()
                launches = read_launches()
                got = [out.detach()] + [x.grad for x in leaves]
                errs = [segment_err(a, b) for a, b in zip(got, refs)]
                runs[f"{schedule}_{bwd}"] = {
                    "launches": launches, "out_rel_err": errs[0],
                    "dq_dk_dv_rel_err": errs[1:],
                    "finite": all(bool(torch.isfinite(x.float()).all())
                                  for x in got)}
    finally:
        fa._FLASH_BWD = saved
    del refs
    emit({"phase": "ring_replay", **REPLAY, "dtype": "bfloat16",
          "causal": True, "segment": REPLAY_SEGMENT, "tol": REPLAY_TOL,
          "runs": runs, "branches": branches})
    for label, row in runs.items():
        schedule, bwd = label.split("_")
        c = REPLAY_CALLS.get(schedule, 0)
        want = expected_launches(fwd_lse=c, bwd_delta=c, **(
            {"bwd": c} if bwd == "fused" else {"bwd_dq": c, "bwd_dkv": c}))
        if schedule != "whole" and row["launches"] != want:
            fail(f"ring_replay {label}: launches {row['launches']}, "
                 f"expected {want}")
        if not (row["finite"] and row["out_rel_err"] < REPLAY_TOL["out"]
                and max(row["dq_dk_dv_rel_err"]) < REPLAY_TOL["grad"]):
            fail(f"ring_replay {label} leaves the plain attention: {row}")
    return runs, branches


def phase_train_moe():
    """Phase 40: bench.py's MoE vertical through the dispatch route (an
    expert on each of the world's one rank, NCCL), Adam through the
    multi-node optimizer, 8 steps then 2 profiled."""
    import torch.distributed as dist
    from chainermn_tpu_torch import (create_communicator,
                                     create_multi_node_optimizer)
    from chainermn_tpu_torch.core.optimizer import Adam
    from chainermn_tpu_torch.models import MoETransformerLM
    T, L = MOE["max_len"], MOE["n_layers"]
    batches = lm_batches(MOE["n_vocab"], 2 * MOE_BATCH, T, MOE_BATCH)
    comm = create_communicator("pure_nccl")
    try:
        model = MoETransformerLM(ep_comm=comm, compute_dtype=torch.bfloat16,
                                 device="cuda", **MOE)
        opt = create_multi_node_optimizer(Adam(alpha=3e-4),
                                          comm).setup(model)
        comm.calls.clear()
        step_ms, seen, peak, launches = observed_steps(
            opt, model, batches, MOE_STEPS,
            keys=("main/loss", "main/moe_aux", "main/moe_dropped"))
        calls = dict(comm.calls)
        wall, busy, by_name = device_profile(lambda: [
            opt.update(model, *batches[i % 2]) for i in range(MOE_PROFILED)])
        n_params = model.count_params()
    finally:
        comm.finalize()
    flops_tok = transformer_flops_per_token(MOE["d_model"], L,
                                            MOE["n_vocab"], T)
    row = {"phase": "train_moe", **MOE, "batch": MOE_BATCH,
           "steps": MOE_STEPS, "params": n_params,
           "losses": seen["main/loss"], "moe_aux": seen["main/moe_aux"],
           "moe_dropped": seen["main/moe_dropped"], "collectives": calls,
           **lm_step_row(step_ms, MOE_BATCH * T, flops_tok, peak, launches,
                         wall, busy),
           "top_kernels_us": [[k[:80], us] for k, us in sorted(
               by_name.items(), key=lambda kv: -kv[1])[:8]]}
    emit(row)
    calls_per = L * MOE_STEPS
    want = expected_launches(fwd_lse=calls_per, bwd=calls_per,
                             bwd_delta=calls_per)
    if launches != want:
        fail(f"train_moe launches {launches}, expected {want}")
    if calls.get("moe_alltoall") != 2 * calls_per:
        fail(f"train_moe did not take the dispatch route: {calls}")
    if not np.isfinite(row["losses"]).all() \
            or any(d != 0 for d in row["moe_dropped"]) \
            or any(abs(a - 1.0) > 1e-6 for a in row["moe_aux"]):
        fail(f"train_moe: at one expert nothing drops and the aux loss is "
             f"1: {row}")
    if dist.is_initialized():
        fail("the process group outlived train_moe")
    return row


def small_lm_run(device, comm, which, mode=None, steps=3):
    """The small fp32 model ``which`` ("sp", "moe" dispatch or "dense"
    with 4 experts) for 3 SGD steps on ``device``: (losses, parameters on
    the host)."""
    from chainermn_tpu_torch import create_multi_node_optimizer
    from chainermn_tpu_torch.core.optimizer import SGD
    from chainermn_tpu_torch.models import MoETransformerLM, TransformerLM
    if which == "sp":
        model = TransformerLM(sp_comm=comm, sp_mode=mode, device=device,
                              **SP_SMALL)
        batch = lm_batches(SP_SMALL["n_vocab"], 2, 32, 2, device, seed=4)[0]
    else:
        model = MoETransformerLM(ep_comm=comm if which == "moe" else 4,
                                 device=device, **MOE_SMALL)
        batch = lm_batches(MOE_SMALL["n_vocab"], 8, 16, 8, device)[0]
    opt = create_multi_node_optimizer(SGD(lr=SMALL_LR), comm).setup(model)
    losses = [float(opt.update(model, *batch)) for _ in range(steps)]
    return losses, {p: a.detach().cpu() for p, a in model.namedparams()}


def phase_sp_moe_parity():
    """Phase 41: the small fp32 SP LM in each mode, the MoE LM's dispatch
    and its dense route with 4 experts, 3 SGD steps on the card against
    the CPU (a gloo group beside the NCCL world), TF32 off."""
    import torch.distributed as dist
    from chainermn_tpu_torch import create_communicator
    from chainermn_tpu_torch.communicators import MeshCommunicator
    comm = create_communicator("pure_nccl")
    out = {}
    try:
        cpu_comm = MeshCommunicator(device="cpu",
                                    group=dist.new_group(backend="gloo"),
                                    name="pure_nccl")
        reset_launches()
        for which, mode in [("sp", m) for m in SP_MODES] + [("moe", None),
                                                            ("dense", None)]:
            card = small_lm_run("cuda", comm, which, mode)
            cpu = small_lm_run("cpu", cpu_comm, which, mode)
            out[mode or which] = {
                "losses": card[0], "cpu_losses": cpu[0],
                "loss_rel_err": max(abs(a - b) / abs(b)
                                    for a, b in zip(card[0], cpu[0])),
                "param_abs_err": max((card[1][p] - v).abs().max().item()
                                     for p, v in cpu[1].items())}
        launches = read_launches()
    finally:
        comm.finalize()
    emit({"phase": "sp_moe_parity", "runs": out, "tol": SP_PARITY_TOL,
          "launches": launches})
    for label, errs in out.items():
        if not (errs["loss_rel_err"] < SP_PARITY_TOL["loss_rel"]
                and errs["param_abs_err"] < SP_PARITY_TOL["param_abs"]):
            fail(f"sp_moe_parity: {label} on the card leaves the CPU's "
                 f"run: {errs}")
    if not (launches["fwd_lse"] and launches["bwd"]) or launches["fwd"]:
        fail(f"sp_moe_parity launches {launches}: the lse forward and the "
             "backward on the card, never the no-grad forward")
    if dist.is_initialized():
        fail("the process group outlived sp_moe_parity")


#: phases 42-43: 12 iterations, a DCP snapshot every 4, one fault
#: injected at the 7th gradient exchange (the 7th iteration, after its
#: backward): the rollback resumes from iteration 4
RECOVER_STEPS, RECOVER_EVERY, RECOVER_FAULT_AT = 12, 4, 7
#: host-channel round trips timed over the script's TCPStore
CHANNEL_ROUNDS = 200


def recover_trainer(comm, out, sharded=False, checkpoint=True):
    """The full-width LM (bf16, split backward) on ``comm``'s multi-node
    Adam for RECOVER_STEPS iterations of train_rows, with the per-rank DCP
    checkpointer every RECOVER_EVERY when ``checkpoint``: ``(model,
    trainer, checkpointer, step_marks)``; ``step_marks`` collects
    ``(iteration, perf_counter after a sync)`` after each iteration."""
    from chainermn_tpu_torch import create_multi_node_optimizer
    from chainermn_tpu_torch.core.optimizer import Adam
    from chainermn_tpu_torch.dataset import SerialIterator
    from chainermn_tpu_torch.extensions import \
        create_multi_node_orbax_checkpointer
    from chainermn_tpu_torch.models import TransformerLM
    from chainermn_tpu_torch.training import StandardUpdater, Trainer
    model = TransformerLM(compute_dtype=torch.bfloat16, remat=False,
                          device="cuda", **MODEL)
    comm.bcast_data(model)
    adam = Adam(alpha=3e-4)
    adam.seed = 0
    opt = create_multi_node_optimizer(adam, comm, zero_sharding=sharded)
    opt.setup(model)
    _, data = train_rows()
    trainer = Trainer(StandardUpdater(
        SerialIterator(data, TRAIN_BATCH, shuffle=False), opt),
        (RECOVER_STEPS, "iteration"), out=os.path.join("build", out))
    marks = []

    def mark(tr):
        torch.cuda.synchronize()
        marks.append((tr.updater.iteration, time.perf_counter()))

    trainer.extend(mark, name="mark")
    cp = None
    if checkpoint:
        directory = os.path.join("build", out, "dcp")
        shutil.rmtree(directory, ignore_errors=True)
        cp = create_multi_node_orbax_checkpointer(comm, directory)
        trainer.extend(cp, trigger=(RECOVER_EVERY, "iteration"))
    return model, trainer, cp, marks


def timed_checkpointer(cp):
    """Wrap ``cp``'s save and consensus load with wall-clock timers (the
    save copies the state to the host: it syncs); returns the dict they
    fill."""
    t = {"save_ms": [], "load_ms": [], "load_at": []}
    save, load = cp.save, cp.maybe_load

    def timed_save(trainer, iteration):
        t0 = time.perf_counter()
        save(trainer, iteration)
        t["save_ms"].append((time.perf_counter() - t0) * 1e3)

    def timed_load(trainer, optimizer=None):
        t0 = time.perf_counter()
        t["load_at"].append(t0)
        out = load(trainer)
        torch.cuda.synchronize()
        t["load_ms"].append((time.perf_counter() - t0) * 1e3)
        return out

    cp.save, cp.maybe_load = timed_save, timed_load
    return t


def params_of(model):
    return {p: v.detach().clone() for p, v in model.namedparams()}


def recovery_timeline(fault_at, marks, t, resumed):
    """Seconds from the fault (the supervisor catching it) to the end of
    the first resumed step: quiesce (to the consensus load), the load,
    and the first step."""
    load_at = t["load_at"][0]
    load_end = load_at + t["load_ms"][0] / 1e3
    first = next(m for i, m in marks if m > load_end and i == resumed + 1)
    return {"fault_to_first_step_s": first - fault_at,
            "quiesce_s": load_at - fault_at,
            "consensus_load_s": t["load_ms"][0] / 1e3,
            "first_step_s": first - load_end}


def dir_bytes(path):
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, files in os.walk(path) for f in files)


def phase_train_recover():
    """Phase 42: FailureRecovery on the full-width LM (bf16, split
    backward, Adam 3e-4, batch 8 x T 1024) in a world of one on NCCL: the
    'fault' communicator over the bf16 flat wire raises at the 7th
    gradient exchange; the supervisor rolls back to the DCP snapshot of
    iteration 4 and the run ends at 12, bitwise on an uninterrupted run
    in this call."""
    import torch.distributed as dist
    from chainermn_tpu_torch import create_communicator
    from chainermn_tpu_torch.extensions import FailureRecovery
    from chainermn_tpu_torch.training.trainer import Extension
    fa = flash_module()
    saved = fa._FLASH_BWD
    fa._FLASH_BWD = "split"

    def comm_with(faults):
        return create_communicator(
            "fault", allreduce_grad_dtype="bfloat16",
            fault_schedule={"seed": 0, "faults": faults})

    try:
        comm = comm_with([])
        model, trainer, _, _ = recover_trainer(comm, "chip_smoke_recover_gold",
                                               checkpoint=False)
        trainer.run()
        gold = params_of(model)
        comm.finalize()
        del model, trainer
        torch.cuda.empty_cache()

        comm = comm_with([{"op": "multi_node_mean_grad",
                           "nth": RECOVER_FAULT_AT}])
        model, trainer, cp, marks = recover_trainer(
            comm, "chip_smoke_recover")
        t = timed_checkpointer(cp)
        fault = {}

        class FaultClock(Extension):
            trigger = (10 ** 9, "iteration")

            def __call__(self, trainer):
                pass

            def on_error(self, trainer, exc, tb):
                fault.setdefault("at", time.perf_counter())
                fault.setdefault("exc", type(exc).__name__)

        trainer.extend(FaultClock(), name="fault_clock")
        rec = FailureRecovery(checkpointer=cp, verbose=False)
        trainer.extend(rec)
        reset_launches()
        trainer.run()
        torch.cuda.synchronize()
        launches = read_launches()
        final = params_of(model)
        bitwise = all(torch.equal(final[p], v) for p, v in gold.items())
        resumed = rec.stats["resumed_iterations"]
        steps = sorted(int(d) for d in os.listdir(cp._ckpt.directory)
                       if d.isdigit())
        row = {"phase": "train_recover", "communicator": "fault",
               "backend": dist.get_backend(), "world": comm.size,
               "wire_dtype": str(comm.allreduce_grad_dtype),
               "fault": fault.get("exc"),
               "fault_at_exchange": RECOVER_FAULT_AT,
               "recoveries": rec.stats["recoveries"],
               "resumed_iterations": resumed,
               "iteration": trainer.updater.iteration,
               "final_bitwise": bitwise,
               **recovery_timeline(fault["at"], marks, t, resumed[0]),
               "save_ms": t["save_ms"], "load_ms": t["load_ms"],
               "snapshot_bytes": dir_bytes(cp._ckpt._step_dir(steps[-1])),
               "snapshots": steps, "launches": launches,
               "exchanges": comm.calls["allreduce_grad"]}
        comm.finalize()
    finally:
        fa._FLASH_BWD = saved
    emit(row)
    forwards = RECOVER_STEPS + RECOVER_FAULT_AT - resumed[0]
    want = expected_launches(fwd_lse=MODEL["n_layers"] * forwards,
                             bwd_delta=MODEL["n_layers"] * forwards,
                             bwd_dq=MODEL["n_layers"] * forwards,
                             bwd_dkv=MODEL["n_layers"] * forwards)
    if launches != want:
        fail(f"train_recover launches {launches}, expected {want}")
    if not (row["recoveries"] == 1 and resumed == [RECOVER_EVERY]
            and row["iteration"] == RECOVER_STEPS and bitwise):
        fail(f"train_recover: not one rollback to iteration "
             f"{RECOVER_EVERY} ending bitwise on the uninterrupted run: "
             f"{row}")
    if dist.is_initialized():
        fail("the process group outlived train_recover")


def channel_round_trips(channel, store):
    """Mean microseconds of a host-channel point-to-point round trip
    (send_obj then recv_obj of a small dict, this process to itself) and
    of a barrier, over CHANNEL_ROUNDS each, and the store's key count
    before and after them (every matched op takes its keys back out)."""
    keys_before = store.num_keys()
    t0 = time.perf_counter()
    for i in range(CHANNEL_ROUNDS):
        channel.send_obj({"i": i}, 0, tag=7)
        if channel.recv_obj(0, tag=7) != {"i": i}:
            fail("host channel: a message came back changed")
    p2p = (time.perf_counter() - t0) / CHANNEL_ROUNDS * 1e6
    t0 = time.perf_counter()
    for _ in range(CHANNEL_ROUNDS):
        channel.barrier()
    barrier = (time.perf_counter() - t0) / CHANNEL_ROUNDS * 1e6
    keys = (keys_before, store.num_keys())
    if keys[1] != keys[0]:
        fail(f"host channel: the store went from {keys[0]} to {keys[1]} "
             f"keys over {2 * CHANNEL_ROUNDS} matched ops")
    return p2p, barrier, keys


def phase_elastic_rebuild():
    """Phase 43: ElasticRecovery on the same LM under the sharded update
    (ZeRO-1 Adam, bf16 wire, split backward) in a world of one: a
    TCPStore this script hosts carries a host channel (heartbeat on, its
    round trips timed) and the membership, over whose store the
    supervisor builds; a fault at the 7th reduce-scatter makes the
    supervisor resolve a one-member view at epoch 1 and rebuild onto
    ElasticMeshCommunicator((0,), epoch=1) -- a fresh NCCL world over the
    store -- through change_communicator, roll back to iteration 4 and
    end at 12, bitwise on an uninterrupted run."""
    import datetime

    import torch.distributed as dist
    from chainermn_tpu_torch import create_communicator
    from chainermn_tpu_torch.communicators import (ElasticMembership,
                                                   ElasticMeshCommunicator,
                                                   HostChannel, StoreKV)
    from chainermn_tpu_torch.extensions import ElasticRecovery
    fa = flash_module()
    saved = fa._FLASH_BWD
    fa._FLASH_BWD = "split"
    store = dist.TCPStore("127.0.0.1", 0, 1, True,
                          timeout=datetime.timedelta(seconds=60),
                          wait_for_workers=False)
    channel = HostChannel(client=StoreKV(store), process_id=0,
                          num_processes=1, timeout_ms=60_000)
    channel.enable_heartbeat(interval_s=0.5)
    p2p_us, barrier_us, store_keys = channel_round_trips(channel, store)
    try:
        comm = create_communicator("pure_nccl",
                                   allreduce_grad_dtype="bfloat16")
        model, trainer, _, _ = recover_trainer(
            comm, "chip_smoke_elastic_gold", sharded=True, checkpoint=False)
        trainer.run()
        gold = params_of(model)
        comm.finalize()
        del model, trainer
        torch.cuda.empty_cache()

        comm = create_communicator(
            "fault", allreduce_grad_dtype="bfloat16",
            fault_schedule={"seed": 0, "faults": [
                {"op": "reduce_scatter_grad", "nth": RECOVER_FAULT_AT}]})
        model, trainer, cp, marks = recover_trainer(
            comm, "chip_smoke_elastic", sharded=True)
        t = timed_checkpointer(cp)
        membership = ElasticMembership(StoreKV(store), rank=0, world=1,
                                       settle_s=0.05, poll_s=0.005)
        rec = ElasticRecovery(checkpointer=cp, comm=comm,
                              membership=membership, verbose=False)
        build = {}
        factory = rec._default_factory

        def timed_factory(view):
            t0 = time.perf_counter()
            new = factory(view)
            torch.cuda.synchronize()
            build["rebuild_s"] = time.perf_counter() - t0
            return new

        rec._default_factory = timed_factory
        trainer.extend(rec)
        reset_launches()
        trainer.run()
        torch.cuda.synchronize()
        launches = read_launches()
        final = params_of(model)
        bitwise = all(torch.equal(final[p], v) for p, v in gold.items())
        new = rec.comm
        row = {"phase": "elastic_rebuild",
               "communicator": type(new).__name__,
               "epoch": new.epoch, "members": list(new.members),
               "stable_rank": new.stable_rank,
               "backend": dist.get_backend(), "world": new.size,
               "recoveries": rec.stats["recoveries"],
               "resumed_iterations": rec.stats["resumed_iterations"],
               "resizes": rec.stats["resizes"],
               "iteration": trainer.updater.iteration,
               "final_bitwise": bitwise, **build,
               "save_ms": t["save_ms"], "load_ms": t["load_ms"],
               "channel_p2p_us": p2p_us, "channel_barrier_us": barrier_us,
               "store_keys_before_after": store_keys,
               "heartbeat_interval_s": channel.monitor.interval_s,
               "launches": launches,
               "collectives": dict(new.calls)}
        ok_type = isinstance(new, ElasticMeshCommunicator)
        new.finalize()
    finally:
        fa._FLASH_BWD = saved
        channel.monitor.stop_thread()
    emit(row)
    forwards = RECOVER_STEPS + RECOVER_FAULT_AT - RECOVER_EVERY
    want = expected_launches(fwd_lse=MODEL["n_layers"] * forwards,
                             bwd_delta=MODEL["n_layers"] * forwards,
                             bwd_dq=MODEL["n_layers"] * forwards,
                             bwd_dkv=MODEL["n_layers"] * forwards)
    if launches != want:
        fail(f"elastic_rebuild launches {launches}, expected {want}")
    if not (ok_type and row["epoch"] == 1 and row["members"] == [0]
            and "nccl" in row["backend"] and row["recoveries"] == 1
            and row["resumed_iterations"] == [RECOVER_EVERY]
            and row["iteration"] == RECOVER_STEPS and bitwise):
        fail(f"elastic_rebuild: not one rebuild onto an epoch-1 NCCL world "
             f"of member 0 ending bitwise on the uninterrupted run: {row}")
    if dist.is_initialized():
        fail("the process group outlived elastic_rebuild")


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke run needs one card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from chainermn_tpu_torch._build import (build_log, library_path,
                                          load_library)
    from chainermn_tpu_torch.models import TransformerLM

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    kind = torch.cuda.get_device_name(0)
    t0 = time.perf_counter()
    load_library()
    build_s = time.perf_counter() - t0
    # nvcc's -Xptxas -v report (registers, spills) beside the library
    with open(library_path().with_suffix(".log"), "w") as f:
        f.write(build_log())
    sass = sass_counts(library_path())
    emit({"phase": "device", "kind": kind, "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "build_s": build_s, "ptxas": ptxas_report(build_log()),
          "sass": sass})
    plain = [name for name, n in sass.items()
             if not (n["HGMMA"] and n["UTMALDG"])]
    missing = [k for k in SM90_KERNELS
               if not any(n.startswith(k) for n in sass)]
    if plain or missing:
        fail(f"bf16 Hopper instantiations without wgmma or TMA: "
             f"{plain or sass}; kernels not found: {missing}")

    checks, times = phase_kernel()
    model = TransformerLM(compute_dtype=torch.bfloat16, device="cuda",
                          **MODEL)
    launches, streams = phase_serving(model)
    phase_decode_parity(model)
    t_a13a = time.perf_counter()
    chunked_row, chunked_streams = phase_serving_chunked(model, streams)
    phase_serving_spec(model, streams)
    phase_serving_spec_draft_chunked(model, streams)
    phase_spec_verify_parity(model)
    emit({"phase": "a13a_phases", "seconds": time.perf_counter() - t_a13a})
    phases_a13b(model, streams, launches, chunked_row, chunked_streams)
    phases_a13c(model, streams, launches)
    del model
    torch.cuda.empty_cache()
    train_times = phase_kernel_train()
    split_times = phase_kernel_split()
    branches = replay_branch_times()
    train_launches, _ = phase_train()
    dp_launches, _ = phase_train_dp()
    phase_train_parity()
    phase_train_dp_parity()
    torch.cuda.empty_cache()
    resnet_row = phase_train_resnet()
    for i, phase in enumerate(RESNET_EXCHANGE_ORDER):
        torch.cuda.empty_cache()
        phase_train_resnet_exchange(
            phase, resnet_row, 1 + RESNET_EXCHANGE_ORDER[:i].count(phase))
    torch.cuda.empty_cache()
    phase_resnet_parity()
    phase_exchange_parity()
    phase_train_mnist()
    phase_train_mnist_dp()
    torch.cuda.empty_cache()
    phase_train_imagenet()
    pipeline_rows = phase_train_imagenet_pipeline(resnet_row)
    phase_resnet_remat()
    phase_convnet_parity()
    t_a14 = time.perf_counter()
    torch.cuda.empty_cache()
    phase_train_resnet_files(resnet_row)
    torch.cuda.empty_cache()
    phase_surface_parity()
    phase_dlpack_bridge()
    a14_s = time.perf_counter() - t_a14
    for i, phase in enumerate(RESNET_HIER_ORDER):
        torch.cuda.empty_cache()
        if phase in RESNET_HIER:
            phase_train_resnet_hier(phase, resnet_row)
        else:
            phase_train_resnet_exchange(
                phase, resnet_row, 1 + RESNET_EXCHANGE_ORDER.count(phase))
    phase_train_imagenet_hier(next(r for r in pipeline_rows
                                   if r["run"] == "thread"))
    phase_hier_parity(resnet_row["params"])
    for phase in RESNET_STRIPED:
        torch.cuda.empty_cache()
        phase_train_resnet_striped(phase, resnet_row)
    torch.cuda.empty_cache()
    phase_train_resnet_traced(resnet_row)
    t_merge = time.perf_counter()
    phase_trace_merge()
    emit({"phase": "a14_phases",
          "seconds": a14_s + time.perf_counter() - t_merge})
    phase_striped_parity()
    torch.cuda.empty_cache()
    phase_autotune(resnet_row)
    torch.cuda.empty_cache()
    seq2seq_row = phase_seq2seq_dp()
    torch.cuda.empty_cache()
    phase_seq2seq_mp(seq2seq_row)
    phase_model_parallel_parity()
    torch.cuda.empty_cache()
    t_dcgan = time.perf_counter()
    phase_train_dcgan()
    torch.cuda.empty_cache()
    phase_dcgan_checkpoint()
    phase_train_dcgan_twin()
    phase_dcgan_parity()
    emit({"phase": "dcgan_phases", "seconds":
          time.perf_counter() - t_dcgan})
    torch.cuda.empty_cache()
    t_sp = time.perf_counter()
    phase_train_sp()
    phase_ring_replay(branches)
    phase_train_moe()
    phase_sp_moe_parity()
    emit({"phase": "sp_moe_phases", "seconds": time.perf_counter() - t_sp})
    torch.cuda.empty_cache()
    t_resilience = time.perf_counter()
    phase_train_recover()
    torch.cuda.empty_cache()
    phase_elastic_rebuild()
    emit({"phase": "resilience_phases",
          "seconds": time.perf_counter() - t_resilience})

    main_check = next(c for c in checks
                      if c["B"] == 1 and c["T"] == 1024 and c["causal"])
    main_time = next(t for t in times if t["T"] == 1024)
    fields = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
              "library_ms", "device_ms", "library_device_ms",
              "call_device_ms", "host_us")
    emit({"kernels": [{
        "name": "flash_attention_fwd",
        "route": "cuda",
        "source": "chainermn_tpu_torch/csrc/flash_fwd_sm90.cu",
        "replaces": "chainermn_tpu/ops/flash_attention.py:322",
        "launches": launches,
        "max_abs_err": main_check["max_abs_err"],
        **{f: main_time[f] for f in fields[1:]},
    }] + [{
        "name": name, "route": "cuda", "source": source,
        "replaces": replaces, "launches": train_launches[key],
        **{f: train_times[key][f] for f in fields},
    } for name, key, source, replaces in [
        ("flash_attention_fwd_lse", "fwd_lse",
         "chainermn_tpu_torch/csrc/flash_fwd_sm90.cu",
         "chainermn_tpu/ops/flash_attention.py:92"),
        ("flash_attention_bwd", "bwd",
         "chainermn_tpu_torch/csrc/flash_bwd_sm90.cu",
         "chainermn_tpu/ops/flash_attention.py:239")]] + [{
        "name": f"flash_attention_bwd_{part}", "route": "cuda",
        "source": source, "replaces": replaces,
        "launches": dp_launches[f"bwd_{part}"],
        **{f: split_times[part][f] for f in fields},
    } for part, source, replaces in [
        ("dq", "chainermn_tpu_torch/csrc/flash_bwd_dq_sm90.cu",
         "chainermn_tpu/ops/flash_attention.py:146"),
        ("dkv", "chainermn_tpu_torch/csrc/flash_bwd_sm90.cu",
         "chainermn_tpu/ops/flash_attention.py:187")]]})
    emit({"phase": "total", "seconds": time.perf_counter() - T_START,
          "profile_missed_launches": dict(PROFILE_MISSED)})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
